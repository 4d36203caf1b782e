"""DoRA decomposition, LoRA adapters and masks, aggregation, the method
registry and the paper's pipeline (``fedlora.run_federated``)."""
