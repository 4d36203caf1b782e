"""DoRA decomposition and LoRA adapters."""
