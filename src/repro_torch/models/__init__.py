"""Dense decoder of the port (config, layers, model)."""
