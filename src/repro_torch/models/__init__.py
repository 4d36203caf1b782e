"""The transformer zoo of the port (config, layers, the SSM mixer,
model)."""
