"""Decoder of the port (config, layers, the SSM mixer, model)."""
