"""Weights carried across from the JAX package (checkpoint files are
ROADMAP A10)."""
