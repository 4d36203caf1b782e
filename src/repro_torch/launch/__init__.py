"""Serving entry points (greedy generation, per-tenant merge)."""
