"""Nested-dict tree helpers."""
