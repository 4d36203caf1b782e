"""Fused DoRA-decomposed LoRA linear: base product and adapter in one pass."""
