"""Dequant-fused int8/int4 weight-only quantized matmul for serving."""
