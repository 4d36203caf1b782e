"""Mamba-2 SSD chunked scan: the state carried across chunks in f32."""
