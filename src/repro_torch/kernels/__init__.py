"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

  batched_lora  — BGMV: per-row adapter gather for mixed-tenant serving
                  (CUDA, csrc/bgmv.cu)
  fused_dora    — base product and DoRA-decomposed adapter in one pass
                  (CUDA, csrc/fused_dora.cu)
  quant_matmul  — dequant-fused int8/int4 backbone matmul for serving,
                  with the codecs and ``quantize_backbone`` (CUDA,
                  csrc/quant_matmul.cu)

The reference's flash_attention and ssd_scan kernels are not ported yet
(ROADMAP B5, B6).  Importing this package builds nothing and needs no
card: each kernel builds on its first launch.
"""
from repro_torch.kernels.batched_lora.ops import (bgmv, bgmv_mag,  # noqa: F401
                                                  bgmv_mag_ref, bgmv_ref)
from repro_torch.kernels.fused_dora.ops import (fused_dora,  # noqa: F401
                                                fused_dora_ref)
from repro_torch.kernels.quant_matmul.ops import (dequantize,  # noqa: F401
                                                  quant_matmul,
                                                  quant_matmul_ref,
                                                  quantize_backbone,
                                                  quantize_int4,
                                                  quantize_int8, unpack_int4)
