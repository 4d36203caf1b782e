"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

  batched_lora  — BGMV: per-row adapter gather for mixed-tenant serving
                  (CUDA, csrc/bgmv.cu)
  fused_dora    — base product and DoRA-decomposed adapter in one pass
                  (CUDA, csrc/fused_dora.cu)
  quant_matmul  — dequant-fused int8/int4 backbone matmul for serving,
                  with the codecs and ``quantize_backbone`` (CUDA,
                  csrc/quant_matmul.cu)
  flash_attention — online-softmax attention with GQA, causal offset,
                  window and a valid-key limit (CUDA,
                  csrc/flash_attention.cu)
  ssd_scan      — the Mamba-2 SSD chunked scan, its state carried in f32
                  (CUDA, csrc/ssd_scan.cu)

Every Pallas kernel of the reference has its counterpart here.
Importing this package builds nothing and needs no card, no nvcc and no
triton: each kernel builds on its first launch (``_build.build_all``
builds them all at once).
"""
from repro_torch.kernels.batched_lora.ops import (bgmv, bgmv_mag,  # noqa: F401
                                                  bgmv_mag_ref, bgmv_ref)
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    attention_ref, flash_attention)
from repro_torch.kernels.fused_dora.ops import (fused_dora,  # noqa: F401
                                                fused_dora_ref)
from repro_torch.kernels.quant_matmul.ops import (dequantize,  # noqa: F401
                                                  quant_matmul,
                                                  quant_matmul_ref,
                                                  quantize_backbone,
                                                  quantize_int4,
                                                  quantize_int8, unpack_int4)
from repro_torch.kernels.ssd_scan.ops import (ssd_naive, ssd_ref,  # noqa: F401
                                              ssd_scan)
