"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version.

  batched_lora  — BGMV: per-row adapter gather for mixed-tenant serving
                  (CUDA, csrc/bgmv.cu)

The other Pallas kernels of the reference (fused_dora, quant_matmul,
flash_attention, ssd_scan) are not ported yet (ROADMAP B1, B4-B6).
Importing this package builds nothing: kernels build on first launch.
"""
from repro_torch.kernels.batched_lora.ops import (bgmv, bgmv_mag,  # noqa: F401
                                                  bgmv_mag_ref, bgmv_ref)
