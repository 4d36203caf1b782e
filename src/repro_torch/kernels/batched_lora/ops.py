"""Public dispatchers for the batched-LoRA (BGMV) ops.

``impl=None`` runs the CUDA kernel for a CUDA tensor and the plain
PyTorch version for a CPU tensor — the CPU is the only reason the plain
version runs, and there is no fallback: on a CUDA tensor the kernel
launches or raises.  ``impl="torch"`` forces the plain version, for
explicit comparisons only (``chip_smoke.py`` and the tests).

Inputs accept (B, S, d_in) token blocks or (B, d_in) single-token decode
rows (taken as S = 1); ``idx`` is the (B,) int32 pool-slot vector from
the AdapterStore.  Each call runs inside ``obs.named_scope``
("kernels/bgmv", "kernels/bgmv_mag"), as the reference's, which names it
in a profiler trace and costs nothing with telemetry off and no profiler
recording.
"""
from __future__ import annotations

from repro_torch.kernels._wrap import resolve_impl
from repro_torch.kernels.batched_lora.bgmv import bgmv_cuda, bgmv_mag_cuda
from repro_torch.kernels.batched_lora.ref import bgmv_mag_ref, bgmv_ref
from repro_torch.obs.tracing import named_scope


def bgmv(x, a_pool, b_pool, idx, *, scale: float = 1.0, ranks=None,
         impl=None):
    """y[i] = scale · (x[i] @ a_pool[idx[i]]) @ b_pool[idx[i]]; ``ranks``
    (L,) int32 masks rank columns ≥ ranks[idx[i]] out of row i."""
    impl = resolve_impl(impl, x, "bgmv")
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, None, :]
    with named_scope("kernels/bgmv"):
        if impl == "torch":
            y = bgmv_ref(x, a_pool, b_pool, idx, scale, ranks=ranks)
        else:
            y = bgmv_cuda(x, a_pool, b_pool, idx, ranks, scale=scale)
    return y[:, 0] if squeeze else y


def bgmv_mag(x, a_dir, a_mag, b_mag, dmag_pool, b_dir, idx, *,
             scale: float = 1.0, ranks=None, impl=None):
    """Decomposed-DoRA magnitude path (raw-delta pool):
    y[i] = scale · (((x[i] ⊙ a_mag) @ a_dir)
                    ⊙ (b_mag + dmag_pool[idx[i]])) @ b_dir;
    ``ranks`` masks the magnitude product per row (shared b_mag rows
    included, so a rank-0 slot serves the bare backbone)."""
    impl = resolve_impl(impl, x, "bgmv")
    squeeze = x.dim() == 2
    if squeeze:
        x = x[:, None, :]
    with named_scope("kernels/bgmv_mag"):
        if impl == "torch":
            y = bgmv_mag_ref(x, a_dir, a_mag, b_mag, dmag_pool, b_dir, idx,
                             scale, ranks=ranks)
        else:
            y = bgmv_mag_cuda(x, a_dir, a_mag, b_mag, dmag_pool, b_dir, idx,
                              ranks, scale=scale)
    return y[:, 0] if squeeze else y


__all__ = ["bgmv", "bgmv_mag", "bgmv_ref", "bgmv_mag_ref"]
