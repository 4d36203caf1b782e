"""Public dispatcher for the dequant-fused quantized matmul, and the
``quantize_backbone`` pass that makes the quantized param tree.

``quant_matmul(..., impl=None)`` launches the CUDA kernel for a CUDA
tensor and runs the plain version for a CPU tensor; ``impl="torch"``
forces the plain version, for explicit comparisons only.  The call runs
inside ``obs.named_scope("kernels/quant_matmul")``, as the reference's.  The kernel
masks its own ragged edges, so unlike the JAX dispatcher nothing is
padded or sliced here.

A quantized leaf is a dict ``{"kernel_q", "kernel_scale"}`` in place of
``{"kernel"}``; ``models.layers.linear`` sees the key and dispatches
here, and the adapter and pool leaves beside it stay full precision.
"""
from __future__ import annotations

import re

from repro_torch.kernels._wrap import resolve_impl
from repro_torch.kernels.quant_matmul.quant_matmul import quant_matmul_cuda
from repro_torch.kernels.quant_matmul.ref import (dequantize,  # noqa: F401
                                                  quant_matmul_ref,
                                                  quantize_int4, quantize_int8,
                                                  unpack_int4)
from repro_torch.obs.tracing import named_scope
from repro_torch.utils import pytree as pt

# the backbone leaves that quantize: attention and FFN projection kernels.
# Embeddings, norms, biases and the LM head keep their type.
_PROJ_RX = re.compile(r"(?:^|/)(?:q|k|v|o|gate|up|down)_proj/kernel$")


def quant_matmul(x, q, scale, *, impl=None):
    """x (..., d_in) @ dequant(q, scale) → (..., d_out).

    ``q`` int8 (d_in, d_out) or packed-int4 uint8 (d_in/2, d_out);
    ``scale`` (G, d_out) f32, per channel (G = 1) or per group."""
    impl = resolve_impl(impl, x, "quant_matmul")
    with named_scope("kernels/quant_matmul"):
        if impl == "torch":
            return quant_matmul_ref(x, q, scale)
        lead, d_in = x.shape[:-1], x.shape[-1]
        y = quant_matmul_cuda(x.reshape(-1, d_in).contiguous(), q, scale)
        return y.reshape(*lead, q.shape[-1])


def _quantize(quant, leaf, group_size):
    """Quantize a 2-D kernel, or a stacked (n_sb, d_in, d_out) one slice
    at a time on its own device, so no f32 copy of the whole stack is
    made; the codec reduces over d_in only, so each slice comes out as
    the whole stack would."""
    if leaf.dim() == 2:
        return quant(leaf, group_size=group_size)
    q0, s0 = quant(leaf[0], group_size=group_size)
    q = q0.new_empty((leaf.shape[0], *q0.shape))
    s = s0.new_empty((leaf.shape[0], *s0.shape))
    q[0], s[0] = q0, s0
    for i in range(1, leaf.shape[0]):
        q[i], s[i] = quant(leaf[i], group_size=group_size)
    return q, s


def quantize_backbone(base, mode: str, *, group_size=None):
    """A copy of the base tree with every attention/FFN projection kernel
    replaced by ``{kernel_q, kernel_scale}`` in ``mode`` ("int8" |
    "int4"); every other leaf, any merged adapter leaf included, is
    carried over as it is (not copied)."""
    if mode not in ("int8", "int4"):
        raise ValueError(
            f"backbone_quant must be 'int8' or 'int4', got {mode!r}")
    quant = quantize_int8 if mode == "int8" else quantize_int4
    out: dict = {}
    for path, leaf in pt.tree_leaves_with_path(base):
        if _PROJ_RX.search(path) and leaf.dim() in (2, 3):
            qv, s = _quantize(quant, leaf, group_size)
            stem = path[: -len("kernel")]
            pt.set_leaf(out, stem + "kernel_q", qv)
            pt.set_leaf(out, stem + "kernel_scale", s)
        else:
            pt.set_leaf(out, path, leaf)
    return out


__all__ = ["quant_matmul", "quant_matmul_ref", "quantize_backbone",
           "quantize_int8", "quantize_int4", "dequantize", "unpack_int4"]
