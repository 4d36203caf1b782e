"""LoRA adapters as param-tree overlays over the shared backbone.

``add_lora`` returns an *adapter tree*: a sparse overlay whose leaves sit
at the same paths the model's ``linear`` consults
(``.../q_proj/lora_A`` etc.); ``merge_trees(base, adapters)`` gives the
full forward params.  Raw LoRA and the paper's DoRA-decomposed form are
ported, with the stage masks that drive ``optim.masked`` through the
paper's pipeline; the other adapter kinds of the reference zoo, and the
per-client rank masks of mixed-rank fleets, are ROADMAP A8.

Random draws come from an explicit ``torch.Generator`` and differ from
the reference's threefry streams, so parity tests carry the JAX
adapters across through ``checkpoint.bridge`` instead.
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch

from repro_torch.core import dora
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt

Params = Any

_KERNEL_RX = re.compile(r"(?P<proj>[a-zA-Z0-9_]+)/kernel$")


def _target_kernels(base: Params, targets) -> list[tuple[str, Any]]:
    out = []
    for path in pt.tree_paths(base):
        m = _KERNEL_RX.search(path)
        if m and m.group("proj") in targets:
            out.append((path, pt.tree_get(base, path)))
    return out


def add_lora(base: Params, cfg: ArchConfig, generator: torch.Generator, *,
             decomposed: bool = False, rank: int = 0) -> Params:
    """Build the adapter overlay for every target projection.

    Raw LoRA init: A ~ N(0, 1/r), B ~ N(0, 1e-3).  Decomposed init:
    B_dir is a random unit-norm direction and B_mag = 0, so ΔW = 0
    exactly (see the reference's docstring for why that matters).
    Draws happen on the generator's device; leaves land on each target
    kernel's device, in f32.
    """
    r = rank or cfg.lora_rank
    g = generator
    overlay: dict = {}
    for path, kern in _target_kernels(base, cfg.lora_targets):
        *lead, d_in, d_out = kern.shape
        A = (torch.randn((*lead, d_in, r), generator=g, device=g.device)
             / math.sqrt(r)).to(kern.device)
        rawB = torch.randn((*lead, r, d_out), generator=g,
                           device=g.device).to(kern.device)
        prefix = path.rsplit("/", 1)[0]
        if decomposed:
            A_mag, A_dir = dora.decompose(A)
            _, B_dir = dora.decompose(rawB)
            B_mag = torch.zeros((*lead, r), device=kern.device)
            pt.set_leaf(overlay, f"{prefix}/A_dir", A_dir)
            pt.set_leaf(overlay, f"{prefix}/A_mag", A_mag)
            pt.set_leaf(overlay, f"{prefix}/B_dir", B_dir)
            pt.set_leaf(overlay, f"{prefix}/B_mag", B_mag)
            pt.set_leaf(overlay, f"{prefix}/dA_dir", torch.zeros_like(A_dir))
            pt.set_leaf(overlay, f"{prefix}/dB_mag", torch.zeros_like(B_mag))
        else:
            pt.set_leaf(overlay, f"{prefix}/lora_A", A)
            pt.set_leaf(overlay, f"{prefix}/lora_B", rawB * 1e-3)
    return overlay


# ---------------------------------------------------------------------------
# trainable masks (drive optim.masked and the paper's stage pipeline)
# ---------------------------------------------------------------------------

def mask_all(adapters: Params) -> Params:
    return pt.path_mask(adapters, lambda p: True)


def mask_stage_local_pretrain(adapters: Params) -> Params:
    """Stage 1, client LoRA fine-tune: the base components train, the
    pipeline deltas (dA_dir / dB_mag) stay zero until their stages."""
    return pt.path_mask(adapters,
                        lambda p: not re.search(r"d[AB]_(dir|mag)", p))


def mask_stage_global(adapters: Params) -> Params:
    """Stage 2, global optimizer: ΔA_D only (paper Eq. 9)."""
    return pt.path_mask(adapters, lambda p: p.endswith("dA_dir"))


def mask_stage_local(adapters: Params) -> Params:
    """Stage 3, local optimizer: ΔB_M only (paper Eqs. 10-11)."""
    return pt.path_mask(adapters, lambda p: p.endswith("dB_mag"))


def reg_mask_dB(adapters: Params) -> Params:
    """The leaves of the Eq. 11 ½λ‖·‖²_F regularizer."""
    return pt.path_mask(adapters, lambda p: p.endswith("dB_mag"))
