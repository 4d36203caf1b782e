"""LoRA adapters as param-tree overlays over the shared backbone.

Each ``add_*`` function returns an *adapter tree*: a sparse overlay
whose leaves sit at the same paths the model consults
(``.../q_proj/lora_A`` etc.); ``merge_trees(base, adapters)`` gives the
full forward params.  The zoo:

  add_lora            raw LoRA, or the paper's DoRA-decomposed form
  add_dual_lora       FedALT's shared pair plus a client-local pair
  add_prompt_tuning   a trained prompt prepended to every sequence
  add_adapter_tuning  Houlsby bottleneck adapters after each dense FFN

with the trainable masks that drive ``optim.masked`` (FFA-LoRA's is
``mask_ffa``).  The per-client rank masks of mixed-rank fleets are
ROADMAP A8b.

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


def _randn(g, shape, device):
    """N(0, 1) in f32, drawn on the generator's device, moved to
    ``device``."""
    return torch.randn(shape, generator=g, device=g.device).to(device)


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
        A = _randn(g, (*lead, d_in, r), kern.device) / math.sqrt(r)
        rawB = _randn(g, (*lead, r, d_out), kern.device)
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


def add_dual_lora(base: Params, cfg: ArchConfig, generator: torch.Generator,
                  *, rank: int = 0) -> Params:
    """FedALT-style dual adapters on every target projection: the shared
    pair {lora_A, lora_B} (``add_lora``'s raw init) is aggregated, the
    individual pair {local_A, local_B} never leaves the client (the
    method's keep-local regex).  local_A ~ N(0, 1/r), local_B = 0, so
    the personal delta is 0 at init."""
    r = rank or cfg.lora_rank
    overlay = add_lora(base, cfg, generator, decomposed=False, rank=r)
    for path, kern in _target_kernels(base, cfg.lora_targets):
        *lead, d_in, d_out = kern.shape
        prefix = path.rsplit("/", 1)[0]
        pt.set_leaf(overlay, f"{prefix}/local_A",
                    _randn(generator, (*lead, d_in, r), kern.device)
                    / math.sqrt(r))
        pt.set_leaf(overlay, f"{prefix}/local_B",
                    torch.zeros((*lead, r, d_out), device=kern.device))
    return overlay


def add_prompt_tuning(base: Params, cfg: ArchConfig,
                      generator: torch.Generator,
                      n_prompt: int = 16) -> Params:
    """Prompt tuning (Lester et al.): ``n_prompt`` trained embeddings,
    N(0, 0.02²), prepended to every sequence by ``model.forward``."""
    emb = base["embed"]["embedding"]
    return {"prompt_embed": _randn(generator, (n_prompt, cfg.d_model),
                                   emb.device) * 0.02}


def add_adapter_tuning(base: Params, cfg: ArchConfig,
                       generator: torch.Generator,
                       bottleneck: int = 16) -> Params:
    """Houlsby bottleneck after each dense FFN (``mlp`` dicts):
    adapter_down (..., d, bottleneck) ~ N(0, 0.02²), adapter_up = 0, so
    the adapter is the identity at init."""
    overlay: dict = {}
    for path in pt.tree_paths(base):
        m = re.search(r"(.*mlp)/down_proj/kernel$", path)
        if not m:
            continue
        kern = pt.tree_get(base, path)
        *lead, _, d_out = kern.shape
        pt.set_leaf(overlay, f"{m.group(1)}/adapter_down",
                    _randn(generator, (*lead, d_out, bottleneck),
                           kern.device) * 0.02)
        pt.set_leaf(overlay, f"{m.group(1)}/adapter_up",
                    torch.zeros((*lead, bottleneck, d_out),
                                device=kern.device))
    return overlay


def validate_client_weights(client_weights, n_clients: int) -> None:
    """Per-client aggregation weights: one per client, each > 0."""
    if len(client_weights) != n_clients:
        raise ValueError(
            f"client_weights has {len(client_weights)} entries for "
            f"{n_clients} clients")
    if min(client_weights) <= 0:
        raise ValueError(
            f"client weights must be > 0, got {tuple(client_weights)}")


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


def mask_ffa(adapters: Params) -> Params:
    """FFA-LoRA (Sun et al.): A frozen, B trains."""
    return pt.path_mask(adapters, lambda p: p.endswith("lora_B"))


def reg_mask_dB(adapters: Params) -> Params:
    """The leaves of the Eq. 11 ½λ‖·‖²_F regularizer."""
    return pt.path_mask(adapters, lambda p: p.endswith("dB_mag"))
