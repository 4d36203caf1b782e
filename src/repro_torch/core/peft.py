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
``mask_ffa``) and the per-client rank masks of mixed-rank fleets
(``client_rank_masks``, over the axis ``rank_axis`` names).

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
    ``device`` (on "meta", shapes only: nothing is drawn)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=g, device=g.device).to(device)


def add_lora(base: Params, cfg: ArchConfig, generator: torch.Generator, *,
             decomposed: bool = False, rank: int = 0) -> Params:
    """Build the adapter overlay for every target projection.

    Raw LoRA init: A ~ N(0, 1/r), B ~ N(0, 1e-3).  Decomposed init:
    B_dir is a random unit-norm direction and B_mag = 0, so ΔW = 0
    exactly (see the reference's docstring for why that matters).
    Draws happen on the generator's device; leaves land on each target
    kernel's device, in f32.  Over a ``device="meta"`` base nothing is
    drawn (``generator`` may be None): the overlay has the shapes only.
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


# ---------------------------------------------------------------------------
# heterogeneous ranks (per-client adapter capacity)
# ---------------------------------------------------------------------------
#
# A mixed-rank fleet keeps every adapter tree allocated at r_max, so the
# client axis stays stackable; a per-leaf rank mask zeroes the rows /
# columns above each client's own rank.  This table is the one source of
# truth for which axis of each adapter leaf is the rank axis.

_RANK_AXIS = {
    "lora_A": -1, "local_A": -1, "A_dir": -1, "dA_dir": -1,
    "lora_B": -2, "local_B": -2, "B_dir": -2,
    "B_mag": -1, "dB_mag": -1,
}


def rank_axis(path: str) -> int | None:
    """The axis of the adapter leaf at ``path`` that indexes LoRA rank
    (negative, relative to the per-client leaf), or None for leaves with
    no rank dimension (A_mag, prompt embeddings, Houlsby adapters)."""
    return _RANK_AXIS.get(path.rsplit("/", 1)[-1])


def fleet_alloc_rank(client_ranks, n_clients: int,
                     server_rank: int = 0) -> int:
    """Validate a mixed-rank fleet's per-client ranks and return the
    allocation rank: ``server_rank``, or the fleet's largest rank when
    it is 0."""
    client_ranks = tuple(int(r) for r in client_ranks)
    if len(client_ranks) != n_clients:
        raise ValueError(
            f"client_ranks has {len(client_ranks)} entries for "
            f"{n_clients} clients")
    if min(client_ranks) < 1:
        raise ValueError(f"client ranks must be >= 1, got {client_ranks}")
    alloc = int(server_rank or max(client_ranks))
    if alloc < max(client_ranks):
        raise ValueError(
            f"server_rank {server_rank} is below the fleet max "
            f"{max(client_ranks)}")
    return alloc


def client_rank_masks(adapters: Params, ranks) -> Params:
    """Per-client 0/1 f32 masks over the rank axis of every adapter leaf.

    ``ranks``: the C per-client ranks.  Each mask leaf has shape
    (C, 1, ..., r, ..., 1), broadcasting against the client-stacked
    leaf: 1 where the rank index is below the client's rank, 0 above.
    A leaf with no rank axis gets all-ones (C, 1, ..., 1).  Masks land
    on each leaf's device."""
    ranks = torch.as_tensor(ranks, dtype=torch.int64).reshape(-1)
    C = ranks.shape[0]

    def one(path, x):
        ax = rank_axis(path)
        if ax is None:
            return torch.ones((C,) + (1,) * x.dim(), device=x.device)
        ax_abs = x.dim() + ax                  # absolute, per-client leaf
        shape = [1] * (x.dim() + 1)
        shape[ax_abs + 1] = x.shape[ax_abs]
        keep = (torch.arange(x.shape[ax_abs]).reshape(shape)
                < ranks.reshape((C,) + (1,) * x.dim()))
        return keep.to(device=x.device, dtype=torch.float32)

    return pt.tree_map_with_path(one, adapters)


def apply_rank_masks(client_adapters: Params, masks: Params) -> Params:
    """Zero the rows above each client's rank (masks broadcast per leaf,
    each leaf keeps its dtype)."""
    return pt.tree_map2(lambda x, m: x * m.to(x.dtype), client_adapters,
                        masks)


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
