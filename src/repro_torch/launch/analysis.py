"""The analytic FLOP / byte account of one step and its roofline terms
(port of ``repro/launch/analysis.py``'s analytic half).

Three terms per (architecture × input shape), in seconds:

  compute    = FLOPs_per_device / PEAK_FLOPS
  memory     = HBM_bytes_per_device / HBM_BW
  collective = collective bytes a device sends / NVLINK_BW

The constants are one NVIDIA H100 SXM's (NVIDIA's data sheet, dense
bf16, at the full 700 W): the figures the port's kernel bounds use.
The collective term is the reference's convention (its per-link ICI
rate, ``ICI_BW``): the bytes a rank sends in a step, as a grid's
``ClientGroup.stats`` count them (the dry run on a grid,
``launch/dryrun.py``), over one card's NVLink 4 rate, 450 GB/s a
direction (900 GB/s both ways) between the cards of one node.  It
describes ranks on cards of their own; a grid whose ranks share one card
over gloo moves its bytes through the host, which this term does not
describe.  One card has no collective: 0 bytes.

The formulas are the reference's, copied exactly (its tests hold the two
equal for every supported pair).  Where they miss the port's work they
are left as they are and listed in ROADMAP queue C (caveat 6): an
encoder's non-causal attention counted as a causal average over S / 2,
the encoder counted in every decode step, and the cross-attention k / v
projections a decode step recomputes not counted.

The reference's HLO parsers (``_result_bytes``, ``_split_computations``,
``parse_collectives``) read XLA's compiled text, which the port does not
produce; they have no counterpart here.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import InputShape
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt

PEAK_FLOPS = 989e12          # H100 SXM bf16 dense / card
HBM_BW = 3.35e12             # bytes/s / card
NVLINK_BW = 450e9            # bytes/s / card, one direction (NVLink 4)


# ---------------------------------------------------------------------------
# analytic FLOPs / bytes (documented formulas)
# ---------------------------------------------------------------------------

def _sublayer_flops_per_token(cfg: ArchConfig, sub, kind: str,
                              seq_len: int) -> float:
    D = cfg.d_model
    fl = 0.0
    if sub.mixer in ("attn", "cross_attn"):
        Hdh = cfg.n_heads * cfg.head_dim
        Kdh = cfg.n_kv_heads * cfg.head_dim
        fl += 2 * D * Hdh + 2 * 2 * D * Kdh + 2 * Hdh * D
        if kind == "decode":
            eff = seq_len if sub.attn_kind != "local" or not cfg.sliding_window \
                else min(cfg.sliding_window, seq_len)
        else:
            full = seq_len / 2                       # causal average
            eff = full if sub.attn_kind != "local" or not cfg.sliding_window \
                else min(cfg.sliding_window, full)
        fl += 4 * cfg.n_heads * cfg.head_dim * eff   # qk^T + pv
    elif sub.mixer == "ssm":
        H = D * cfg.ssm_expand // cfg.ssm_headdim
        P = cfg.ssm_headdim
        N = cfg.ssm_state
        GN = cfg.ssm_groups * N
        d_inner = H * P
        fl += 2 * D * (2 * d_inner) + 2 * D * 2 * GN + 2 * D * H
        fl += 2 * cfg.ssm_conv * (d_inner + 2 * GN)
        if kind == "decode":
            fl += 6 * H * N * P                      # state update + read
        else:
            Q = min(cfg.ssm_chunk, seq_len)
            fl += H * (2 * Q * (N + P) + 4 * N * P)  # SSD chunked
        fl += 2 * d_inner * D
    if sub.ffn == "dense":
        fl += 3 * 2 * D * cfg.d_ff
    elif sub.ffn == "moe":
        fl += 2 * D * cfg.n_experts
        fl += 3 * 2 * D * cfg.d_ff * cfg.top_k * cfg.capacity_factor
    return fl


def _layer_list(cfg: ArchConfig):
    n_sb, tail, pattern = cfg.blocks_layout()
    if cfg.n_enc_layers:
        pattern = cfg.dec_pattern()
        n_sb, tail = cfg.n_layers, 0
    return n_sb, tail, pattern


def analytic_step_flops(cfg: ArchConfig, shape: InputShape) -> dict:
    """Global FLOPs for one step of the shape's kind.  A train step counts
    3 forward passes: the forward, its recomputation under remat and the
    input gradient (adapter training takes no gradient of a backbone
    weight).  A full-parameter backward takes both the input and the
    weight gradients, about 2 forward passes, so 3 is also that step's
    count without remat."""
    kind = shape.kind
    S, B = shape.seq_len, shape.global_batch
    n_sb, tail, pattern = _layer_list(cfg)
    per_tok = sum(_sublayer_flops_per_token(cfg, s, kind, S) for s in pattern)
    per_tok_tail = sum(_sublayer_flops_per_token(cfg, pattern[i], kind, S)
                       for i in range(tail))
    layers_per_tok = per_tok * n_sb + per_tok_tail
    if cfg.n_enc_layers:
        enc_sub = type(pattern[0])("attn", "dense", "global")
        layers_per_tok += _sublayer_flops_per_token(
            cfg, enc_sub, "prefill", S // 2) * cfg.n_enc_layers

    head = 2 * cfg.d_model * cfg.vocab_size
    if kind == "train":
        tokens = B * S
        fwd = layers_per_tok * tokens + head * tokens
        total = 3.0 * fwd                 # fwd + remat-fwd + dL/dx bwd
    elif kind == "prefill":
        tokens = B * S
        total = layers_per_tok * tokens + head * B
    else:                                 # decode: one token per sequence
        tokens = B
        total = layers_per_tok * tokens + head * B
    return {"flops_global": float(total), "tokens": float(tokens)}


def param_counts(cfg: ArchConfig, abstract_params) -> dict:
    """Parameter counts over a (meta) parameter tree: total, active
    (experts at top_k / n_experts), active without the embedding and
    head, embedding + head, experts."""
    total = 0
    expert = 0
    embed_head = 0
    for path, x in pt.tree_leaves_with_path(abstract_params):
        n = x.numel()
        total += n
        if "experts" in path:
            expert += n
        if path.startswith(("embed/", "lm_head/")):
            embed_head += n
    active = total - expert
    if cfg.n_experts:
        active += expert * cfg.top_k / cfg.n_experts
    return {"n_params": total, "n_active": int(active),
            "n_active_body": int(active - embed_head),
            "embed_head_params": embed_head,
            "expert_params": expert}


def analytic_step_bytes(cfg: ArchConfig, shape: InputShape, n_params: int,
                        n_devices: int, cache_bytes_global: int = 0) -> dict:
    """Per-device HBM traffic model (coarse but stated):

      train:   3 passes over resident params (fwd, remat, bwd)
               + activation traffic ≈ L · T_dev · D · 2B · 12
      prefill: 1 pass over params + activations + cache write
      decode:  1 pass over params + cache read   (weights+cache bound)
    """
    pbytes_dev = n_params * 2 / n_devices * _param_replication(cfg)
    S, B = shape.seq_len, shape.global_batch
    L = cfg.n_layers + cfg.n_enc_layers
    D = cfg.d_model
    if shape.kind == "train":
        t_dev = B * S / n_devices
        act = L * t_dev * D * 2 * 12
        total = 3 * pbytes_dev + act
    elif shape.kind == "prefill":
        t_dev = B * S / n_devices
        act = L * t_dev * D * 2 * 8
        total = pbytes_dev + act + cache_bytes_global / n_devices
    else:
        total = pbytes_dev + cache_bytes_global / n_devices
    return {"hbm_bytes_dev": float(total),
            "param_bytes_dev": float(pbytes_dev)}


def _param_replication(cfg: ArchConfig) -> float:
    """The per-device resident bytes are what one step reads: replication
    factor 1 for traffic purposes."""
    return 1.0


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        vals = {"compute": self.compute_s, "memory": self.memory_s,
                "collective": self.collective_s}
        return max(vals, key=vals.get)


def roofline_terms(flops_global: float, hbm_bytes_dev: float,
                   coll_bytes_dev: float, n_devices: int) -> Roofline:
    """The three terms at the H100's rates: ``coll_bytes_dev`` the bytes
    a device sends in the step, over ``NVLINK_BW`` (module docstring)."""
    return Roofline(
        compute_s=flops_global / n_devices / PEAK_FLOPS,
        memory_s=hbm_bytes_dev / HBM_BW,
        collective_s=coll_bytes_dev / NVLINK_BW,
    )
