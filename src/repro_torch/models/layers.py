"""Core layers of the transformer zoo (port of ``repro/models/layers.py``).

Everything is a function over nested-dict params.  Linear layers
understand adapter params living alongside their kernel:

  {kernel}                                  — plain frozen projection
  {kernel, lora_A, lora_B}                  — raw LoRA (baseline)
  {kernel, lora_A, lora_B, local_A, local_B} — FedALT's dual pairs
  {kernel, A_dir, A_mag, B_dir, B_mag,
   dA_dir, dB_mag}                          — DoRA-decomposed LoRA
  {kernel, pool_A, pool_B[, pool_ranks]}    — pooled per-tenant pairs
  {kernel, bgmv_A_dir, bgmv_A_mag,
   bgmv_B_mag, bgmv_B_dir, pool_dB_mag
   [, pool_ranks]}                          — pooled decomposed DoRA
  {kernel_q, kernel_scale, ...}             — quantized frozen backbone
                                              (int8 / packed int4), any
                                              of the adapters above on top

Kernels use (d_in, d_out) layout.  Dtypes and cast points follow the
reference: bf16 operands with f32 accumulation where it accumulates in
f32, so the two packages agree to a stated tolerance and the port's
pooled path equals its merged path in float32.

``linear`` routes to the port's kernels: ``fused=True`` (``cfg.
use_fused_dora``) sends a non-pooled DoRA-decomposed projection through
``fused_dora``, a ``kernel_q`` leaf goes through ``quant_matmul``, and
pooled adapters through the BGMV ops.  ``kernel_impl`` threads down to
all of them: None launches the CUDA kernel for CUDA tensors (the plain
version for CPU ones); "torch" forces the plain versions, for explicit
comparisons only.

Tensor parallelism (``tp``: a grid's model row, ``launch/mesh.Grid``;
None or a group of one computes whole tensors).  The backbone leaves are
this rank's shard (``launch/specs.shard_tree`` by the rule table of
``utils/sharding.py``); every adapter leaf is whole on every rank, as the
rules say.  ``linear(split="col")`` (q/k/v/gate/up) computes the rank's
columns: x·W0[:, cols], the adapter's h from the whole x and the rank's
columns of B (``B_dir``, ``lora_B``).  ``linear(split="row")`` (o/down)
computes the rank's partial sum from its rows of the input: x_r·W0[rows]
plus the adapter's partial h_r = (x_r ⊙ A_mag[rows])·A_dir[rows] carried
through the whole B, and one all-reduce over the group sums both: Σ_r
(h_r ⊙ b)·B is (Σ_r h_r ⊙ b)·B, so h's all-reduce rides the product's;
a bias is added once, after it.  That keeps every adapter leaf's
gradient a partial sum on each rank, so the engine's one sum over the
model group after the backward is exact (an all-reduce of h before B
would leave B's gradient whole on every rank, and the sum would count it
n_model times).  Adapters that every rank applies whole to whole
activations (the Houlsby adapter, ``model.forward``'s prompt) go through
``scale_grad`` by 1/n_model, so their gradients are partial sums too.  ``fused_dora`` takes the rank's slice of W0 and of the
adapter unchanged, columns or rows.  The region's input goes through
``copy_to`` once a sublayer (identity forward, all-reduce backward).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels._wrap import resolve_impl
from repro_torch.utils.collectives import (all_to_all, copy_to,
                                           gather_from, mean_over,
                                           model_group, reduce_from,
                                           scale_grad)

Params = Any


def wide(t):
    """``t`` in f32, or left in f64: where the reference computes in f32,
    an f64 run (the tests' witness) stays f64, so that a tensor-parallel
    run's other summation order is not rounded through f32 there."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(dh: int, theta: float, device):
    return theta ** (-torch.arange(0, dh // 2, dtype=torch.float32,
                                   device=device) / (dh // 2))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, dh); positions: (B, S) int.  Rotates split halves
    (x[..., :dh/2], x[..., dh/2:]), not interleaved pairs."""
    dh = x.shape[-1]
    freqs = _rope_freqs(dh, theta, x.device)                   # (dh/2,)
    ang = positions[..., None].float() * freqs                 # (B,S,dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float = 1e4,
                sections=(0.25, 0.375, 0.375)):
    """Qwen2-VL's multimodal rotary: positions3 (B, S, 3) holds the (t, h,
    w) ids.  The dh/2 frequency bands split into three sections (at dh
    128: 16 / 24 / 24 bands), each rotated by its own component.  With
    all three components equal this is ``apply_rope`` bit for bit."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(x.shape[-1], theta, x.device)
    n0, n1 = int(half * sections[0]), int(half * sections[1])
    sel = torch.cat([torch.full((n,), c, dtype=torch.int64, device=x.device)
                     for c, n in enumerate((n0, n1, half - n0 - n1))])
    ang = positions3.float()[..., sel] * freqs                 # (B,S,dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _rotate(q, k, positions, cfg):
    """RoPE on q and k: M-RoPE when ``cfg.mrope`` (a (B, S) positions
    tensor repeated to its three components), else the standard rotary
    on (B, S) positions (component 0 of (B, S, 3) ones)."""
    if cfg.mrope:
        pos3 = (positions if positions.dim() == 3
                else positions[..., None].expand(*positions.shape, 3))
        return (apply_mrope(q, pos3, cfg.rope_theta),
                apply_mrope(k, pos3, cfg.rope_theta))
    pos = positions if positions.dim() == 2 else positions[..., 0]
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos,
                                                           cfg.rope_theta)


# ---------------------------------------------------------------------------
# adapter-aware linear
# ---------------------------------------------------------------------------

def adapter_dropout(x, generator, p: float):
    """Inverted dropout on the adapter's input: keep each element with
    probability 1 − p (a fresh draw from ``generator``, which lives on
    x's device) and divide the kept ones by 1 − p."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def lora_delta(p: Params, x, scale: float, dropout_gen=None,
               dropout: float = 0.0):
    """Low-rank adapter contribution for input x (..., d_in), with adapter
    dropout at rate ``dropout`` when ``dropout_gen`` is given."""
    if dropout_gen is not None and dropout > 0.0:
        x = adapter_dropout(x, dropout_gen, dropout)
    if "lora_A" in p:                                    # raw LoRA
        h = x @ p["lora_A"].to(x.dtype)
        y = (h @ p["lora_B"].to(x.dtype)) * scale
        if "local_A" in p:           # FedALT dual pair, on the same x
            hl = x @ p["local_A"].to(x.dtype)
            y = y + (hl @ p["local_B"].to(x.dtype)) * scale
        return y
    # DoRA-decomposed LoRA (the paper's form):
    #   A = (A_dir + dA_dir) * A_mag[:, None]
    #   B = B_dir * (B_mag + dB_mag)[:, None]
    a_dir = p["A_dir"] + p["dA_dir"] if "dA_dir" in p else p["A_dir"]
    h = (x * p["A_mag"].to(x.dtype)) @ a_dir.to(x.dtype)
    b_mag = p["B_mag"] + p["dB_mag"] if "dB_mag" in p else p["B_mag"]
    return ((h * b_mag.to(x.dtype)) @ p["B_dir"].to(x.dtype)) * scale


def lora_delta_batched(p: Params, x, adapter_idx, scale: float,
                       kernel_impl=None):
    """Mixed-tenant adapter contribution: row i of x (B, ..., d_in) uses
    the adapter in pool slot adapter_idx[i] (BGMV — see
    kernels/batched_lora and serve/adapter_store).  An optional
    {pool_ranks} leaf ((L,) int32) masks each row at its slot's rank."""
    from repro_torch.kernels import bgmv, bgmv_mag
    ranks = p.get("pool_ranks")
    if "pool_A" in p:
        return bgmv(x, p["pool_A"], p["pool_B"], adapter_idx, scale=scale,
                    ranks=ranks, impl=kernel_impl)
    return bgmv_mag(x, p["bgmv_A_dir"], p["bgmv_A_mag"], p["bgmv_B_mag"],
                    p["pool_dB_mag"], p["bgmv_B_dir"], adapter_idx,
                    scale=scale, ranks=ranks, impl=kernel_impl)


def _has_pooled(p: Params) -> bool:
    return "pool_A" in p or "pool_dB_mag" in p


# adapter leaves by the axis a tensor-parallel slice cuts: the output
# columns (a column-parallel target) or the input rows (a row-parallel one)
_OUT_COLS = ("lora_B", "local_B", "B_dir")
_IN_ROWS = ("lora_A", "local_A", "A_dir", "dA_dir", "A_mag")


def _tp_slice(p: Params, tp, split: str) -> Params:
    """``p`` with its whole adapter leaves (and bias) cut to this rank's
    columns ("col") or rows ("row") of the projection, whose kernel is
    already the rank's shard (views)."""
    if "kernel" not in p:
        raise ValueError("tensor parallelism needs a plain kernel (the "
                         "quantized backbone is not split over a grid)")
    if _has_pooled(p):
        raise ValueError("pooled adapters are not served on a grid (as in "
                         "the reference, whose mesh path refuses "
                         "adapter_idx)")
    w = p["kernel"]
    if split == "col":
        n = w.shape[-1]
        sl = {k: p[k][..., tp.rank * n:(tp.rank + 1) * n]
              for k in _OUT_COLS + ("bias",) if k in p}
    else:
        n = w.shape[0]
        sl = {k: p[k][tp.rank * n:(tp.rank + 1) * n]
              for k in _IN_ROWS if k in p}
    return {**p, **sl}


def linear(p: Params, x, *, lora_scale: float = 0.0, dropout_gen=None,
           dropout: float = 0.0, fused: bool = False, adapter_idx=None,
           kernel_impl=None, tp=None, split=None):
    """x · W0 (+ bias) + the adapter's delta.  ``tp`` / ``split``: the
    rank's columns or its row-parallel partial, all-reduced over ``tp``
    (module docstring)."""
    kw = dict(lora_scale=lora_scale, dropout_gen=dropout_gen,
              dropout=dropout, fused=fused, adapter_idx=adapter_idx,
              kernel_impl=kernel_impl)
    if tp is not None and split is not None:
        q = _tp_slice(p, tp, split)
        if split == "col":
            return linear(q, x, **kw)
        bias = q.pop("bias", None)
        y = reduce_from(linear(q, x, **kw), tp)
        return y if bias is None else y + bias.to(y.dtype)
    if (fused and "A_dir" in p and lora_scale
            and (adapter_idx is None or not _has_pooled(p))
            and (dropout_gen is None or dropout == 0.0)
            and "bias" not in p and "kernel" in p
            and p["kernel"].dim() == 2):
        # fused base + adapter product (forward only).  Pooled per-row
        # routing outranks it: taking this branch there would serve every
        # tenant the shared adapter.
        from repro_torch.kernels import fused_dora
        return fused_dora(x, p["kernel"], p["A_dir"], p["A_mag"],
                          p["B_dir"], p["B_mag"], p.get("dA_dir"),
                          p.get("dB_mag"), scale=lora_scale,
                          impl=kernel_impl)
    if "kernel_q" in p:
        # quantized frozen backbone: dequant-fused product; the adapter
        # deltas below stay full precision on top
        from repro_torch.kernels import quant_matmul
        y = quant_matmul(x, p["kernel_q"], p["kernel_scale"],
                         impl=kernel_impl)
    else:
        y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    if adapter_idx is not None and lora_scale and _has_pooled(p):
        y = y + lora_delta_batched(p, x, adapter_idx, lora_scale, kernel_impl)
    elif ("lora_A" in p or "A_dir" in p) and lora_scale:
        y = y + lora_delta(p, x, lora_scale, dropout_gen, dropout)
    return y


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _causal_window_mask(S_q, S_k, q_offset, window, device, causal=True):
    """(S_q, S_k) boolean mask; q position i (+ q_offset) attends k
    position j ≤ i when ``causal`` (every j otherwise), and only
    j > i - window when ``window`` is given."""
    qi = torch.arange(S_q, device=device)[:, None] + q_offset
    kj = torch.arange(S_k, device=device)[None, :]
    m = kj <= qi if causal else torch.ones((S_q, S_k), dtype=torch.bool,
                                            device=device)
    if window is not None:
        m = m & (kj > qi - window)
    return m


def _sdpa(q, k, v, mask, softmax_scale, w_dtype=None):
    """q:(B,Sq,H,dh) k,v:(B,Sk,K,dh) GQA by grouped heads; mask
    (..., Sq, Sk) bool or None.  Scores in f32 (bf16 operands are exact
    in f32, so this is the reference's f32 accumulation), masked to
    -1e30, softmax in f32, weights cast to ``w_dtype`` (v's dtype when
    None) before the PV product, which accumulates in f32."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    rep = H // K
    qg = q.reshape(B, Sq, K, rep, dh)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg.float(),
                          k.float()) * softmax_scale
    if mask is not None:
        m = mask
        if m.dim() == 4:                      # (B?,1,Sq,Sk) → (B?,1,1,Sq,Sk)
            m = m[:, :, None]
        scores = torch.where(m, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", w.to(w_dtype or v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _sdpa_chunked(q, k, v, softmax_scale, window, causal=True,
                  q_block: int = 512):
    """Attention over 512-row query blocks, each block ``_sdpa`` over all
    Sk keys (Sk may differ from Sq), masked at its offset when ``causal``
    or windowed (unmasked otherwise): bounds the (bq × Sk) score
    and weight tensors for long prefills.  Under autograd each block
    runs under ``torch.utils.checkpoint``, so its scores and weights are
    recomputed in the backward pass instead of kept (the reference's
    ``jax.checkpoint``: about 2 GB a layer on 4k × 1152 trains without
    it)."""
    Sq, Sk = q.shape[1], k.shape[1]
    grad = _needs_grad(q, k, v)
    kf, vf = k.float(), v.float()           # once, not once a block
    outs = []
    for q0 in range(0, Sq, q_block):
        qi = q[:, q0:q0 + q_block]
        mask = _causal_window_mask(qi.shape[1], Sk, q0, window, q.device,
                                   causal)[None, None]
        args = (qi, kf, vf, mask, softmax_scale, v.dtype)
        outs.append(checkpoint(_sdpa, *args, use_reentrant=False)
                    if grad else _sdpa(*args))
    return torch.cat(outs, dim=1)


def _long_attention(q, k, v, softmax_scale, window, kernel_impl,
                    causal=True):
    """Prefill attention where the reference takes ``_sdpa_chunked``:
    causal (windowed) self-attention, or ``causal=False`` (the encoder,
    and cross-attention of Sq queries over Sk encoder keys).  Without a gradient, ``flash_attention`` runs it:
    kernel_impl None launches the CUDA kernel for a CUDA tensor (the
    plain chunked path for a CPU one), "cuda" launches it or raises,
    "torch" takes the plain chunked path.  The kernel defines no
    backward (as the reference's defines no VJP), so under autograd the
    plain chunked path runs, and "cuda" raises."""
    grad = _needs_grad(q, k, v)
    if grad and kernel_impl == "cuda":
        raise ValueError("flash_attention defines no backward: training "
                         "takes the plain chunked path (kernel_impl None "
                         "or 'torch')")
    if not grad and resolve_impl(kernel_impl, q, "attention") == "cuda":
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=softmax_scale, impl="cuda")
    return _sdpa_chunked(q, k, v, softmax_scale, window, causal)


def _target_scale(cfg, proj: str, lora_scale: float) -> float:
    return lora_scale if proj in cfg.lora_targets else 0.0


def kv_split(cfg, tp) -> bool:
    """Whether k_proj / v_proj and the cache's kv heads split over the
    model group: when the kv heads divide over it.  Otherwise (an MQA
    model such as granite-34b, gemma3-1b's one kv head) every rank keeps
    them whole and reads the heads its q heads use, where the reference's
    rule table would split k_proj's columns (one kv head's dh) and let
    XLA gather them (ROADMAP C)."""
    return tp is not None and cfg.n_kv_heads % tp.size == 0


def seq_split(cfg, n: int, Sc: int) -> bool:
    """Whether a layer's whole kv cache of ``Sc`` slots splits on its
    sequence over ``n`` model ranks under the ``seq_shard_kv`` layout:
    the reference's rule (``launch/specs.cache_specs``), its kv heads do
    not divide over the ranks and its slots do."""
    return n > 1 and cfg.n_kv_heads % n != 0 and Sc % n == 0


def _decode_split(cfg, n: int, Sc: int, window, kv_len: int) -> bool:
    """Whether a decode cache of ``Sc`` slots on a rank is its share of a
    sequence-split one (else it is whole), under the ``seq_shard_kv``
    layout of a cache of ``kv_len`` positions: a global layer's whole
    cache holds kv_len slots, a local layer's ``window`` (a prefill's
    ring) or min(kv_len, window) (``init_cache``'s)."""
    if n == 1 or cfg.n_kv_heads % n == 0:
        return False
    if kv_len <= 0:
        raise ValueError("a decode step on the seq_shard_kv layout needs the "
                         "whole cache's length: grid.replace(kv_len=...)")
    wholes = {kv_len} if window is None else {window, min(kv_len, window)}
    split = any(w % n == 0 and w // n == Sc for w in wholes)
    whole = any(w % n and w == Sc for w in wholes)
    if split == whole:
        raise ValueError(
            f"a kv cache of {Sc} slots is not one of a {kv_len}-position "
            f"cache's layouts on {n} model ranks (whole slots {sorted(wholes)})")
    return split


def _seq_split_decode(q, k, v, ck, cv, cache_index, window, scale, tp):
    """The decode step's attention over a cache split on its sequence
    over the model row (``seq_shard_kv``): rank m holds slots [m·Sl,
    (m + 1)·Sl) of every kv head of the whole cache's n·Sl (a ring of
    ``window`` when n·Sl is the window).  The owner of the written slot
    writes the new k / v (per row with (B,) positions).  q's heads are
    gathered over the row, each rank scores all of them against its
    slots, masked by the whole cache's slot validity, and the softmax is
    combined as XLA partitions the reference's: the row maxima's max,
    the f32 sums all-reduced, the weights normalised and cast to v's
    dtype where ``_sdpa`` casts them, the partial P·V, one all-reduce of
    the f32 outputs.  Returns the rank's q heads' output (B, 1, H/n,
    dh)."""
    B, _, Hl, dh = q.shape
    n, m = tp.size, tp.rank
    Sl = ck.shape[1]
    Sc, lo = n * Sl, m * Sl
    ring = window is not None and Sc == window
    ar = lo + torch.arange(Sl, device=q.device)            # whole-cache slots
    if torch.is_tensor(cache_index) and cache_index.dim() == 1:
        pos = cache_index.to(torch.int64)
        rows = torch.arange(B, device=q.device)
        slot = pos % window if ring else pos.clamp(max=Sc - 1)
        mine = (slot >= lo) & (slot < lo + Sl)
        if not ring:
            mine = mine & (pos < Sc)
        loc = (slot - lo).clamp(0, Sl - 1)
        mine = mine[:, None, None]
        ck[rows, loc] = torch.where(mine, k[:, 0], ck[rows, loc])
        cv[rows, loc] = torch.where(mine, v[:, 0], cv[rows, loc])
        mask = (ar[None, :] < (pos + 1).clamp(max=Sc)[:, None])[:, None,
                                                                 None, None]
    else:
        idx = int(cache_index)
        start = min(max(idx % window if ring else idx, 0), Sc - 1)
        if lo <= start < lo + Sl:
            ck[:, start - lo] = k[:, 0]
            cv[:, start - lo] = v[:, 0]
        mask = (ar < min(idx + 1, Sc))[None, None, None, None]
    qa = gather_from(q, tp, 2)                              # (B, 1, H, dh)
    H, K = qa.shape[2], ck.shape[2]
    qg = qa.reshape(B, 1, K, H // K, dh)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), ck.float()) * scale
    s = torch.where(mask, s, -1e30)
    mx = tp.reduce_max(s.amax(dim=-1, keepdim=True))
    e = torch.exp(s - mx)
    tot = tp.all_reduce([e.sum(dim=-1, keepdim=True)])[0]
    w = (e / tot).to(cv.dtype).float()
    o = tp.all_reduce([torch.einsum("bkrqs,bskd->bqkrd", w, cv.float())])[0]
    return o.reshape(B, 1, H, dh)[:, :, m * Hl:(m + 1) * Hl].to(q.dtype)


def _kv_for_heads(k, v, h0: int, H: int, rep: int):
    """The kv heads that q heads h0 … h0 + H − 1 of the whole model read
    (head h reads kv head h // rep), from whole (B, S, K, dh) k / v, as
    (k, v) whose grouped layout (q head i reads kv head i // (H / K'))
    matches: one kv head where the q heads sit in one group (an MQA
    model's), else one kv head a q head.  (Where the q heads cover whole
    groups the kv heads divide over the ranks, and ``kv_split`` splits
    them instead.)"""
    if h0 // rep == (h0 + H - 1) // rep:
        j = slice(h0 // rep, h0 // rep + 1)
        return k[:, :, j], v[:, :, j]
    idx = torch.arange(h0, h0 + H, device=k.device) // rep
    return k.index_select(2, idx), v.index_select(2, idx)


def attention(p: Params, x, positions, cfg, *, kind: str = "global",
              causal: bool = True, cache=None, cache_index=None,
              kv_source=None, lora_scale: float = 0.0, dropout_gen=None,
              return_cache: bool = False, cache_len: int = 0,
              adapter_idx=None, kernel_impl=None, tp=None, seq_kv=None):
    """Attention sublayer (pre-norm outside).  Returns (y, new_cache).
    ``kind="local"`` attends the last ``cfg.sliding_window`` positions
    only; ``q_norm`` / ``k_norm`` in ``p`` normalize q and k over the
    head dim before RoPE (qk-norm).  ``causal=False``: every query sees
    every key (the encoder).

    positions: (B, S) ints, or (B, S, 3) (t, h, w) ids for M-RoPE
    (``cfg.mrope``; a (B, S) tensor is repeated to three components).

    kv_source: (B, Sk, D) encoder output for cross-attention: k and v
    are its projections, q is not rotated and k has no rotary, nothing
    is masked, and no cache is read or written (a decode step
    recomputes k and v from it, as the reference does).

    dropout_gen: torch.Generator for adapter dropout (training) on the
    q/k/v adapters, at cfg.lora_dropout; each projection takes its own
    draw from it.

    cache: dict(k=(B,Sc,K,dh), v=...) — decode buffer; a local layer's
    buffer of ``Sc == window`` slots is a ring (position p at slot
    p % window).  The port writes the new token's k/v into it IN PLACE
    (the reference returns a functional copy); the returned cache is the
    same dict.
    cache_index: int / 0-d tensor shared write position, or (B,) int
    tensor of per-row positions (mixed-tenant serving).  Per-row writes
    past a linear buffer are dropped, as the reference's scatter drops
    them.
    Without a cache, S >= 2048 and S % 512 == 0 (the reference's
    condition for its chunked path), the prefill runs in 512-row query
    blocks: through ``flash_attention`` without a gradient, else the
    plain chunked path (``_long_attention``).
    return_cache: the prefill's cache; a local layer's holds its last
    ``window`` keys and values in ring layout, or is zero-padded up to
    ``window`` (``cache_len`` is for the global layers).
    adapter_idx: (B,) int32 pool slot per row for batched-LoRA serving.

    tp: the model group.  The rank computes its q heads (a contiguous
    block: q_proj's column shard) and, where ``kv_split``, its kv heads
    (their groups' block), or else all kv heads, of which it reads those
    its q heads use; the cache holds the kv heads the rank computes;
    o_proj is row-parallel.  Cross-attention likewise: ``kv_source`` is
    whole on every rank of the group and enters through ``copy_to``, so
    that the partial gradients the ranks' heads send back to it are
    summed.

    seq_kv: None, or the ``seq_shard_kv`` layout on: the whole decode
    cache's positions (the grid's ``kv_len``; 0 when not known, enough
    for a prefill).  Where ``seq_split`` splits a layer's cache (kv heads
    whole on every rank, its slots dividing over the model group), a
    prefill's cache is cut to the rank's slots and a decode step runs
    ``_seq_split_decode`` over them.
    """
    B, S, D = x.shape
    dh = cfg.head_dim
    window = cfg.sliding_window if kind == "local" else None
    scale = 1.0 / math.sqrt(dh)
    kw = dict(fused=cfg.use_fused_dora, adapter_idx=adapter_idx,
              kernel_impl=kernel_impl)
    drop = dict(dropout_gen=dropout_gen, dropout=cfg.lora_dropout)
    if tp is not None:
        x = copy_to(x, tp)
        if kv_source is not None:
            kv_source = copy_to(kv_source, tp)
    kv_in = x if kv_source is None else kv_source
    col = dict(tp=tp, split="col") if tp is not None else {}
    kv_col = col if kv_split(cfg, tp) else {}
    q = linear(p["q_proj"], x, lora_scale=_target_scale(cfg, "q_proj",
                                                        lora_scale),
               **drop, **kw, **col)
    k = linear(p["k_proj"], kv_in, lora_scale=_target_scale(cfg, "k_proj",
                                                            lora_scale),
               **drop, **kw, **kv_col)
    v = linear(p["v_proj"], kv_in, lora_scale=_target_scale(cfg, "v_proj",
                                                            lora_scale),
               **drop, **kw, **kv_col)
    Skv = kv_in.shape[1]
    H, Kh = q.shape[-1] // dh, k.shape[-1] // dh
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, Skv, Kh, dh)
    v = v.reshape(B, Skv, Kh, dh)

    def heads(kk, vv):
        """The kv heads this rank's q heads read."""
        if tp is None or kv_col:
            return kk, vv
        return _kv_for_heads(kk, vv, tp.rank * H, H,
                             cfg.n_heads // cfg.n_kv_heads)
    if "q_norm" in p:                      # qwen3 qk-norm, over the head dim
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if kv_source is None:
        q, k = _rotate(q, k, positions, cfg)
    else:                    # cross-attention: no rotary, mask or cache
        causal, cache, return_cache = False, None, False

    new_cache = None
    if cache is not None and seq_kv is not None and tp is not None \
            and _decode_split(cfg, tp.size, cache["k"].shape[1], window,
                              seq_kv):
        if S != 1:
            raise ValueError(f"a sequence-split cache takes one token a "
                             f"step, not {S}")
        new_cache = cache
        out = _seq_split_decode(q, k, v, cache["k"], cache["v"], cache_index,
                                window, scale, tp)
    elif cache is not None:
        ck, cv = cache["k"], cache["v"]
        Sc = ck.shape[1]
        ring = window is not None and Sc == window
        ar = torch.arange(Sc, device=x.device)
        if torch.is_tensor(cache_index) and cache_index.dim() == 1:
            # per-row write positions (continuous batching): one slot per
            # row; on a linear buffer rows past its end keep what they hold
            pos = cache_index.to(torch.int64)
            rows = torch.arange(B, device=x.device)
            if ring:
                slot = pos % window
                ck[rows, slot] = k[:, 0]
                cv[rows, slot] = v[:, 0]
            else:
                slot = pos.clamp(max=Sc - 1)
                inside = (pos < Sc)[:, None, None]
                ck[rows, slot] = torch.where(inside, k[:, 0], ck[rows, slot])
                cv[rows, slot] = torch.where(inside, v[:, 0], cv[rows, slot])
            valid = ar[None, :] < (pos + 1).clamp(max=Sc)[:, None]
            mask = valid[:, None, None, :]                 # (B,1,1,Sc)
        else:
            idx = int(cache_index)
            slot = idx % window if ring else idx
            start = min(max(slot, 0), Sc - S)              # as dynamic_update_slice clamps
            ck[:, start:start + S] = k
            cv[:, start:start + S] = v
            valid = ar < min(idx + 1, Sc)
            mask = valid[None, None, None, :]              # (1,1,1,Sc)
        new_cache = cache
        out = _sdpa(q, *heads(ck, cv), mask, scale)
    else:
        ka, va = heads(k, v)
        if S >= 2048 and S % 512 == 0:
            out = _long_attention(q, ka, va, scale, window, kernel_impl,
                                  causal)
        elif causal or window is not None:
            mask = _causal_window_mask(S, S, 0, window, x.device, causal)
            out = _sdpa(q, ka, va, mask[None, None], scale)
        else:
            out = _sdpa(q, ka, va, None, scale)
        if return_cache:
            if window is not None and S > window:
                # the last `window` keys and values, rolled so position p
                # sits at slot p % window (the ring the decode path reads)
                new_cache = {"k": torch.roll(k[:, -window:], S % window, 1),
                             "v": torch.roll(v[:, -window:], S % window, 1)}
            else:
                pad = (window if window is not None
                       else max(cache_len, S)) - S
                new_cache = {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                             "v": F.pad(v, (0, 0, 0, 0, 0, pad))}
            Sw = new_cache["k"].shape[1]
            if seq_kv is not None and tp is not None \
                    and seq_split(cfg, tp.size, Sw):
                # the rank's slots of the whole (padded or rolled) cache
                Sl = Sw // tp.size
                new_cache = {n_: c.narrow(1, tp.rank * Sl, Sl).clone(
                    memory_format=torch.contiguous_format)
                    for n_, c in new_cache.items()}

    y = linear(p["o_proj"], out.reshape(B, S, H * dh),
               lora_scale=_target_scale(cfg, "o_proj", lora_scale), **kw,
               **({"tp": tp, "split": "row"} if tp is not None else {}))
    return y, new_cache


def init_attn_cache(cfg, batch, seq_len: int, kind: str, dtype, device,
                    n_model: int = 1, seq_shard: bool = False):
    """Zero k/v buffers of shape (*batch, Sc, K, dh); ``batch`` is an int
    or a tuple of leading dims (the stacked superblock axis first).  A
    local layer's buffer is a ring of Sc = min(seq_len, window) slots, a
    global layer's a linear buffer of seq_len.  ``n_model``: a rank's
    share of a model group of that many ranks, K / n_model kv heads where
    they divide (``kv_split``), else all of them; with ``seq_shard`` (the
    ``seq_shard_kv`` layout) the rank's Sc / n_model slots where
    ``seq_split`` splits the cache."""
    window = cfg.sliding_window if kind == "local" else None
    Sc = min(seq_len, window) if window is not None else seq_len
    if seq_shard and seq_split(cfg, n_model, Sc):
        Sc //= n_model
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    K = cfg.n_kv_heads
    shape = (*lead, Sc, K // n_model if K % n_model == 0 else K,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU)
# ---------------------------------------------------------------------------

def dense_ffn(p: Params, x, cfg, lora_scale: float = 0.0, adapter_idx=None,
              kernel_impl=None, tp=None):
    """SwiGLU FFN; with {adapter_down, adapter_up} in ``p``, a Houlsby
    adapter after down_proj: y + gelu(y @ down) @ up, gelu in its tanh
    form (``jax.nn.gelu``'s default) computed in f32.  The adapter's
    factors are cast to the activation dtype, as ``lora_delta`` casts
    its own, so a bf16 model stays bf16 (the reference's f32
    ``adapter_up`` promotes a bf16 block to f32: ROADMAP C, caveat 3).
    ``tp``: gate and up column-parallel, down row-parallel (the Houlsby
    adapter then runs whole on the all-reduced output)."""
    kw = dict(fused=cfg.use_fused_dora, adapter_idx=adapter_idx,
              kernel_impl=kernel_impl)
    col, row = {}, {}
    if tp is not None:
        x = copy_to(x, tp)
        col, row = dict(tp=tp, split="col"), dict(tp=tp, split="row")
    g = linear(p["gate_proj"], x,
               lora_scale=_target_scale(cfg, "gate_proj", lora_scale), **kw,
               **col)
    u = linear(p["up_proj"], x,
               lora_scale=_target_scale(cfg, "up_proj", lora_scale), **kw,
               **col)
    h = F.silu(g.float()).to(x.dtype) * u
    y = linear(p["down_proj"], h,
               lora_scale=_target_scale(cfg, "down_proj", lora_scale), **kw,
               **row)
    if "adapter_down" in p:                              # Houlsby adapter
        down, up = p["adapter_down"], p["adapter_up"]
        if tp is not None:          # whole on every rank: a 1/n share each
            down, up = (scale_grad(down, 1.0 / tp.size),
                        scale_grad(up, 1.0 / tp.size))
        a = F.gelu((y @ down.to(y.dtype)).float(),
                   approximate="tanh").to(y.dtype)
        y = y + a @ up.to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# MoE FFN: sort + capacity grouped matmul
# ---------------------------------------------------------------------------

def moe_capacity(cfg, T: int) -> int:
    """Rows a slot takes from T tokens: ceil(top_k · T · capacity_factor
    / n_experts), at least 1 and at most T (logical experts, whatever
    the slot layout)."""
    C = max(1, int(math.ceil(cfg.top_k * T * cfg.capacity_factor
                             / cfg.n_experts)))
    return min(C, T)


def moe_router(p: Params, xt, cfg):
    """(top_i (T, k) int64, top_w (T, k) in xt's dtype, aux 0-d f32).

    Router logits are ``xt @ router`` in xt's dtype, read in f32.  The
    top-k is a stable descending sort, so equal logits go to the lower
    expert index first, as ``lax.top_k`` orders them (bf16 logits over
    128 experts tie often; ``torch.topk`` promises no order).  The
    weights are a softmax over the top-k.  aux is the Switch load-balance
    loss E · Σ_e f_e · p_e, with f_e the share of the (logical) top-k
    picks that went to e and p_e the mean router probability."""
    logits = wide(xt @ p["router"]["kernel"].to(xt.dtype))
    top_i = torch.sort(logits, dim=-1, descending=True,
                       stable=True).indices[:, :cfg.top_k]
    top_w = torch.softmax(torch.gather(logits, -1, top_i), dim=-1).to(
        xt.dtype)
    probs = torch.softmax(logits, dim=-1)
    # counts by index_add_ (integers, exact in f32 in any order), not
    # bincount, which reads its input's max back to the host
    counts = torch.zeros(cfg.n_experts, dtype=torch.float32,
                         device=xt.device).index_add_(
        0, top_i.reshape(-1), torch.ones(top_i.numel(), device=xt.device))
    f = counts / torch.clamp(counts.sum(), min=1.0)
    aux = cfg.n_experts * torch.sum(f * probs.mean(0))
    return top_i, top_w, aux


def _group_by_expert(xt, top_i, top_w, E_slots: int, C: int, fsplit: int):
    """Token grouping → (xg (E_slots·C, D), combine info).

    Tokens routed to logical expert e are duplicated onto the fsplit
    slots [e·fsplit, (e+1)·fsplit), each a 1/fsplit slice of d_ff; the
    weight is repeated, not divided (the slices' down-projections are
    partial sums).  The (token, pick) pairs are sorted by slot, stably
    (token order within a slot); a pair's place in its slot is its rank
    there, and pairs past C rows go to a dump row that is dropped."""
    T, k = top_i.shape
    dev = xt.device
    if fsplit > 1:
        top_i = (top_i[..., None] * fsplit
                 + torch.arange(fsplit, device=dev)).reshape(T, k * fsplit)
        top_w = torch.repeat_interleave(top_w, fsplit, dim=-1)
        k = k * fsplit
    flat_e = top_i.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(T * k, device=dev) - first
    keep = pos < C
    dest = torch.where(keep, se * C + pos, E_slots * C)      # dump row
    xg = xt.new_zeros((E_slots * C + 1, xt.shape[-1]))
    xg = xg.index_copy(0, dest, xt[st])      # kept rows are distinct
    return xg[:-1], (order, sw, dest, keep)


def _combine_from_expert(yg, combine, T: int):
    """y (T, D) = Σ over each token's k·fsplit picks of weight · its
    slot row (0 for a dropped pick).  The sort is undone first, so each
    token's picks are summed in one fixed order (its top-k order), not
    by a scatter-add whose order a CUDA atomic leaves open."""
    order, sw, dest, keep = combine
    D = yg.shape[-1]
    yg1 = torch.cat([yg, yg.new_zeros((1, D))], dim=0)
    vals = yg1[dest] * (sw * keep).to(yg.dtype)[:, None]
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return vals[inv].reshape(T, -1, D).sum(dim=1)


def _expert_mlp(xg, wg, wu, wd):
    """SwiGLU per slot: xg (E, C, D); weights (E, D, F) / (E, F, D)."""
    g = torch.bmm(xg, wg.to(xg.dtype))
    u = torch.bmm(xg, wu.to(xg.dtype))
    h = F.silu(g.float()).to(xg.dtype) * u
    return torch.bmm(h, wd.to(xg.dtype))


def moe_ffn_local(p: Params, x, cfg):
    """Sort + capacity grouped-matmul MoE over x (B, S, D) → (y, aux).

    Expert weights are stored in slot layout (E·fsplit, D, F/fsplit)
    (``cfg.ep_fsplit``; plain for 1).  Every slot computes its C rows
    (C from this call's T tokens, ``moe_capacity``), so a token's output
    depends on the batch whenever capacity drops picks.  On a client
    mesh the production engine runs it on each rank's own micro-batch,
    every slot resident on every rank: what ``moe_ffn_manual``'s
    per-shard grouping and all-to-all compute (a grid runs that)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    fsplit = cfg.ep_fsplit
    E_slots = cfg.n_experts * fsplit
    C = moe_capacity(cfg, T)
    top_i, top_w, aux = moe_router(p, xt, cfg)
    xg, combine = _group_by_expert(xt, top_i, top_w, E_slots, C, fsplit)
    e = p["experts"]
    yg = _expert_mlp(xg.reshape(E_slots, C, D), e["gate"], e["up"],
                     e["down"]).reshape(E_slots * C, D)
    y = _combine_from_expert(yg, combine, T)
    return y.reshape(B, S, D), aux


def _moe_sharded(p: Params, x, cfg, data, tp, *, replicated: bool):
    """The body of ``moe_ffn_ep`` / ``moe_ffn_manual`` on this rank: its
    tokens x (B_l, S, D) and its resident slots (E_loc = E_slots / dp of
    them, each with its tp slice of d_ff: ``p["experts"]`` is the rank's
    shard).  Returns (y, this rank's aux)."""
    B_l, S, D = x.shape
    T = B_l * S
    fsplit = cfg.ep_fsplit
    E_slots = cfg.n_experts * fsplit
    dp = data.size
    if E_slots % dp:
        raise ValueError(f"{E_slots} expert slots do not split over {dp} "
                         f"data ranks")
    E_loc = E_slots // dp
    e = p["experts"]
    if e["gate"].shape[0] != E_loc:
        raise ValueError(f"the rank holds {e['gate'].shape[0]} expert slots, "
                         f"not its {E_loc} of {E_slots} (shard the base by "
                         f"launch/specs.param_specs)")
    xt = copy_to(x.reshape(T, D), tp)
    C = moe_capacity(cfg, T)
    top_i, top_w, aux = moe_router(p, xt, cfg)
    if tp is not None:
        # every model rank computes the same aux from the same router
        # input, whose gradient copy_to sums over the group
        aux = scale_grad(aux, 1.0 / tp.size)
    xg, combine = _group_by_expert(xt, top_i, top_w, E_slots, C, fsplit)
    if replicated:
        # the small-batch path: every data rank holds the same tokens and
        # computes its resident slots; the sum over data and model below
        # assembles every slot's (partial) rows
        lo = data.rank * E_loc
        y_loc = _expert_mlp(xg.reshape(E_slots, C, D)[lo:lo + E_loc],
                            e["gate"], e["up"], e["down"])
        yg = torch.cat([y_loc.new_zeros((lo, C, D)), y_loc,
                        y_loc.new_zeros((E_slots - lo - E_loc, C, D))])
        y = _combine_from_expert(yg.reshape(E_slots * C, D), combine, T)
        y = reduce_from(reduce_from(y, data), tp)
        return y.reshape(B_l, S, D), aux
    # dispatch: chunk j (slots of data rank j) to rank j; receive each
    # rank's rows for this rank's slots, source-major
    xr = all_to_all(xg.reshape(dp, E_loc, C, D), data)
    xr = xr.transpose(0, 1).reshape(E_loc, dp * C, D)
    yr = _expert_mlp(xr, e["gate"], e["up"], e["down"])    # partial over F
    yr = yr.reshape(E_loc, dp, C, D).transpose(0, 1).contiguous()
    yg = all_to_all(yr, data)                              # back to the owners
    y = _combine_from_expert(yg.reshape(E_slots * C, D), combine, T)
    y = reduce_from(y, tp)               # the d_ff partials, after the combine
    return y.reshape(B_l, S, D), aux


def moe_ffn_manual(p: Params, x, cfg, mesh):
    """The MoE body of the production engine on a grid (``mesh``: a
    ``launch/mesh.Grid``): x is this rank's client's tokens, the slots
    are split over the data group (``launch/train.base_manual_specs``)
    and exchanged by all-to-all, their d_ff over the model group.  The
    capacity comes from the rank's own T.  Returns (y, the rank's aux):
    the engine means the metrics over the clients."""
    return _moe_sharded(p, x, cfg, mesh.data, model_group(mesh),
                        replicated=False)


def moe_ffn_ep(p: Params, x, cfg, mesh):
    """Expert-parallel MoE on a grid (the reference's ``moe_ffn_ep``):
    expert slots split over the data group and d_ff over the model group
    (``("data", None, "model")``).  When the batch's rows are split over
    the data ranks (``mesh.rows_split``): per rank, route its tokens,
    group them by slot at the capacity of its own T, all-to-all to the
    slots' owners, the grouped SwiGLU on the resident slots, all-to-all
    back, the weighted combine, then the all-reduce of the d_ff partials
    over the model group.  Otherwise (a batch that does not divide over
    the data ranks, as a one-row decode step) every data rank holds the
    same tokens, computes its resident slots for them, and the outputs
    are summed over data and model.

    The aux is the mean over the data ranks (the reference's pmean over
    the batch axes), and carries its gradient.  With the rows split, the
    backward is the mean too: each rank's gradient holds its own aux at
    full weight, as its CE holds its own rows, so the mean of the ranks'
    gradients is the whole batch's.  On the small-batch path every data
    rank computes the same aux from the same tokens, and its gradient is
    taken at 1/dp a rank, a partial sum over the data ranks like the
    outputs'."""
    data = mesh.data
    y, aux = _moe_sharded(p, x, cfg, data, model_group(mesh),
                          replicated=not mesh.rows_split)
    if mesh.rows_split:
        aux = mean_over(aux, data)
    else:
        aux = scale_grad(aux, 1.0 / data.size)
    return y, aux


def moe_ffn_dense_ref(p: Params, x, cfg):
    """Oracle: every expert on every token, weighted by the router's
    top-k (no capacity).  O(E·T·D·F); ep_fsplit 1 only; for tests."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    top_i, top_w, aux = moe_router(p, xt, cfg)
    e = p["experts"]
    g = torch.einsum("td,edf->tef", xt, e["gate"].to(xt.dtype))
    u = torch.einsum("td,edf->tef", xt, e["up"].to(xt.dtype))
    h = F.silu(g.float()).to(xt.dtype) * u
    y_all = torch.einsum("tef,efd->ted", h, e["down"].to(xt.dtype))
    gates = torch.zeros((xt.shape[0], cfg.n_experts), dtype=xt.dtype,
                        device=xt.device).scatter_add(1, top_i, top_w)
    y = torch.einsum("ted,te->td", y_all, gates.to(y_all.dtype))
    return y.reshape(B, S, D), aux
