"""Mamba-2 (SSD, state-space duality) mixer: port of
``repro/models/ssm.py``.

Separate projections instead of mamba_ssm's fused in_proj, as the
reference's (the depthwise convs over concat(x, B, C) factor into one
conv a segment):

  z_proj (D, d_inner)   gate
  x_proj (D, d_inner)   the adapters' "in" projection
  B_proj (D, G*N)   C_proj (D, G*N)   dt_proj (D, H)
  conv_x (d_inner, k)  conv_B (G*N, k)  conv_C (G*N, k)   [depthwise causal]
  A_log (H,)  D_skip (H,)  dt_bias (H,)  norm_w (d_inner,)
  out_proj (d_inner, D)

with d_inner = expand*D, H = d_inner/headdim heads, G groups, N state dim.

A prefill runs the chunked scan (``_ssd`` below): without a gradient on
a CUDA tensor through the ``ssd_scan`` kernel, else through the plain
``_ssd_chunked``; a decode step runs the one-token recurrence on the
cache, written in place (the port's convention for every decode cache).

``_ssd_chunked``'s cast points are the reference's: B, C, x·dt, the Q×Q
decay and the per-step segment decay in x's dtype (``cdt``); the
log-decay, its cumulative sum and every product's accumulation in f32
(the cumulative sum is accumulated in f64 and rounded once to f32).  The
reference carries the state across chunks with a log-depth
``associative_scan``; here a loop over chunks computes the same
recurrence S_c = exp(l_Q)·S_{c−1} + states_c, with its sums in another
order.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels._wrap import resolve_impl
# the module, not its names: models/layers.py imports the kernels
# package, whose ssd_scan/ref.py imports this module
from repro_torch.models import layers as L
from repro_torch.utils.collectives import copy_to, sum_over

Params = Any


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, C); w: (C, k); state: (B, k−1, C)
    trailing context (decode) or None (zero padding).  The k shifted
    products are summed in f32 (f64 stays f64: ``layers.wide``; no (B,
    S, k, C) gather) and the result is cast to x's dtype.  Returns (y,
    new_state), new_state the padded input's trailing k − 1 rows (a
    copy, not a view of it)."""
    B, S, C = x.shape
    k = w.shape[-1]
    pad = (x.new_zeros((B, k - 1, C)) if state is None
           else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)                      # (B, S+k-1, C)
    wf = L.wide(w)
    y = torch.zeros((B, S, C), dtype=L.wide(x).dtype, device=x.device)
    for j in range(k):
        y = y + L.wide(xp[:, j:j + S]) * wf[:, j]
    return y.to(x.dtype), xp[:, S:].clone()


def _ssd_chunked(x, dt, A_log, B, C, chunk: int):
    """SSD forward.  x: (b, S, H, P); dt: (b, S, H); A_log: (H,);
    B, C: (b, S, G, N).  Returns y: (b, S, H, P) in f32 (the
    reference's einsums accumulate in f32 and it does not cast back) and
    the final state (b, H, P, N) in f32."""
    f32 = torch.float32
    b, S, H, Pd = x.shape
    cdt = x.dtype
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2).to(cdt)           # (b,S,H,N)
    Ch = C.repeat_interleave(rep, dim=2).to(cdt)
    dtf = dt.to(f32)
    a = -torch.exp(A_log.to(f32)) * dtf                     # (b,S,H) log-decay
    xdt = (x.to(f32) * dtf[..., None]).to(cdt)              # (b,S,H,P)

    nc = S // chunk
    ac = a.reshape(b, nc, chunk, H)
    xc = xdt.reshape(b, nc, chunk, H, Pd)
    Bc = Bh.reshape(b, nc, chunk, H, N)
    Cc = Ch.reshape(b, nc, chunk, H, N)

    # intra-chunk: L[i,j] = exp(l_i - l_j) for i >= j else 0; the f32
    # log-decay summed in f64 and rounded once, so that the CPU (which
    # accumulates f32 cumsums in f64 anyway) and the card agree
    ld = torch.cumsum(ac, dim=2, dtype=torch.float64).to(f32)   # (b,nc,Q,H)
    li = ld[:, :, :, None, :]
    lj = ld[:, :, None, :, :]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    decay = torch.where(tri, torch.exp(torch.where(tri, li - lj, 0.0)),
                        0.0).to(cdt)
    cb = torch.einsum("bnihd,bnjhd->bnijh", Cc.to(f32),
                      Bc.to(f32)).to(cdt)                   # (b,nc,Q,Q,H)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", (cb * decay).to(f32),
                           xc.to(f32))

    # per-chunk end state: sum_j exp(l_last - l_j) B_j x_j^T
    seg = torch.exp(ld[:, :, -1:, :] - ld).to(cdt)          # (b,nc,Q,H)
    states = torch.einsum("bnjh,bnjhd,bnjhp->bnhdp", seg.to(f32),
                          Bc.to(f32), xc.to(f32))           # (b,nc,H,N,P)
    chunk_decay = torch.exp(ld[:, :, -1, :])                # (b,nc,H)

    # inter-chunk recurrence, one chunk at a time; s_in[c] is the state
    # entering chunk c
    s = torch.zeros_like(states[:, 0])
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    s_in = torch.stack(s_in, dim=1)                         # (b,nc,H,N,P)
    y_inter = torch.einsum("bnihd,bnih,bnhdp->bnihp", Cc.to(f32),
                           torch.exp(ld), s_in)
    y = (y_intra + y_inter).reshape(b, S, H, Pd)
    return y, s.transpose(2, 3)                             # (b,H,P,N)


def _ssd(x, dt, A_log, B, C, chunk: int, kernel_impl=None):
    """A prefill's scan at the reference's chunk Q = min(chunk, S), over S
    zero-padded to a multiple of Q (a padded row, x = 0 and dt = 0, adds
    nothing to the state and does not decay it, so the final state is
    the unpadded run's).  Returns (y (b, S, H, P), final state (b, H, P,
    N) f32).

    Without a gradient, ``ssd_scan``'s CUDA kernel runs it: kernel_impl
    None launches it for a CUDA tensor, "cuda" launches it or raises.
    Its y comes back rounded to x's dtype, where ``_ssd_chunked``'s is
    f32: the mixer then adds D_skip·x in f32 to either, so in bf16 the
    kernel path rounds y once more than the plain path (one bf16 ulp of
    |y|, on top of the kernel's own ``bf16_bound``).  The kernel defines
    no backward (as the reference's defines no VJP), so under autograd
    the plain ``_ssd_chunked`` runs and "cuda" raises; on a CPU tensor,
    or with kernel_impl "torch", it runs too."""
    grad = L._needs_grad(x, dt, A_log, B, C)
    if grad and kernel_impl == "cuda":
        raise ValueError("ssd_scan defines no backward: training takes the "
                         "plain _ssd_chunked (kernel_impl None or 'torch')")
    S = x.shape[1]
    Q = min(chunk, S)
    pad = -S % Q
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, B, C))
    if not grad and resolve_impl(kernel_impl, x, "ssd_scan") == "cuda":
        # imported here: ssd_scan/ref.py imports this module
        from repro_torch.kernels.ssd_scan import ops
        y, st = ops.ssd_scan(x, dt, A_log, B, C, chunk=Q, impl="cuda")
    else:
        y, st = _ssd_chunked(x, dt, A_log, B, C, Q)
    return y[:, :S], st


def _recurrent_step(cache, xh, dt, A_log, Bh, Ch):
    """One token of the recurrence in f32: state ← exp(−exp(A_log)·dt)·
    state + (x·dt) Bᵀ, y = state·C.  xh (B, 1, H, P), dt (B, 1, H) f32,
    Bh / Ch (B, 1, G, N).  Writes the state back into ``cache["state"]``
    in place, in the cache's dtype (as the reference stores it).
    Returns y (B, 1, H, P) f32."""
    f32 = torch.float32
    H, G = xh.shape[2], Bh.shape[2]
    rep = H // G
    st = cache["state"].to(f32)                                   # (B,H,P,N)
    af = torch.exp(-torch.exp(A_log.to(f32)) * dt[:, 0])          # (B,H)
    Bt = Bh[:, 0].repeat_interleave(rep, dim=1).to(f32)           # (B,H,N)
    Ct = Ch[:, 0].repeat_interleave(rep, dim=1).to(f32)
    xt = xh[:, 0].to(f32) * dt[:, 0][..., None]                   # (B,H,P)
    st = af[..., None, None] * st + torch.einsum("bhp,bhn->bhpn", xt, Bt)
    cache["state"].copy_(st)
    return torch.einsum("bhpn,bhn->bhp", st, Ct)[:, None]


def _refuse_pooled(p: Params) -> None:
    """The reference's mixer passes no ``adapter_idx`` to its projections,
    and its ``linear`` adds nothing for pooled leaves without ``A_dir``
    or ``lora_A``: a pooled tree there serves the bare projection to
    every tenant.  The port refuses it (ROADMAP C)."""
    for name in ("x_proj", "out_proj"):
        if L._has_pooled(p[name]):
            raise ValueError(
                f"mamba2_mixer: {name} carries pooled adapter leaves, but "
                f"the SSM mixer takes no per-row adapters (the reference "
                f"would serve every tenant the bare projection); serve "
                f"merged per-tenant models instead (merge_adapters + "
                f"greedy_generate)")


def _gated_norm(y, w, eps: float, tp=None):
    """mamba2's RMSNorm of the gated y (B, S, d) over the whole inner
    dimension, in f32 (f64 stays f64: ``layers.wide``).  ``tp``: y and w
    are this rank's slice of d_inner; each rank's sum of squares is
    summed over the model group (``sum_over``: its backward sums the
    ranks' partial gradients of it too) and divided by the whole d_inner
    before the rank scales its own slice."""
    yf = L.wide(y)
    if tp is None:
        ms = yf.square().mean(dim=-1, keepdim=True)
    else:
        ms = sum_over(yf.square().sum(dim=-1, keepdim=True), tp) / (
            y.shape[-1] * tp.size)
    return (yf * torch.rsqrt(ms + eps) * w.to(yf.dtype)).to(y.dtype)


def mamba2_mixer(p: Params, x, cfg, *, cache: Optional[dict] = None,
                 lora_scale: float = 0.0, dropout_gen=None,
                 return_cache: bool = False, kernel_impl=None, tp=None):
    """The Mamba-2 block body (the pre-norm is the caller's).  Returns
    (y (B, S, D), cache).

    Adapters attach to x_proj (the "in" projection, with adapter dropout
    from ``dropout_gen`` at cfg.lora_dropout) and out_proj when
    cfg.lora_targets name them.  Without a cache the sequence runs
    through ``_ssd`` (``kernel_impl`` as there); ``return_cache`` returns
    the final state in x's dtype and the three convs' trailing k − 1
    rows.  With a cache (one token: decode) the state and the conv states
    are written into it in place and the same dict is returned.

    ``tp``: the model group.  ``p`` is the rank's shard
    (``launch/specs.param_specs``): its H / n contiguous heads of z_proj,
    x_proj and dt_proj's columns, conv_x's channels, A_log, D_skip,
    dt_bias and norm_w, and out_proj's rows; B_proj / C_proj / conv_B /
    conv_C are the rank's groups, or whole (one group, or groups that do
    not divide), of which it reads those its heads use.  The head count
    comes from the leaves.  The scan and the recurrence run over the
    rank's heads, the cache holds them, the gated norm's mean of squares
    is over the whole d_inner (``_gated_norm``), and out_proj is
    row-parallel.  x enters through ``copy_to``: the gradients the ranks
    send back to it (through their columns, and through the B / C every
    rank computes whole but uses for its own heads) are partial sums."""
    _refuse_pooled(p)
    f32 = torch.float32
    B, S, D = x.shape
    H = p["A_log"].shape[-1]
    Pd, N = cfg.ssm_headdim, cfg.ssm_state
    tgt = cfg.lora_targets
    col = {}
    if tp is not None:
        x = copy_to(x, tp)
        col = dict(tp=tp, split="col")
    z = L.linear(p["z_proj"], x, **col)
    xi = L.linear(p["x_proj"], x,
                  lora_scale=(lora_scale if "x_proj" in tgt
                              or "in_proj" in tgt else 0.0),
                  dropout_gen=dropout_gen, dropout=cfg.lora_dropout, **col)
    Bv = L.linear(p["B_proj"], x)
    Cv = L.linear(p["C_proj"], x)
    dt = L.linear(p["dt_proj"], x, **col)

    names = ("conv_x", "conv_B", "conv_C")
    convs = [_causal_conv(t, p[n], None if cache is None else cache[n])
             for t, n in zip((xi, Bv, Cv), names)]
    xi, Bv, Cv = (F.silu(L.wide(y)).to(x.dtype) for y, _ in convs)
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))            # (B,S,H)
    G = Bv.shape[-1] // N
    xh = xi.reshape(B, S, H, Pd)
    Bh = Bv.reshape(B, S, G, N)
    Ch = Cv.reshape(B, S, G, N)
    if tp is not None and 1 < G == cfg.ssm_groups:
        # whole groups that do not divide: those the rank's heads read
        Bh, Ch = L._kv_for_heads(Bh, Ch, tp.rank * H, H, tp.size * H // G)

    if cache is None:
        y, st = _ssd(xh, dt, p["A_log"], Bh, Ch, cfg.ssm_chunk, kernel_impl)
        new_cache = None
        if return_cache:
            new_cache = {"state": st.to(x.dtype),
                         **{n: s for n, (_, s) in zip(names, convs)}}
    else:
        y = _recurrent_step(cache, xh, dt, p["A_log"], Bh, Ch)
        for n, (_, s) in zip(names, convs):
            cache[n].copy_(s)
        new_cache = cache

    y = y.to(f32) + p["D_skip"].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(B, S, H * Pd).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z)) * w
    y = y * F.silu(z.to(f32)).to(x.dtype)
    y = _gated_norm(y, p["norm_w"], cfg.norm_eps, tp)
    y = L.linear(p["out_proj"], y,
                 lora_scale=lora_scale if "out_proj" in tgt else 0.0,
                 **({"tp": tp, "split": "row"} if tp is not None else {}))
    return y, new_cache


def init_ssm_cache(cfg, batch, dtype, device, n_model: int = 1):
    """Zero state (*lead, H, P, N) and conv states (*lead, k−1, d_inner) /
    (*lead, k−1, G·N) in ``dtype``; ``batch`` is an int or a tuple of
    leading dims (the stacked superblock axis first), as
    ``layers.init_attn_cache`` takes it.  ``n_model``: a rank's share of
    a model group of that many ranks: H / n_model heads and their conv_x
    channels, and the groups' conv states split only where the groups
    divide (``launch/specs.param_specs``)."""
    H = cfg.d_model * cfg.ssm_expand // cfg.ssm_headdim // n_model
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    G = cfg.ssm_groups
    GN = (G // n_model if G % n_model == 0 else G) * cfg.ssm_state
    k = cfg.ssm_conv

    def z(*shape):
        return torch.zeros((*lead, *shape), dtype=dtype, device=device)
    return {"state": z(H, cfg.ssm_headdim, cfg.ssm_state),
            "conv_x": z(k - 1, H * cfg.ssm_headdim),
            "conv_B": z(k - 1, GN), "conv_C": z(k - 1, GN)}
