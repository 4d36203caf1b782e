"""Plain PyTorch versions of the Mamba-2 SSD chunked scan.

Port of ``repro/kernels/ssd_scan/ref.py``.  ``ssd_ref`` is the model's
chunked form (``repro_torch/models/ssm.py::_ssd_chunked``) and
``ssd_naive`` the O(S) per-step recurrence, so kernel, chunked form and
recurrence make a three-way check.  Both serve CPU tensors; the CUDA
scan is held against them.

``ssd_cast_points`` evaluates the bf16 kernel's decomposition
(``csrc/ssd_scan.cu``) at its cast points, and ``bf16_bound`` gives an
elementwise bound on how far a bf16 output computed with those cast
points, or the reference's, may lie from the f32 scan of the same bf16
values.
"""
from __future__ import annotations

import torch

# the module, not the name: models/ssm.py imports models/layers.py, which
# imports this package, so either may be imported first
from repro_torch.models import ssm as _ssm

BF16_UNIT = 2.0 ** -8    # bf16's unit roundoff: 8 significant bits
# an f32 add's relative error: 2^-24 rounding to nearest, 2^-23 for the
# tensor cores' sums, which may truncate
F32_SUM_UNIT = 2.0 ** -23


def ssd_ref(x, dt, A_log, B, C, chunk: int):
    """x (b,S,H,P); dt (b,S,H); B,C (b,S,G,N) → (y (b,S,H,P) f32,
    final state (b,H,P,N) f32)."""
    return _ssm._ssd_chunked(x, dt, A_log, B, C, chunk)


def ssd_naive(x, dt, A_log, B, C):
    """O(S) sequential recurrence in f32 — ground truth for short S.
    Returns y in x's dtype and the final state (b,H,P,N) in f32."""
    f32 = torch.float32
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2).to(f32)
    Ch = C.repeat_interleave(rep, dim=2).to(f32)
    dtf = dt.to(f32)
    a = torch.exp(-torch.exp(A_log.to(f32)) * dtf)          # (b,S,H)
    xdt = x.to(f32) * dtf[..., None]
    state = torch.zeros((b, H, N, P), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        state = a[:, t, :, None, None] * state + torch.einsum(
            "bhn,bhp->bhnp", Bh[:, t], xdt[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), state.transpose(2, 3)


def _log_decay(dt, A_log, chunk: int):
    """The inclusive log-decay l (b, nc, Q, H), summed in f64 and rounded
    once to f32 as ``_ssd_chunked`` and the kernel sum it."""
    f32 = torch.float32
    b, S, H = dt.shape
    a = -torch.exp(A_log.to(f32)) * dt.to(f32)
    return torch.cumsum(a.reshape(b, S // chunk, chunk, H), dim=2,
                        dtype=torch.float64).to(f32)


def _cast_points(x, dt, A_log, B, C, Q: int, f, omit=None):
    """The pieces of ``ssd_cast_points`` with every product and sum in the
    type f: each cast point's argument (``*_a``) beside its value rounded to
    x's type, the l they share (f32 as the kernel holds it), the chunk end
    states, the carried states and y before its rounding (shapes in the
    comments)."""
    T = x.dtype
    b, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep, nc = H // G, S // Q

    def rnd(t):
        return t.to(T).to(f)
    p = {"l": _log_decay(dt, A_log, Q).to(f)}                 # (b,nc,Q,H)
    ld = p["l"]
    p["xdt_a"] = (x.to(f) * dt.to(f)[..., None]).reshape(b, nc, Q, H, Pd)
    p["xdt"] = rnd(p["xdt_a"])
    Bc = B.to(f).reshape(b, nc, Q, G, N)
    Cc = C.to(f).reshape(b, nc, Q, G, N)
    p["cb_a"] = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc)    # (b,nc,G,Q,Q)
    cb = rnd(p["cb_a"]).repeat_interleave(rep, dim=2)         # (b,nc,H,Q,Q)
    lh = ld.transpose(2, 3)                                   # (b,nc,H,Q)
    p["tri"] = tri = torch.ones((Q, Q), dtype=torch.bool,
                                device=x.device).tril()
    diff = torch.where(tri, lh[..., :, None] - lh[..., None, :], 0.0)
    p["d_a"] = torch.where(tri, torch.exp(diff), 0.0)
    p["d"] = rnd(p["d_a"])
    p["m_a"] = cb * p["d"]
    p["m"] = m = rnd(p["m_a"])
    if omit == "column_tile":
        m[..., 32:64] = 0.0
    y = torch.einsum("bchij,bcjhp->bcihp", m, p["xdt"])

    p["seg"] = torch.exp(ld[:, :, -1:, :] - ld)               # (b,nc,Q,H)
    Bh = Bc.repeat_interleave(rep, dim=3)                     # (b,nc,Q,H,N)
    p["w_a"] = p["seg"][..., None] * Bh
    p["w"] = rnd(p["w_a"])
    states = torch.einsum("bcjhn,bcjhp->bchnp", p["w"], p["xdt"])
    if omit == "chunk_state":
        states[:, 1] = 0.0
    p["decay"] = torch.exp(ld[:, :, -1, :])                   # (b,nc,H)
    s = torch.zeros_like(states[:, 0])
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = p["decay"][:, c, :, None, None] * s + states[:, c]
    p["s_in"] = torch.stack(s_in, dim=1)                      # (b,nc,H,N,P)
    p["s"] = s
    hi = rnd(p["s_in"])
    lo = torch.zeros_like(hi) if omit == "lo" else rnd(p["s_in"] - hi)
    Ch = Cc.repeat_interleave(rep, dim=3)                     # (b,nc,Q,H,N)
    inter = (torch.einsum("bcihn,bchnp->bcihp", Ch, hi)
             + torch.einsum("bcihn,bchnp->bcihp", Ch, lo))
    if omit != "state":
        y = y + inter * torch.exp(ld)[..., None]
    p["y"] = y                                                # (b,nc,Q,H,P)
    return p


def ssd_cast_points(x, dt, A_log, B, C, chunk: int, *, omit=None):
    """The bf16 kernel's decomposition evaluated at its cast points, with
    T(·) the rounding to x's type: cb = T(C·Bᵀ) once a group and chunk;
    the triangle T(cb · T(exp(l_i − l_j))) against T(x·dt); each chunk's
    end state Σ_j T(exp(l_Q − l_j) B_j) T(x·dt)_jᵀ in f32; the states
    carried in f32; the state term exp(l_i) · (C·hi + C·lo) with the
    entering state split s = hi + lo into two values of x's type; y
    rounded once.  Shapes as ``ssd_ref``; returns (y in x's type, final
    state (b,H,P,N) f32).

    ``omit`` leaves one piece out, as a faulty kernel would, for the
    tests of ``bf16_bound`` and ``cast_point_interval``: ``"state"`` the
    carried state term, ``"column_tile"`` the triangle's second column
    tile of 32 (columns 32–63 of every chunk), ``"chunk_state"`` chunk 1's
    end state, ``"lo"`` the low half of the split (the state rounded once
    to x's type)."""
    p = _cast_points(x, dt, A_log, B, C, chunk, torch.float32, omit)
    return p["y"].reshape(x.shape).to(x.dtype), p["s"].transpose(2, 3)


def _gamma(n: int) -> float:
    """The relative error bound of an f32 sum of n terms in any order."""
    return n * F32_SUM_UNIT / (1.0 - n * F32_SUM_UNIT)


def bf16_bound(x, dt, A_log, B, C, chunk: int):
    """The f32 scan of the same bf16 values (``ssd_ref`` on their f32
    upcasts) and an elementwise bound on how far a bf16 output, computed
    at the kernel's cast points (``ssd_cast_points``) or the reference's
    (``ssd_ref`` on the bf16 values), with f32 sums in any order, may lie
    from it.  Returns (ref, bound), both (b, S, H, P) f32.

    Every error is carried relative to the same scan on |x|, |B|, |C|,
    split into its two terms: Y_tri = Σ_j D_ij Σ_n |C_in B_jn| |xdt_jp|
    (D_ij = exp(l_i − l_j)) and Y_state = exp(l_i) Σ_n |C_in| s̄_np, s̄ the
    carried state of |B|, |xdt|.  With u = 2^-8, u32 = 2^-23, γ_n the
    bound of an f32 sum of n terms, and δ = 2^-21 (1 + max |l|) for an f32
    exp whose argument may differ by an ulp of l (the f64 sums are
    rounded once, but in another order):

      triangle  T(C·Bᵀ) (u after γ_N), T(D) (u after δ), their product
                rounded (u), T(x·dt) (u + 2 u32), the sum over Q steps
                (γ_Q): k_tri = (1 + e_M)(1 + e_x)(1 + γ_Q) − 1, e_M the
                product of the first three;
      state     T(seg ∘ B) (δ, 2 u32, u), T(x·dt), the sum over Q (γ_Q),
                each carried step's decay and sum (δ + 2 u32, nc steps),
                the hi + lo split (u²), the sum over 2N products (γ_2N)
                and exp(l_i) (δ + u32);
      the f32 reference's own error, γ_{2N + Q + nc + 8} + (nc + 2) δ of
                both terms, and the sum of the two terms (u32).

    With E the sum of these, the output's rounding gives
    bound = u |ref| + (1 + u) E.  On the CPU (tests/test_torch_ssd_scan.py:
    mamba2's init, chunk 128, P 16–64, N 20–128, one to four groups) the
    plain bf16 ``ssd_ref`` and the cast-point version read 0.19–0.38 of it
    and the Pallas body 0.12–0.15; the carried state term left out reads
    12.7–41×, one column tile of the triangle left out 20.7–43.6× and one
    chunk's end state left out 9.7–41×."""
    f32 = torch.float32
    b, S, H, Pd = x.shape
    N = B.shape[3]
    Q, nc = chunk, S // chunk
    u, u32 = BF16_UNIT, F32_SUM_UNIT
    up = [t.to(f32) for t in (x, dt, A_log, B, C)]
    ref, _ = ssd_ref(*up, Q)
    xa, dta, al, Ba, Ca = up
    xa, Ba, Ca = xa.abs(), Ba.abs(), Ca.abs()
    y_abs, _ = ssd_ref(xa, dta, al, Ba, Ca, Q)
    # each chunk alone: the triangle's term without the carried state
    def chunks(t):
        return t.reshape(b * nc, Q, *t.shape[2:])
    y_tri, _ = ssd_ref(chunks(xa), chunks(dta), al, chunks(Ba), chunks(Ca), Q)
    y_tri = y_tri.reshape(y_abs.shape).double()
    y_state = (y_abs.double() - y_tri).clamp_min(0.0)

    L = _log_decay(dt, A_log, Q).abs().max().item()
    d = 2.0 ** -21 * (1.0 + L)
    e_x = u + 2 * u32
    e_m = (1 + u) * (1 + u + (1 + u) * _gamma(N)) * (1 + u + (1 + u) * d) - 1
    k_tri = (1 + e_m) * (1 + e_x) * (1 + _gamma(Q)) - 1
    e_w = ((1 + d) * (1 + 2 * u32) * (1 + u) * (1 + e_x) * (1 + _gamma(Q))
           - 1)
    e_s = (1 + e_w) * (1 + d + 2 * u32) ** nc - 1
    k_state = ((1 + e_s) * (1 + u * u) * (1 + _gamma(2 * N)) * (1 + d)
               * (1 + u32) - 1)
    k_ref = _gamma(2 * N + Q + nc + 8) + (nc + 2) * d
    err = ((1 + u32) * (k_tri * y_tri + k_state * y_state)
           + (u32 + k_ref) * (y_tri + y_state))
    bound = u * ref.double().abs() + (1 + u) * err
    return ref, bound.to(f32)


def _flip(a, e, T):
    """How far a value of type T rounded from a point within e of a may lie
    from a rounded: rounding is monotone, so it lies between the roundings
    of a − e and a + e (0 wherever no rounding boundary lies within e)."""
    def rnd(t):
        return t.to(T).to(a.dtype)
    t = rnd(a)
    return torch.maximum(rnd(a + e) - t, t - rnd(a - e))


def cast_point_interval(x, dt, A_log, B, C, chunk: int):
    """The interval [lo, hi], elementwise in x's type, that a kernel with
    ``ssd_cast_points``' cast points and only another order of its f32
    sums must round y into.  It is tighter than ``bf16_bound``: the cast
    points are the same, so no rounding of x's type stands between the two
    but the ones f32 sums or an exp in another order can move.

    y_cp is ``ssd_cast_points`` with exact (f64) sums and exps of the same
    f32 l.  Each cast point T(a) the kernel evaluates at an a' within e of
    a lies between T(a − e) and T(a + e): its flip f = max |T(a ± e) −
    T(a)| is 0 unless a rounding boundary lies within e.  With u32 = 2^-23,
    u24 = 2^-24, γ_n the bound of an f32 sum of n terms and ε(l) = 2^-20
    (1 + |l|) the relative error of an exp of l (the kernel's l may differ
    by an ulp; ``__expf`` adds 2 + 1.17 |arg| ulps):

      T(x·dt)        e = u24 |x dt|
      T(C·Bᵀ)        e = γ_N Σ_n |C B|
      T(exp(l_i−l_j)) e = ε(|l_i| + |l_j|) D
      M = T(cb D)    e = f_cb D + |cb| f_D + f_cb f_D
      T(seg ∘ B)     e = |B| ε(|l_Q| + |l_j|) seg + u24 |seg B|

    The triangle then differs by Td = Σ_j f_M (|xdt| + f_x) + |M| f_x; a
    chunk's end state by Σ_j f_w (|xdt| + f_x) + |w| f_x plus γ_Q of its
    absolute sum; the carried state by the decay's ε(|l_Q|) and four f32
    roundings a step; the state term by exp(l_i) Σ_n |C| Δs, the split
    (2^-16), γ_2N, exp(l_i)'s ε and a rounding; and the sum of all Q + 1
    parts by γ_{Q+2} of their absolute sum.  With E the total,
    lo = T(y_cp − E) and hi = T(y_cp + E): the output's rounding is
    monotone too.  Every e also carries 2^-120 for flushed subnormals.

    The interval holds one value wherever no boundary lies within E (at
    74–89% of the outputs of the CPU cases).  On the CPU
    (tests/test_torch_ssd_scan.py, the cases of ``bf16_bound``, three
    seeds) ``ssd_cast_points`` in f32 lies within it at every output; with
    the low half of the split left out (``omit="lo"``, the state rounded
    once) 121–313 outputs lie outside it, while that version reads only
    0.19–0.44 of ``bf16_bound``."""
    f64, T = torch.float64, x.dtype
    b, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    rep, Q, nc = H // G, chunk, S // chunk
    u24, tiny = 2.0 ** -24, 2.0 ** -120
    p = _cast_points(x, dt, A_log, B, C, Q, f64)
    tri = p["tri"]

    def eps(la):
        return 2.0 ** -20 * (1.0 + la)
    la = p["l"].abs()                                         # (b,nc,Q,H)
    lh = la.transpose(2, 3)                                   # (b,nc,H,Q)
    xdt = p["xdt"].abs()
    f_x = _flip(p["xdt_a"], u24 * p["xdt_a"].abs() + tiny, T)
    xa = xdt + f_x
    Bc = B.to(f64).abs().reshape(b, nc, Q, G, N)
    Cc = C.to(f64).abs().reshape(b, nc, Q, G, N)
    cb_e = _gamma(N) * torch.einsum("bcign,bcjgn->bcgij", Cc, Bc) + tiny
    cb = p["cb_a"].to(T).to(f64).abs().repeat_interleave(rep, dim=2)
    f_cb = _flip(p["cb_a"], cb_e, T).repeat_interleave(rep, dim=2)
    e_d = p["d_a"] * eps(lh[..., :, None] + lh[..., None, :]) + tiny
    f_d = torch.where(tri, _flip(p["d_a"], e_d, T), 0.0)
    d = p["d"].abs()
    e_m = f_cb * d + cb * f_d + f_cb * f_d + tiny
    f_m = torch.where(tri, _flip(p["m_a"], e_m, T), 0.0)
    m = p["m"].abs()
    t_abs = torch.einsum("bchij,bcjhp->bcihp", m + f_m, xa)
    t_d = (torch.einsum("bchij,bcjhp->bcihp", f_m, xa)
           + torch.einsum("bchij,bcjhp->bcihp", m, f_x))

    Bh = Bc.repeat_interleave(rep, dim=3)                     # (b,nc,Q,H,N)
    seg_e = p["seg"] * eps(la[:, :, -1:, :] + la)
    e_w = Bh * seg_e[..., None] + u24 * p["w_a"].abs() + tiny
    f_w = _flip(p["w_a"], e_w, T)
    w = p["w"].abs()
    w_abs = torch.einsum("bcjhn,bcjhp->bchnp", w + f_w, xa)
    w_d = (torch.einsum("bcjhn,bcjhp->bchnp", f_w, xa)
           + torch.einsum("bcjhn,bcjhp->bchnp", w, f_x) + _gamma(Q) * w_abs)
    dec, dec_e = p["decay"], eps(la[:, :, -1, :])             # (b,nc,H)
    s_abs = torch.zeros_like(w_abs[:, 0])
    s_d = torch.zeros_like(s_abs)
    a_in, d_in = [], []
    for c in range(nc):
        a_in.append(s_abs)
        d_in.append(s_d)
        dc = dec[:, c, :, None, None]
        ec = dec_e[:, c, :, None, None]
        nxt = ((1 + ec) * dc * s_abs + (1 + _gamma(Q)) * w_abs[:, c]) * (
            1 + 4 * u24)
        s_d = dc * s_d + ec * dc * s_abs + w_d[:, c] + 4 * u24 * nxt
        s_abs = nxt
    a_in = torch.stack(a_in, dim=1)                           # (b,nc,H,N,P)
    d_in = torch.stack(d_in, dim=1)
    Ch = Cc.repeat_interleave(rep, dim=3)                     # (b,nc,Q,H,N)
    el = torch.exp(p["l"])[..., None]                         # (b,nc,Q,H,1)
    el_e = eps(la)[..., None]
    st_abs = el * torch.einsum("bcihn,bchnp->bcihp", Ch, a_in + d_in)
    st_d = el * torch.einsum("bcihn,bchnp->bcihp", Ch, d_in)
    k_st = 2.0 ** -16 + _gamma(2 * N) + el_e + 2 * u24
    err = ((1 + el_e) * st_d + k_st * (1 + el_e) * st_abs + t_d
           + _gamma(Q + 2) * (t_abs + (1 + 2.0 ** -7) * st_abs) + tiny)
    y = p["y"]
    lo = (y - err).reshape(x.shape).to(T)
    hi = (y + err).reshape(x.shape).to(T)
    return lo, hi
