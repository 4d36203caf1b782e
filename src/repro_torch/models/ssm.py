"""Mamba-2 SSD forward, the chunked (state-space duality) form.

Port of ``repro/models/ssm.py::_ssd_chunked`` only: the plain version
that ``kernels/ssd_scan/ref.py::ssd_ref`` holds the CUDA scan against.
``_causal_conv`` and ``mamba2_mixer`` wait for ROADMAP A12 (the SSM
family).

Cast points are the reference's: B, C, x·dt, the Q×Q decay and the
per-step segment decay in x's dtype (``cdt``); the log-decay, its
cumulative sum and every product's accumulation in f32 (the cumulative
sum is accumulated in f64 and rounded once to f32).  The reference
carries the state across chunks with a log-depth ``associative_scan``;
here a loop over chunks computes the same recurrence
S_c = exp(l_Q)·S_{c−1} + states_c, with its sums in another order.
"""
from __future__ import annotations

import torch


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
