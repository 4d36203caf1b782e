"""How accurately ``aggregation.exact_fedavg`` re-factors a mixed-rank
fleet's aggregate in f32, on one device (the card unless ``--device
cpu``): the products A'·B' of its aggregate against the best rank-r_out
factorization of Σwᵢ·AᵢBᵢ computed here in f64 (QR of the stacked
factors, SVD of the small core, all in f64), with the SVD routine the
port picks ("default": gesvd on the card) and, on the card, each of
cuSOLVER's SVD routines in its place; and
the QR of the stacked A factor alone (its residual ‖QR − A‖ and
‖QᵀQ − I‖).

Stacks: 4 clients at ranks 2/4/8/16 (the allocation at the fleet's
largest rank, zero-padded above each client's rank), llama2-7b's q/v
width (4096 x 4096), ``--layers`` layers, A ~ N(0, 1/16), B ~ N(0,
0.01²), seeded; with ``--dominant k`` the rank-16 client's B is k times
that, which opens a gap between the 16th and 17th singular values (the
rank-16 truncation is then well conditioned).  Prints, for each server
rank and routine, the largest over layers of ‖A'B' − P_r‖_F / ‖P_r‖_F,
the gap σ_r / σ_(r+1) and the call's seconds.

    PYTHONPATH=src python scripts/exact_fedavg_accuracy.py \\
        [--layers 4] [--server-ranks 16 32] [--dominant 1 30] [--device cpu]

Seconds on the card; about a minute on 4 CPU threads.
"""
import argparse
import json
import time

import torch

from repro_torch.core import aggregation as agg
from repro_torch.device import resolve_device

RANKS = (2, 4, 8, 16)


def stacks(layers, r_alloc, device, dominant):
    g = torch.Generator().manual_seed(0)
    C, d = len(RANKS), 4096
    A = torch.randn((C, layers, d, r_alloc), generator=g) / 4.0
    B = torch.randn((C, layers, r_alloc, d), generator=g) * 0.01
    B[-1] *= dominant
    for c, r in enumerate(RANKS):
        A[c, ..., r:] = 0
        B[c, ..., r:, :] = 0
    return {"q_proj": {"lora_A": A.to(device), "lora_B": B.to(device)}}


def best_f64(tree, r_out):
    """The best rank-``r_out`` approximation of Σwᵢ·AᵢBᵢ (uniform w),
    in f64 on the CPU, and its singular values."""
    A = tree["q_proj"]["lora_A"].cpu().double()
    B = tree["q_proj"]["lora_B"].cpu().double()
    C = A.shape[0]
    a_cat = torch.cat([A[c] / C for c in range(C)], dim=-1)
    b_cat = torch.cat([B[c] for c in range(C)], dim=-2)
    qa, ra = torch.linalg.qr(a_cat)
    qb, rb = torch.linalg.qr(b_cat.transpose(-1, -2))
    u, s, vh = torch.linalg.svd(ra @ rb.transpose(-1, -2))
    k = min(r_out, s.shape[-1])
    return ((qa @ u[..., :k]) * s[..., None, :k]) @ (
        vh[..., :k, :] @ qb.transpose(-1, -2)), s


def product_err(out, best):
    p = (out["q_proj"]["lora_A"].cpu().double()
         @ out["q_proj"]["lora_B"].cpu().double())
    return float((torch.linalg.matrix_norm(p - best)
                  / torch.linalg.matrix_norm(best)).max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--server-ranks", type=int, nargs="+", default=[16, 32])
    ap.add_argument("--dominant", type=float, nargs="+", default=[1.0, 30.0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 GEMMs in f32
    routines = [None] + (["gesvd", "gesvdj", "gesvda"]
                         if dev.type == "cuda" else [])
    real_svd = torch.linalg.svd
    out = {"device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                      else "cpu")}
    for dominant in args.dominant:
        for r_alloc in args.server_ranks:
            tree = stacks(args.layers, r_alloc, dev, dominant)
            best, s = best_f64(tree, r_alloc)
            key = f"dominant {dominant:g} r{r_alloc}"
            a_cat = torch.cat(list(tree["q_proj"]["lora_A"] / len(RANKS)),
                              dim=-1)
            q, r = torch.linalg.qr(a_cat)
            eye = torch.eye(q.shape[-1], device=dev)
            out[key] = {
                "gap": float((s[..., r_alloc - 1] / s[..., r_alloc]).min())
                if r_alloc < s.shape[-1] else None,
                "qr_residual": float((torch.linalg.matrix_norm(q @ r - a_cat)
                                      / torch.linalg.matrix_norm(a_cat)).max()),
                "qr_orthogonality": float(torch.linalg.matrix_norm(
                    q.transpose(-1, -2) @ q - eye).max())}
            for name in routines:
                torch.linalg.svd = (
                    lambda m, full_matrices=True, driver=None, _d=name:
                    real_svd(m, full_matrices=full_matrices,
                             driver=_d or driver))
                try:
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = agg.exact_fedavg(tree, ranks=RANKS)
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                    out[key][name or "default"] = {
                        "product_err": product_err(res, best),
                        "seconds": secs}
                except torch.linalg.LinAlgError as e:   # a routine that
                    out[key][name or "default"] = str(e)  # did not converge
                finally:
                    torch.linalg.svd = real_svd
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
