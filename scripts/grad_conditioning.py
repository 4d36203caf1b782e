"""How well f32 computes one stage-1 step's adapter gradients: f32
against f64 weights and activations on the same inputs, on one device
(the card unless ``--device cpu``).

The backbone is 2 layers at llama2-7b's layer width (d 4096, 32 heads,
d_ff 11008) with a vocabulary of 4096 (the head is not what is asked
about), seeded random weights; one client, 1 x 64 tokens of the dolly
data, dropout 0.  The method's zero-initialized factor (``--leaf``) is
drawn N(0, s²) for each ``--scales`` s.  Prints, for every adapter leaf,
max |g32 − g64| / max |g64|.

The model computes attention (scores, softmax, the PV product), RMS
norm, RoPE, the MLP's SiLU, the adapter's GELU and the CE in f32 whatever
its weights' dtype; the f64 run holds the embedding, every projection,
the adapters and the residual stream in f64.  So the reading is the part
of f32's error that those products' and sums' rounding causes, a lower
bound on it: a check that holds the card's f32 gradients against the
CPU's, whose GEMMs sum in another order, cannot be tighter.

    PYTHONPATH=src python scripts/grad_conditioning.py \\
        --method fedalt --leaf /local_B --scales 0.5 0.01 [--device cpu]

About 7 GB of memory; seconds on the card, a minute on 4 CPU threads.
"""
import argparse

import numpy as np
import torch

from repro_torch.data import (SyntheticInstructionDataset, make_dataset_family,
                              specialist_partition, to_device)
from repro_torch.device import resolve_device
from repro_torch.fed.simulate import FedHyper, FedSim
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="fedalt")
    ap.add_argument("--leaf", default="/local_B")
    ap.add_argument("--scales", type=float, nargs="+", default=[0.5, 0.01])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 GEMMs in f32
    cfg = ArchConfig(name="llama2-7b-2l", family="dense", n_layers=2,
                     d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
                     vocab_size=4096, dtype="float32", lora_dropout=0.0)
    base = M.init_params(torch.Generator().manual_seed(0), cfg,
                         device=dev)
    fam = make_dataset_family("dolly", vocab_size=cfg.vocab_size)
    ds = SyntheticInstructionDataset(fam, specialist_partition(1, 4)[0])
    batch = to_device(ds.sample_batch(np.random.default_rng(1), 1, 64),
                      dev)
    hp = FedHyper(method=args.method, n_clients=1)
    sims = {dt: FedSim(cfg, hp, base=pt.tree_map(lambda t: t.to(dt), base),
                       device=dev)
            for dt in (torch.float32, torch.float64)}
    del base
    for s in args.scales:
        g = torch.Generator().manual_seed(2)
        ad = pt.tree_map_with_path(
            lambda p, x: (s * torch.randn(x.shape, generator=g).to(x.device)
                          if p.endswith(args.leaf) else x),
            sims[torch.float32].adapter_template)
        grads = {dt: sim.loss_and_grad(pt.tree_map(lambda t: t.to(dt), ad),
                                       batch)[2]
                 for dt, sim in sims.items()}
        for p, want in pt.tree_leaves_with_path(grads[torch.float64]):
            got = pt.tree_get(grads[torch.float32], p).double()
            err = float((got - want).abs().max() / want.abs().max())
            print(f"scale {s}: {p}: f32 vs f64 {err:.3e}")


if __name__ == "__main__":
    main()
