"""Find what a step allocates on the card that the dry run's tally does
not see: the step runs on the card under ``launch.dryrun.StorageTally``,
and for every op the caching allocator's requested bytes at their peak
inside the op are held against the new storages the op returned.  An
op whose kernel takes a workspace from the allocator (below the
dispatcher, where no mode sees it) shows the difference.

    PYTHONPATH=src python scripts/dryrun_unseen.py [--arch llama2-7b] \\
        [--layers 8] [--seq 1024] [--batch 4] [--kind train]

Prints the step's account on meta, the card's requested-bytes peak, and
the ops with unseen bytes (largest first, with their input shapes).
Needs a CUDA card.
"""
import argparse
import dataclasses
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402


def requested(stat):
    return torch.cuda.memory_stats()[f"requested_bytes.all.{stat}"]


class OpWatch(dryrun.StorageTally):
    """StorageTally that also reads the allocator around every op."""

    def __init__(self):
        super().__init__()
        self.unseen = defaultdict(lambda: [0, 0, None])   # op → n, max, shapes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        torch.cuda.reset_peak_memory_stats()
        before, c0 = requested("current"), self.current
        out = super().__torch_dispatch__(func, types, args, kwargs)
        extra = (requested("peak") - before) - (self.current - c0)
        if extra > 0:
            u = self.unseen[str(func)]
            u[0] += 1
            if extra > u[1]:
                u[1] = extra
                u[2] = [tuple(a.shape) for a in args
                        if isinstance(a, torch.Tensor)]
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama2-7b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--kind", default="train")
    a = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config(a.arch), n_layers=a.layers)
    shape = InputShape("probe", a.seq, a.batch, a.kind)
    acc = dryrun.account(cfg, shape)["memory"]
    want = acc["peak_estimate_bytes"] - acc["argument_bytes"]
    step, make_args = dryrun.step_and_inputs(cfg, shape, device="cuda")
    args = make_args()
    step(*args)                        # once: handles and workspaces made
    torch.cuda.synchronize()
    r0 = requested("current")
    torch.cuda.reset_peak_memory_stats()
    step(*args)
    torch.cuda.synchronize()
    card = requested("peak") - r0
    print(f"{torch.cuda.get_device_name(0)}; {a.arch} x {a.layers} layers, "
          f"{a.batch} x {a.seq} {a.kind}: account {want} bytes, card "
          f"requested {card}, off {card - want}")
    watch = OpWatch()
    with watch:
        step(*args)
    torch.cuda.synchronize()
    print(f"the tally on the card: peak {watch.peak} bytes (the account's "
          f"{want}: every op seen, the backward's too, when equal)")
    rows = sorted(watch.unseen.items(), key=lambda kv: -kv[1][1])
    for op, (n, most, shapes) in rows[:20]:
        print(f"{most:>14,d} bytes unseen at most, {n:>5d} calls: {op} "
              f"{shapes}")


if __name__ == "__main__":
    main()
