#!/usr/bin/env python3
"""Time variants of the CUDA fused_dora kernel against each other.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/fused_dora_variants.py VARIANTS.json [SHAPES.json]

VARIANTS.json maps a variant's name to text substitutions of
``src/repro_torch/kernels/fused_dora/csrc/fused_dora.cu``
(``{"old text": "new text"}``; ``{}`` is the source as it is).  Each
variant is compiled with the port's own nvcc flags into
``build/variants/``, all at once, and its bf16 kernels' registers and
spills are printed.  SHAPES.json is a list of [M, K, N] (default: phase
2's decode and prefill calls, [8, 4096, 4096] and [512, 4096, 4096]);
at each shape, r 8, chip_smoke.py's inputs, every variant is checked
against ``ref.bf16_bound`` (a variant that changes the arithmetic on
purpose prints a ratio above 1) and timed from a CUDA graph in two
rounds, the second in reverse order, on the one card.
"""
import ctypes
import json
import os
import sys
from pathlib import Path

import _variants as V   # puts src/ and the checkout's root on sys.path
import torch

import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels.fused_dora import fused_dora as FD
from repro_torch.kernels.fused_dora.ref import bf16_bound

SRC = V.ROOT / "src/repro_torch/kernels/fused_dora/csrc/fused_dora.cu"


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    variants = json.loads(Path(sys.argv[1]).read_text())
    shapes = (json.loads(Path(sys.argv[2]).read_text()) if len(sys.argv) > 2
              else [[8, 4096, 4096], [512, 4096, 4096]])
    print(f"gpu: {cs.gpu_line()}")
    src = SRC.read_text()
    libs = V.build("fused_dora", {name: V.edit(src, subs, name)
                                  for name, subs in variants.items()}, "_mma")
    side = torch.cuda.Stream()
    for M, K, N in shapes:
        v = cs.fused_inputs(torch, M, K, N, 8, torch.bfloat16, seed=7)
        a_eff = (v["a_dir"] + v["da_dir"]).bfloat16()
        b_eff, b_dir = v["b_mag"] + v["db_mag"], v["b_dir"].bfloat16()
        ref, bound = bf16_bound(*(v[k] for k in cs.FUSED_ORDER), 4.0)

        def call():
            return FD.fused_dora_cuda(v["x"], v["w0"], a_eff, v["a_mag"],
                                      b_dir, b_eff, scale=4.0)
        def run(name):
            _build._loaded["fused_dora"] = ctypes.CDLL(str(libs[name]))
            y = call()
            ratio = ((y.float() - ref).abs() / bound).max().item()
            ms = cs.time_ms(torch, call, side)["graph"][0]
            print(f"M={M} K={K} N={N} {name}: {ms:.5f} ms, |err| / bound "
                  f"{ratio:.3f}", flush=True)
        V.alternate(list(libs), run)
    return 0


if __name__ == "__main__":
    os.chdir(V.ROOT)
    sys.exit(main())
