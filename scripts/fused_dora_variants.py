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
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fused_dora import fused_dora as FD  # noqa: E402
from repro_torch.kernels.fused_dora.ref import bf16_bound  # noqa: E402

SRC = ROOT / "src/repro_torch/kernels/fused_dora/csrc/fused_dora.cu"
OUT = ROOT / "build" / "variants"


def build(variants):
    """{name: library path} for every variant that compiled."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, src, procs = _build.find_nvcc(), SRC.read_text(), {}
    for name, subs in variants.items():
        text = src
        for old, new in subs.items():
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}")
            continue
        usage = {k: (u["registers"], u["spill_stores"] + u["spill_loads"])
                 for k, u in cs.ptxas_usage(log).items() if "_mma" in k}
        print(f"{name}: (registers, spilled bytes) of the bf16 kernels "
              + json.dumps(usage))
        libs[name] = OUT / f"{name}.so"
    return libs


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    variants = json.loads(Path(sys.argv[1]).read_text())
    shapes = (json.loads(Path(sys.argv[2]).read_text()) if len(sys.argv) > 2
              else [[8, 4096, 4096], [512, 4096, 4096]])
    print(f"gpu: {cs.gpu_line()}")
    libs = build(variants)
    side = torch.cuda.Stream()
    for M, K, N in shapes:
        v = cs.fused_inputs(torch, M, K, N, 8, torch.bfloat16, seed=7)
        a_eff = (v["a_dir"] + v["da_dir"]).bfloat16()
        b_eff, b_dir = v["b_mag"] + v["db_mag"], v["b_dir"].bfloat16()
        ref, bound = bf16_bound(*(v[k] for k in cs.FUSED_ORDER), 4.0)

        def call():
            return FD.fused_dora_cuda(v["x"], v["w0"], a_eff, v["a_mag"],
                                      b_dir, b_eff, scale=4.0)
        names = list(libs)
        for rnd in (names, names[::-1]):
            for name in rnd:
                _build._loaded["fused_dora"] = ctypes.CDLL(str(libs[name]))
                y = call()
                ratio = ((y.float() - ref).abs() / bound).max().item()
                ms = cs.time_ms(torch, call, side)["graph"][0]
                print(f"M={M} K={K} N={N} {name}: {ms:.5f} ms, |err| / bound "
                      f"{ratio:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
