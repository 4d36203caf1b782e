#!/usr/bin/env python3
"""Time variants of the CUDA BGMV kernels against each other.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/bgmv_variants.py VARIANTS.json
    python3 scripts/bgmv_variants.py --timeline

VARIANTS.json maps a variant's name to text substitutions of
``src/repro_torch/kernels/batched_lora/csrc/bgmv.cu``
(``{"old text": "new text"}``; ``{}`` is the source as it is).  Each
variant is compiled with the port's own nvcc flags into
``build/variants/``, all at once, and its r-8 kernels' registers and
spills are printed.  At phase 2's decode and prefill calls (x (8, 4096)
and (8, 64, 4096), bf16, r 8, ranked, chip_smoke.py's inputs), both
kinds, every variant is checked against ``ref.bf16_bound`` and timed
from a CUDA graph in two rounds, the second in reverse order, on the one
card.

``--timeline`` builds a copy of the source whose blocks read ``clock64``
at the phase boundaries (start; x, A and the metadata staged; shrink
done; partials pushed; cluster barrier passed; h ready; expand done) and
prints, for the same four calls replayed from a CUDA graph, the median
and the largest cycles each phase takes over the blocks of the last call
(SM cycles; the probes themselves cost a few cycles each).
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

SRC = V.ROOT / "src/repro_torch/kernels/batched_lora/csrc/bgmv.cu"


def build(variants):
    """{name: library path} for every variant that compiled."""
    src = SRC.read_text()
    return V.build("bgmv", {name: V.edit(src, subs, name)
                            for name, subs in variants.items()}, "Li8E")


# the clock64 probes of --timeline: text substitutions of the source
PHASES = ("staged", "shrink", "push", "barrier", "h", "expand")
PROBES = {
    "namespace {\n\nconstexpr int kThreads":
        V.probe_arrays(["g_ts"]) + "namespace {\n\nconstexpr int kThreads",
    "  const int S = pr.S, d_in":
        "  long long ts[8] = {clock64()};\n  const int S = pr.S, d_in",
    "    __syncthreads();\n\n    if constexpr (MMA)":
        "    __syncthreads();\n    if (kb == k0) ts[1] = clock64();\n\n"
        "    if constexpr (MMA)",
    "  if (!meta_done) {   // a block with no slice":
        "  ts[2] = clock64();\n  if (!meta_done) {   // a block with no slice",
    "  cluster.sync();\n\n  float* hs":
        "  ts[3] = clock64();\n  cluster.sync();\n  ts[4] = clock64();\n\n  float* hs",
    "  __syncthreads();   // hs is complete":
        "  __syncthreads();   // hs is complete\n  ts[5] = clock64();",
    "sc, nv);\n    }\n  }\n}":
        "sc, nv);\n    }\n  }\n  ts[6] = clock64();\n"
        "  if (tid == 0) for (int i = 0; i < 8; ++i) g_ts[blockIdx.x * 8 + i] = ts[i];\n}",
    'extern "C" {\n': 'extern "C" {\n' + V.probe_readers("bgmv", ["g_ts"]),
}


def timeline():
    lib = ctypes.CDLL(str(V.build(
        "bgmv", {"timeline": V.edit(SRC.read_text(), PROBES, "timeline")},
        "Li8E")["timeline"]))
    _build._loaded["bgmv"] = lib
    side = torch.cuda.Stream()
    for kind in ("bgmv", "bgmv_mag"):
        for label, S in (("decode", None), ("prefill", cs.PAD_W)):
            v = cs.kernel_inputs(torch, cs.ROWS, S, cs.R_MAIN, torch.bfloat16,
                                 seed=7)
            torch.cuda.synchronize()
            V.clear_probes(lib, "bgmv", 0)
            cs.time_ms(torch, lambda: cs.call(kind, v, None, True), side,
                       reps=1, iters=200, warmup=20)
            torch.cuda.synchronize()
            # 4096 blocks: more than any of these grids
            rows = [r for r in V.read_probes(lib, "bgmv", 0, 4096)
                    if r[6] > r[0] > 0]
            out = {}
            for i, name in enumerate(PHASES):
                d = sorted(r[i + 1] - r[i] for r in rows)
                out[name] = [d[len(d) // 2], d[-1]]
            tot = sorted(r[6] - r[0] for r in rows)
            print(f"timeline {kind} {label}: {len(rows)} blocks, cycles "
                  f"[median, max] {json.dumps(out)}; total {tot[len(tot) // 2]}"
                  f" / {tot[-1]}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--timeline"]:
        print(f"gpu: {cs.gpu_line()}")
        timeline()
        return 0
    variants = json.loads(Path(sys.argv[1]).read_text())
    print(f"gpu: {cs.gpu_line()}")
    libs = build(variants)
    side = torch.cuda.Stream()
    names = list(libs)
    for kind in ("bgmv", "bgmv_mag"):
        for label, S in (("decode", None), ("prefill", cs.PAD_W)):
            v = cs.kernel_inputs(torch, cs.ROWS, S, cs.R_MAIN, torch.bfloat16,
                                 seed=7)

            def call():
                return cs.call(kind, v, None, True)
            def run(name):
                _build._loaded["bgmv"] = ctypes.CDLL(str(libs[name]))
                y = call()
                ratio = cs.bgmv_bound_ratio(kind, v, y, True)
                ms = cs.time_ms(torch, call, side)["graph"][0]
                print(f"{kind} {label} {name}: {ms:.5f} ms, |err| / "
                      f"bound {ratio:.3f}", flush=True)
            V.alternate(names, run)
    return 0


if __name__ == "__main__":
    os.chdir(V.ROOT)
    sys.exit(main())
