#!/usr/bin/env python3
"""Time variants of the CUDA SSD scan against each other.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/ssd_scan_variants.py VARIANTS.json [--earlier OLD.cu]
    python3 scripts/ssd_scan_variants.py VARIANTS.json --profile

VARIANTS.json maps a variant's name to text substitutions of
``src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu`` (``{"old text":
"new text"}``; ``{}`` is the source as it is).  Each variant is compiled
with the port's own nvcc flags into ``build/variants/``, all at once, and
its kernels' registers and spills are printed.  ``--earlier`` adds a
source with the one-launch interface of the one-block-a-head kernel
(x, dt, a_log, B, C, y, state, BH, BG, S, P, N, Q, stream), e.g. that
kernel's source at the commit before the chunk-parallel one:

    git show 4d05af3:src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu \\
        > build/ssd_scan_pr13.cu

At chip_smoke.py's phase 2 calls (``SSD_TIMED``: mamba2-2.7b 1 x 4096
bf16 and f32 at chunk 128, bf16 at chunk 256, jamba-v0.1 bf16), every
variant's output is held as phase 2 holds it and timed through the
dispatcher from a CUDA graph in two rounds, the second in reverse order,
on the one card.  ``--profile`` instead runs each variant's calls under
``torch.profiler`` and prints the device time of each of its kernels
(the mean over 10 calls).  ``--timeline`` (no VARIANTS.json) builds a copy
of the source whose ssd_states_mma and ssd_y_mma blocks read ``clock64``
at their phase boundaries and ``%globaltimer`` at start and end, and
prints for each bf16 call the median SM cycles of each phase, the median
block time and how many blocks ran on an SM at once.
"""
import ctypes
import json
import os
import re
import sys
from pathlib import Path

import _variants as V   # puts src/ and the checkout's root on sys.path
import torch

import chip_smoke as cs
from repro_torch.kernels import _build
from repro_torch.kernels._wrap import I, P, SUFFIX, raise_on, stream
from repro_torch.kernels.ssd_scan import ops
from repro_torch.kernels.ssd_scan import ssd_scan as K

SRC = V.ROOT / "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"


def earlier_call(lib):
    """A stand-in for ``ssd_scan_bh_cuda`` that launches the one-launch
    kernel of ``lib``."""
    for s in SUFFIX.values():
        fn = getattr(lib, f"ssd_scan_{s}")
        fn.argtypes = [P] * 7 + [I] * 6 + [P]
        fn.restype = I

    def call(x, dt, a_log, B, C, *, chunk=256):
        BH, S, Pd = x.shape
        BG, _, N = B.shape
        y = torch.empty_like(x)
        st = torch.empty((BH, N, Pd), dtype=torch.float32, device=x.device)
        rc = getattr(lib, f"ssd_scan_{SUFFIX[x.dtype]}")(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), st.data_ptr(), BH, BG, S, Pd, N,
            min(chunk, S), stream(x))
        raise_on(rc, lib, "ssd_scan", "ssd_scan")
        return y, st
    return call


def use(name, libs, earlier):
    """Route the dispatcher to variant ``name``."""
    lib = ctypes.CDLL(str(libs[name]))
    if name == earlier:
        ops.ssd_scan_bh_cuda = earlier_call(lib)
    else:
        ops.ssd_scan_bh_cuda = K.ssd_scan_bh_cuda
        _build._loaded["ssd_scan"] = lib


def profile(names, libs, earlier):
    """Each call's device time by kernel, for every variant."""
    from torch.profiler import ProfilerActivity, profile as prof
    for label in cs.SSD_TIMED:
        v, chunk = cs.ssd_timed_inputs(torch, label)
        for name in names:
            use(name, libs, earlier)
            for _ in range(3):
                cs.ssd_call(v, chunk=chunk)
            torch.cuda.synchronize()
            with prof(activities=[ProfilerActivity.CUDA]) as p:
                for _ in range(10):
                    cs.ssd_call(v, chunk=chunk)
                torch.cuda.synchronize()
            rows = {}
            for e in p.key_averages():
                if e.device_time_total > 0:
                    m = re.search(r"ssd_[a-z_]+(?:<\d>)?", e.key)
                    k = m.group(0) if m else e.key[:40]
                    rows[k] = rows.get(k, 0) + e.device_time_total / 10 / 1e3
            print(f"profile {label} {name}: ms a call by kernel "
                  + json.dumps({k: round(t, 5) for k, t in rows.items()})
                  + f"; sum {sum(rows.values()):.5f}",
                  flush=True)
        del v


# the probes of --timeline: text substitutions of the source.  Per block 8
# words: globaltimer at start, clock64 - start at phases 1-5, %smid,
# globaltimer at the end.
_TS = ("  long long ts[6];\n  ts[0] = clock64();\n"
       "  unsigned long long gt0;\n"
       "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt0));\n")


def _record(arr):
    return ("  if (threadIdx.x == 0) {\n"
            "    unsigned long long gt1; unsigned sm;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt1));\n"
            "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
            "    long long* o = " + arr + " + 8 * (blockIdx.y * gridDim.x + blockIdx.x);\n"
            "    o[0] = (long long)gt0; o[6] = sm; o[7] = (long long)gt1;\n"
            "    for (int i = 1; i < 6; ++i) o[i] = ts[i] - ts[0];\n  }\n")


PHASES = {
    "ssd_states_mma": ("scan", "wait", "convert", "mma", "rest"),
    "ssd_y_mma": ("issue", "wait", "M pass", "state term", "triangle"),
}
PROBES = {
    "namespace {\n\nusing bf16":
        V.probe_arrays(["g_st", "g_y"]) + "namespace {\n\nusing bf16",
    "  const StatesLayout L = states_layout(true, P, N, Q);\n":
        "  const StatesLayout L = states_layout(true, P, N, Q);\n" + _TS,
    "  issue(1);\n\n  chunk_scan(dt + row0, d0, -expf(a_log[bh]), Q, dts, lds, red);\n":
        "  issue(1);\n\n  chunk_scan(dt + row0, d0, -expf(a_log[bh]), Q, dts, lds, red);\n"
        "  ts[1] = clock64();\n",
    "    cp_async_wait<0>();\n    __syncthreads();\n    // T(seg o B)":
        "    cp_async_wait<0>();\n    __syncthreads();\n    ts[2] = clock64();\n"
        "    // T(seg o B)",
    "    __syncthreads();\n#pragma unroll\n    for (int st = 0; st < 2; ++st) {":
        "    __syncthreads();\n    ts[3] = clock64();\n#pragma unroll\n"
        "    for (int st = 0; st < 2; ++st) {",
    "    if (s0 + 2 < steps) {":
        "    ts[4] = clock64();\n    if (s0 + 2 < steps) {",
    "  float* wc = W + (static_cast<size_t>(bh) * nc + c) * N * P;\n#pragma unroll\n"
    "  for (int t = 0; t < MT; ++t) {":
        "  ts[5] = clock64();\n" + _record("g_st") +
        "  float* wc = W + (static_cast<size_t>(bh) * nc + c) * N * P;\n#pragma unroll\n"
        "  for (int t = 0; t < MT; ++t) {",
    "  const YLayout L = y_layout(true, P, N, Q);\n":
        "  const YLayout L = y_layout(true, P, N, Q);\n" + _TS,
    "  float acc[4][2][4];":
        "  ts[1] = clock64();\n  float acc[4][2][4];",
    "C rows and column tile J\n    __syncthreads();\n":
        "C rows and column tile J\n    __syncthreads();\n    ts[2] = clock64();\n",
    "    __syncthreads();\n\n    // (C o exp(l)) . s_in":
        "    __syncthreads();\n    ts[3] = clock64();\n\n    // (C o exp(l)) . s_in",
    "    // M . xdt over this column tile, up to the diagonal":
        "    ts[4] = clock64();\n    // M . xdt over this column tile, up to the diagonal",
    "  bf16* yc = y + row0 * P;":
        "  ts[5] = clock64();\n" + _record("g_y") + "  bf16* yc = y + row0 * P;",
    'extern "C" {\n': 'extern "C" {\n' + V.probe_readers("ssd", ["g_st", "g_y"]),
}


def timeline():
    libs = V.build("ssd", {"timeline": V.edit(SRC.read_text(), PROBES,
                                              "timeline")})
    use("timeline", libs, None)
    lib = _build._loaded["ssd_scan"]
    for label, (c, b, S, chunk, dn) in cs.SSD_TIMED.items():
        if dn != "bfloat16":
            continue
        v, chunk = cs.ssd_timed_inputs(torch, label)
        for _ in range(3):
            cs.ssd_call(v, chunk=chunk)
        torch.cuda.synchronize()
        blocks = K.blocks(b * c["H"], b * c["G"], S, c["P"], c["N"], chunk,
                          torch.bfloat16)
        for which, name in ((0, "ssd_states_mma"), (1, "ssd_y_mma")):
            n = blocks["ssd_states" if which == 0 else "ssd_y"]
            rows = V.read_probes(lib, "ssd", which, n)
            med = {}
            prev = [0] * n
            for k, ph in enumerate(PHASES[name]):
                d = sorted(r[k + 1] - p for r, p in zip(rows, prev))
                med[ph] = d[len(d) // 2]
                prev = [r[k + 1] for r in rows]
            t0 = min(r[0] for r in rows)
            span_us = (max(r[7] for r in rows) - t0) / 1e3
            dur = sorted((r[7] - r[0]) / 1e3 for r in rows)
            # blocks running on SM 0 at the middle of the launch
            mid = t0 + span_us * 500
            on0 = sum(1 for r in rows if r[6] == rows[0][6] and r[0] <= mid <= r[7])
            print(f"timeline {label} {name}: {n} blocks over {span_us:.1f} us; "
                  f"block us median {dur[len(dur) // 2]:.2f} max {dur[-1]:.2f}; "
                  f"resident on one SM at mid-launch {on0}; median cycles by "
                  f"phase {json.dumps(med)}", flush=True)
        del v


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args == ["--timeline"]:
        print(f"gpu: {cs.gpu_line()}")
        timeline()
        return 0
    earlier = None
    do_profile = "--profile" in args
    if do_profile:
        args.remove("--profile")
    sources = {}
    if "--earlier" in args:
        i = args.index("--earlier")
        sources["earlier"] = Path(args[i + 1]).read_text()
        earlier = "earlier"
        del args[i:i + 2]
    src = SRC.read_text()
    for name, subs in json.loads(Path(args[0]).read_text()).items():
        sources[name] = V.edit(src, subs, name)
    print(f"gpu: {cs.gpu_line()}")
    libs = V.build("ssd", sources)
    names = list(libs)
    if do_profile:
        profile(names, libs, earlier)
        return 0
    side = torch.cuda.Stream()
    out = {}
    for label in cs.SSD_TIMED:
        v, chunk = cs.ssd_timed_inputs(torch, label)

        def call():
            return cs.ssd_call(v, chunk=chunk)
        def run(name):
            use(name, libs, earlier)
            y, st = call()
            e, _ = cs.ssd_check(torch, f"{label} {name}", v, y, st, chunk)
            ms = cs.time_ms(torch, call, side, reps=3, iters=10,
                            warmup=3)["graph"][0]
            extra = ("" if y.dtype == torch.float32 else
                     f", |err| / bf16_bound {e['bound_ratio']:.3f}")
            print(f"{label} {name}: {ms:.5f} ms{extra}", flush=True)
            return ms
        out[label] = V.alternate(names, run)
        del v
    print("ms by call and variant (two rounds): " + json.dumps(out))
    return 0


if __name__ == "__main__":
    os.chdir(V.ROOT)
    sys.exit(main())
