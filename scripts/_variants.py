"""What scripts/*_variants.py share: build text-edited copies of a CUDA
source with the port's own nvcc flags, all at once; time them in two
rounds, the second in reverse order; and read the ``clock64`` probes a
copy writes into device arrays.

Each per-kernel script keeps only its calls, its check and its table of
probes.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "build" / "variants"


def edit(text, subs, what):
    """text with each {"old text": "new text"} of subs applied; every old
    text must occur in it exactly once."""
    for old, new in subs.items():
        if text.count(old) != 1:
            raise SystemExit(f"{what}: {old!r} is not in the source once")
        text = text.replace(old, new)
    return text


def build(stem, sources, keep=""):
    """Compile {name: source text} into build/variants/{stem}_{name}.so,
    one nvcc each, all started together; print each one's (registers,
    spilled bytes) from ptxas for the kernels whose mangled names contain
    ``keep``; return {name: library path} of those that compiled."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.find_nvcc(), {}
    for name, text in sources.items():
        cu = OUT / f"{stem}_{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: build failed\n{log[-3000:]}")
            continue
        usage = {k: (u.get("registers"), u.get("spill_stores", 0)
                     + u.get("spill_loads", 0))
                 for k, u in cs.ptxas_usage(log).items() if keep in k}
        print(f"{name}: (registers, spilled bytes) of the {keep or 'all'} "
              f"kernels " + json.dumps(usage))
        libs[name] = OUT / f"{stem}_{name}.so"
    return libs


def alternate(names, run):
    """run(name) for every name in two rounds, the second in reverse
    order, so that a drift of the card's clock falls on every variant
    alike; {name: [round 1's result, round 2's]}."""
    out = {}
    for rnd in (names, names[::-1]):
        for name in rnd:
            out.setdefault(name, []).append(run(name))
    return out


def probe_arrays(arrays):
    """Source text declaring each device array of probe words (2^16
    64-bit words each), to go before the source's own namespace."""
    return "".join(f"__device__ long long {a}[1 << 16];\n" for a in arrays)


def probe_readers(stem, arrays):
    """Source text of two C functions, to go at the start of the source's
    ``extern "C"`` block: ``{stem}_read_ts(which, host, n)`` copies n words
    of array ``which`` to the host and ``{stem}_clear_ts(which)`` sets it
    to 0; each returns the CUDA error code."""
    read = "".join(f"  if (which == {i}) e = cudaMemcpyFromSymbol(host, {a}, "
                   f"n * 8);\n" for i, a in enumerate(arrays))
    addr = "".join(f"  if (which == {i}) e = cudaGetSymbolAddress(&p, {a});\n"
                   for i, a in enumerate(arrays))
    return (f"int {stem}_read_ts(int which, void* host, int n) {{\n"
            f"  cudaError_t e = cudaErrorInvalidValue;\n{read}"
            f"  return (int)e;\n}}\n"
            f"int {stem}_clear_ts(int which) {{\n  void* p = nullptr;\n"
            f"  cudaError_t e = cudaErrorInvalidValue;\n{addr}"
            f"  return (int)(e ? e : cudaMemset(p, 0, 8 << 16));\n}}\n")


def read_probes(lib, stem, which, rows, width=8):
    """The first ``rows`` rows of ``width`` probe words of array
    ``which``."""
    buf = (ctypes.c_longlong * (rows * width))()
    if getattr(lib, f"{stem}_read_ts")(which, ctypes.cast(buf, ctypes.c_void_p),
                                       rows * width):
        raise SystemExit("reading the probes failed")
    return [list(buf[width * i: width * i + width]) for i in range(rows)]


def clear_probes(lib, stem, which):
    if getattr(lib, f"{stem}_clear_ts")(which):
        raise SystemExit("clearing the probes failed")
