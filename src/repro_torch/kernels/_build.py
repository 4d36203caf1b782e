"""Build the port's CUDA kernels and load them with ctypes.

Each source under a ``csrc/`` directory is compiled by ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <src>

Libraries are built on first use only, into ``build/kernels/`` at the
root of the checkout, named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads at once.  ``nvcc`` is
found from ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda/bin``.
``build_all`` starts one ``nvcc`` per source, all at once, and waits
for every one of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_KERNELS = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS.parents[2] / "build" / "kernels"

# library name → source, relative to this package
SOURCES = {"bgmv": "batched_lora/csrc/bgmv.cu",
           "fused_dora": "fused_dora/csrc/fused_dora.cu",
           "quant_matmul": "quant_matmul/csrc/quant_matmul.cu",
           "flash_attention": "flash_attention/csrc/flash_attention.cu",
           "ssd_scan": "ssd_scan/csrc/ssd_scan.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be "
                       "built")


def library_path(name: str) -> Path:
    src = _KERNELS / SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's output (``-Xptxas -v``: registers, shared memory
    and spills per kernel) for the current build of ``name``."""
    return library_path(name).with_suffix(".log")


def build_all(names=None) -> dict[str, Path]:
    """Build every named library that is not built yet, one ``nvcc``
    each, all started together; returns ``{name: library path}``."""
    names = list(SOURCES if names is None else names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}.tmp")
        log = open(log_path(n), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_KERNELS / SOURCES[n])]
        procs.append((n, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out[n])
        else:
            failed.append(f"{n} (nvcc exit {rc}):\n"
                          + log_path(n).read_text()[-4000:])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _loaded:
        path = build_all([name])[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
