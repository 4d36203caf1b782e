"""The one-card dry run: account every (architecture × input shape) pair
by running its step once on ``device="meta"`` tensors, allocating nothing
(port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k [--variant cf1] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-34b \\
        --shape decode_32k --grid 1x4 --variant seqshard_kv
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
        --grids 1x4,2x2,4x1

The reference lowers and compiles each step on 512 host devices and
reads XLA's memory and cost analyses.  PyTorch has no compile step that
reports memory; its counterpart of "compile without allocating" is to
run the step on meta tensors, which have shapes and dtypes and no
storage.  The step is the one the reference lowers, on one card:

  train    ``launch/train.make_fed_train_step`` on ``make_client_mesh(1)``
           (one client holds the whole global batch) with the reference's
           ``pick_micro_batches`` and remat;
  prefill  ``launch/serve.make_prefill_step``;
  decode   ``launch/serve.make_decode_step`` (an encoder-decoder's with
           ``enc_out``), the cache written in place.

The step's inputs (``launch/specs.py``) are built before the run; the run
goes under ``StorageTally`` (the bytes of every storage an op makes,
freed when the storage dies) and ``torch.utils.flop_counter.
FlopCounterMode``.  The two kernels on the path, ``flash_attention`` and
``ssd_scan``, have a meta branch that makes the CUDA path's allocations
and counts the launch's FLOPs (``META_FLOPS``).  The record:

  memory         argument_bytes (the inputs' storages), output_bytes (the
                 returned storages), alias_bytes (inputs updated in place
                 and returned: the decode cache; the port's counterpart of
                 donation), temp_bytes (the tally's peak less the step's
                 new outputs, output − alias) and peak_estimate_bytes by
                 the reference's formula, argument + temp + output −
                 alias: the inputs plus the tally's peak.  (Less only the
                 outputs live at the peak, the formula would count an
                 output made after the peak twice: a mamba2 prefill's
                 86 MB cache, measured on the card.)
  fits_80g       peak_estimate_bytes < 80e9 (one H100's memory)
  cost_analysis  flops_counted (FlopCounterMode's total) and kernel_flops
                 (the meta branches'), with a note of what each counts
  params, analytic, roofline
                 the reference's fields and formulas through
                 ``launch/analysis.py`` at n_dev = 1 and no collective
                 (``analytic_record``, which needs no meta run)

On a grid (``--grid NxM``: N data × M model ranks; ``--grids`` a list)
the record is one rank's (rank 0's; ``run_config(rank=)``): its step runs
on a meta grid
(``launch/mesh.make_meta_grid``, whose groups make the real groups'
buffers and count what the rank sends) over its shard of the meta trees
(``launch/specs.shard_tree`` by ``param_specs``, and the decode cache by
``cache_specs``): train through the production engine on the grid (the
rank's client, ``global_batch / N`` rows, the micro-batches the
reference picks for them), prefill and decode through ``launch/serve``
with the whole batch, the rank's rows of an encoder's output.  The
record has the reference's ``mesh`` ("NxM") and ``n_devices``, the
rank's memory fields and ``fits_80g``, ``collectives`` (per group and op
the calls and the bytes the rank sends, and their ``total``), the
analytic fields at n_dev = N · M and the roofline's collective term (the
rank's bytes over ``analysis.NVLINK_BW``).  Every rank of an even grid
runs the same shapes (``shard_tree`` cuts evenly or raises; the tests
compare two ranks).  The ``seqshard_kv`` variant puts a decode step on
the grid's ``seq_shard_kv`` layout (the cache split on its sequence over
the model ranks where the kv heads do not divide over them); on one card
it is the baseline.

A train step of more than ``MICRO_RUN`` micro-batches runs at 3 and 4
micro-batches of the same rows: from the third micro-batch on, each
makes the same allocations while the same tensors are live (the f32
accumulator and the previous micro-batch's gradient and its f32 copy;
in the second, that copy is the accumulator) and keeps one more set of
0-d metrics, so every number of the account is affine in the
micro-batch count from 3 on, and the two runs fix the line
(``micro_batches_run`` says which counts ran).  At train_4k one client
takes 256 micro-batches, and a run of each would take tens of minutes.

No counterpart here: the HLO archive, ``hlo_lines``, ``lower_s`` /
``compile_s`` and ``--multipod`` (nothing is compiled; one node has no
'pod' axis).  The dry run never touches CUDA: it runs the same on a host
with no card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ARCH_IDS, SHAPES, InputShape, get_config,
                                 shape_supported)
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.ssd_scan import ssd_scan as SSD
from repro_torch.launch import analysis as AN
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_client_mesh, make_meta_grid
from repro_torch.launch.serve import make_decode_step, make_prefill_step
from repro_torch.launch.train import (TrainSettings, make_fed_train_step,
                                      pick_micro_batches)
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt

FITS_BYTES = 80e9               # one H100's memory
MICRO_RUN = 4                   # micro-batches a train account runs at most
VARIANTS = ("baseline", "cf1", "remat_dots", "swa_global", "seqshard_kv")
FLOPS_NOTE = (
    "flops_counted: torch.utils.flop_counter.FlopCounterMode over the "
    "meta run, matrix products only (mm, bmm, addmm, baddbmm, "
    "convolution, scaled_dot_product_attention and their backward), 2 a "
    "multiply-add; elementwise ops and reductions are not in it. "
    "kernel_flops: the flash_attention and ssd_scan calls the meta "
    "branches stood in for (QK^T and PV over the kept pairs; the scan's "
    "products), which no op on the meta device counts")


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class StorageTally(TorchDispatchMode):
    """The bytes of every storage an op makes while the mode is on, less
    those freed since: ``current`` and its ``peak``.  A storage is new
    when an op returns it and it is none of the op's inputs' (a view, an
    in-place or ``out=`` op makes none); it is freed when it dies (a
    ``weakref.finalize`` on the storage, whose Python object lives as
    long as it does).  Meta
    tensors go through the same ops as real ones, so on the meta device
    the tally is what the step would allocate.  ``round_to``: each
    storage counted rounded up to this many bytes (the CUDA caching
    allocator's 512)."""

    def __init__(self, round_to: int = 1):
        super().__init__()
        self.round_to = round_to
        self.live: dict[int, int] = {}      # storage key → bytes
        self.current = self.peak = 0

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        inputs = {_key(a) for a in tree_leaves((args, kwargs))
                  if isinstance(a, torch.Tensor)}
        for o in tree_leaves(out):
            if not isinstance(o, torch.Tensor):
                continue
            st = o.untyped_storage()
            k = st._cdata
            if k in inputs or k in self.live:
                continue
            nb = -(-st.nbytes() // self.round_to) * self.round_to
            self.live[k] = nb
            self.current += nb
            self.peak = max(self.peak, self.current)
            weakref.finalize(st, self._free, k)
        return out


def storage_bytes(tree) -> dict[int, int]:
    """{storage key: bytes} of the tensors in ``tree`` (any nesting of
    dicts, lists and tuples), each storage once."""
    return {_key(t): t.untyped_storage().nbytes() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)}


def zero_stats(grid):
    """Zero a grid's collective stats (``collectives`` reads them)."""
    for g in (grid.data, grid.model):
        for st in g.stats.values():
            st.update(calls=0, bytes=0, seconds=0.0)


def collectives(grid) -> dict:
    """A grid's collectives since its stats were zeroed: per group and op
    the calls and bytes this rank sent (the ops it issued), and the
    bytes' ``total``."""
    out = {name: {op: {"calls": st["calls"], "bytes": st["bytes"]}
                  for op, st in g.stats.items() if st["calls"]}
           for name, g in (("data", grid.data), ("model", grid.model))}
    out["total"] = sum(v["bytes"] for name in ("data", "model")
                       for v in out[name].values())
    return out


def measure(step, args, grid=None) -> dict:
    """Run ``step(*args)`` once under the tally and FlopCounterMode (the
    inputs built before, on any device).  Returns the memory account,
    the counted and the kernels' FLOPs and, with the step's ``grid``,
    its collectives."""
    arg = storage_bytes(args)
    for flops in (FA.META_FLOPS, SSD.META_FLOPS):
        for k in flops:
            flops[k] = 0
    if grid is not None:
        zero_stats(grid)
    with FlopCounterMode(display=False) as fc, StorageTally() as tally:
        out = step(*args)
    res = storage_bytes(out)
    alias = sum(nb for k, nb in res.items() if k in arg)
    output = sum(res.values())
    temp = tally.peak - (output - alias)
    memory = {"argument_bytes": sum(arg.values()), "output_bytes": output,
              "temp_bytes": temp, "alias_bytes": alias,
              "peak_estimate_bytes": sum(arg.values()) + temp + output
              - alias}
    res = {"memory": memory, "flops_counted": int(fc.get_total_flops()),
           "kernel_flops": {**FA.META_FLOPS, **SSD.META_FLOPS}}
    if grid is not None:
        res["collectives"] = collectives(grid)
    return res


def apply_variant(cfg: ArchConfig, variant: str):
    """(cfg, remat) of a variant (the reference's); ``seqshard_kv``
    changes neither: it is the grid's cache layout (``step_and_inputs``'
    ``seq_shard_kv``)."""
    if variant == "baseline":
        return cfg, True
    if variant == "cf1":
        return dataclasses.replace(cfg, capacity_factor=1.0), True
    if variant == "remat_dots":
        return cfg, "dots"
    if variant == "swa_global":          # beyond-paper: window the attn layers
        return dataclasses.replace(cfg, sliding_window=4096), True
    if variant == "seqshard_kv":
        return cfg, True
    raise ValueError(f"unknown variant {variant!r}; one of {VARIANTS}")


def _realize(tree, dev, gen, vocab: int):
    """The meta tree's leaves as tensors of their own on ``dev``: meta
    ones materialized (``abstract_adapters``' client axis is an expanded
    view), real ones drawn from ``gen`` in their own dtype, with no
    temporary (ids in [0, vocab), floats N(0, 0.02²))."""
    def one(x):
        if dev.type == "meta":
            return torch.empty(x.shape, dtype=x.dtype, device=dev)
        if not x.is_floating_point():
            return torch.randint(0, vocab, x.shape, dtype=x.dtype,
                                 device=dev, generator=gen)
        return torch.randn(x.shape, dtype=x.dtype, device=dev,
                           generator=gen).mul_(0.02)
    return pt.tree_map(one, tree)


def _no_grad(fn):
    def step(*args):
        with torch.no_grad():
            return fn(*args)
    return step


def micro_batches(cfg: ArchConfig, shape: InputShape, n_data: int = 1):
    """A train step's micro-batches: the reference's pick for one
    client's ``global_batch / n_data`` rows."""
    return pick_micro_batches(cfg, shape.global_batch // n_data,
                              shape.seq_len)


def _cut(tree, specs, grid):
    return tree if grid is None else SP.shard_tree(tree, specs, grid)


def step_and_inputs(cfg: ArchConfig, shape: InputShape, *,
                    device="meta", seed: int = 0, micro_run=None,
                    remat=True, grid=None, seq_shard_kv=False):
    """(step, make_args): the shape's step and a function that builds
    its inputs on ``device`` (meta by default; on a real device the
    backbone from ``init_params`` and the rest drawn from ``seed``).  A
    serving step runs without a gradient.  A train step is one client's
    federated round (``n_clients`` 1) of ``micro`` micro-batches, run
    over its first ``micro_run`` micro-batches' rows (views of the
    global batch's storage).

    ``grid``: this rank's place on a grid (``make_meta_grid``, or a
    pool rank's ``Grid`` on the CPU or the card): the backbone and the
    decode cache are the rank's shards of the whole trees, built whole
    and cut (``shard_tree``); a train step is the production engine's on
    the grid, its client the rank's data index with ``global_batch /
    n_data`` rows; the serving steps take the whole batch, the decode
    step an encoder's output of the rank's rows.  ``seq_shard_kv``: the
    decode step on the grid's ``seq_shard_kv`` layout."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    n_data = 1 if grid is None else grid.data.size

    def realize(tree):
        return _realize(tree, dev, gen, cfg.vocab_size)

    def params():
        whole = (SP.abstract_params(cfg) if dev.type == "meta"
                 else M.init_params(gen, cfg, device=dev))
        return whole if grid is None else _cut(
            whole, SP.param_specs(cfg, grid, whole), grid)

    if shape.kind == "train":
        micro = micro_batches(cfg, shape, n_data)
        k = micro_run or micro
        step, opt_init = make_fed_train_step(
            cfg, make_client_mesh(1) if grid is None else grid,
            TrainSettings(micro_batches=k, remat=remat), device=dev)
        client = dataclasses.replace(shape,
                                     global_batch=shape.global_batch // n_data)

        def make_args():
            ad = realize(SP.abstract_adapters(cfg, n_clients=1))
            batch = realize(SP.train_batch_specs(cfg, client, 1))
            rows = batch["tokens"].shape[1] // micro * k
            batch = {n: v[:, :rows] for n, v in batch.items()}
            return (params(), ad, opt_init(ad), 0, batch)
        return step, make_args
    if shape.kind == "prefill":
        def make_args():
            return (params(), realize(SP.serve_batch_specs(cfg, shape)))
        return _no_grad(make_prefill_step(cfg, grid)), make_args

    a = SP.decode_specs(cfg, shape)
    mesh = grid
    if grid is not None and seq_shard_kv:
        mesh = grid.replace(seq_shard_kv=True, kv_len=a["cache_index"] + 1)

    def make_args():
        a = SP.decode_specs(cfg, shape)
        cache, enc = realize(a["cache"]), a.get("enc_out")
        if grid is not None:
            B = shape.global_batch
            cache = _cut(cache, SP.cache_specs(cfg, grid, cache, B,
                                               seq_shard_kv=seq_shard_kv),
                         grid)
            if enc is not None and B % n_data == 0:
                n = B // n_data
                enc = enc[grid.data.rank * n:(grid.data.rank + 1) * n]
        return (params(), realize(a["new_token"]), cache, a["cache_index"],
                None if enc is None else realize(enc))
    return _no_grad(make_decode_step(cfg, mesh)), make_args


def _affine(lo: dict, hi: dict, n: int, n_hi: int):
    """Every number of ``hi`` moved along the line through ``lo`` (at
    n_hi - 1) and ``hi`` (at n_hi) to n: integers stay integers."""
    if isinstance(hi, dict):
        return {k: _affine(lo[k], v, n, n_hi) for k, v in hi.items()}
    return hi + (n - n_hi) * (hi - lo)


def account(cfg: ArchConfig, shape: InputShape, remat=True, *, grid=None,
            seq_shard_kv=False) -> dict:
    """The meta run's fields of the record (``memory``, ``fits_80g``,
    ``cost_analysis``, ``trace_s``; a train step's ``n_clients``,
    ``micro_batches`` and ``micro_batches_run``: all of them, or 3 and 4
    past ``MICRO_RUN``, the account moved along their line; on a
    ``grid``, one rank's, with its ``collectives``)."""
    t0 = time.time()
    rec = {}
    kw = dict(remat=remat, grid=grid, seq_shard_kv=seq_shard_kv)
    if shape.kind == "train":
        n_data = 1 if grid is None else grid.data.size
        micro = micro_batches(cfg, shape, n_data)
        runs = [micro] if micro <= MICRO_RUN else [3, 4]
        res = []
        for k in runs:
            step, make_args = step_and_inputs(cfg, shape, micro_run=k, **kw)
            res.append(measure(step, make_args(), grid))
        res = (res[0] if len(res) == 1
               else _affine(res[0], res[1], micro, runs[1]))
        rec.update(n_clients=n_data, micro_batches=micro,
                   micro_batches_run=runs)
    else:
        step, make_args = step_and_inputs(cfg, shape, **kw)
        res = measure(step, make_args(), grid)
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["memory"] = res["memory"]
    rec["fits_80g"] = res["memory"]["peak_estimate_bytes"] < FITS_BYTES
    rec["cost_analysis"] = {"flops_counted": res["flops_counted"],
                            "kernel_flops": res["kernel_flops"],
                            "note": FLOPS_NOTE}
    if grid is not None:
        rec["collectives"] = res["collectives"]
    return rec


def analytic_record(cfg: ArchConfig, shape: InputShape, n_dev: int = 1,
                    coll_bytes_dev: float = 0) -> dict:
    """``params``, ``analytic`` and ``roofline``: the reference's fields
    and formulas at ``n_dev`` devices, the collective term from the bytes
    a device sends (0 on one card)."""
    fl = AN.analytic_step_flops(cfg, shape)
    pc = AN.param_counts(cfg, SP.abstract_params(cfg))
    cache_bytes = 0
    if shape.kind == "decode":
        cache = SP.abstract_cache(
            cfg, shape.global_batch,
            shape.seq_len // 2 if cfg.n_enc_layers else shape.seq_len)
        cache_bytes = pt.tree_bytes(cache)
    by = AN.analytic_step_bytes(cfg, shape, pc["n_params"], n_dev,
                                cache_bytes)
    terms = AN.roofline_terms(fl["flops_global"], by["hbm_bytes_dev"],
                              coll_bytes_dev, n_dev)
    # MODEL_FLOPS: body params see every token; the lm_head sees every
    # token only in training (serve computes last-position logits), and
    # the embedding gather is not FLOPs.
    head_p = cfg.d_model * cfg.vocab_size
    factor = 6 if shape.kind == "train" else 2
    head_tokens = fl["tokens"] if shape.kind == "train" \
        else shape.global_batch
    model_flops = factor * pc["n_active_body"] * fl["tokens"] \
        + factor * head_p * head_tokens
    return {
        "params": pc,
        "analytic": {**fl, **by, "cache_bytes_global": cache_bytes},
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "model_flops": model_flops,
            "useful_flops_ratio":
                model_flops / max(fl["flops_global"], 1.0),
        },
    }


def parse_grid(text) -> tuple[int, int] | None:
    """"NxM" → (N data, M model) ranks; None or "1" → one card."""
    if text in (None, "", "1"):
        return None
    n, m = (int(v) for v in str(text).lower().split("x"))
    return n, m


def mesh_name(grid) -> str:
    return "1" if grid is None else f"{grid[0]}x{grid[1]}"


def run_config(cfg: ArchConfig, shape: InputShape, *, arch: str,
               variant: str = "baseline", grid=None, rank: int = 0) -> dict:
    """The record of ``cfg`` (a variant already applied, or cut to a
    depth) at ``shape``: on one card, or on a ``grid`` of (N, M) ranks,
    rank ``rank``'s."""
    cfg, remat = apply_variant(cfg, variant)
    n_dev = 1 if grid is None else grid[0] * grid[1]
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh_name(grid),
                 "n_devices": n_dev, "variant": variant}
    meta = None if grid is None else make_meta_grid(*grid, rank=rank)
    if meta is not None:
        rec["rank"] = rank
    rec.update(account(cfg, shape, remat, grid=meta,
                       seq_shard_kv=variant == "seqshard_kv"
                       and meta is not None))
    coll = rec.get("collectives", {}).get("total", 0)
    rec.update(analytic_record(cfg, shape, n_dev, coll))
    return rec


def run_one(arch: str, shape_name: str, variant: str = "baseline",
            grid=None, rank: int = 0) -> dict:
    return run_config(get_config(arch), SHAPES[shape_name], arch=arch,
                      variant=variant, grid=grid, rank=rank)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--grid", default=None,
                    help="NxM: N data x M model ranks (default: one card)")
    ap.add_argument("--grids", default=None,
                    help="comma-separated grids, e.g. 1x4,2x2,4x1")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    grids = ([parse_grid(g) for g in args.grids.split(",")] if args.grids
             else [parse_grid(args.grid)])
    if args.all:
        pairs = [(a, s) for a in ARCH_IDS if a != "llama2-7b"  # paper target
                 for s in SHAPES if shape_supported(a, s)]
    else:
        pairs = [(args.arch, args.shape)]
    results = []
    for grid in grids:
        for arch, shape in pairs:
            tag = f"{arch}__{shape}__{mesh_name(grid)}"
            if args.variant != "baseline":
                tag += f"__{args.variant}"
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {tag}")
                continue
            print(f"[dryrun] {tag} ...", flush=True)
            try:
                rec = run_one(arch, shape, variant=args.variant, grid=grid)
                rec["status"] = "ok"
            except Exception as e:
                rec = {"arch": arch, "shape": shape,
                       "mesh": mesh_name(grid),
                       "n_devices": 1 if grid is None else grid[0] * grid[1],
                       "variant": args.variant, "status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
                print(rec["error"][:400])
            with open(path, "w") as f:
                json.dump(rec, f, indent=1, default=str)
            if rec["status"] == "ok":
                r = rec["roofline"]
                print(f"  ok: trace={rec['trace_s']}s "
                      f"mem={rec['memory']['peak_estimate_bytes']/1e9:.2f}GB "
                      f"terms(c/m/coll)={r['compute_s']:.2e}/"
                      f"{r['memory_s']:.2e}/{r['collective_s']:.2e} "
                      f"dom={r['dominant']}", flush=True)
            results.append(rec)
    return results


if __name__ == "__main__":
    main()
