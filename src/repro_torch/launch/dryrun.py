"""The one-card dry run: account every (architecture × input shape) pair
by running its step once on ``device="meta"`` tensors, allocating nothing
(port of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k [--variant cf1] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

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

A train step of more than ``MICRO_RUN`` micro-batches runs at 3 and 4
micro-batches of the same rows: from the third micro-batch on, each
makes the same allocations while the same tensors are live (the f32
accumulator and the previous micro-batch's gradient and its f32 copy;
in the second, that copy is the accumulator) and keeps one more set of
0-d metrics, so every number of the account is affine in the
micro-batch count from 3 on, and the two runs fix the line
(``micro_batches_run`` says which counts ran).  At train_4k one client
takes 256 micro-batches, and a run of each would take tens of minutes.

No counterpart here: the HLO archive, ``collectives``, ``hlo_lines``,
``lower_s`` / ``compile_s`` and ``--multipod`` (one card has no mesh and
compiles nothing), and the ``seqshard_kv`` variant (a cache sharding
over a mesh axis), which raises.  The dry run never touches CUDA: it runs
the same on a host with no card.
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
from repro_torch.launch.mesh import make_client_mesh
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


def measure(step, args) -> dict:
    """Run ``step(*args)`` once under the tally and FlopCounterMode (the
    inputs built before, on any device).  Returns the memory account,
    the counted and the kernels' FLOPs."""
    arg = storage_bytes(args)
    for flops in (FA.META_FLOPS, SSD.META_FLOPS):
        for k in flops:
            flops[k] = 0
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
    return {"memory": memory, "flops_counted": int(fc.get_total_flops()),
            "kernel_flops": {**FA.META_FLOPS, **SSD.META_FLOPS}}


def apply_variant(cfg: ArchConfig, variant: str):
    """(cfg, remat) of a variant: the reference's, but ``seqshard_kv``."""
    if variant == "baseline":
        return cfg, True
    if variant == "cf1":
        return dataclasses.replace(cfg, capacity_factor=1.0), True
    if variant == "remat_dots":
        return cfg, "dots"
    if variant == "swa_global":          # beyond-paper: window the attn layers
        return dataclasses.replace(cfg, sliding_window=4096), True
    if variant == "seqshard_kv":
        raise ValueError("variant seqshard_kv shards the KV cache's sequence "
                         "over a mesh axis; one card has no mesh")
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


def step_and_inputs(cfg: ArchConfig, shape: InputShape, *,
                    device="meta", seed: int = 0, micro_run=None,
                    remat=True):
    """(step, make_args): the shape's step and a function that builds
    its inputs on ``device`` (meta by default; on a real device the
    backbone from ``init_params`` and the rest drawn from ``seed``).  A
    serving step runs without a gradient.  A train step is one client's
    federated round (``n_clients`` 1) of ``micro`` micro-batches, run
    over its first ``micro_run`` micro-batches' rows (views of the
    global batch's storage)."""
    dev = resolve_device(device)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))

    def realize(tree):
        return _realize(tree, dev, gen, cfg.vocab_size)

    def params():
        return (SP.abstract_params(cfg) if dev.type == "meta"
                else M.init_params(gen, cfg, device=dev))

    if shape.kind == "train":
        micro = pick_micro_batches(cfg, shape.global_batch, shape.seq_len)
        k = micro_run or micro
        step, opt_init = make_fed_train_step(
            cfg, make_client_mesh(1),
            TrainSettings(micro_batches=k, remat=remat), device=dev)

        def make_args():
            ad = realize(SP.abstract_adapters(cfg, n_clients=1))
            batch = realize(SP.train_batch_specs(cfg, shape, 1))
            rows = batch["tokens"].shape[1] // micro * k
            batch = {n: v[:, :rows] for n, v in batch.items()}
            return (params(), ad, opt_init(ad), 0, batch)
        return step, make_args
    if shape.kind == "prefill":
        def make_args():
            return (params(), realize(SP.serve_batch_specs(cfg, shape)))
        return _no_grad(make_prefill_step(cfg)), make_args

    def make_args():
        a = SP.decode_specs(cfg, shape)
        enc = a.get("enc_out")
        return (params(), realize(a["new_token"]), realize(a["cache"]),
                a["cache_index"], None if enc is None else realize(enc))
    return _no_grad(make_decode_step(cfg)), make_args


def _affine(lo: dict, hi: dict, n: int, n_hi: int):
    """Every number of ``hi`` moved along the line through ``lo`` (at
    n_hi - 1) and ``hi`` (at n_hi) to n: integers stay integers."""
    if isinstance(hi, dict):
        return {k: _affine(lo[k], v, n, n_hi) for k, v in hi.items()}
    return hi + (n - n_hi) * (hi - lo)


def account(cfg: ArchConfig, shape: InputShape, remat=True) -> dict:
    """The meta run's fields of the record (``memory``, ``fits_80g``,
    ``cost_analysis``, ``trace_s``; a train step's ``n_clients``,
    ``micro_batches`` and ``micro_batches_run``: all of them, or 3 and 4
    past ``MICRO_RUN``, the account moved along their line)."""
    t0 = time.time()
    rec = {}
    if shape.kind == "train":
        micro = pick_micro_batches(cfg, shape.global_batch, shape.seq_len)
        runs = [micro] if micro <= MICRO_RUN else [3, 4]
        res = []
        for k in runs:
            step, make_args = step_and_inputs(cfg, shape, micro_run=k,
                                              remat=remat)
            res.append(measure(step, make_args()))
        res = (res[0] if len(res) == 1
               else _affine(res[0], res[1], micro, runs[1]))
        rec.update(n_clients=1, micro_batches=micro, micro_batches_run=runs)
    else:
        step, make_args = step_and_inputs(cfg, shape)
        res = measure(step, make_args())
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["memory"] = res["memory"]
    rec["fits_80g"] = res["memory"]["peak_estimate_bytes"] < FITS_BYTES
    rec["cost_analysis"] = {"flops_counted": res["flops_counted"],
                            "kernel_flops": res["kernel_flops"],
                            "note": FLOPS_NOTE}
    return rec


def analytic_record(cfg: ArchConfig, shape: InputShape) -> dict:
    """``params``, ``analytic`` and ``roofline``: the reference's fields
    and formulas at n_dev = 1 with no collective bytes."""
    fl = AN.analytic_step_flops(cfg, shape)
    pc = AN.param_counts(cfg, SP.abstract_params(cfg))
    cache_bytes = 0
    if shape.kind == "decode":
        cache = SP.abstract_cache(
            cfg, shape.global_batch,
            shape.seq_len // 2 if cfg.n_enc_layers else shape.seq_len)
        cache_bytes = pt.tree_bytes(cache)
    by = AN.analytic_step_bytes(cfg, shape, pc["n_params"], 1, cache_bytes)
    terms = AN.roofline_terms(fl["flops_global"], by["hbm_bytes_dev"], 0, 1)
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


def run_config(cfg: ArchConfig, shape: InputShape, *, arch: str,
               variant: str = "baseline") -> dict:
    """The record of ``cfg`` (a variant already applied, or cut to a
    depth) at ``shape``."""
    cfg, remat = apply_variant(cfg, variant)
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": "1",
                 "n_devices": 1, "variant": variant}
    rec.update(account(cfg, shape, remat))
    rec.update(analytic_record(cfg, shape))
    return rec


def run_one(arch: str, shape_name: str, variant: str = "baseline") -> dict:
    return run_config(get_config(arch), SHAPES[shape_name], arch=arch,
                      variant=variant)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        combos = [(a, s) for a in ARCH_IDS if a != "llama2-7b"  # paper target
                  for s in SHAPES if shape_supported(a, s)]
    else:
        combos = [(args.arch, args.shape)]
    results = []
    for arch, shape in combos:
        tag = f"{arch}__{shape}__1"
        if args.variant != "baseline":
            tag += f"__{args.variant}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_existing and os.path.exists(path):
            print(f"[skip] {tag}")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            rec = run_one(arch, shape, variant=args.variant)
            rec["status"] = "ok"
        except Exception as e:
            rec = {"arch": arch, "shape": shape, "mesh": "1",
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
                  f"terms(c/m)={r['compute_s']:.2e}/{r['memory_s']:.2e} "
                  f"dom={r['dominant']}", flush=True)
        results.append(rec)
    return results


if __name__ == "__main__":
    main()
