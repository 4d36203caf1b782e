"""Multi-tenant personalized serving demo, one mixed batch (port of
``examples/serve_personalized.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_personalized \
        [--device cuda|cpu]

One frozen backbone + per-tenant DoRA-decomposed adapters where only the
ΔB_M magnitude vectors differ per tenant (the paper's local-optimizer
output, a few hundred *bytes* per tenant).  The AdapterStore pools the
magnitudes behind integer slots; the ServeEngine then serves N tenants
in ONE batch, the BGMV kernel (``bgmv_mag`` on the card) gathering each
row's adapter per token; the backbone is never merged with anybody's
adapter.  Tenants produce different continuations from identical
prompts while sharing every backbone byte, and the mixed batch must give
exactly the tokens of the merge-per-tenant loop (``merge_adapters`` +
``greedy_generate``), whose tokens/s it is printed beside.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import peft
from repro_torch.device import resolve_device
from repro_torch.launch.serve import greedy_generate, merge_adapters
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.serve import AdapterStore, ServeEngine
from repro_torch.utils.pytree import (filter_tree, tree_bytes,
                                      tree_map_with_path)

CFG = ArchConfig(name="serve-demo", family="dense", n_layers=4, d_model=256,
                 n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=1024,
                 dtype="float32", lora_rank=8, lora_dropout=0.0)

N_TENANTS = 6
PROMPT = 24
N_NEW = 8
CHUNK = 8               # the engine's decode chunk


def _tenant_variant(shared, tenant: int):
    """Per-tenant personalization = only the dB_mag leaves differ."""
    def vary(p, x):
        if not p.endswith("dB_mag"):
            return x
        ar = torch.arange(x.numel(), dtype=torch.float32, device=x.device)
        return x + 0.3 * (tenant + 1) * torch.sign(
            torch.sin(ar + tenant)).reshape(x.shape)
    return tree_map_with_path(vary, shared)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Run the demo; returns the two tokens/s figures and the timed
    engine run's counts (``ServeEngine.last_run``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    params = M.init_params(torch.Generator(device=dev).manual_seed(0), CFG,
                           device=dev)
    shared = peft.add_lora(params, CFG,
                           torch.Generator(device=dev).manual_seed(1),
                           decomposed=True)
    shared = tree_map_with_path(
        lambda p, x: x + 0.2 if p.endswith("B_mag") else x, shared)

    rng = np.random.default_rng(0)
    prompt = np.asarray(rng.integers(5, CFG.vocab_size, size=(PROMPT,)),
                        np.int32)

    store = AdapterStore(params, CFG, n_slots=N_TENANTS, kind="dora_mag",
                         shared=shared, device=dev)
    variants = {}
    for t in range(N_TENANTS):
        variants[t] = _tenant_variant(shared, t)
        store.register(f"tenant{t}", filter_tree(
            variants[t], lambda p: p.endswith("dB_mag")))

    print(f"backbone: {tree_bytes(params)/1e6:.1f} MB shared across tenants; "
          f"ΔB_M payload {store.bytes_per_tenant()} B/tenant")

    engine = ServeEngine(params, CFG, store, max_rows=N_TENANTS,
                         max_prompt_len=PROMPT,
                         max_len=PROMPT + N_NEW + 8, decode_chunk=CHUNK,
                         device=dev)
    # every tenant gets the SAME prompt: one mixed batch, N tenants
    reqs = [(f"tenant{t}", prompt) for t in range(N_TENANTS)]
    outs = engine.generate(reqs, n_new=N_NEW)       # also builds kernels
    for t, out in enumerate(outs):
        print(f"tenant {t}: mixed-batch continuation: {out.tolist()}")

    # naive path: merge each tenant's adapter into the backbone, generate
    # one tenant at a time
    def naive():
        outs = []
        for t in range(N_TENANTS):
            merged = merge_adapters(params, variants[t])
            out = greedy_generate(merged, {"tokens": prompt[None]}, CFG,
                                  n_new=N_NEW, device=dev)
            outs.append(out[0].cpu().numpy())
        return outs

    naive_outs = naive()
    for t in range(N_TENANTS):
        if not np.array_equal(outs[t], naive_outs[t]):
            raise AssertionError(
                f"tenant {t}: mixed batch {outs[t].tolist()} != merged "
                f"{naive_outs[t].tolist()}")
    _sync(dev)
    t0 = time.perf_counter()
    engine.generate(reqs, n_new=N_NEW)
    t_mixed = time.perf_counter() - t0
    _sync(dev)
    t0 = time.perf_counter()
    naive()
    t_naive = time.perf_counter() - t0
    tok = N_TENANTS * N_NEW
    print(f"one mixed batch : {tok/t_mixed:8.1f} tok/s")
    print(f"merge-per-tenant: {tok/t_naive:8.1f} tok/s "
          f"(same tokens, bit-identical — {t_naive/t_mixed:.1f}x slower)")
    return {"mixed_tokens_per_s": tok / t_mixed,
            "merged_tokens_per_s": tok / t_naive,
            "last_run": engine.last_run}


if __name__ == "__main__":
    main()
