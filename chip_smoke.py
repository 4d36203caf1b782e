#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phase 1  the card's name and power limit; builds every CUDA kernel from
         the checkout's sources (one nvcc per source, started together).
Phase 2  each kernel against its plain PyTorch version on the card at
         llama2-7b widths (d_in = d_out = 4096, r 8 and 16, 9 pool slots,
         f32 and bf16; decode rows, prefill blocks, an odd S, repeated
         slots, mixed ranks with rank-0 slots that must give exactly 0),
         and its time beside the plain version's, one library call's and
         the bound (bytes over 3.35 TB/s or operations over the peak):
         each replayed from a CUDA graph (device time) and issued eagerly.
Phase 3  the main path at full width: llama2-7b, 32 layers, bf16, random
         weights from a seeded generator on the card.  AdapterStore
         (dora_mag, 6 tenants at ranks 2/4/8 + the null tenant) →
         ServeEngine (8 rows, prompts of 16-64 tokens, 32 new tokens, 12
         requests), then the same with a pairs store of raw-LoRA tenants.
         Each run starts with every launch count at 0 and must launch its
         kernel 2 targets × 32 layers × (prefills + decode steps) times.
         Prefill logits of one admitted batch, kernel against plain, at
         2e-2: bf16 weights through the first CHECK_DEPTH layers, f32
         weights through all 32.

Prints a JSON ``kernels`` line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result line, when there is no CUDA device, outside a checkout, or when
any check fails.  Imports nothing of JAX.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # relative to max |plain output|
HBM_BYTES_PER_S = 3.35e12                   # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
D, R_MAIN, L_SLOTS = 4096, 8, 9
N_NEW, PAD_W, MAX_LEN, ROWS, CHUNK = 32, 64, 128, 8, 8
CHECK_DEPTH = 2         # layers through which bf16 prefill logits are held
DEPTHS = (1, 2, 4, 8, 16, 32)   # depths at which they are read


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)
    print(f"ok: {msg}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(torch, B, S, r, dtype, seed):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device="cuda")

    shape = (B, D) if S is None else (B, S, D)
    ranks = [r, r // 2, 0, 1, r, 2, r - 1, 3, 0]        # slot 8 = null
    return dict(
        x=t(rng.normal(size=shape), dtype),
        a_pool=t(rng.normal(size=(L_SLOTS, D, r)) / np.sqrt(D)),
        b_pool=t(rng.normal(size=(L_SLOTS, r, D)) / np.sqrt(r)),
        a_dir=t(rng.normal(size=(D, r)) / np.sqrt(D)),
        a_mag=t(rng.uniform(0.5, 1.5, size=(D,))),
        b_mag=t(rng.normal(size=(r,))),
        dmag=t(rng.normal(size=(L_SLOTS, r))),
        b_dir=t(rng.normal(size=(r, D)) / np.sqrt(r)),
        # repeated slots and rank-0 slots (2 and the null slot 8)
        idx=t([0, 2, 4, 4, 8, 1, 6, 6][:B], torch.int32),
        ranks=t(ranks, torch.int32))


def call(kind, v, impl, ranked, scale=4.0):
    from repro_torch.kernels import bgmv, bgmv_mag
    ranks = v["ranks"] if ranked else None
    if kind == "bgmv":
        return bgmv(v["x"], v["a_pool"], v["b_pool"], v["idx"], scale=scale,
                    ranks=ranks, impl=impl)
    return bgmv_mag(v["x"], v["a_dir"], v["a_mag"], v["b_mag"], v["dmag"],
                    v["b_dir"], v["idx"], scale=scale, ranks=ranks, impl=impl)


def library_call(torch, kind, v, scale=4.0):
    """One composite of PyTorch calls for the same ranked function (gather,
    two batched products, the rank mask on h): a yardstick only, never
    called by the port."""
    x = v["x"] if v["x"].dim() == 3 else v["x"][:, None]
    dt, idx = x.dtype, v["idx"]
    cols = torch.arange(v["a_dir"].shape[1], device=x.device)

    def keep(gi):                                           # (B, 1, r)
        return (cols < v["ranks"][gi][:, None]).to(dt)[:, None]

    def pairs():
        gi = idx.long()
        return torch.bmm(torch.bmm(x, v["a_pool"][gi].to(dt)) * keep(gi),
                         v["b_pool"][gi].to(dt)) * scale

    def mag():
        gi = idx.long()
        m = (v["b_mag"] + v["dmag"][gi])[:, None].to(dt) * keep(gi)
        return torch.matmul(torch.matmul(x * v["a_mag"].to(dt),
                                         v["a_dir"].to(dt)) * m,
                            v["b_dir"].to(dt)) * scale
    return pairs if kind == "bgmv" else mag


def rel_err(y, ref):
    diff = (y.float() - ref.float()).abs().max()
    return (diff / ref.float().abs().max().clamp_min(1e-30)).item(), diff.item()


def time_ms(torch, fn, side, reps=5, iters=200, warmup=20):
    """Per-call ms of ``fn``: {"graph": ..., "eager": ...}, each a median
    and [min, max] over ``reps`` CUDA-event timings of ``iters`` calls.
    "graph" replays the calls from one CUDA graph captured on stream
    ``side``, so it is the device's time with the host taken out; "eager"
    issues them back to back from Python, which is what an eager caller
    such as the engine pays."""
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()

    def eager():
        for _ in range(iters):
            fn()

    out = {}
    for name, run in (("graph", graph.replay), ("eager", eager)):
        run()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / iters)
        out[name] = (statistics.median(ts), [min(ts), max(ts)])
    del graph
    return out


def bound(kind, v, dtype_name):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    (each input read once, each output written once; pool factors of the
    slots this idx touches) over HBM and its operations over the peak."""
    x = v["x"]
    BS = x.numel() // D
    es = x.element_size()
    r = v["a_dir"].shape[1]
    slots = len(set(v["idx"].tolist()))
    nbytes = 2 * x.numel() * es + 4 * (v["idx"].numel() + v["ranks"].numel())
    ops = 2 * BS * r * (D + D)
    if kind == "bgmv":
        nbytes += 4 * slots * (D * r + r * D)
    else:
        nbytes += 4 * (D * r + D + r + r * D + slots * r)
        ops += BS * (D + r)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch):
    worst = {}
    for kind in ("bgmv", "bgmv_mag"):
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            for r in (8, 16):
                for B, S in ((8, None), (8, 64), (8, 37)):
                    v = kernel_inputs(torch, B, S, r, dtype, seed=r + (S or 0))
                    for ranked in (False, True):
                        y = call(kind, v, None, ranked)
                        ref = call(kind, v, "torch", ranked)
                        torch.cuda.synchronize()
                        rel, _ = rel_err(y, ref)
                        case = (f"{kind} {dn} r={r} x{tuple(v['x'].shape)} "
                                f"{'ranked' if ranked else 'full'}")
                        check(y.shape == ref.shape and bool(
                            torch.isfinite(y.float()).all()), f"{case} shape")
                        check(rel <= TOL[dn], f"{case} rel err {rel:.3e} <= "
                              f"{TOL[dn]}")
                        if ranked:
                            zero = (v["ranks"][v["idx"].long()] == 0)
                            check(bool((y[zero] == 0).all()),
                                  f"{case} rank-0 rows exactly 0")
                        worst[(kind, dn)] = max(worst.get((kind, dn), 0), rel)
    print("worst relative error by kernel and dtype: "
          + json.dumps({f"{k} {d}": e for (k, d), e in worst.items()}))

    rows = {}
    # One capture stream for all timings: cuBLAS keeps a workspace for
    # each stream it runs on, cleared below.
    side = torch.cuda.Stream()
    for kind in ("bgmv", "bgmv_mag"):
        rows[kind] = {}
        for label, S in (("decode", None), ("prefill", PAD_W)):
            v = kernel_inputs(torch, ROWS, S, R_MAIN, torch.bfloat16, seed=7)
            y = call(kind, v, None, True)
            ref = call(kind, v, "torch", True)
            rel, err = rel_err(y, ref)
            b_ms, b_by = bound(kind, v, "bfloat16")
            lib = library_call(torch, kind, v)
            lib_rel = rel_err(lib().reshape(ref.shape), ref)[0]
            check(lib_rel <= TOL["bfloat16"], f"{kind} {label} library "
                  f"yardstick vs plain {lib_rel:.3e} <= {TOL['bfloat16']}")
            row = {"x": list(v["x"].shape), "max_abs_err": err,
                   "rel_err": rel, "tolerance": TOL["bfloat16"]}
            for key, fn in (
                    ("ms", lambda: call(kind, v, None, True)),
                    ("plain_ms", lambda: call(kind, v, "torch", True)),
                    ("library_ms", lib)):
                t = time_ms(torch, fn, side)
                row[key], row[key + "_range"] = t["graph"]
                row["eager_" + key], row["eager_" + key + "_range"] = t["eager"]
            rows[kind][label] = dict(row, bound_ms=b_ms, bound_by=b_by)
            print(f"{kind} {label} x{tuple(v['x'].shape)} bf16 r={R_MAIN}: "
                  + json.dumps(rows[kind][label]))
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()  # so the engine's peak is its own
    return rows


# ---------------------------------------------------------------------------
# phase 3: the main path at full width
# ---------------------------------------------------------------------------

def requests(rng, tenants, vocab):
    """12 requests: the first 7 share one prompt (6 tenants + the null
    tenant), the rest have prompts of 16-64 tokens."""
    shared = rng.integers(0, vocab, size=48).astype(np.int32)
    reqs = [(t, shared) for t in tenants] + [(None, shared)]
    for i in range(12 - len(reqs)):
        n = int(rng.integers(16, PAD_W + 1))
        reqs.append((tenants[i % len(tenants)],
                     rng.integers(0, vocab, size=n).astype(np.int32)))
    return reqs


def serve(torch, params, cfg, store, reqs, *, count):
    from repro_torch.kernels.batched_lora import bgmv as K
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(params, cfg, store, max_rows=ROWS, max_prompt_len=PAD_W,
                      max_len=MAX_LEN, decode_chunk=CHUNK, device="cuda")
    torch.cuda.synchronize()
    K.reset_launches()
    rids = [eng.submit(t, p, N_NEW) for t, p in reqs]
    results = eng.run()
    launches = dict(K.LAUNCHES)
    st = eng.last_run
    expected = 2 * cfg.n_layers * (st["prefills"] + st["decode_steps"])
    check(len(results) == len(reqs) and all(
        results[r].shape == (N_NEW,) for r in rids),
        f"{store.kind}: {len(reqs)} requests returned {N_NEW} tokens each")
    if count:
        other = "bgmv" if count == "bgmv_mag" else "bgmv_mag"
        check(launches[count] == expected and launches[other] == 0,
              f"{store.kind}: {count} launched {launches[count]} times = "
              f"2 x {cfg.n_layers} x ({st['prefills']} prefills + "
              f"{st['decode_steps']} decode steps); {other} 0")
    return [results[r] for r in rids], st, launches


def prefill_logits(torch, params, cfg, store, reqs):
    """Prefill logits of one admitted batch (the first 8 requests, full
    width) through the kernel and through the plain version.

    Both checks use the fixed bf16 tolerance: with the bf16 weights, the
    model cut to its first CHECK_DEPTH layers (the same weights and head);
    with the weights cast to f32, all 32 layers.  The bf16 kernel rounds
    the adapter path at other points than the plain version (PERF.md),
    and a random bf16 network amplifies a rounding difference with depth
    as it amplifies bf16 arithmetic itself, so the bf16 readings at each
    depth in DEPTHS are printed beside plain bf16 against plain f32."""
    from repro_torch.models import model as M
    from repro_torch.utils import pytree as pt
    tokens = np.zeros((ROWS, PAD_W), np.int32)
    lens = np.ones((ROWS,), np.int64)
    slots = np.zeros((ROWS,), np.int32)
    for i, (t, p) in enumerate(reqs[:ROWS]):
        tokens[i, :p.size], lens[i] = p, p.size
        slots[i] = store.null_slot if t is None else store.slot_of(t)
    batch = {"tokens": torch.as_tensor(tokens, device="cuda"),
             "adapter_idx": torch.as_tensor(slots, device="cuda")}
    ar = torch.arange(ROWS, device="cuda")
    last = torch.as_tensor(lens - 1, device="cuda")
    bf16 = pt.merge_trees(params, store.overlay())
    f32 = pt.tree_map(lambda t: t.float() if t.is_floating_point() else t,
                      bf16)

    def logits(tree, depth, impl):
        cut = dict(tree, blocks=pt.tree_map(lambda t: t[:depth],
                                            tree["blocks"]))
        h, _, _ = M.forward(cut, batch, cfg, bgmv_impl=impl)
        return (h[ar, last] @ M._head_kernel(tree, cfg).to(h.dtype)).float()

    by_depth = {}
    for d in DEPTHS:
        plain = logits(bf16, d, "torch")
        by_depth[d] = {
            "kernel_vs_plain_bf16": rel_err(logits(bf16, d, "cuda"), plain)[0],
            "plain_bf16_vs_f32": rel_err(plain, logits(f32, d, "torch"))[0]}
    n = cfg.n_layers
    f32_err = rel_err(logits(f32, n, "cuda"), logits(f32, n, "torch"))[0]
    del f32
    print("prefill logits, relative to max |logit|, by depth: "
          + json.dumps(by_depth))
    tol = TOL["bfloat16"]
    check(f32_err <= tol, f"prefill logits, {n} layers, f32 weights, kernel "
          f"vs plain: {f32_err:.3e} <= {tol}")
    err = by_depth[CHECK_DEPTH]["kernel_vs_plain_bf16"]
    check(err <= tol, f"prefill logits, {CHECK_DEPTH} layers, bf16 weights, "
          f"kernel vs plain: {err:.3e} <= {tol}")
    return {"kernel_vs_plain_f32": f32_err, "by_depth": by_depth}


def profile_run(torch, params, cfg, store, reqs):
    """Device busy share of one prefill + one decode chunk of the engine
    (8 rows), from torch.profiler's kernel events; the profiler's own
    host cost inflates the wall time, so the share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(params, cfg, store, max_rows=ROWS, max_prompt_len=PAD_W,
                      max_len=MAX_LEN, decode_chunk=CHUNK, device="cuda")
    for t, p in reqs[:ROWS]:
        eng.submit(t, p, CHUNK + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run()
    st = eng.last_run
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": 1e3 * st["wall_seconds"], "device_busy_ms": busy_ms,
           "busy_share": busy_ms / (1e3 * st["wall_seconds"]),
           "prefill_ms": 1e3 * st["prefill_seconds"][0],
           "decode_chunk_ms": 1e3 * st["chunk_seconds"][0],
           "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top}}
    print("profile (1 prefill + 1 decode chunk, 8 rows): " + json.dumps(out))
    return out


def engine_report(store, st):
    out = {"kind": store.kind, "requests": 12, "tokens": st["tokens"],
           "wall_s": st["wall_seconds"],
           "tokens_per_s": st["tokens"] / st["wall_seconds"],
           "prefills": st["prefills"], "decode_steps": st["decode_steps"],
           "prefill_ms": [1e3 * s for s in st["prefill_seconds"]],
           "decode_chunk_ms": [1e3 * s for s in st["chunk_seconds"]]}
    print(f"engine {store.kind}: " + json.dumps(out))
    return out


def phase_main_path(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.dora import magnitude
    from repro_torch.core.peft import add_lora
    from repro_torch.models import model as M
    from repro_torch.serve import AdapterStore
    from repro_torch.utils import pytree as pt

    cfg = get_config("llama2-7b")
    g = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = M.init_params(g, cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"llama2-7b params drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    ranks = [2, 4, 8, 2, 4, 8]
    tenants = [f"tenant{i}" for i in range(len(ranks))]

    # --- dora_mag: shared decomposed adapter, per-tenant raw ΔB_M ---------
    # add_lora's decomposed init has B_mag = 0.  B_mag is set to the
    # magnitudes of its raw-LoRA B init instead (the pairs tenants' below),
    # so the two stores' adapters have one size; each tenant's ΔB_M moves
    # every magnitude by N(0, 1) times itself, up to the tenant's rank.
    raw = add_lora(params, cfg, g)
    shared = pt.tree_map_with_path(
        lambda p, x: (magnitude(pt.tree_get(raw, p[:-len("B_mag")]
                                            + "lora_B"))
                      if p.endswith("/B_mag") else x),
        add_lora(params, cfg, g, decomposed=True))
    del raw
    mag = AdapterStore(params, cfg, n_slots=8, kind="dora_mag", shared=shared,
                       device="cuda")
    for t, r in zip(tenants, ranks):
        delta = pt.tree_map_with_path(
            lambda p, x: pt.tree_get(shared, p[:-len("dB_mag")] + "B_mag")
            * torch.as_tensor(rng.normal(size=tuple(x.shape))
                              * (np.arange(x.shape[-1]) < r),
                              dtype=torch.float32, device="cuda"),
            pt.filter_tree(shared, lambda p: p.endswith("dB_mag")))
        mag.register(t, delta, rank=r)
    reqs = requests(rng, tenants, cfg.vocab_size)

    serve(torch, params, cfg, mag, reqs[:2], count=None)         # warm-up
    torch.cuda.reset_peak_memory_stats()
    outs, st, launches_mag = serve(torch, params, cfg, mag, reqs,
                                   count="bgmv_mag")
    peak_mag = torch.cuda.max_memory_allocated()
    first = [tuple(o.tolist()) for o in outs[:len(tenants) + 1]]
    check(len(set(first)) >= 2, f"dora_mag: {len(set(first))} distinct "
          f"continuations of one prompt over 6 tenants + the null tenant")
    report = {"dora_mag": engine_report(mag, st)}
    report["dora_mag"]["peak_bytes"] = peak_mag

    report["dora_mag"]["prefill_logits"] = prefill_logits(
        torch, params, cfg, mag, reqs)
    report["dora_mag"]["profile"] = profile_run(torch, params, cfg, mag, reqs)
    del mag, shared

    # --- pairs: raw-LoRA tenants at their own ranks (add_lora's init) ----
    pairs = AdapterStore(params, cfg, n_slots=8, kind="pairs", rank=R_MAIN,
                         device="cuda")
    for t, r in zip(tenants, ranks):
        pairs.register(t, add_lora(params, cfg, g, rank=r))
    torch.cuda.reset_peak_memory_stats()
    outs, st, launches_pairs = serve(torch, params, cfg, pairs, reqs,
                                     count="bgmv")
    first = [tuple(o.tolist()) for o in outs[:len(tenants) + 1]]
    check(len(set(first)) >= 2, f"pairs: {len(set(first))} distinct "
          f"continuations of one prompt over 6 tenants + the null tenant")
    report["pairs"] = engine_report(pairs, st)
    report["pairs"]["peak_bytes"] = torch.cuda.max_memory_allocated()
    launches = {"bgmv_mag": launches_mag["bgmv_mag"],
                "bgmv": launches_pairs["bgmv"]}
    return report, launches


def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print(f"FAIL: {ROOT} is not a checkout of the repository "
              f"(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    try:
        t0 = time.perf_counter()
        libs = _build.build_all()
        print(f"built {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
        for name in libs:
            print(f"--- nvcc log {name} ---\n"
                  + _build.log_path(name).read_text().strip())
        rows = phase_kernels(torch)
        report, launches = phase_main_path(torch)
    except CheckFailed as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    src = "src/repro_torch/kernels/batched_lora/csrc/bgmv.cu"
    replaces = {"bgmv": "src/repro/kernels/batched_lora/bgmv.py:134",
                "bgmv_mag": "src/repro/kernels/batched_lora/bgmv.py:223"}
    kernels = []
    for name in ("bgmv_mag", "bgmv"):
        dec = rows[name]["decode"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": dec["max_abs_err"], "rel_err": dec["rel_err"],
            "tolerance": dec["tolerance"], "shape": "x (8, 4096) bf16, r 8, "
            "9 slots, ranked (the decode step)",
            "ms": dec["ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "library_ms": dec["library_ms"],
            "eager_ms": dec["eager_ms"],
            "ranges_ms": {k: dec[k + "_range"] for k in
                          ("ms", "plain_ms", "library_ms", "eager_ms",
                           "eager_plain_ms", "eager_library_ms")},
            "prefill": {k: rows[name]["prefill"][k] for k in
                        ("x", "ms", "plain_ms", "library_ms", "bound_ms",
                         "eager_ms")}})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"engine": report}))
    print(f"gpu: {gpu}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
