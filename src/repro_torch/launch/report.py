"""Render the §Dry-run, §Roofline and §Telemetry sections from the dry
run's JSON records (``launch/dryrun.py``) and the obs event log (port of
``repro/launch/report.py``).

    PYTHONPATH=src python -m repro_torch.launch.report > experiments/roofline.md

``REPRO_DRYRUN_DIR`` names the records' directory (default
experiments/dryrun_torch, where the dry run writes them); a telemetry
JSONL path in ``REPRO_TELEMETRY`` appends §Telemetry.  A record is one
card's or one rank's of a grid (its ``mesh``, "1" or "NxM"): §Dry-run
has a mesh column, "fits 80G" and the rank's collective bytes; §Roofline
reads the records on the most cards there are (the 4-card grids, where
the reference's reads its 16 x 16 mesh), at the H100's constants and its
NVLink rate (``launch/analysis.py``); §Grids puts each pair's grids side
by side (a rank's peak, whether it fits, the three terms).
``telemetry_section`` renders the same text as the reference's for the
same events.
"""
from __future__ import annotations

import glob
import json
import os
from collections import defaultdict

from repro_torch.launch import analysis as AN

DRYRUN_DIR = os.environ.get("REPRO_DRYRUN_DIR", "experiments/dryrun_torch")
TELEMETRY = os.environ.get("REPRO_TELEMETRY", "")


def load() -> list[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(DRYRUN_DIR, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def fmt_bytes(b):
    return f"{b/1e9:.2f} GB"


def _name(r) -> str:
    return r["arch"] + ("" if r.get("variant", "baseline") == "baseline"
                        else f" +{r['variant']}")


def _n_dev(r) -> int:
    return int(r.get("n_devices", 1))


def _top_collectives(r) -> str:
    """The record's two largest (group, op) byte counts."""
    colls = r.get("collectives") or {}
    ops = [(f"{g}/{op}", v["bytes"]) for g in ("data", "model")
           for op, v in colls.get(g, {}).items()]
    ops.sort(key=lambda kv: -kv[1])
    return ", ".join(f"{k}:{b/1e9:.2f}GB" for k, b in ops[:2])


def dryrun_section(recs) -> str:
    out = ["## §Dry-run", "",
           "Per (arch × shape × mesh): status, one rank's memory from its "
           "step run on meta tensors (launch/dryrun.py: inputs, "
           "temporaries, the reference's peak estimate; on a grid the "
           "rank's shard and what its collectives send) and the FLOPs "
           "counted there.", "",
           "| arch | shape | mesh | status | args | temps | peak estimate | "
           "fits 80G | collective bytes/step (rank) | top collectives | "
           "counted TFLOPs (matmuls + kernels) |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | {r.get('mesh', '1')} "
                       f"| ERROR: {str(r.get('error'))[:60]} | | | | | | | |")
            continue
        m, ca = r["memory"], r["cost_analysis"]
        counted = ca["flops_counted"] + sum(ca["kernel_flops"].values())
        coll = (r.get("collectives") or {}).get("total", 0)
        out.append(
            f"| {_name(r)} | {r['shape']} | {r['mesh']} | ok "
            f"({r['trace_s']}s) | {fmt_bytes(m['argument_bytes'])} | "
            f"{fmt_bytes(m['temp_bytes'])} | "
            f"{fmt_bytes(m['peak_estimate_bytes'])} | "
            f"{'yes' if r['fits_80g'] else '**NO**'} | "
            f"{fmt_bytes(coll)} | {_top_collectives(r)} | "
            f"{counted / 1e12:.1f} |")
    return "\n".join(out)


def roofline_section(recs) -> str:
    """The roofline of the records on the most cards there are (the 4-card
    grids when their records are there, as the reference's reads its
    16 x 16 mesh; else one card's)."""
    ok = [r for r in recs if r.get("status") == "ok"]
    n = max((_n_dev(r) for r in ok), default=1)
    out = [f"## §Roofline ({n} H100{'s' if n > 1 else ''}, "
           f"{AN.PEAK_FLOPS:.3g} FLOP/s bf16, {AN.HBM_BW:.3g} B/s, "
           f"NVLink {AN.NVLINK_BW:.3g} B/s)", "",
           f"Terms in seconds/step — compute = analytic FLOPs/dev ÷ "
           f"{AN.PEAK_FLOPS:.3g}; memory = modeled HBM bytes/dev ÷ "
           f"{AN.HBM_BW:.3g}; collective = the bytes a rank sends ÷ "
           f"{AN.NVLINK_BW:.3g} (0 on one card).  `useful` = MODEL_FLOPS "
           "(6·N_active·tokens train / 2·N·tokens serve) ÷ total analytic "
           "FLOPs.", "",
           "| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | useful | what would move the dominant term |",
           "|---|---|---|---|---|---|---|---|---|"]
    advice = {
        ("compute", "train"): "lower remat factor (3× fwd), fewer "
                              "recomputed passes",
        ("compute", "prefill"): "flash-kernel tensor-core util / larger "
                                "tiles",
        ("compute", "decode"): "batch more requests per step",
        ("memory", "train"): "re-use param reads across micro-batches",
        ("memory", "prefill"): "KV-cache write coalescing, bf16 cache",
        ("memory", "decode"): "weight/cache quantization, larger batch to "
                              "amortize weight reads",
        ("collective", "train"): "overlap the model row's all-reduces "
                                 "with compute; bf16 payloads",
        ("collective", "prefill"): "fewer activation all-reduces (sequence "
                                   "parallelism)",
        ("collective", "decode"): "fewer hops: the sequence split's "
                                  "combine, the all-to-all",
    }
    for r in ok:
        if _n_dev(r) != n:
            continue
        ro = r["roofline"]
        kind = ("train" if r["shape"].startswith("train") else
                "prefill" if "prefill" in r["shape"] else "decode")
        out.append(
            f"| {_name(r)} | {r['shape']} | {r['mesh']} | "
            f"{ro['compute_s']:.3e} | {ro['memory_s']:.3e} | "
            f"{ro['collective_s']:.3e} | **{ro['dominant']}** | "
            f"{ro['useful_flops_ratio']:.2f} | "
            f"{advice[(ro['dominant'], kind)]} |")
    return "\n".join(out)


_DOM = {"compute": "C", "memory": "M", "collective": "X"}


def grid_section(recs) -> str:
    """One row a (arch, variant, shape) of the grid records, one column a
    grid: the rank's peak GB, whether it fits 80 GB, the compute /
    memory / collective terms (s) and the dominant one's initial."""
    ok = [r for r in recs if r.get("status") == "ok" and _n_dev(r) > 1]
    meshes = sorted({r["mesh"] for r in ok})
    cells: dict = {}
    for r in ok:
        ro = r["roofline"]
        cells.setdefault((_name(r), r["shape"]), {})[r["mesh"]] = (
            f"{r['memory']['peak_estimate_bytes'] / 1e9:.1f} "
            f"{'fits' if r['fits_80g'] else '**no**'}; "
            f"{ro['compute_s']:.2g} / {ro['memory_s']:.2g} / "
            f"{ro['collective_s']:.2g} {_DOM[ro['dominant']]}")
    out = ["## §Grids", "",
           "Per (arch × shape), one rank of each grid (data x model "
           "ranks): peak GB and whether it fits 80 GB; compute / memory / "
           "collective s; the dominant term (C compute, M memory, X "
           "collective).",
           "", "| arch | shape | " + " | ".join(meshes) + " |",
           "|---|---|" + "---|" * len(meshes)]
    for (name, shape), row in sorted(cells.items()):
        out.append(f"| {name} | {shape} | "
                   + " | ".join(row.get(m, "") for m in meshes) + " |")
    return "\n".join(out)


def _mean(xs):
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


def telemetry_section(events) -> str:
    """Render obs event-log JSONL (a path, rotation-aware, or an
    already-loaded list of event dicts) into EXPERIMENTS-style tables:
    one federated-rounds table (per-round loss/drift/comm/wall split)
    and one serving table (per-run throughput + pool behaviour)."""
    if isinstance(events, (str, os.PathLike)):
        from repro_torch.obs import read_events
        events = read_events(str(events))
    by_kind = defaultdict(list)
    for e in events:
        by_kind[e.get("kind", "?")].append(e)
    out = ["## §Telemetry", ""]

    rounds = by_kind["fed_round"]
    if rounds:
        out += ["### Federated rounds", "",
                "| engine | method | step | clients | ce mean | spread | "
                "grad-norm | drift mean | comm bytes (class) | "
                "wall split (s) |",
                "|---|---|---|---|---|---|---|---|---|---|"]
        for e in rounds:
            wall = e.get("wall", {})
            split = ", ".join(f"{k}:{v:.3f}" for k, v in wall.items())
            out.append(
                f"| {e.get('engine', 'sim')} | {e.get('method', '?')} | "
                f"{e.get('step', 0)} | {e.get('clients', 0)} | "
                f"{_mean(e.get('ce', [])):.4f} | "
                f"{e.get('loss_spread', 0.0):.4f} | "
                f"{_mean(e.get('grad_norm', [])):.4f} | "
                f"{_mean(e.get('drift', [])):.4f} | "
                f"{e.get('comm_bytes', 0):,} ({e.get('comm_class', '?')}) | "
                f"{split} |")
        out.append("")

    cohorts = by_kind["fed_cohort"]
    if cohorts:
        out += ["### Cohort rounds (partial participation)", "",
                "| method | round | cohort | part. rate | staleness "
                "mean/max | drop | strag | corrupt | delivered | "
                "in-flight | comm bytes |",
                "|---|---|---|---|---|---|---|---|---|---|---|"]
        for e in cohorts:
            part = e.get("participation", [])
            stale = e.get("staleness", []) or [0.0]
            rate = _mean(part)
            out.append(
                f"| {e.get('method', '?')} | {e.get('round', 0)} | "
                f"{len(part)} | {rate:.2f} | "
                f"{_mean(stale):.1f}/{max(stale):.0f} | "
                f"{e.get('dropouts', 0)} | {e.get('stragglers', 0)} | "
                f"{e.get('corrupt', 0)} | {e.get('delivered', 0)} | "
                f"{e.get('pending', 0)} | {e.get('comm_bytes', 0):,} |")
        out.append("")

    stages = by_kind["fed_stage"]
    if stages:
        out += ["### Pipeline stages", "",
                "| engine | stage | method | ce | wall s |",
                "|---|---|---|---|---|"]
        for e in stages:
            ce = e.get("ce", 0.0)
            out.append(f"| {e.get('engine', 'sim')} | {e['stage']} | "
                       f"{e.get('method', '?')} | {ce:.4f} | "
                       f"{e.get('wall', 0.0):.3f} |")
        out.append("")

    runs = by_kind["serve_run"]
    if runs:
        admits = by_kind["serve_admit"]
        waits = [a.get("wait", 0.0) for a in admits]
        depth = max((a.get("queue_depth", 0) for a in admits), default=0)
        out += ["### Serving", "",
                "| requests | tokens | wall s | tokens/s | chunks | "
                "prefills | rows |",
                "|---|---|---|---|---|---|---|"]
        for e in runs:
            out.append(f"| {e.get('requests', 0)} | {e.get('tokens', 0)} | "
                       f"{e.get('wall', 0.0):.3f} | "
                       f"{e.get('tokens_per_s', 0.0):,.1f} | "
                       f"{e.get('chunks', 0)} | {e.get('prefills', 0)} | "
                       f"{e.get('rows', 0)} |")
        out += ["",
                f"admission wait mean {_mean(waits)*1e3:.2f} ms / max "
                f"{max(waits, default=0.0)*1e3:.2f} ms over {len(admits)} "
                f"admits; peak queue depth {depth}; pool registers "
                f"{len(by_kind['pool_register'])}, evictions "
                f"{len(by_kind['pool_evict'])}", ""]

    snaps = by_kind["metrics_snapshot"]
    if snaps:
        counters = snaps[-1].get("snapshot", {}).get("counters", {})
        total = lambda n: sum(s.get("value", 0.0)  # noqa: E731
                              for s in counters.get(n, []))
        lookups, regs = total("pool/lookups"), total("pool/registers")
        if lookups or regs:
            out += [f"pool hit-rate {lookups / max(lookups + regs, 1):.2%} "
                    f"({int(lookups)} lookups / {int(regs)} registers)", ""]
        hists = snaps[-1].get("snapshot", {}).get("histograms", {})
        if hists:
            # bucket-resolved view: with the sub-ms default/latency
            # bounds, an 80 µs and a 600 µs span show up as *different*
            # rows here instead of one collapsed "< 1 ms" bucket
            out += ["### Histograms", "",
                    "| metric | labels | count | mean | min | max | "
                    "buckets (le: n) |",
                    "|---|---|---|---|---|---|---|"]
            for name, series in sorted(hists.items()):
                for s in series:
                    labels = ", ".join(
                        f"{k}={v}" for k, v in
                        sorted(s.get("labels", {}).items())) or "-"
                    bk = s.get("buckets", {})

                    def le(k):
                        return (float("inf") if k == "le_inf"
                                else float(k[3:]))
                    buckets = ", ".join(
                        f"{k[3:]}:{bk[k]}" for k in sorted(bk, key=le))
                    out.append(
                        f"| {name} | {labels} | {s.get('count', 0)} | "
                        f"{s.get('mean', 0.0):.3g} | "
                        f"{s.get('min', 0.0):.3g} | "
                        f"{s.get('max', 0.0):.3g} | {buckets} |")
            out.append("")

    if len(out) == 2:
        out += ["_no telemetry events_", ""]
    return "\n".join(out).rstrip()


def summarize(recs) -> str:
    ok = [r for r in recs if r.get("status") == "ok"]
    bad = [r for r in recs if r.get("status") != "ok"]
    n = max((_n_dev(r) for r in ok), default=1)
    by_dom = defaultdict(int)
    for r in ok:
        if _n_dev(r) == n:
            by_dom[r["roofline"]["dominant"]] += 1
    return (f"{len(ok)} ok / {len(bad)} failed; {n}-card dominants: "
            + ", ".join(f"{k}={v}" for k, v in sorted(by_dom.items())))


def main():
    recs = load()
    print(f"<!-- {summarize(recs)} -->\n")
    print(dryrun_section(recs))
    print()
    print(roofline_section(recs))
    if any(_n_dev(r) > 1 for r in recs if r.get("status") == "ok"):
        print()
        print(grid_section(recs))
    if TELEMETRY and os.path.exists(TELEMETRY):
        print()
        print(telemetry_section(TELEMETRY))


if __name__ == "__main__":
    main()
