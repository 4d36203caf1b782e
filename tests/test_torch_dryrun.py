"""The port's one-card dry run and its report against the JAX package's,
on the CPU.

- The batch specs of every (architecture × shape) pair ``shape_supported``
  allows have the shapes and dtypes of the reference's
  ``ShapeDtypeStruct``s (the reference's specs on a 1 x 1 debug mesh).
- The ``params``, ``analytic`` and ``roofline`` fields of every pair equal
  the reference's functions exactly, the roofline by the reference's
  formulas at the card's constants.
- The tally of a step run on meta tensors equals the same tally over the
  step run on real CPU tensors, byte for byte, for the steps that reach
  no kernel (training of the dense, MoE, SSM and encoder-decoder
  families; prefill and decode at S < 2048): meta execution makes the
  allocations a real run makes.  A train account moved along its line
  from 3 and 4 micro-batches equals the run of all of them.
- The meta branches of ``flash_attention`` and ``ssd_scan`` return the
  plain versions' shapes and dtypes and allocate what their CUDA paths
  do; a CPU tensor given to a CUDA wrapper still raises, and the other
  four wrappers refuse meta tensors.
- ``run_one`` end to end at full width (llama2-7b prefill_32k,
  seamless-m4t-large-v2 decode_32k) through the CLI; the report renders
  its records, and its ``telemetry_section`` renders the reference's
  text for a file each package wrote.
- On a grid: the analytic fields at n_dev = 4 with a collective term
  (the reference's formulas at the card's NVLink rate) for every pair;
  two ranks' records of a 2 x 2 meta grid equal; ``--grid 1x4`` at full
  width, granite-34b's decode_32k on both cache layouts, and the report
  of grid records.  (Each rank's meta account against the same step on
  a CPU rank is in ``tests/test_torch_tp.py``.)
All comparisons are exact.
"""
import json

import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch
from torch.utils._pytree import tree_leaves

from repro import configs as j_configs
from repro import obs as j_obs
from repro.launch import analysis as j_an
from repro.launch import report as j_report
from repro.launch import specs as j_specs
from repro.launch.mesh import make_debug_mesh
from repro.utils import pytree as jpt
from repro_torch import configs as t_configs
from repro_torch import obs as t_obs
from repro_torch.configs import InputShape
from repro_torch.kernels.batched_lora import bgmv as t_bgmv
from repro_torch.kernels.flash_attention import flash_attention as t_fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.fused_dora import fused_dora as t_fd
from repro_torch.kernels.quant_matmul import quant_matmul as t_qm
from repro_torch.kernels.ssd_scan import ssd_scan as t_ssd
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch import analysis as t_an
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as t_report
from repro_torch.launch import specs as t_specs
from repro_torch.utils import pytree as tpt

PAIRS = [(a, s) for a in j_configs.ARCH_IDS for s in j_configs.SHAPES
         if j_configs.shape_supported(a, s)]
TORCH_DT = {jnp.dtype(jnp.int32): torch.int32,
            jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.bfloat16): torch.bfloat16}
FIELDS = ("arch", "shape", "mesh", "n_devices", "variant", "trace_s",
          "memory", "fits_80g", "cost_analysis", "params", "analytic",
          "roofline", "status")
MEMORY = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "peak_estimate_bytes")


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def struct(x):
    return (tuple(x.shape), TORCH_DT[jnp.dtype(x.dtype)])


def tstruct(x):
    return (tuple(x.shape), x.dtype)


# ---------------------------------------------------------------------------
# batch specs and the analytic fields, every supported pair
# ---------------------------------------------------------------------------

def test_batch_specs_equal_the_reference_for_every_pair():
    mesh = make_debug_mesh(1, 1)
    assert len(PAIRS) == 37
    for arch, name in PAIRS:
        jc, tc = j_configs.get_config(arch), t_configs.get_config(arch)
        js, ts = j_configs.SHAPES[name], t_configs.SHAPES[name]
        if ts.kind == "train":
            want, _ = j_specs.train_batch_specs(jc, js, mesh, 1)
            got = t_specs.train_batch_specs(tc, ts, 1)
        elif ts.kind == "prefill":
            want, _ = j_specs.serve_batch_specs(jc, js, mesh)
            got = t_specs.serve_batch_specs(tc, ts)
        else:
            want, _ = j_specs.decode_specs(jc, js, mesh)
            got = t_specs.decode_specs(tc, ts)
            jcache, tcache = want.pop("cache"), got.pop("cache")
            assert {p: tstruct(x) for p, x in
                    tpt.tree_leaves_with_path(tcache)} == \
                {p: struct(x) for p, x in j_leaves(jcache)}, (arch, name)
            assert struct(want.pop("cache_index"))[0] == ()
            assert isinstance(got.pop("cache_index"), int)
        assert sorted(got) == sorted(want), (arch, name)
        for k in want:
            assert got[k].device.type == "meta"
            assert tstruct(got[k]) == struct(want[k]), (arch, name, k)


def j_leaves(tree):
    """(path, leaf) pairs of a reference tree."""
    return list(zip(jpt.tree_paths(tree), jax.tree.leaves(tree)))


def to_structs(tree):
    """The port's meta tree as the reference's ShapeDtypeStructs."""
    inv = {v: k for k, v in TORCH_DT.items()}
    return tpt.tree_map(lambda x: jax.ShapeDtypeStruct(
        tuple(x.shape), inv[x.dtype]), tree)


def test_analytic_fields_equal_the_reference_for_every_pair():
    for arch, name in PAIRS:
        jc, tc = j_configs.get_config(arch), t_configs.get_config(arch)
        js, ts = j_configs.SHAPES[name], t_configs.SHAPES[name]
        got = D.analytic_record(tc, ts)
        pc = j_an.param_counts(jc, to_structs(t_specs.abstract_params(tc)))
        fl = j_an.analytic_step_flops(jc, js)
        cache_bytes = 0
        if js.kind == "decode":
            cache_bytes = jpt.tree_bytes(j_specs.abstract_cache(
                jc, js.global_batch,
                js.seq_len // 2 if jc.n_enc_layers else js.seq_len))
        by = j_an.analytic_step_bytes(jc, js, pc["n_params"], 1, cache_bytes)
        # the reference's roofline and MODEL_FLOPS formulas
        # (repro/launch/dryrun.py) at one card and the H100's constants
        compute_s = fl["flops_global"] / 1 / t_an.PEAK_FLOPS
        memory_s = by["hbm_bytes_dev"] / t_an.HBM_BW
        factor = 6 if js.kind == "train" else 2
        head_tokens = fl["tokens"] if js.kind == "train" else js.global_batch
        model_flops = factor * pc["n_active_body"] * fl["tokens"] \
            + factor * jc.d_model * jc.vocab_size * head_tokens
        assert got == {
            "params": pc,
            "analytic": {**fl, **by, "cache_bytes_global": cache_bytes},
            "roofline": {
                "compute_s": compute_s, "memory_s": memory_s,
                "collective_s": 0.0,
                "dominant": "compute" if compute_s >= memory_s
                else "memory",
                "model_flops": model_flops,
                "useful_flops_ratio":
                    model_flops / max(fl["flops_global"], 1.0)}}, \
            (arch, name)


# ---------------------------------------------------------------------------
# the tally: meta against real CPU tensors, at SMOKE
# ---------------------------------------------------------------------------

TALLY_CASES = [
    ("llama2-7b", InputShape("smoke_train", 64, 4, "train")),
    ("qwen3-moe-30b-a3b", InputShape("smoke_train", 64, 4, "train")),
    ("mamba2-2.7b", InputShape("smoke_train", 64, 4, "train")),
    ("seamless-m4t-large-v2", InputShape("smoke_train", 64, 4, "train")),
    ("llama2-7b", InputShape("smoke_prefill", 256, 2, "prefill")),
    ("seamless-m4t-large-v2", InputShape("smoke_prefill", 256, 2,
                                         "prefill")),
    ("llama2-7b", InputShape("smoke_decode", 256, 2, "decode")),
    ("seamless-m4t-large-v2", InputShape("smoke_decode", 256, 2, "decode")),
]


@pytest.mark.parametrize("arch,shape", TALLY_CASES,
                         ids=[f"{a}-{s.kind}" for a, s in TALLY_CASES])
def test_meta_tally_equals_the_cpu_tally(arch, shape):
    cfg = t_configs.get_smoke_config(arch)
    got = []
    for dev in ("meta", "cpu"):
        step, make_args = D.step_and_inputs(cfg, shape, device=dev)
        args = make_args()
        assert {x.device.type for x in tree_leaves(args)
                if torch.is_tensor(x)} == {dev}
        got.append(D.measure(step, args))
    meta, cpu = got
    assert meta == cpu
    assert meta["memory"]["temp_bytes"] > 0 and meta["flops_counted"] > 0
    assert meta["kernel_flops"] == {"flash_attention": 0, "ssd_scan": 0}
    if shape.kind == "decode":          # the cache is written in place
        assert 0 < meta["memory"]["alias_bytes"] < \
            meta["memory"]["output_bytes"]
    else:
        assert meta["memory"]["alias_bytes"] == 0


def test_train_account_along_its_line_equals_the_full_run(monkeypatch):
    cfg = t_configs.get_smoke_config("llama2-7b")
    shape = InputShape("smoke_train", 32, 12, "train")
    monkeypatch.setattr(D, "pick_micro_batches", lambda *a, **k: 6)
    line = D.account(cfg, shape)
    monkeypatch.setattr(D, "MICRO_RUN", 6)
    full = D.account(cfg, shape)
    assert (full["micro_batches"], line["micro_batches"]) == (6, 6)
    assert (line["micro_batches_run"], full["micro_batches_run"]) == \
        ([3, 4], [6])
    assert full["memory"] == line["memory"]
    assert full["cost_analysis"] == line["cost_analysis"]
    assert full["cost_analysis"]["flops_counted"] > 0


def test_tally_counts_storages_once_and_frees_them():
    with D.StorageTally() as t:
        a = torch.empty((1000,), dtype=torch.float32, device="meta")
        v = a[10:20].view(2, 5)          # views: no new storage
        a.add_(1.0)                      # in place: none
        b = a * 2
        del b
        c = torch.empty((3,), dtype=torch.bfloat16, device="meta")
    assert (t.peak, t.current) == (8000, 4006) and v.shape == (2, 5)
    with D.StorageTally(round_to=512) as t:
        c = torch.empty((3,), dtype=torch.bfloat16, device="meta")
        d = torch.empty((513,), dtype=torch.uint8, device="meta")
    assert (t.peak, c.shape, d.shape) == (1536, (3,), (513,))


# ---------------------------------------------------------------------------
# the meta branches
# ---------------------------------------------------------------------------

def meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_meta_branch(dtype):
    B, S, H, K, dh = 2, 2048, 4, 2, 64
    q, k, v = meta((B, S, H, dh), dtype), meta((B, S, K, dh), dtype), \
        meta((B, S, K, dh), dtype)
    g = torch.Generator().manual_seed(0)
    qc, kc, vc = (torch.randn(x.shape, generator=g).to(dtype)
                  for x in (q, k, v))
    want = flash_attention(qc, kc, vc, causal=True)
    t_fa.reset_launches()
    t_fa.META_FLOPS["flash_attention"] = 0
    with D.StorageTally() as t:
        got = flash_attention(q, k, v, causal=True)
    assert (got.device.type, got.shape, got.dtype) == \
        ("meta", want.shape, want.dtype)
    assert t_fa.LAUNCHES["flash_attention"] == 0
    assert t_fa.META_FLOPS["flash_attention"] == \
        4 * B * H * dh * (S * (S + 1) // 2)
    # the dispatcher's three head-major copies and the kernel's output
    es = q.element_size()
    assert t.peak == es * (2 * B * H * S * dh + 2 * B * K * S * dh)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        t_fa.flash_attention_bhsd_cuda(
            qc.reshape(B * H, S, dh)[:4].contiguous(),
            kc.reshape(B * K, S, dh)[:2].contiguous(),
            vc.reshape(B * K, S, dh)[:2].contiguous(), scale=0.125)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_meta_branch(dtype):
    b, S, H, P, G, N, Q = 1, 256, 4, 16, 1, 32, 64
    shapes = dict(x=((b, S, H, P), dtype), dt=((b, S, H), torch.float32),
                  A_log=((H,), torch.float32), B=((b, S, G, N), dtype),
                  C=((b, S, G, N), dtype))
    g = torch.Generator().manual_seed(1)
    real = {n: (torch.randn(s, generator=g) * 0.1).to(d)
            for n, (s, d) in shapes.items()}
    y_w, st_w = ssd_scan(*real.values(), chunk=Q)
    t_ssd.reset_launches()
    t_ssd.META_FLOPS["ssd_scan"] = 0
    xs = [meta(s, d) for s, d in shapes.values()]
    BH, BG = b * H, b * G
    ins = (meta((BH, S, P), dtype), meta((BH, S), torch.float32),
           meta((BH,), torch.float32), meta((BG, S, N), dtype),
           meta((BG, S, N), dtype))
    with D.StorageTally() as t:
        y, st = t_ssd.ssd_scan_bh_cuda(*ins, chunk=Q)
    nc, es = S // Q, ins[0].element_size()
    split = t_ssd.state_bytes(P, N, dtype == torch.bfloat16)
    # csrc/ssd_scan.cu's ssd_scan_state_bytes: two bf16 tiles of
    # 16·ceil(N/16) rows of 2^lg 16-byte chunks, 2^lg >= 2·ceil(P/16)
    assert split == (2 * 32 * 2 * 16 if dtype == torch.bfloat16 else 0)
    assert t_ssd.state_bytes(64, 128, True) == 2 * 128 * 8 * 16
    assert t.peak == (es * BH * S * P + 4 * BH * N * P + es * BG * nc * Q * Q
                      + 4 * BH * S + 4 * BH * nc * N * P + BH * nc * split)
    assert (tuple(y.shape), y.dtype, tuple(st.shape), st.dtype) == \
        ((BH, S, P), dtype, (BH, N, P), torch.float32)
    y2, st2 = ssd_scan(*xs, chunk=Q)
    assert (y2.shape, y2.dtype, st2.shape, st2.dtype) == \
        (y_w.shape, y_w.dtype, st_w.shape, st_w.dtype)
    assert t_ssd.LAUNCHES["ssd_scan"] == 0
    tri = Q * (Q + 1) // 2
    assert t_ssd.META_FLOPS["ssd_scan"] == 2 * 2 * nc * (
        BG * tri * N + BH * (tri * P + 2 * Q * N * P))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        t_ssd.ssd_scan_bh_cuda(
            torch.zeros((BH, S, P), dtype=dtype),
            torch.zeros((BH, S)), torch.zeros((BH,)),
            torch.zeros((BG, S, N), dtype=dtype),
            torch.zeros((BG, S, N), dtype=dtype), chunk=Q)


def test_the_other_wrappers_refuse_meta():
    x2, x3 = meta((8, 64), torch.bfloat16), meta((2, 4, 64), torch.bfloat16)
    calls = [
        lambda: t_bgmv.bgmv_cuda(x3, meta((3, 64, 8), torch.bfloat16),
                                 meta((3, 8, 64), torch.bfloat16),
                                 meta((2,), torch.int32)),
        lambda: t_bgmv.bgmv_mag_cuda(x3, *[meta((1,), torch.float32)] * 5,
                                     meta((2,), torch.int32)),
        lambda: t_fd.fused_dora_cuda(x2, *[meta((1,), torch.bfloat16)] * 5),
        lambda: t_qm.quant_matmul_cuda(x2, meta((64, 64), torch.int8),
                                       meta((64,), torch.float32)),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="takes CUDA tensors, x is on "
                                             "meta"):
            call()


# ---------------------------------------------------------------------------
# run_one end to end, the report
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    for arch, shape in (("llama2-7b", "prefill_32k"),
                        ("seamless-m4t-large-v2", "decode_32k")):
        D.main(["--arch", arch, "--shape", shape, "--out", str(out)])
    return out, [json.loads(p.read_text())
                 for p in sorted(out.glob("*.json"))]


def test_run_one_end_to_end(records):
    _, recs = records
    assert [(r["arch"], r["shape"]) for r in recs] == [
        ("llama2-7b", "prefill_32k"), ("seamless-m4t-large-v2", "decode_32k")]
    for r in recs:
        assert r["status"] == "ok", r.get("error")
        for f in FIELDS:
            assert f in r, f
        m = r["memory"]
        assert sorted(m) == sorted(MEMORY)
        assert m["peak_estimate_bytes"] == m["argument_bytes"] + \
            m["temp_bytes"] + m["output_bytes"] - m["alias_bytes"]
        assert r["fits_80g"] == (m["peak_estimate_bytes"] < 80e9)
        assert (r["mesh"], r["n_devices"], r["variant"]) == ("1", 1,
                                                            "baseline")
        assert r["cost_analysis"]["flops_counted"] > 0
    llama, seamless = recs
    tc = t_configs.get_config("llama2-7b")
    assert llama["memory"]["argument_bytes"] == \
        tpt.tree_bytes(t_specs.abstract_params(tc)) + 32 * 32768 * 4
    # every layer's flash call, causal over 32768 positions
    assert llama["cost_analysis"]["kernel_flops"]["flash_attention"] == \
        tc.n_layers * 4 * 32 * tc.n_heads * tc.head_dim \
        * (32768 * 32769 // 2)
    # the decoder's cache is updated in place: it is the alias
    assert seamless["memory"]["alias_bytes"] == \
        seamless["analytic"]["cache_bytes_global"]


def test_resolve_device_takes_meta():
    from repro_torch.device import resolve_device
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        resolve_device("xpu")


def test_variants():
    """The reference's variants; ``seqshard_kv`` changes neither the
    config nor remat (it is the grid's cache layout), so on one card its
    record is the baseline's."""
    cfg = t_configs.get_config("qwen3-moe-30b-a3b")
    assert D.apply_variant(cfg, "cf1")[0].capacity_factor == 1.0
    assert D.apply_variant(cfg, "remat_dots") == (cfg, "dots")
    assert D.apply_variant(cfg, "swa_global")[0].sliding_window == 4096
    assert D.apply_variant(cfg, "seqshard_kv") == (cfg, True)
    with pytest.raises(ValueError, match="unknown variant"):
        D.apply_variant(cfg, "nope")
    small = t_configs.get_smoke_config("granite-34b")
    shape = InputShape("smoke_decode", 64, 2, "decode")
    recs = [D.run_config(small, shape, arch="granite-34b", variant=v)
            for v in ("baseline", "seqshard_kv")]
    for r in recs:
        r.pop("trace_s")
        r.pop("variant")
    assert recs[0] == recs[1]
    assert "collectives" not in recs[0] and recs[0]["mesh"] == "1"


def test_report_renders_the_records(records, monkeypatch):
    """One card's records: a mesh column reading "1", no collective
    bytes, and the roofline of the one-card records (the most cards
    there are), its collective term 0."""
    out, recs = records
    monkeypatch.setattr(t_report, "DRYRUN_DIR", str(out))
    assert t_report.load() == recs
    dry = t_report.dryrun_section(recs)
    roof = t_report.roofline_section(recs)
    assert "fits 80G" in dry and "| mesh |" in dry
    assert "collective s" in roof and "9.89e+14" in roof
    assert "(1 H100," in roof
    for r in recs:
        row = [ln for ln in dry.splitlines()
               if ln.startswith(f"| {r['arch']} | {r['shape']} | 1 | ok")]
        assert len(row) == 1
        assert t_report.fmt_bytes(r["memory"]["temp_bytes"]) in row[0]
        assert ("yes" if r["fits_80g"] else "**NO**") in row[0]
        assert "| 0.00 GB |  |" in row[0]
        row = [ln for ln in roof.splitlines()
               if ln.startswith(f"| {r['arch']} | {r['shape']} | 1 |")]
        assert len(row) == 1
        assert f"**{r['roofline']['dominant']}**" in row[0]
        assert "| 0.000e+00 |" in row[0]
    assert t_report.summarize(recs + [{"status": "error"}]).startswith(
        "2 ok / 1 failed; 1-card")
    bad = {"arch": "x", "shape": "y", "status": "error", "error": "E: z"}
    assert "ERROR: E: z" in t_report.dryrun_section([bad])


# ---------------------------------------------------------------------------
# the dry run on a grid
# ---------------------------------------------------------------------------

def test_analytic_fields_on_four_cards_equal_the_reference():
    """n_dev = 4 and a rank's collective bytes: the reference's formulas,
    its collective term the bytes over the card's NVLink rate (450 GB/s a
    direction), for every supported pair."""
    assert t_an.NVLINK_BW == 450e9
    coll = 3.0e9
    for arch, name in PAIRS:
        jc, tc = j_configs.get_config(arch), t_configs.get_config(arch)
        js, ts = j_configs.SHAPES[name], t_configs.SHAPES[name]
        got = D.analytic_record(tc, ts, 4, coll)
        pc = j_an.param_counts(jc, to_structs(t_specs.abstract_params(tc)))
        fl = j_an.analytic_step_flops(jc, js)
        cache_bytes = 0
        if js.kind == "decode":
            cache_bytes = jpt.tree_bytes(j_specs.abstract_cache(
                jc, js.global_batch,
                js.seq_len // 2 if jc.n_enc_layers else js.seq_len))
        by = j_an.analytic_step_bytes(jc, js, pc["n_params"], 4, cache_bytes)
        assert got["params"] == pc, (arch, name)
        assert got["analytic"] == {**fl, **by,
                                   "cache_bytes_global": cache_bytes}
        terms = {"compute": fl["flops_global"] / 4 / t_an.PEAK_FLOPS,
                 "memory": by["hbm_bytes_dev"] / t_an.HBM_BW,
                 "collective": coll / 450e9}
        ro = got["roofline"]
        assert (ro["compute_s"], ro["memory_s"], ro["collective_s"]) == (
            terms["compute"], terms["memory"], terms["collective"])
        assert ro["dominant"] == max(terms, key=terms.get), (arch, name)


GRID_CASES = [
    ("llama2-7b", InputShape("smoke_prefill", 256, 2, "prefill"), "baseline"),
    ("gemma3-1b", InputShape("smoke_decode", 64, 2, "decode"), "seqshard_kv"),
    ("qwen3-moe-30b-a3b", InputShape("smoke_train", 32, 4, "train"),
     "baseline"),
]


@pytest.mark.parametrize("arch,shape,variant", GRID_CASES,
                         ids=[f"{a}-{s.kind}" for a, s, _ in GRID_CASES])
def test_grid_records_of_two_ranks_agree(arch, shape, variant):
    """Rank 0's and rank 3's records on a 2 x 2 meta grid are the same
    (but the rank and the trace time): the account is one rank's for
    all.  The record carries the grid, the rank's collectives and the
    collective term from them."""
    cfg = t_configs.get_smoke_config(arch)
    recs = [D.run_config(cfg, shape, arch=arch, variant=variant, grid=(2, 2),
                         rank=r) for r in (0, 3)]
    for r in recs:
        assert (r["mesh"], r["n_devices"]) == ("2x2", 4)
        assert r.pop("trace_s") >= 0
    assert (recs[0].pop("rank"), recs[1].pop("rank")) == (0, 3)
    assert recs[0] == recs[1]
    colls = recs[0]["collectives"]
    assert colls["total"] == sum(v["bytes"] for g in ("data", "model")
                                 for v in colls[g].values()) > 0
    assert recs[0]["roofline"]["collective_s"] == \
        colls["total"] / t_an.NVLINK_BW


def test_grid_cli_and_report(tmp_path):
    """``--grid 1x4`` at full width: granite-34b's decode_32k (MQA, 88
    layers, a 189 GB cache) does not fit a rank with the kv head whole on
    every rank, and does on the sequence-split layout (a quarter of the
    cache a rank); the report renders the grid records with their mesh
    and reads the 4-card records in its roofline."""
    for variant in ("baseline", "seqshard_kv"):
        D.main(["--arch", "granite-34b", "--shape", "decode_32k", "--grid",
                "1x4", "--variant", variant, "--out", str(tmp_path)])
    base, seq = [json.loads((tmp_path / f"granite-34b__decode_32k__1x4"
                             f"{tag}.json").read_text())
                 for tag in ("", "__seqshard_kv")]
    for r in (base, seq):
        assert r["status"] == "ok", r.get("error")
        assert (r["mesh"], r["n_devices"], r["rank"]) == ("1x4", 4, 0)
    cache = base["analytic"]["cache_bytes_global"]
    assert cache > 180e9
    assert not base["fits_80g"] and seq["fits_80g"]
    assert base["memory"]["argument_bytes"] - seq["memory"][
        "argument_bytes"] == cache - cache // 4
    assert seq["collectives"]["total"] > base["collectives"]["total"] > 0
    recs = [base, seq]
    dry = t_report.dryrun_section(recs)
    assert "| granite-34b | decode_32k | 1x4 | ok" in dry
    assert "| granite-34b +seqshard_kv | decode_32k | 1x4 | ok" in dry
    roof = t_report.roofline_section(recs + [dict(base, mesh="1",
                                                  n_devices=1)])
    assert "(4 H100s," in roof and "| 1 |" not in roof
    grids = t_report.grid_section(recs).splitlines()
    assert grids[4] == "| arch | shape | 1x4 |"
    assert grids[6].startswith("| granite-34b | decode_32k | 215.6 **no**; ")
    assert grids[7].startswith("| granite-34b +seqshard_kv | decode_32k | "
                               "72.2 fits; ")
    assert t_report.summarize(recs).startswith("2 ok / 0 failed; 4-card")


def write_events(pkg, path):
    """The same events through one package's obs: every table of the
    telemetry section."""
    pkg.enable(path)
    try:
        pkg.event("fed_round", engine="sim", method="fedlora_opt", step=2,
                  clients=2, ce=[1.5, 2.25], grad_norm=[0.5, 0.75],
                  drift=[0.1, 0.2], loss_spread=0.75, comm_bytes=12345,
                  comm_class="psum", wall={"round": 0.5, "total": 0.75})
        pkg.event("fed_cohort", method="lora", round=1,
                  participation=[1.0, 0.0, 1.0], staleness=[0.0, 2.0],
                  dropouts=1, stragglers=0, corrupt=0, delivered=2,
                  pending=1, comm_bytes=999)
        pkg.event("fed_stage", engine="pipeline", stage="global",
                  method="fedlora_opt", ce=1.25, wall=0.125)
        pkg.event("serve_admit", wait=0.002, queue_depth=3)
        pkg.event("serve_admit", wait=0.004, queue_depth=1)
        pkg.event("serve_run", requests=4, tokens=64, wall=0.5,
                  tokens_per_s=128.0, chunks=2, prefills=1, rows=4)
        pkg.event("pool_register", tenant=1)
        pkg.inc("pool/lookups", 3)
        pkg.inc("pool/registers", 1)
        for v in (0.00008, 0.0006, 0.02):
            pkg.observe("span_seconds", v, span="serve/prefill")
        pkg.emit_snapshot()
    finally:
        pkg.disable()


def test_telemetry_section_renders_the_references_text(tmp_path):
    for pkg in (t_obs, j_obs):
        path = str(tmp_path / f"{pkg.__name__}.jsonl")
        write_events(pkg, path)
        got, want = (t_report.telemetry_section(path),
                     j_report.telemetry_section(path))
        assert got == want
        for head in ("### Federated rounds", "### Cohort rounds",
                     "### Pipeline stages", "### Serving",
                     "### Histograms", "pool hit-rate 75.00%"):
            assert head in got, head
    assert t_report.telemetry_section([]) == \
        j_report.telemetry_section([])
