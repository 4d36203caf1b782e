"""The 'model' axis for the SSM, hybrid and encoder-decoder families:
mamba2-2.7b, jamba-v0.1-52b and seamless-m4t-large-v2 at SMOKE on a 2
data × 2 model grid of gloo ranks on the CPU (``ClientPool(n_model=2)``;
the rank side is ``tests/torch_tp_ranks.py``, the helpers and the
tolerances ``tests/test_torch_tp.py``'s).

Against the port's own unsharded or data-only runs, on the same inputs:

  * serving (the prefill step, decode steps fed the greedy tokens, with
    the encoder's output for seamless, ``greedy_generate``): logits
    within 1e-5 of max, tokens equal, and each rank's cache equal to its
    shard of the unsharded cache by ``launch/specs.cache_specs`` (the SSM
    state's heads and conv_x's channels split, conv_B / conv_C whole at
    one group); mamba2 also with 2 groups (B_proj, C_proj and their
    convs split by group) and 3 (whole, each rank reading its heads'
    groups);
  * the fedlora_opt pipeline (a round, stage 2 sharded over the data
    ranks, stage 3) against the port's 2-rank data-only engine in f64:
    every client and server leaf within 1e-9 of its max.

(The f64 gradient sums of the three families are cases of
``tests/test_torch_tp.py::test_grid_gradient_sums_to_the_unsharded_one``.)

Against the reference (``repro``, in subprocesses on 4 host devices):
serving logits within 1e-4 of max (``tests/test_torch_model.py``'s
whole-model f32 tolerance), jamba's on ``make_debug_mesh(2, 2)`` (its
MoE through ``moe_ffn_ep``, capacity 8: nothing drops); the pipeline on
``make_debug_mesh(2, 2)`` in f32 at rtol 2e-4 / atol 2e-5 or by the
f64-witness rule (``assert_by_the_witness``).

Without processes: the specs (``cache_specs`` splits a conv cache only
where its kernel is split; ``param_specs`` raises where the mixer's heads
do not divide), and ``init_cache(mesh=)`` against the cut of the whole
cache.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_tp_ranks as R
from repro_torch.checkpoint.bridge import shard_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import AbstractGrid, ClientPool
from repro_torch.launch.serve import (greedy_generate, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import model as M
from repro_torch.utils import pytree as pt
from test_torch_tp import (HP, JAX_HEAD, N_DATA, N_MODEL, SRC, ST, B, C,
                           SP_LEN, T, TG, TP, jax_out, rel, rows_agree,
                           smoke, sub)

FAMILIES = ("mamba2-2.7b", "jamba-v0.1-52b", "seamless-m4t-large-v2")
S, N_NEW, F_ENC = 48, 12, 16    # seamless: 16 frames into the encoder
GROUPS = (2, 3)                 # mamba2 variants: B / C split, or whole

# serving: the reference's prefill / decode_step jitted, jamba's on
# make_debug_mesh(2, 2), seamless's decode steps with the encoder's output
JAX_SERVE = r"""
from repro.launch.mesh import make_debug_mesh
from repro.models import layers as JL
from repro.models import model as M
from repro.models.config import SubLayer
mesh = make_debug_mesh(2, 2)
prefill = jax.jit(M.prefill, static_argnames=("cfg", "cache_len", "mesh"))
decode = jax.jit(M.decode_step, static_argnames=("cfg", "mesh"))


def encode(params, cfg, fe):
    pos = jnp.broadcast_to(jnp.arange(fe.shape[1])[None], fe.shape[:2])
    x, _, _ = M._run_blocks(params["encoder"]["blocks"], {}, fe,
                            [SubLayer("attn", "dense", "global")], cfg,
                            positions=pos, causal=False, chunk_q=True)
    return JL.rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


for arch in FAMILIES:
    cfg = dataclasses.replace(get_smoke_config(arch), lora_dropout=0.0)
    params = M.init_params(jax.random.PRNGKey(1), cfg)
    put(f"{arch}/params", params)
    tok = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    out[f"{arch}/tokens"] = tok
    batch = {"tokens": jnp.asarray(tok)}
    enc = None
    if cfg.n_enc_layers:
        fe = rng.normal(size=(2, F_ENC, cfg.d_model)).astype(np.float32)
        out[f"{arch}/frontend_emb"] = fe
        batch["frontend_emb"] = jnp.asarray(fe)
        enc = encode(params, cfg, jnp.asarray(fe))
    m = mesh if cfg.n_experts else None
    with jax.set_mesh(mesh):
        logits, cache = prefill(params, batch, cfg=cfg, cache_len=S + N_NEW,
                                mesh=m)
        steps = [np.asarray(logits)]
        t = jnp.argmax(logits, -1).astype(jnp.int32)
        for i in range(N_NEW - 1):
            logits, cache = decode(params, t, cache, jnp.int32(S + i),
                                   cfg=cfg, mesh=m, enc_out=enc)
            steps.append(np.asarray(logits))
            t = jnp.argmax(logits, -1).astype(jnp.int32)
    out[f"{arch}/steps"] = np.stack(steps)
np.savez(sys.argv[1], **out)
"""

# one fedlora_opt pipeline iteration on make_debug_mesh(2, 2), with frame
# embeddings for seamless's encoder
JAX_PIPE = r"""
from repro.fed.simulate import FedHyper, FedSim
from repro.launch.mesh import make_debug_mesh
from repro.launch.train import TrainSettings, make_fed_pipeline_step
arch = sys.argv[2]
mesh = make_debug_mesh(2, 2)
cfg = dataclasses.replace(get_smoke_config(arch), lora_dropout=0.0)
sim = FedSim(cfg, FedHyper(method="fedlora_opt", **HP))
put("base", sim.base)
put("ad0", sim.client_adapters)


def bt(name, shape):
    tok = rng.integers(5, cfg.vocab_size, size=shape).astype(np.int32)
    out[name] = tok
    b = {"tokens": jnp.asarray(tok),
         "loss_mask": jnp.ones(shape, jnp.float32)}
    if cfg.n_enc_layers:
        fe = rng.normal(size=shape[:-1] + (F_ENC, cfg.d_model))
        out[name + "_fe"] = fe.astype(np.float32)
        b["frontend_emb"] = jnp.asarray(out[name + "_fe"])
    return b


with jax.set_mesh(mesh):
    pipe = make_fed_pipeline_step(cfg, mesh, TrainSettings(**ST))
    cb = bt("cb", (C, T * B, SP_LEN))
    sb = bt("sb", (TG * 4, SP_LEN))             # 8 rows: stage 2 sharded
    pb = bt("pb", (C, TP * B, SP_LEN))
    na, no, agg, _ = pipe.round_step(sim.base, sim.client_adapters,
                                     sim.opt_state, jnp.int32(0), cb)
    agg, na, _ = pipe.global_step(sim.base, agg, na, sb)
    na, _ = pipe.personal_step(sim.base, na, pb)
put("ad", na)
put("agg", agg)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def jax_refs(tmp_path_factory):
    """The reference's runs in four subprocesses on 4 host devices,
    started with the module so that they run beside the grid's tests:
    {name: (process, .npz path)}."""
    try:
        import jax  # noqa: F401
    except ImportError:
        yield None
        return
    tmp = tmp_path_factory.mktemp("jax")
    head = "\n".join([
        f"FAMILIES = {FAMILIES!r}", f"S, N_NEW, F_ENC = {S}, {N_NEW}, {F_ENC}",
        f"HP, ST = {HP!r}, {ST!r}",
        f"C, T, B, SP_LEN, TG, TP = {C}, {T}, {B}, {SP_LEN}, {TG}, {TP}"])
    # one intra-op thread each: four of them run beside the test workers
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false")
    jobs = {"serve": (JAX_SERVE, [])}
    jobs.update({f"pipe_{a}": (JAX_PIPE, [a]) for a in FAMILIES})
    procs = {}
    for name, (body, args) in jobs.items():
        path = str(tmp / f"{name}.npz")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", head + JAX_HEAD + body, path, *args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), path)
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with ClientPool(N_DATA, str(tmp_path_factory.mktemp("grid")),
                    n_model=N_MODEL, device="cpu") as p:
        yield p


def rank_grid(r):
    """The abstract grid at rank r's coordinates."""
    return AbstractGrid((N_DATA, N_MODEL), coords={"data": r // N_MODEL,
                                                   "model": r % N_MODEL})


def groups_cfg(G):
    """mamba2 SMOKE with G groups: d_model 384 (24 heads) for G = 3."""
    return smoke("mamba2-2.7b", ssm_groups=G,
                 **({"d_model": 384, "d_head": 384} if G == 3 else {}))


# ---------------------------------------------------------------------------
# the specs and the caches, no processes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("mamba2-2.7b", "jamba-v0.1-52b"))
def test_cache_specs_split_a_conv_cache_only_with_its_kernel(arch):
    """At one group conv_B / conv_C's kernels and caches stay whole on
    every rank, the state's heads and conv_x's channels split with their
    kernels (z_proj / x_proj / dt_proj columns, conv_x channels); at 2
    groups conv_B / conv_C split with B_proj / C_proj."""
    for G in (1, 2):
        cfg = dataclasses.replace(get_smoke_config(arch), ssm_groups=G)
        grid = AbstractGrid((2, 2))
        pspec = dict(pt.tree_leaves_with_path(
            SP.param_specs(cfg, grid, SP.abstract_params(cfg))))
        cspec = dict(pt.tree_leaves_with_path(SP.cache_specs(
            cfg, grid, SP.abstract_cache(cfg, 4, 64), 4)))
        split = "model" if G == 2 else None
        conv = [p for p in cspec if "/ssm/conv" in p]
        assert conv and len(conv) % 3 == 0
        for p in conv:
            kernel = pspec[p]           # the same path in both trees
            want = "model" if p.endswith("conv_x") else split
            assert cspec[p][-3:] == ("data", None, want), (G, p, cspec[p])
            assert kernel[-2:] == (want, None), (G, p, kernel)
        for p in cspec:
            if p.endswith("/state"):
                assert cspec[p][-4:] == ("data", "model", None, None), p
        for p, s in pspec.items():
            if p.endswith(("z_proj/kernel", "x_proj/kernel",
                           "dt_proj/kernel")):
                assert s[-2:] == (None, "model"), p
            if p.endswith(("B_proj/kernel", "C_proj/kernel")):
                assert s[-2:] == (None, split), p
            if p.endswith("out_proj/kernel"):
                assert s[-2:] == ("model", None), p


def test_param_specs_raise_where_the_heads_do_not_divide():
    """mamba2 SMOKE's 16 heads over 3 model ranks, jamba's over 3: a
    ValueError naming the head count; over 2 and 4 they split."""
    for arch in ("mamba2-2.7b", "jamba-v0.1-52b"):
        cfg = get_smoke_config(arch)
        base = SP.abstract_params(cfg)
        with pytest.raises(ValueError, match="16 heads"):
            SP.param_specs(cfg, AbstractGrid((1, 3)), base)
        for n in (2, 4):
            SP.param_specs(cfg, AbstractGrid((1, n)), base)


@pytest.mark.parametrize("arch", FAMILIES + ("llama2-7b", "granite-34b"))
def test_init_cache_on_a_grid_is_a_ranks_cut_of_the_whole(arch):
    """``init_cache(mesh=)``'s shapes are those of every rank's cut of
    the whole cache by ``cache_specs`` (kv heads, SSM heads and conv
    channels as they split, conv_B / conv_C whole at one group; granite's
    one kv head whole)."""
    cfg = get_smoke_config(arch)
    whole = M.init_cache(cfg, 4, 64, device="meta")
    specs = SP.cache_specs(cfg, AbstractGrid((2, 2)), whole, 4)
    for r in range(N_DATA * N_MODEL):
        cut = SP.shard_tree(M.init_cache(cfg, 4, 64, device="cpu"), specs,
                            rank_grid(r))
        mine = M.init_cache(cfg, 2, 64, device="meta", mesh=rank_grid(r))
        assert ({p: tuple(x.shape) for p, x in pt.tree_leaves_with_path(cut)}
                == {p: tuple(x.shape)
                    for p, x in pt.tree_leaves_with_path(mine)}), (arch, r)


# ---------------------------------------------------------------------------
# serving on the grid
# ---------------------------------------------------------------------------

def unsharded(cfg, params, batch):
    """The port's unsharded serving: the prefill's cache, every step's
    logits (decode steps fed the greedy tokens, with enc_out) and
    ``greedy_generate``'s tokens."""
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg)(params, batch,
                                               cache_len=S + N_NEW)
        whole = pt.tree_map(torch.Tensor.clone, cache)
        enc = (M._encode(params, batch["frontend_emb"], cfg)
               if cfg.n_enc_layers else None)
        steps, tok = [logits.numpy()], logits.argmax(-1)
        decode = make_decode_step(cfg)
        for i in range(N_NEW - 1):
            logits, cache = decode(params, tok, cache, S + i, enc_out=enc)
            steps.append(logits.numpy())
            tok = logits.argmax(-1)
    tokens = greedy_generate(params, batch, cfg, N_NEW, device="cpu").numpy()
    return whole, np.stack(steps), tokens


def check_grid_serving(pool, cfg, params, batch, what):
    """The grid's serving against the unsharded port's; returns the
    unsharded logits."""
    whole, steps, tokens = unsharded(cfg, params, batch)
    specs = SP.cache_specs(cfg, AbstractGrid((2, 2)), whole,
                           batch["tokens"].shape[0])
    for r, got in enumerate(pool.run(R.serve, cfg, params, batch, N_NEW)):
        assert rel(got["steps"], steps) <= 1e-5, (what, r)
        np.testing.assert_array_equal(got["tokens"], tokens)
        want = SP.shard_tree(whole, specs, rank_grid(r))
        assert set(got["cache"]) == set(dict(pt.tree_leaves_with_path(want)))
        for p, w in pt.tree_leaves_with_path(want):
            assert rel(got["cache"][p], w.numpy()) <= 1e-5, (what, r, p)
    return steps


@pytest.mark.parametrize("G", GROUPS)
def test_mamba2_groups_on_the_grid(pool, G):
    """2 groups: B_proj / C_proj and their convs split, each rank its own
    group; 3 groups over 2 model ranks: whole, each rank reading the
    groups of its 12 of 24 heads."""
    cfg = groups_cfg(G)
    params = M.init_params(torch.Generator().manual_seed(5), cfg,
                           device="cpu")
    tok = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(2, S)))
    check_grid_serving(pool, cfg, params, {"tokens": tok}, f"G={G}")


# ---------------------------------------------------------------------------
# against the reference: these wait for its subprocesses (started with
# the module), so they come last
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_serving_matches_unsharded_and_reference(pool, jax_refs,
                                                        arch):
    run = jax_out(jax_refs, "serve")
    cfg = smoke(arch)
    params = sub(run, f"{arch}/params")
    batch = {"tokens": torch.as_tensor(run[f"{arch}/tokens"].astype(
        np.int64))}
    if cfg.n_enc_layers:
        batch["frontend_emb"] = torch.as_tensor(run[f"{arch}/frontend_emb"])
    steps = check_grid_serving(pool, cfg, params, batch, arch)
    assert rel(steps, run[f"{arch}/steps"]) <= 1e-4


@pytest.mark.parametrize("arch", FAMILIES)
def test_shard_from_numpy_cuts_the_references_leaves(jax_refs, arch):
    """The reference's numpy backbone into each rank's shard
    (``checkpoint/bridge.shard_from_numpy`` by ``param_specs``): the
    mixer's z_proj / x_proj / dt_proj columns, conv_x channels, A_log /
    D_skip / dt_bias / norm_w and out_proj's rows at the rank's heads,
    B_proj / C_proj / conv_B / conv_C whole; attention's q / k / v
    columns and o_proj's rows (the encoder's too) at its heads."""
    run = jax_out(jax_refs, "serve")
    prefix = f"{arch}/params/"
    tree: dict = {}
    for k, v in run.items():
        if k.startswith(prefix):
            pt.set_leaf(tree, k[len(prefix):], v)
    cfg = smoke(arch)
    specs = SP.param_specs(cfg, AbstractGrid((2, 2)), pt.tree_map(
        lambda a: torch.empty(a.shape, device="meta"), tree))
    cols = ("z_proj/kernel", "x_proj/kernel", "dt_proj/kernel",
            "q_proj/kernel", "k_proj/kernel", "v_proj/kernel")
    rows = ("conv_x", "A_log", "D_skip", "dt_bias", "norm_w",
            "out_proj/kernel", "o_proj/kernel")
    whole = ("B_proj/kernel", "C_proj/kernel", "conv_B", "conv_C")
    seen = set()
    for r in range(N_DATA * N_MODEL):
        m = r % N_MODEL
        mine = dict(pt.tree_leaves_with_path(shard_from_numpy(
            tree, specs, rank_grid(r), device="cpu")))
        for p, a in pt.tree_leaves_with_path(tree):
            a = np.asarray(a)
            if p.endswith(cols):
                n = a.shape[-1] // N_MODEL
                want = a[..., m * n:(m + 1) * n]
            elif p.endswith(rows) and "/moe/" not in p:
                lead = a.ndim - (1 if p.endswith(rows[1:5]) else 2)
                n = a.shape[lead] // N_MODEL
                want = np.take(a, range(m * n, (m + 1) * n), axis=lead)
            elif p.endswith(whole):
                want = a
            else:
                continue
            seen.add(p.rsplit("/", 2)[-2] if p.endswith("kernel")
                     else p.rsplit("/", 1)[-1])
            np.testing.assert_array_equal(mine[p].numpy(), want, err_msg=p)
    assert seen, arch


def fam_iters(run, dtype):
    def b(key):
        tok = torch.as_tensor(run[key].astype(np.int64))
        out = {"tokens": tok, "loss_mask": torch.ones(tok.shape,
                                                      dtype=dtype)}
        if key + "_fe" in run:
            out["frontend_emb"] = torch.as_tensor(run[key + "_fe"]).to(dtype)
        return out
    return [(b("cb"), b("sb"), b("pb"))]


@pytest.fixture(scope="module")
def pipelines(pool, jax_refs):
    """Per family: the grid's pipeline in f64 and f32 and the data-only
    engine's in f64, from the reference's base, adapters and batches;
    the grid with remat, the data-only engine without."""
    out = {}
    for arch in FAMILIES:
        run = jax_out(jax_refs, f"pipe_{arch}")
        cfg = smoke(arch)
        res = {}
        for name, dt, data_only in (("grid64", torch.float64, False),
                                    ("data64", torch.float64, True),
                                    ("grid32", torch.float32, False)):
            res[name] = rows_agree(pool.run(
                R.pipeline, cfg, dict(ST, remat=not data_only),
                sub(run, "base", dt), sub(run, "ad0", dt),
                fam_iters(run, dt), data_only=data_only))
        out[arch] = (run, res)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_grid_pipeline_equals_the_data_only_engine(pipelines, arch):
    """Every client and server leaf within 1e-9 of its max."""
    _, res = pipelines[arch]
    for got, want in zip(res["grid64"], res["data64"]):
        for p, w in want.items():
            assert rel(got[p], w) <= 1e-9, (arch, p)


def assert_by_the_witness(got, want, witness, what, rtol=2e-4, atol=2e-5,
                          wtol=1e-5, share=1e-3, outlier_tol=1e-2):
    """``tests/test_torch_tp.py``'s f64-witness rule, with the port's f64
    grid run as the witness of both f32 runs: every element of ``got``
    (the grid, f32) within rtol / atol of ``want`` (the reference, f32)
    but where f32 does not resolve it, ``got`` or ``want`` being more
    than ``wtol`` of the leaf's max off ``witness``; at most a ``share``
    of the leaf (2 at least) beyond; and each of those within
    ``outlier_tol`` of max of ``want``, or of the witness where ``want``
    itself is off it (an element the reference does not resolve cannot
    hold the port to 1e-2 of its own value)."""
    assert set(got) == set(want) == set(witness), what
    for p, w in want.items():
        out = ~np.isclose(got[p], w, rtol=rtol, atol=atol)
        if not out.any():
            continue
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(got[p] - w) / scale
        got_off = np.abs(got[p] - witness[p]) / scale
        want_off = np.abs(w - witness[p]) / scale > wtol
        assert out.sum() <= max(2, share * out.size), (what, p, out.sum())
        assert ((got_off > wtol) | want_off)[out].all(), (what, p, err[out])
        held = np.where(want_off, got_off, err)[out]
        assert held.max() <= outlier_tol, (what, p, held.max())


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_grid_pipeline_matches_the_reference(pipelines, arch):
    """By ``assert_by_the_witness``: at mamba2 SMOKE one element of
    out_proj's dA_dir (stage 2 moves it from zero at gradients near
    AdamW's eps) is 1.4e-2 of max off the reference, whose own f32 run is
    0.96e-2 off the port's f64 run there and the grid's 0.4e-2."""
    run, res = pipelines[arch]
    for i, prefix in enumerate(("ad", "agg")):
        want = {k[len(prefix) + 1:]: v for k, v in run.items()
                if k.startswith(prefix + "/")}
        assert_by_the_witness(res["grid32"][i], want, res["grid64"][i],
                              f"{arch} {prefix}")
