"""The 'model' axis: the port on a 2 data × 2 model grid of gloo ranks
on the CPU (``launch/mesh.make_debug_mesh``, ``ClientPool(n_model=2)``;
``tests/torch_tp_ranks.py`` holds the rank side).

Against the port's own unsharded or data-only runs, on the same inputs:

  * serving (the prefill step, decode steps fed the greedy tokens,
    ``greedy_generate``) at the SMOKE configs of llama2-7b, granite-34b
    (MQA: kv heads whole on every rank), gemma3-1b (tied embeddings, a
    window, ring caches wrapping) and qwen2-vl-2b (a frontend prefix):
    logits within 1e-5 of max, tokens equal;
  * one stage-1 gradient, summed over the model row as the engine sums
    it, against the unsharded gradient in f64 within 1e-12 of each
    leaf's max (llama2-7b with adapters on all seven projections, so the
    row-parallel targets are held too, and qwen3-moe);
  * the fedlora_opt pipeline (a round, stage 2 sharded over the data
    ranks, stage 3) at llama2-7b and qwen3-moe SMOKE, with remat, against
    the port's 2-rank data-only engine without it in f64: every client
    and server leaf within 1e-9 of its max (measured: 0);
  * decoding on the grid's ``seq_shard_kv`` layout (the cache split on
    its sequence over the model ranks) at gemma3-1b and granite-34b
    SMOKE: logits within 1e-5 of max, tokens equal, each rank's slots
    the unsharded cache's (a ring that wraps across the ranks, writes
    that cross a rank boundary, a length that does not divide, per-row
    positions);
  * the dry run on a grid: each rank's step on a meta grid against the
    same step on that CPU rank, its storage tally and its collectives'
    calls and bytes exactly.

Against the reference (``repro``, in subprocesses on 4 host devices):
serving logits within 1e-4 of max (``tests/test_torch_model.py``'s
whole-model f32 tolerance), the sequence-split decode against the
reference's decode step jitted on ``make_debug_mesh(2, 2)`` with
``cache_specs(seq_shard_kv=True)`` at the same tolerance, ``moe_ffn_ep`` on ``make_debug_mesh(2, 2)``
at qwen3-moe and mixtral (ep_fsplit 2) SMOKE, capacity 8.0 and 1.0 (the
shards drop tokens), on the batch-divisible and the small-batch path
(outputs within 1e-5 of max, aux within 1e-6), and the pipeline on
``make_debug_mesh(2, 2)`` in f32 at rtol 2e-4 / atol 2e-5 or by the
f64-witness rule of ``tests/test_torch_fed_methods.py``.
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
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.core import peft
from repro_torch.core.methods import get_method
from repro_torch.fed.simulate import stage_loss, value_and_grad
from repro_torch.kernels import fused_dora
from repro_torch.configs import InputShape
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import ClientPool, make_meta_grid
from repro_torch.launch.serve import (greedy_generate, make_decode_step,
                                      make_prefill_step)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.utils import pytree as pt

N_DATA, N_MODEL = 2, 2
SERVE = ("llama2-7b", "granite-34b", "gemma3-1b", "qwen2-vl-2b")
SEQ = ("gemma3-1b", "granite-34b")     # one kv head: the sequence split
S, N_NEW, F = 48, 24, 8         # gemma3's 64-slot ring wraps at step 16
MOE = (("qwen3-moe-30b-a3b", 1), ("mixtral-8x22b", 2))
PIPE = ("llama2-7b", "qwen3-moe-30b-a3b")
C, T, B, SP_LEN, TG, TP = 2, 2, 2, 16, 2, 2
HP = dict(n_clients=C, local_steps=T, batch=B, seq_len=SP_LEN, lr=1e-2,
          server_lr=5e-3, global_steps=TG, personal_steps=TP, lam=1e-2)
ST = dict(lr=1e-2, micro_batches=1, clip=1.0, remat=False,
          method="fedlora_opt", local_steps=T, server_lr=5e-3,
          global_steps=TG, personal_steps=TP, lam=1e-2)
ALL_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
               "up_proj", "down_proj")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

JAX_HEAD = r"""
import sys, dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.utils import pytree as pt
out = {}
rng = np.random.default_rng(0)


def put(prefix, tree):
    for p, x in zip(pt.tree_paths(tree), jax.tree.leaves(tree)):
        out[f"{prefix}/{p}"] = np.asarray(x)
"""

# serving and moe_ffn_ep (the reference's prefill / decode_step jitted,
# moe_ffn_ep under shard_map on make_debug_mesh(2, 2))
JAX_SERVE_MOE = r"""
from repro.launch.mesh import make_debug_mesh
from repro.models import model as M
from repro.models.layers import moe_ffn_ep
prefill = jax.jit(M.prefill, static_argnames=("cfg", "cache_len"))
decode = jax.jit(M.decode_step, static_argnames=("cfg",))
for arch in SERVE:
    cfg = dataclasses.replace(get_smoke_config(arch), lora_dropout=0.0)
    params = M.init_params(jax.random.PRNGKey(1), cfg)
    put(f"serve/{arch}/params", params)
    tok = rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
    out[f"serve/{arch}/tokens"] = tok
    batch = {"tokens": jnp.asarray(tok)}
    Ft = 0
    if cfg.frontend:
        fe = rng.normal(size=(2, F, cfg.d_model)).astype(np.float32)
        out[f"serve/{arch}/frontend_emb"] = fe
        batch["frontend_emb"] = jnp.asarray(fe)
        Ft = F
    logits, cache = prefill(params, batch, cfg=cfg, cache_len=Ft + S + N_NEW)
    steps = [np.asarray(logits)]
    t = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(N_NEW - 1):
        logits, cache = decode(params, t, cache, jnp.int32(Ft + S + i),
                               cfg=cfg)
        steps.append(np.asarray(logits))
        t = jnp.argmax(logits, -1).astype(jnp.int32)
    out[f"serve/{arch}/steps"] = np.stack(steps)
mesh = make_debug_mesh(2, 2)
for arch, fs in MOE:
    for cf in (8.0, 1.0):
        cfg = dataclasses.replace(get_smoke_config(arch), ep_fsplit=fs,
                                  capacity_factor=cf)
        params = M.init_params(jax.random.PRNGKey(2), cfg)
        p = jax.tree.map(lambda x: x[0], params["blocks"]["sub0"]["moe"])
        put(f"moe/{arch}/{cf}/p", p)
        for Bx, Sx in ((4, 8), (1, 3)):
            x = rng.normal(size=(Bx, Sx, cfg.d_model)).astype(np.float32)
            out[f"moe/{arch}/{cf}/{Bx}/x"] = x
            with jax.set_mesh(mesh):
                y, aux = jax.jit(lambda p, x: moe_ffn_ep(p, x, cfg, mesh))(
                    p, jnp.asarray(x))
            out[f"moe/{arch}/{cf}/{Bx}/y"] = np.asarray(y)
            out[f"moe/{arch}/{cf}/{Bx}/aux"] = np.asarray(aux)
# the decode step jitted on the mesh with the cache split on its sequence
# over 'model' (cache_specs(seq_shard_kv=True)), from serve's prefill
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch import specs as JSP
from repro.launch.serve import make_decode_step
rep = NamedSharding(mesh, P())
for arch in SEQ:
    cfg = dataclasses.replace(get_smoke_config(arch), lora_dropout=0.0)
    params = M.init_params(jax.random.PRNGKey(1), cfg)
    batch = {"tokens": jnp.asarray(out[f"serve/{arch}/tokens"])}
    logits, cache = prefill(params, batch, cfg=cfg, cache_len=S + N_NEW)
    with jax.set_mesh(mesh):
        psh = JSP.param_specs(cfg, mesh, params)
        csh = JSP.cache_specs(cfg, mesh, cache, 2, seq_shard_kv=True)
        step = jax.jit(make_decode_step(cfg, mesh), in_shardings=(
            psh, NamedSharding(mesh, P("data")), csh, rep),
            out_shardings=(rep, csh))
        ps, cache = jax.device_put(params, psh), jax.device_put(cache, csh)
        steps = [np.asarray(logits)]
        for i in range(N_NEW - 1):
            t = jax.device_put(jnp.argmax(logits, -1).astype(jnp.int32),
                               NamedSharding(mesh, P("data")))
            logits, cache = step(ps, t, cache, jnp.int32(S + i))
            steps.append(np.asarray(logits))
    out[f"seq/{arch}/steps"] = np.stack(steps)
    out[f"seq/{arch}/spec"] = np.array(str(jax.tree.leaves(csh)[0].spec))
np.savez(sys.argv[1], **out)
"""

# one fedlora_opt pipeline iteration on make_debug_mesh(2, 2)
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


def bt(shape):
    tok = rng.integers(5, cfg.vocab_size, size=shape).astype(np.int32)
    return tok, {"tokens": jnp.asarray(tok),
                 "loss_mask": jnp.ones(shape, jnp.float32)}


with jax.set_mesh(mesh):
    pipe = make_fed_pipeline_step(cfg, mesh, TrainSettings(**ST))
    out["cb"], cb = bt((C, T * B, SP_LEN))
    out["sb"], sb = bt((TG * 4, SP_LEN))        # 8 rows: stage 2 sharded
    out["pb"], pb = bt((C, TP * B, SP_LEN))
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
    """The reference's runs in three subprocesses on 4 host devices,
    started with the module so that they run beside the grid's tests:
    {name: (process, .npz path)}."""
    try:
        import jax  # noqa: F401
    except ImportError:
        yield None
        return
    tmp = tmp_path_factory.mktemp("jax")
    head = "\n".join([
        f"SERVE, MOE, SEQ = {SERVE!r}, {MOE!r}, {SEQ!r}",
        f"S, N_NEW, F = {S}, {N_NEW}, {F}", f"HP, ST = {HP!r}, {ST!r}",
        f"C, T, B, SP_LEN, TG, TP = {C}, {T}, {B}, {SP_LEN}, {TG}, {TP}"])
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = {"serve_moe": (JAX_SERVE_MOE, [])}
    jobs.update({f"pipe_{a}": (JAX_PIPE, [a]) for a in PIPE})
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


def jax_out(jax_refs, name):
    if jax_refs is None:
        pytest.skip("the comparison with the reference needs JAX")
    proc, path = jax_refs[name]
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with ClientPool(N_DATA, str(tmp_path_factory.mktemp("grid")),
                    n_model=N_MODEL, device="cpu") as p:
        yield p


def sub(run, prefix, dtype=None):
    """The tree under ``prefix`` of a reference run, as CPU tensors."""
    tree: dict = {}
    for k, v in run.items():
        if k.startswith(prefix + "/"):
            pt.set_leaf(tree, k[len(prefix) + 1:], v)
    return params_from_numpy(tree, "cpu", dtype)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def smoke(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), lora_dropout=0.0, **kw)


def random_model(arch, seed=0, **kw):
    cfg = smoke(arch, **kw)
    return cfg, M.init_params(torch.Generator().manual_seed(seed), cfg,
                              device="cpu")


# ---------------------------------------------------------------------------
# the grid itself
# ---------------------------------------------------------------------------

def grid_layout(grid):
    return (grid.rank, grid.coords, grid.data.rank, grid.data.size,
            grid.model.rank, grid.model.size, grid.backend, grid.shape)


def test_grid_places_rank_r_at_data_r_div_n_model(pool):
    """Rank r sits at (r // n_model, r % n_model); the data column and
    the model row are its groups; ranks on the CPU run gloo."""
    for r, (rank, coords, dr, dn, mr, mn, backend, shape) in enumerate(
            pool.run(grid_layout)):
        assert rank == r and coords == {"data": r // 2, "model": r % 2}
        assert (dr, dn, mr, mn) == (r // 2, N_DATA, r % 2, N_MODEL)
        assert backend == "gloo" and shape == {"data": 2, "model": 2}


def test_collectives_carry_their_gradients(pool):
    """copy_to, reduce_from, gather_from, sum_over (model row),
    all_to_all and mean_over (data column), forward and backward, against
    their definitions."""
    x = np.arange(8, dtype=np.float64).reshape(4, 2) / 3
    res = pool.run(R.collectives, x)
    w = np.arange(8, dtype=np.float64).reshape(4, 2) / 7
    for r, out in enumerate(res):
        d, m = divmod(r, 2)
        row = [x + d * 2 + j for j in range(2)]
        col = [x + j * 2 + m for j in range(2)]
        y, g = out["copy_to"]
        np.testing.assert_array_equal(y, x + r)
        np.testing.assert_allclose(g, 2 * w)          # Σ over the row of w
        y, g = out["reduce_from"]
        np.testing.assert_allclose(y, row[0] + row[1])
        np.testing.assert_array_equal(g, w)
        y, g = out["gather_from"]
        np.testing.assert_allclose(y, np.concatenate(row, axis=-1))
        wg = np.arange(16, dtype=np.float64).reshape(4, 4) / 7
        np.testing.assert_allclose(g, wg[:, 2 * m:2 * m + 2])
        y, g = out["all_to_all"]
        np.testing.assert_allclose(y, np.concatenate(
            [col[0][2 * d:2 * d + 2], col[1][2 * d:2 * d + 2]]))
        # the loss's weight on what this rank sent to rank j is rank j's
        # w at the rows it received from here
        np.testing.assert_allclose(g, np.concatenate(
            [w[2 * d:2 * d + 2], w[2 * d:2 * d + 2]]))
        y, g = out["mean_over"]
        np.testing.assert_allclose(y, (col[0] + col[1]) / 2)
        # the column's weights 1 + m and 3 + m, meaned
        np.testing.assert_allclose(g, (2 + m) * w)
        y, g = out["sum_over"]
        np.testing.assert_allclose(y, row[0] + row[1])
        # the row's weights 1 + 2d and 2 + 2d, summed
        np.testing.assert_allclose(g, (3 + 4 * d) * w)


def test_argmax_over_shards_breaks_ties_to_the_lower_index(pool):
    """Ties inside a shard, across the shard boundary and a whole row of
    equal logits: the first index wins, as ``argmax_first``."""
    logits = torch.zeros((4, 8))
    logits[0, [1, 6]] = 3.0                    # across shards
    logits[1, [5, 7]] = 2.0                    # inside the second shard
    logits[2, 4] = 1.0                         # the second shard's first id
    want = M.argmax_first(logits)
    for got in pool.run(R.argmax_ties, logits):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert want.tolist() == [1, 5, 4, 0]


# ---------------------------------------------------------------------------
# training: the gradient and remat on the grid
# ---------------------------------------------------------------------------

FAMILIES = ("mamba2-2.7b", "jamba-v0.1-52b", "seamless-m4t-large-v2")
GRAD_TARGETS = {"llama2-7b": ALL_TARGETS,
                "jamba-v0.1-52b": ("q_proj", "v_proj", "x_proj", "out_proj"),
                "seamless-m4t-large-v2": ALL_TARGETS}


@pytest.mark.parametrize("arch,method", [(a, "fedlora_opt") for a in PIPE]
                         + [("llama2-7b", "adapter"),
                            ("llama2-7b", "prompt")]
                         + [(a, "fedlora_opt") for a in FAMILIES])
def test_grid_gradient_sums_to_the_unsharded_one(pool, arch, method):
    """The stage-1 gradient of each client, summed over its model row as
    the engine sums it, against the whole model's, in f64: llama2-7b with
    adapters on every projection (column- and row-parallel targets),
    qwen3-moe through ``moe_ffn_manual`` with its aux, the Houlsby
    adapter and the prompt (computed whole on every rank, each rank's
    gradient at 1/n_model), mamba2 (x_proj column-parallel over the
    rank's heads, out_proj row-parallel, the gated norm's sum of squares
    all-reduced forward and backward), jamba (its attention and MoE
    sublayers, and adapters on its mixers too) and seamless with
    adapters on every projection (the encoder's adapters reached through
    enc_out, whole on every rank and summed back by ``copy_to``)."""
    kw = ({"lora_targets": GRAD_TARGETS[arch]} if arch in GRAD_TARGETS
          else {})
    cfg, base = random_model(arch, **kw)
    base = pt.tree_map(torch.Tensor.double, base)
    g = torch.Generator().manual_seed(1)
    ad = get_method(method).make_adapter(base, cfg, g)
    ad = pt.tree_map(lambda x: torch.stack([
        x.double() + 0.01 * torch.randn(x.shape, generator=g,
                                        dtype=torch.float64)
        for _ in range(C)]), ad)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.as_tensor(rng.integers(
        5, cfg.vocab_size, size=(C, 2, 16))),
        "loss_mask": torch.ones((C, 2, 16), dtype=torch.float64)}
    if cfg.frontend:
        batch["frontend_emb"] = torch.as_tensor(rng.normal(
            size=(C, 2, F, cfg.d_model)))
    res = pool.run(R.grads, cfg, base, ad, batch)
    for r, (got, met) in enumerate(res):
        d = r // 2
        _, m0, g0 = value_and_grad(lambda leaves: stage_loss(
            base, leaves, {k: v[d] for k, v in batch.items()}, cfg),
            pt.tree_map(lambda x: x[d], ad))
        for p, w in pt.tree_leaves_with_path(g0):
            assert rel(got[p], w.numpy()) <= 1e-12, (arch, method, r, p)
        for k in ("ce", "acc", "aux", "n_tok"):
            np.testing.assert_allclose(met[k], float(m0[k]), rtol=1e-12)


def pipe_iters(run, dtype):
    def b(key):
        tok = torch.as_tensor(run[key].astype(np.int64))
        return {"tokens": tok, "loss_mask": torch.ones(tok.shape,
                                                       dtype=dtype)}
    return [(b("cb"), b("sb"), b("pb"))]


def rows_agree(res):
    """Every rank of a model row returns its client's state bit for bit;
    returns (the clients stacked in data order, the server model)."""
    for r in range(1, len(res)):
        same = res[r - r % N_MODEL]
        for a, b in zip(res[r], same):
            for p in b:
                np.testing.assert_array_equal(a[p], b[p], err_msg=p)
    clients = [res[d * N_MODEL][0] for d in range(N_DATA)]
    return ({p: np.concatenate([c[p] for c in clients]) for p in clients[0]},
            res[0][1])


def assert_close_or_witness(got, want, witness, what, rtol=2e-4, atol=2e-5,
                            wtol=1e-5, share=1e-3, outlier_tol=1e-2):
    """rtol / atol elementwise, but where f32 cannot resolve an element:
    each element outside is more than ``wtol`` of the leaf's max from the
    port's f64 run, a ``share`` of the leaf at most (2 at least), within
    ``outlier_tol`` of the leaf's max."""
    assert set(got) == set(want) == set(witness), what
    for p, w in want.items():
        out = ~np.isclose(got[p], w, rtol=rtol, atol=atol)
        if not out.any():
            continue
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(got[p] - w) / scale
        assert out.sum() <= max(2, share * out.size), (what, p, out.sum())
        assert err.max() <= outlier_tol, (what, p, err.max())
        off64 = np.abs(got[p] - witness[p])[out] / scale
        assert (off64 > wtol).all(), (what, p, err[out], off64)


def test_long_prefill_runs_the_chunked_path_on_the_ranks_heads(pool):
    """S 2048 (the reference's chunked length): each rank's
    ``_long_attention`` over its own heads equals the whole model's."""
    cfg, params = random_model("llama2-7b")
    tok = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, size=(2, 2048)))
    res = pool.run(R.serve, cfg, params, {"tokens": tok}, 2)
    with torch.no_grad():
        want, _ = M.prefill(params, {"tokens": tok}, cfg, cache_len=2050)
    for got in res:
        assert rel(got["steps"][0], want) <= 1e-5


def test_kv_heads_a_rank_reads_where_they_stay_whole():
    """``_kv_for_heads``: each of the rank's q heads reads its own kv head
    (h // rep) under the grouped layout, for one kv head shared by the
    rank's q heads (MQA) and for q heads that span kv groups."""
    for K, H, n in ((1, 4, 2), (1, 48, 2), (3, 12, 2), (3, 6, 2)):
        rep, Hl = H // K, H // n
        k = torch.arange(K, dtype=torch.float64).reshape(1, 1, K, 1)
        for m in range(n):
            kk, vv = L._kv_for_heads(k, k + 10, m * Hl, Hl, rep)
            per = Hl // kk.shape[2]
            got = [float(kk[0, 0, i // per, 0]) for i in range(Hl)]
            assert got == [(m * Hl + i) // rep for i in range(Hl)], (K, H, m)
            assert torch.equal(vv, kk + 10)


# ---------------------------------------------------------------------------
# the sequence-split KV cache (the grid's seq_shard_kv layout)
# ---------------------------------------------------------------------------

# (S, n_new, cache_len, per-row position step): 8 decode steps each
SEQ_CASES = {
    # gemma3's 64-slot rings split 32 / 32 and wrap from rank 1 to rank 0
    # at position 64; 68 positions: the global caches split 34 / 34
    "ring-wraps": (60, 9, 68, 0),
    # the global caches' 16 slots split 8 / 8, the writes cross to rank 1
    "crosses-ranks": (7, 9, 16, 0),
    # 17 positions do not divide: the global caches stay whole
    "odd-length": (7, 9, 17, 0),
    # row r at position 7 + i + 3r: each row's write crosses on its own
    "per-row": (7, 9, 22, 3),
}


def seq_model(arch):
    """gemma3-1b at 7 layers (5 local + 1 global + a local tail) or
    granite-34b at its SMOKE config: one kv head, 4 q heads."""
    kw = {"n_layers": 7} if arch == "gemma3-1b" else {}
    return random_model(arch, seed=5, **kw)


def seq_unsharded(cfg, params, batch, n_new, cache_len, rowpos):
    B, S = batch["tokens"].shape
    with torch.no_grad():
        logits, cache = M.prefill(params, batch, cfg, cache_len=cache_len)
        steps, tok = [logits.numpy()], logits.argmax(-1)
        for i in range(n_new - 1):
            idx = (torch.arange(B) * rowpos + S + i) if rowpos else S + i
            logits, cache = M.decode_step(params, tok, cache, idx, cfg)
            steps.append(logits.numpy())
            tok = logits.argmax(-1)
    return np.stack(steps), R.host(cache)


@pytest.mark.parametrize("case", SEQ_CASES)
@pytest.mark.parametrize("arch", SEQ)
def test_seq_split_decode_matches_the_unsharded_port(pool, arch, case):
    """On the grid's ``seq_shard_kv`` layout: every step's logits within
    1e-5 of max of the unsharded port, tokens equal; each rank's prefill
    cache is the default layout's cut to its slots, exactly (the global
    caches whole where their length does not divide); after the steps
    each rank's slots hold the unsharded cache's, within 1e-5 of max,
    and the same slots are unwritten (zero)."""
    S, n_new, L, rowpos = SEQ_CASES[case]
    cfg, params = seq_model(arch)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=(2, S)))}
    want, final = seq_unsharded(cfg, params, batch, n_new, L, rowpos)
    res = pool.run(R.seq_serve, cfg, params, batch, n_new, L, rowpos)
    split = False
    for r, got in enumerate(res):
        assert rel(got["steps"], want) <= 1e-5, (arch, case, r)
        np.testing.assert_array_equal(got["steps"].argmax(-1),
                                      want.argmax(-1))
        assert got["prefill_off"] == 0.0, (arch, case, r)
        d, m = divmod(r, 2)
        for p, w in final.items():
            w = w[..., d:d + 1, :, :, :]
            n = got["final"][p].shape[-3]
            if n != w.shape[-3]:
                split = True
                assert n * 2 == w.shape[-3], (arch, case, p)
                w = w[..., m * n:(m + 1) * n, :, :]
            np.testing.assert_array_equal(got["final"][p] == 0, w == 0)
            assert rel(got["final"][p], w) <= 1e-5, (arch, case, r, p)
    # gemma3's rings always split; a global cache where its length divides
    assert split == (arch == "gemma3-1b" or L % 2 == 0)


ACCOUNT_CASES = (
    ("llama2-7b", InputShape("smoke_prefill", 64, 2, "prefill"), False),
    ("gemma3-1b", InputShape("smoke_decode", 64, 2, "decode"), True),
    ("qwen3-moe-30b-a3b", InputShape("smoke_train", 32, 4, "train"), False))


@pytest.mark.parametrize("arch,shape,seq", ACCOUNT_CASES,
                         ids=[f"{a}-{s.kind}" for a, s, _ in ACCOUNT_CASES])
def test_meta_grid_account_equals_a_cpu_rank(pool, arch, shape, seq):
    """The dry run on a grid: each rank's step on a meta grid at its place
    (``launch/mesh.make_meta_grid``) against the same step on that rank
    of the CPU grid: the storage tally byte for byte, the FLOPs, and the
    collectives' calls and bytes exactly (a prefill; a decode step on the
    sequence-split layout; a train step of the production engine on the
    grid, its MoE all-to-all included).  Every rank's account is the
    same."""
    cfg = smoke(arch)
    res = pool.run(R.account, cfg, shape, seq)
    for r, got in enumerate(res):
        grid = make_meta_grid(N_DATA, N_MODEL, rank=r)
        step, make_args = D.step_and_inputs(cfg, shape, grid=grid,
                                            seq_shard_kv=seq)
        assert D.measure(step, make_args(), grid) == got, (arch, r)
        assert got == res[0]
    assert got["collectives"]["total"] > 0
    assert got["memory"]["temp_bytes"] > 0


# ---------------------------------------------------------------------------
# fused_dora on a slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", ("col", "row"))
def test_fused_dora_on_a_tensor_parallel_slice(split):
    """The plain fused_dora given one rank's columns of W0 and B_dir
    equals those columns of the whole product; given one rank's rows of
    W0 and of the A factors, the ranks' partials sum to it (within 1e-6
    of max, f32)."""
    g = torch.Generator().manual_seed(0)
    M_, K, N, r = 12, 64, 96, 8

    def rnd(*shape):
        return torch.randn(shape, generator=g)
    x, w0 = rnd(M_, K), rnd(K, N) * 0.1
    a_dir, a_mag, b_dir, b_mag = rnd(K, r), rnd(K), rnd(r, N), rnd(r)
    da, db = rnd(K, r) * 0.1, rnd(r) * 0.1
    whole = fused_dora(x, w0, a_dir, a_mag, b_dir, b_mag, da, db, scale=4.0)
    parts = []
    for m in range(N_MODEL):
        if split == "col":
            c = slice(m * N // N_MODEL, (m + 1) * N // N_MODEL)
            y = fused_dora(x, w0[:, c], a_dir, a_mag, b_dir[:, c], b_mag, da,
                           db, scale=4.0)
            assert rel(y, whole[:, c]) <= 1e-6
        else:
            k = slice(m * K // N_MODEL, (m + 1) * K // N_MODEL)
            parts.append(fused_dora(x[:, k], w0[k], a_dir[k], a_mag[k], b_dir,
                                    b_mag, da[k], db, scale=4.0))
    if parts:
        assert rel(sum(parts), whole) <= 1e-6


# ---------------------------------------------------------------------------
# against the reference: these wait for its subprocesses (started with
# the module), so they come last
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVE)
def test_sharded_serving_matches_unsharded_and_reference(pool, jax_refs,
                                                         arch):
    run = jax_out(jax_refs, "serve_moe")
    cfg = smoke(arch)
    params = sub(run, f"serve/{arch}/params")
    batch = {"tokens": torch.as_tensor(run[f"serve/{arch}/tokens"].astype(
        np.int64))}
    if cfg.frontend:
        batch["frontend_emb"] = torch.as_tensor(
            run[f"serve/{arch}/frontend_emb"])
    res = pool.run(R.serve, cfg, params, batch, N_NEW)
    S_all = S + (F if cfg.frontend else 0)
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg)(params, batch,
                                               cache_len=S_all + N_NEW)
        whole = R.host(cache)
        steps, tok = [logits.numpy()], logits.argmax(-1)
        decode = make_decode_step(cfg)
        for i in range(N_NEW - 1):
            logits, cache = decode(params, tok, cache, S_all + i)
            steps.append(logits.numpy())
            tok = logits.argmax(-1)
    steps = np.stack(steps)
    tokens = greedy_generate(params, batch, cfg, N_NEW, device="cpu").numpy()
    kv_whole = cfg.n_kv_heads % N_MODEL != 0
    for r, got in enumerate(res):
        assert rel(got["steps"], steps) <= 1e-5, (arch, r)
        np.testing.assert_array_equal(got["tokens"], tokens)
        # the rank's cache: its row of the batch, its kv heads (or all of
        # them where they do not divide over the model ranks)
        d, m = divmod(r, 2)
        for p, w in whole.items():
            K = w.shape[-2]
            heads = slice(None) if kv_whole else slice(m * K // 2,
                                                       (m + 1) * K // 2)
            want = w[..., d:d + 1, :, heads, :]
            assert rel(got["cache"][p], want) <= 1e-5, (arch, r, p)
    assert rel(steps, run[f"serve/{arch}/steps"]) <= 1e-4
    assert rel(res[0]["steps"], run[f"serve/{arch}/steps"]) <= 1e-4


@pytest.mark.parametrize("arch", SEQ)
def test_seq_split_decode_matches_the_reference(pool, jax_refs, arch):
    """The grid's ``seq_shard_kv`` layout against the reference's decode
    step jitted on ``make_debug_mesh(2, 2)`` with ``cache_specs(
    seq_shard_kv=True)`` (the cache split on its sequence over 'model'),
    from the same parameters and prompt: every step's logits within 1e-4
    of max, the greedy tokens equal."""
    run = jax_out(jax_refs, "serve_moe")
    assert str(run[f"seq/{arch}/spec"]) == \
        "PartitionSpec(None, 'data', 'model', None, None)"
    cfg = smoke(arch)
    params = sub(run, f"serve/{arch}/params")
    batch = {"tokens": torch.as_tensor(run[f"serve/{arch}/tokens"].astype(
        np.int64))}
    want = run[f"seq/{arch}/steps"]
    for got in pool.run(R.seq_serve, cfg, params, batch, N_NEW, S + N_NEW):
        assert rel(got["steps"], want) <= 1e-4, arch
        np.testing.assert_array_equal(got["steps"].argmax(-1),
                                      want.argmax(-1))
        assert rel(got["steps"], run[f"serve/{arch}/steps"]) <= 1e-4


@pytest.mark.parametrize("rows", (4, 1), ids=("batch-divisible",
                                              "small-batch"))
@pytest.mark.parametrize("cf", (8.0, 1.0))
@pytest.mark.parametrize("arch,fsplit", MOE)
def test_moe_ep_matches_the_reference(pool, jax_refs, arch, fsplit, cf,
                                      rows):
    """Capacity 1.0 drops tokens shard by shard: the grid is held to the
    reference's expert-parallel layer, not to the whole batch's."""
    run = jax_out(jax_refs, "serve_moe")
    cfg = smoke(arch, ep_fsplit=fsplit, capacity_factor=cf)
    p = sub(run, f"moe/{arch}/{cf}/p")
    x = run[f"moe/{arch}/{cf}/{rows}/x"]
    want = run[f"moe/{arch}/{cf}/{rows}/y"]
    for y, aux in pool.run(R.moe_ep, cfg, p, x):
        assert rel(y, want) <= 1e-5
        np.testing.assert_allclose(aux, run[f"moe/{arch}/{cf}/{rows}/aux"],
                                   rtol=1e-6)
    if cf == 8.0:           # nothing drops: the whole batch's layer too
        y0, _ = L.moe_ffn_local(p, torch.as_tensor(x), cfg)
        assert rel(want, y0) <= 1e-5


@pytest.mark.parametrize("rows", (4, 1), ids=("batch-divisible",
                                              "small-batch"))
@pytest.mark.parametrize("arch,fsplit", MOE)
def test_moe_ep_carries_the_aux_gradient(pool, arch, fsplit, rows):
    """The gradient through ``moe_ffn_ep`` of Σ w ⊙ y + 5 · aux, in f64
    at capacity 8 (nothing drops), within 1e-12 of max.  With the rows
    split, each rank's is that of its own rows' loss and its own shard's
    aux at full weight (the mean's backward), so the ranks' mean is the
    whole batch's; on the small-batch path the ranks' gradients are
    partial sums over the data column.  The aux's share is checked to be
    more than 1e-6 of max, so a detached aux would fail."""
    cfg = smoke(arch, ep_fsplit=fsplit, capacity_factor=8.0)
    _, params = random_model(arch, seed=4, ep_fsplit=fsplit,
                             capacity_factor=8.0)
    p = pt.tree_map(lambda a: a[0].double(), params["blocks"]["sub0"]["moe"])
    rng = np.random.default_rng(5)
    x = rng.normal(size=(rows, 8, cfg.d_model))
    w = rng.normal(size=x.shape)
    shards = [slice(d * rows // N_DATA, (d + 1) * rows // N_DATA)
              for d in range(N_DATA)] if rows % N_DATA == 0 else [slice(None)]

    def whole(c):
        xt = torch.as_tensor(x).requires_grad_(True)
        loss, auxes = 0.0, []
        for s in shards:
            y, aux = L.moe_ffn_local(p, xt[s], cfg)
            loss = loss + torch.sum(y * torch.as_tensor(w[s])) + c * aux
            auxes.append(float(aux.detach()))
        loss.backward()
        return xt.grad.numpy(), float(np.mean(auxes))

    want, want_aux = whole(5.0)
    assert rel(whole(0.0)[0], want) > 1e-6
    res = pool.run(R.moe_ep_grad, cfg, p, x, w, 5.0)
    for r, (dx, aux) in enumerate(res):
        assert rel(dx, res[r - r % N_MODEL][0]) <= 1e-12   # the row agrees
        np.testing.assert_allclose(aux, want_aux, rtol=1e-12)
    got = [res[d * N_MODEL][0] for d in range(N_DATA)]
    got = np.concatenate(got) if len(shards) > 1 else sum(got)
    assert rel(got, want) <= 1e-12


@pytest.fixture(scope="module")
def pipelines(pool, jax_refs):
    """Per config: the grid's pipeline in f64 and f32 and the data-only
    engine's in f64, from the reference's base, adapters and batches.
    The grid runs with remat (each superblock checkpointed, its
    collectives issued again in the backward pass), the data-only engine
    without."""
    out = {}
    for arch in PIPE:
        run = jax_out(jax_refs, f"pipe_{arch}")
        cfg = smoke(arch)
        res = {}
        for name, dt, data_only in (("grid64", torch.float64, False),
                                    ("data64", torch.float64, True),
                                    ("grid32", torch.float32, False)):
            res[name] = rows_agree(pool.run(
                R.pipeline, cfg, dict(ST, remat=not data_only),
                sub(run, "base", dt), sub(run, "ad0", dt),
                pipe_iters(run, dt), data_only=data_only))
        out[arch] = (run, res)
    return out


@pytest.mark.parametrize("arch", PIPE)
def test_grid_pipeline_equals_the_data_only_engine(pipelines, arch):
    """With remat on the grid and without it on the data-only engine:
    every client and server leaf within 1e-9 of its max (measured 0)."""
    _, res = pipelines[arch]
    for got, want in zip(res["grid64"], res["data64"]):
        for p, w in want.items():
            assert rel(got[p], w) <= 1e-9, (arch, p)


@pytest.mark.parametrize("arch", PIPE)
def test_grid_pipeline_matches_the_reference(pipelines, arch):
    run, res = pipelines[arch]
    for i, prefix in enumerate(("ad", "agg")):
        want = {k[len(prefix) + 1:]: v for k, v in run.items()
                if k.startswith(prefix + "/")}
        assert_close_or_witness(res["grid32"][i], want, res["grid64"][i],
                                f"{arch} {prefix}")
