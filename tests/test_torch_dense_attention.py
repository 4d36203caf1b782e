"""The rest of the dense family in the port against the JAX package, on
the CPU: long-sequence prefill (``_sdpa_chunked``), qk-norm, the
sliding-window mask and ring caches, and local/global superblocks with a
tail, at the SMOKE configs of gemma3-1b (at 3 layers: one superblock of
local + global and a one-layer tail), qwen3-32b and granite-34b.

Parameters are drawn by the JAX package and carried across by
``checkpoint.bridge``; inputs come from numpy seeds.  The JAX runs are
shared through module fixtures, and the port's ``FedSim`` runs on one
intra-op thread.

Tolerances (f32 arithmetic summed in another order by another BLAS):
- ``_sdpa_chunked`` and its input gradients within 1e-5 of max |value|;
  the qk-norm attention sublayer within 1e-5;
- hidden states, prefill logits and caches, and per-row decode logits
  within 1e-4 of max |value| over a few layers; greedy tokens equal;
- the ``FedSim`` leaves within 1e-4 of each leaf's max |value| on every
  element but those where f32 itself is off, by
  ``tests/test_torch_fed_methods.py``'s rule (its module docstring says
  why: AdamW's eps regime) against the port's f64 run, with one
  addition: an element beyond 1e-4 may also be one where the reference
  is the f32 run more than 1e-5 of the leaf's max from the f64 run,
  provided the f64 run's AdamW state shows the eps regime there (its
  bias-corrected sqrt(v̂) within 10 eps at some step).  Measured: every
  element beyond 1e-4 is a stage-2 dA_dir element (and its rebroadcast
  copies) with sqrt(v̂) of 0.06-3.9 eps; on one BLAS order two of
  qwen3's q_proj dA_dir elements were 1.2e-4 and 2.8e-4 from the
  reference and one of them 2.6e-6 from the f64 run.
"""
import dataclasses
import gc

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.data import loader as j_loader
from repro.data import partition as j_part
from repro.data import synthetic as j_syn
from repro.fed.simulate import FedHyper as JHyper, FedSim as JSim
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro.models import layers as JL
from repro.models import model as JM
from repro.serve import AdapterStore as JStore, ServeEngine as JEngine
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.data import loader as t_loader
from repro_torch.data import partition as t_part
from repro_torch.data import synthetic as t_syn
from repro_torch.fed.simulate import FedHyper as THyper, FedSim as TSim
from repro_torch.kernels.flash_attention import flash_attention as FK
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import AdapterStore as TStore, ServeEngine as TEngine
from repro_torch.utils import pytree as tpt

ARCHS = ("gemma3-1b", "qwen3-32b", "granite-34b")
LAYERS = {"gemma3-1b": 3}       # one 2-sublayer superblock and a tail of 1
PROMPT = {"gemma3-1b": 48}      # + 32 new tokens wraps the 64-slot ring
N_NEW = 32
LONG = 2048                     # the reference's chunked-prefill length
# whole-model hidden states at LONG: gemma3 (the chunked path windowed and
# global, and the tail); qwen3's chunked qk-norm sublayer and granite's
# chunked MQA are held on their own below
HIDDEN = [(arch, 96) for arch in ARCHS] + [("gemma3-1b", LONG)]


def configs(arch):
    kw = dict(lora_dropout=0.0)
    if arch in LAYERS:
        kw["n_layers"] = LAYERS[arch]
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(t_smoke(arch), **kw))


def to_port(tree, dtype=None):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu", dtype)


def np_(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x)


def rel(got, want):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def flat(tree):
    if all(torch.is_tensor(x) for x in tpt.tree_leaves(tree)):
        return {p: x.detach().numpy()
                for p, x in tpt.tree_leaves_with_path(tree)}
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(x)
            for path, x in leaves}


ADAM_B2, ADAM_EPS = 0.999, 1e-8     # the optimizers' AdamW
EPS_REGIME = 10                     # sqrt(v̂) within this many eps


class EpsRegime:
    """Where the witness sim's AdamW ran in its eps regime: per adapter
    path, the elements at which the bias-corrected sqrt(v̂) of some step
    so far (any client, any stage) was within ``EPS_REGIME`` eps, where
    an f32 rounding of the gradient moves the update by up to ~1e-3 lr
    (``_step_one`` wrapped to read the state it returns)."""

    def __init__(self, sim):
        self.mask = {}
        real = sim._step_one

        def step_one(adapters, opt_state, batch, gen, step, *a, **kw):
            out = real(adapters, opt_state, batch, gen, step, *a, **kw)
            bc2 = 1 - ADAM_B2 ** (step + 1)
            for p, nu in tpt.tree_leaves_with_path(out[1]["nu"]):
                if nu.numel():
                    low = (torch.sqrt(nu / bc2)
                           <= EPS_REGIME * ADAM_EPS).numpy()
                    self.mask[p] = self.mask.get(p, False) | low
            return out
        sim._step_one = step_one


def assert_leaves(got, want, witness, regime, what, tol=1e-4, wtol=1e-5,
                  share=1e-3, outlier_tol=1e-2):
    """Every element of ``got`` (the port's f32 run) within ``tol`` of
    ``want`` (the reference's) of the leaf's max |value|, but where f32
    cannot resolve it, a ``share`` of the leaf at most (2 at least),
    within ``outlier_tol``: each element beyond must be one where
    ``got`` is more than ``wtol`` from ``witness`` (the port's f64 run),
    or one where ``want`` is and the witness's AdamW was in its eps
    regime (``regime``, an ``EpsRegime``)."""
    got, want, witness = flat(got), flat(want), flat(witness)
    assert set(got) == set(want) == set(witness), what
    for p, w in want.items():
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(got[p] - w) / scale
        out = err > tol
        assert out.sum() <= max(2, share * err.size), (what, p, out.sum())
        assert err.max() <= outlier_tol, (what, p, err.max())
        eps = np.broadcast_to(regime.mask.get(p, False), w.shape)
        got64 = np.abs(got[p] - witness[p]) / scale > wtol
        want64 = (np.abs(w - witness[p]) / scale > wtol) & eps
        assert (got64 | want64)[out].all(), (
            what, p, err[out], got64[out], want64[out])


def tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# configs and the block layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_layout(arch):
    """The same paths, shapes and dtypes as the reference's tree: gemma3's
    superblock of local + global sublayers and its unstacked tail,
    qwen3's q_norm / k_norm; caches per kind, with the tail's."""
    jc, tc = configs(arch)
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jc))
    tp = TM.init_params(torch.Generator().manual_seed(0), tc, device="meta")
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in zip(
        map("/".join, (tuple(str(k.key) for k in path) for path, _ in
                       jax.tree_util.tree_flatten_with_path(jp)[0])),
        jax.tree.leaves(jp))}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tpt.tree_leaves_with_path(tp)}
    assert got == want
    jcache = jax.eval_shape(lambda: JM.init_cache(jc, 2, 80))
    tcache = TM.init_cache(tc, 2, 80, device="cpu")
    assert ([tuple(x.shape) for x in jax.tree.leaves(jcache)]
            == [tuple(x.shape) for x in tpt.tree_leaves(tcache)])
    assert (t_train.pick_micro_batches(tc, 8, 4096)
            == j_train.pick_micro_batches(jc, 8, 4096))


# ---------------------------------------------------------------------------
# layers: the window mask, the chunked path, qk-norm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [None, 5])
def test_causal_window_mask_matches_reference(window):
    want = np.asarray(JL._causal_window_mask(12, 20, 8, window, True))
    got = TL._causal_window_mask(12, 20, 8, window, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def _qkv(H, K, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, LONG, h, 64)).astype(np.float32)
            for h in (H, K, K)]


CHUNK_CASES = [(None, 2), (64, 2), (None, 1), (64, 1)]   # (window, K), H 4


@pytest.mark.parametrize("window,K", CHUNK_CASES,
                         ids=["causal-gqa", "window-gqa", "causal-mqa",
                              "window-mqa"])
def test_sdpa_chunked_and_its_gradient_match_reference(window, K, monkeypatch):
    """S 2048 at SMOKE widths (4 heads of 64): the output, and the input
    gradient of <out, g> against ``jax.vjp``'s; under autograd each of
    the four 512-row blocks runs under ``torch.utils.checkpoint``."""
    q, k, v = _qkv(4, K, seed=K + (window or 0))
    g = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    scale = 0.125

    @jax.jit
    def j_run(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: JL._sdpa_chunked(
            q, k, v, scale, window, True), q, k, v)
        return out, vjp(g)
    jo, jg = j_run(*map(jnp.asarray, (q, k, v, g)))

    with torch.no_grad():
        to = TL._sdpa_chunked(*map(torch.as_tensor, (q, k, v)), scale,
                              window)
    assert rel(to, jo) <= 1e-5
    calls = []
    real = TL.checkpoint
    monkeypatch.setattr(TL, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = TL._sdpa_chunked(tq, tk, tv, scale, window)
    (out * torch.as_tensor(g)).sum().backward()
    assert len(calls) == LONG // 512
    for t, j in zip((tq, tk, tv), jg):
        assert rel(t.grad, j) <= 1e-5


def _qwen_layer(jp):
    lay = jax.tree.map(lambda x: x[0], jp["blocks"]["sub0"]["attn"])
    rng = np.random.default_rng(4)
    # non-unit norm weights, so a q_norm / k_norm mix-up shows
    lay["q_norm"] = jnp.asarray(rng.uniform(0.5, 1.5, lay["q_norm"].shape),
                                jnp.float32)
    lay["k_norm"] = jnp.asarray(rng.uniform(0.5, 1.5, lay["k_norm"].shape),
                                jnp.float32)
    return lay


@pytest.mark.parametrize("S", [96, LONG])
def test_qk_norm_attention_matches_reference(models, S):
    """qwen3's attention sublayer with q_norm / k_norm, the prefill cache
    too; at S 2048 through the chunked path."""
    jc, tc = configs("qwen3-32b")
    lay = _qwen_layer(models["qwen3-32b"]["jp"])
    x = np.random.default_rng(S).normal(size=(2, S, jc.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S)).astype(np.int32)
    jy, jcache = jax.jit(JL.attention, static_argnames=(
        "cfg", "chunk_q", "return_cache", "cache_len"))(
        lay, jnp.asarray(x), jnp.asarray(pos), cfg=jc, chunk_q=True,
        return_cache=True, cache_len=S + 8)
    with torch.no_grad():
        ty, tcache = TL.attention(to_port(lay), torch.as_tensor(x),
                                  torch.as_tensor(pos, dtype=torch.int64), tc,
                                  return_cache=True, cache_len=S + 8)
    assert rel(ty, jy) <= 1e-5
    for key in ("k", "v"):
        assert rel(tcache[key], jcache[key]) <= 1e-5


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "cache_len"))
j_greedy = jax.jit(j_serve.greedy_generate, static_argnames=("cfg", "n_new"))


@pytest.fixture(scope="module")
def models():
    """Per config: both configs, the JAX params and their port, a
    LONG-token row, and the JAX package's hidden states (``HIDDEN``),
    prefill logits and cache, and greedy tokens."""
    out = {}
    forward = jax.jit(JM.forward, static_argnames="cfg")
    for arch in ARCHS:
        jc, tc = configs(arch)
        jp = JM.init_params(jax.random.PRNGKey(1), jc)
        hidden = {}
        for S in (S for a, S in HIDDEN if a == arch):
            tok = tokens(jc.vocab_size, 1, S, seed=S)
            hidden[S] = (tok, np.asarray(forward(
                jp, {"tokens": jnp.asarray(tok)}, cfg=jc)[0]))
        S = PROMPT.get(arch, 40)
        prompt = tokens(jc.vocab_size, 2, S, seed=5)
        logits, cache = j_prefill(jp, {"tokens": jnp.asarray(prompt)},
                                  cfg=jc, cache_len=S + N_NEW)
        greedy = np.asarray(j_greedy(jp, {"tokens": jnp.asarray(prompt)},
                                     cfg=jc, n_new=N_NEW))
        out[arch] = dict(jc=jc, tc=tc, jp=jp, tp=to_port(jp), hidden=hidden,
                         long=tokens(jc.vocab_size, 1, LONG, seed=LONG),
                         prompt=prompt, logits=np.asarray(logits),
                         cache=jax.tree.map(np.asarray, cache), greedy=greedy)
    return out


@pytest.mark.parametrize("arch,S", HIDDEN)
def test_hidden_states_match_reference(models, arch, S):
    m = models[arch]
    tok, want = m["hidden"][S]
    with torch.no_grad():
        got = TM.forward(m["tp"], {"tokens": torch.as_tensor(tok)}, m["tc"])[0]
    assert rel(got, want) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(models, arch):
    """Last-row logits, and every cache leaf: gemma3's local layers hold
    their ring (zero-padded up to the window here: 48 < 64), the global
    layers and the tail theirs."""
    m = models[arch]
    S = m["prompt"].shape[1]
    with torch.no_grad():
        logits, cache = TM.prefill(m["tp"], {"tokens": torch.as_tensor(
            m["prompt"])}, m["tc"], cache_len=S + N_NEW)
    assert rel(logits, m["logits"]) <= 1e-4
    got, want = flat(cache), flat(m["cache"])
    assert set(got) == set(want)
    for p in want:
        assert rel(got[p], want[p]) <= 1e-4, p


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-32b"])
def test_serving_leaves_no_tensor_in_a_reference_cycle(models, arch):
    """A prefill (chunked, S 2048) and a greedy generation free their
    intermediates on return: no reference cycle holds a tensor for
    Python's cyclic collector.  (One did: ``tree_map_with_path``'s
    recursive closure kept each prefill's per-layer caches, a second
    copy of the cache, 2056 MiB at llama2-7b 1 x 4096 on the card,
    until the collector ran.)"""
    m = models[arch]
    tok = torch.as_tensor(m["long"])
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        logits, cache = TM.prefill(m["tp"], {"tokens": tok}, m["tc"],
                                   cache_len=LONG + 4)
        del logits, cache
        t_serve.greedy_generate(m["tp"], {"tokens": m["prompt"]}, m["tc"],
                                n_new=4, device="cpu")
        gc.collect()
        held = [tuple(o.shape) for o in gc.garbage if torch.is_tensor(o)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert not held


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(models, arch):
    m = models[arch]
    got = t_serve.greedy_generate(m["tp"], {"tokens": m["prompt"]}, m["tc"],
                                  n_new=N_NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), m["greedy"])


def test_prefill_rolls_a_long_prompt_into_the_ring(models):
    """A prompt longer than the window (S 100 > 64): each local layer
    keeps its last 64 keys rolled so position p sits at slot p % 64."""
    m = models["gemma3-1b"]
    tok = tokens(m["jc"].vocab_size, 1, 100, seed=8)
    _, jcache = j_prefill(m["jp"], {"tokens": jnp.asarray(tok)},
                          cfg=m["jc"], cache_len=120)
    with torch.no_grad():
        _, tcache = TM.prefill(m["tp"], {"tokens": torch.as_tensor(tok)},
                               m["tc"], cache_len=120)
    got, want = flat(tcache), flat(jcache)
    assert got["blocks/sub0/attn/k"].shape[2] == m["jc"].sliding_window
    for p in want:
        assert rel(got[p], want[p]) <= 1e-4, p


@pytest.mark.parametrize("arch", ARCHS)
def test_per_row_decode_matches_reference_across_the_wrap(models, arch):
    """Two rows at their own positions ((B,) cache_index), 24 steps from
    a prefilled cache: gemma3's rows run 48-71 and 56-79, so both wrap
    the 64-slot ring; logits every step and the caches at the end."""
    m = models[arch]
    S = m["prompt"].shape[1]
    offset = np.array([0, 8])
    jlog, jcache = j_prefill(m["jp"], {"tokens": jnp.asarray(m["prompt"])},
                             cfg=m["jc"], cache_len=S + N_NEW)
    with torch.no_grad():
        tlog, tcache = TM.prefill(m["tp"], {"tokens": torch.as_tensor(
            m["prompt"])}, m["tc"], cache_len=S + N_NEW)
    tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    j_step = jax.jit(JM.decode_step, static_argnames="cfg")
    for i in range(24):
        idx = (S + offset + i).astype(np.int32)
        jlog, jcache = j_step(m["jp"], jnp.asarray(tok), jcache,
                              jnp.asarray(idx), cfg=m["jc"])
        with torch.no_grad():
            tlog, tcache = TM.decode_step(m["tp"], torch.as_tensor(tok),
                                          tcache, torch.as_tensor(idx),
                                          m["tc"])
        assert rel(tlog, jlog) <= 1e-4, i
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    got, want = flat(tcache), flat(jcache)
    for p in want:
        assert rel(got[p], want[p]) <= 1e-4, p


@pytest.fixture(scope="module")
def remat_case(models):
    """gemma3 with a decomposed adapter (B_mag nonzero, so every factor
    has a gradient), a 2048-token batch, and the loss and adapter
    gradients at ``remat``."""
    from repro_torch.core import peft as t_peft
    m = models["gemma3-1b"]
    ad = t_peft.add_lora(m["tp"], m["tc"], torch.Generator().manual_seed(0),
                         decomposed=True)
    ad = tpt.tree_map_with_path(
        lambda p, x: x + 0.5 if p.endswith("B_mag") else x, ad)
    tok = torch.as_tensor(m["long"])
    batch = {"tokens": tok, "loss_mask": torch.ones(tok.shape)}

    def grads(remat):
        leaves = tpt.tree_map(lambda x: x.clone().requires_grad_(True), ad)
        loss, _ = TM.loss_and_metrics(tpt.merge_trees(m["tp"], leaves),
                                      batch, m["tc"], remat=remat)
        loss.backward()
        return loss, {p: x.grad for p, x in tpt.tree_leaves_with_path(leaves)}
    return grads, grads(False)


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_with_a_tail_keeps_the_gradients(remat_case, remat):
    """gemma3's superblock and its tail under ``torch.utils.checkpoint``
    (the production engine's ``remat``), over the chunked path at S
    2048: the loss and every adapter gradient as without remat."""
    grads, (l0, g0) = remat_case
    l1, g1 = grads(remat)
    assert any(p.startswith("tail/") for p in g0)
    assert rel(l1, l0) <= 1e-6
    for p in g0:
        assert rel(g1[p], g0[p]) <= 1e-5, p


def test_production_round_with_a_tail_equals_fedsim(models):
    """The production engine's round (one client, no process group; remat
    and 2 micro-batches) at gemma3 (a superblock and an unstacked tail),
    over 96-token rows (past the 64-token window), against the port's
    ``FedSim`` round on the same batches, in f64: every adapter leaf, the
    tail's too, within 1e-9 of its max (``test_torch_train_engine.py``'s
    tolerance)."""
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.launch.train import TrainSettings, make_fed_train_step
    m = models["gemma3-1b"]
    S = 96
    hp = dict(method="fedlora_opt", n_clients=1, local_steps=2, batch=2,
              seq_len=S, lr=1e-2)
    sim = TSim(m["tc"], THyper(**hp), base=tpt.tree_map(
        torch.Tensor.double, m["tp"]), device="cpu")
    sim.client_adapters = tpt.tree_map(torch.Tensor.double,
                                       sim.client_adapters)
    sim.opt_state = sim._init_clients(sim.opt)
    start = tpt.tree_map(torch.clone, sim.client_adapters)
    rng = np.random.default_rng(4)
    steps = [{"tokens": torch.as_tensor(rng.integers(
        0, m["tc"].vocab_size, size=(1, 2, S))),
        "loss_mask": torch.ones((1, 2, S), dtype=torch.float64)}
        for _ in range(2)]         # (micro-batch means: equal token counts)
    step_fn, opt_init = make_fed_train_step(m["tc"], make_client_mesh(1),
                                            TrainSettings(
        lr=1e-2, micro_batches=2, clip=1.0, remat=True, local_steps=2),
        device="cpu")
    got, _, _ = step_fn(sim.base, start, opt_init(start), 0, {
        k: torch.cat([b[k] for b in steps], dim=1) for k in steps[0]})
    sim.local_round(steps)
    sim.aggregate()
    want = flat(sim.client_adapters)
    got = flat(got)
    assert any(p.startswith("tail/") for p in want) and set(got) == set(want)
    for p, w in want.items():
        assert np.abs(got[p] - w).max() <= 1e-9 * max(np.abs(w).max(),
                                                      1e-30), p


@pytest.mark.parametrize("arch", ARCHS)
def test_pooled_greedy_equals_merged(models, arch):
    """Two dora_mag tenants (each its own ΔB_M over a shared decomposed
    adapter, gemma3's tail targets among them) served in one batch
    through greedy_generate with adapter_idx (the plain BGMV path on the
    CPU): each row's tokens equal its merged model's."""
    from repro_torch.core import peft as t_peft
    m = models[arch]
    g = torch.Generator().manual_seed(2)
    shared = tpt.tree_map_with_path(
        lambda p, x: x + 0.3 if p.endswith("B_mag") else x,
        t_peft.add_lora(m["tp"], m["tc"], g, decomposed=True))
    store = TStore(m["tp"], m["tc"], n_slots=2, kind="dora_mag",
                   shared=shared, device="cpu")
    deltas = [tpt.tree_map(lambda x: torch.randn(x.shape, generator=g),
                           tpt.filter_tree(shared,
                                           lambda p: p.endswith("/dB_mag")))
              for _ in range(2)]
    for t, d in enumerate(deltas):
        store.register(f"t{t}", d)
    idx = torch.tensor([store.slot_of("t0"), store.slot_of("t1")])
    pooled = t_serve.greedy_generate(
        tpt.merge_trees(m["tp"], store.overlay()), {"tokens": m["prompt"]},
        m["tc"], n_new=8, adapter_idx=idx, device="cpu")
    for t, d in enumerate(deltas):
        merged = t_serve.greedy_generate(
            tpt.merge_trees(m["tp"], tpt.merge_trees(shared, d)),
            {"tokens": m["prompt"][t:t + 1]}, m["tc"], n_new=8, device="cpu")
        assert torch.equal(pooled[t:t + 1], merged), t


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-32b"])
def test_checkpoint_bytes_equal_reference(models, arch, tmp_path):
    """The backbone (gemma3's tail, qwen3's q_norm / k_norm) saved by
    each package is the same file, and the port restores the
    reference's."""
    from repro.checkpoint import ckpt as j_ckpt
    from repro_torch.checkpoint import ckpt as t_ckpt
    m = models[arch]
    j_ckpt.save_checkpoint(str(tmp_path / "j.ckpt"), m["jp"], step=3)
    t_ckpt.save_checkpoint(str(tmp_path / "t.ckpt"), m["tp"], step=3)
    assert (tmp_path / "j.ckpt").read_bytes() == \
        (tmp_path / "t.ckpt").read_bytes()
    flat_j, step = t_ckpt.load_checkpoint_flat(str(tmp_path / "j.ckpt"))
    assert step == 3 and set(flat_j) == set(flat(m["tp"]))


# ---------------------------------------------------------------------------
# the flash_attention dispatch on the CPU
# ---------------------------------------------------------------------------

def test_long_prefill_dispatch_on_the_cpu(models):
    """kernel_impl None and "torch" take the plain chunked path on a CPU
    tensor (no launch counted, equal outputs); "cuda" raises on a CPU
    tensor, and under autograd, where the kernel has no backward."""
    jc, tc = configs("gemma3-1b")
    lay = to_port(jax.tree.map(lambda x: x[0],
                               models["gemma3-1b"]["jp"]["blocks"]["sub0"][
                                   "attn"]))
    x = torch.as_tensor(np.random.default_rng(2).normal(
        size=(1, LONG, tc.d_model)).astype(np.float32))
    pos = torch.arange(LONG)[None]
    kw = dict(kind="local")
    before = FK.LAUNCHES["flash_attention"]
    with torch.no_grad():
        y_none = TL.attention(lay, x, pos, tc, **kw)[0]
        y_torch = TL.attention(lay, x, pos, tc, kernel_impl="torch", **kw)[0]
        with pytest.raises(ValueError, match="CUDA"):
            TL.attention(lay, x, pos, tc, kernel_impl="cuda", **kw)
    assert FK.LAUNCHES["flash_attention"] == before
    assert torch.equal(y_none, y_torch)
    grad_lay = tpt.tree_map(lambda t: t.clone().requires_grad_(True), lay)
    with pytest.raises(ValueError, match="no backward"):
        TL.attention(grad_lay, x, pos, tc, kernel_impl="cuda", **kw)
    y = TL.attention(grad_lay, x, pos, tc, **kw)[0]
    assert y.requires_grad and torch.equal(y.detach(), y_none)


def test_serve_engine_refuses_windowed_configs(models):
    """Both packages' ServeEngine refuse gemma3 (local layers): a windowed
    model is served through greedy_generate."""
    m = models["gemma3-1b"]
    with pytest.raises(ValueError, match="sliding-window"):
        JEngine(m["jp"], m["jc"], JStore(m["jp"], m["jc"], n_slots=2))
    with pytest.raises(ValueError, match="sliding-window"):
        TEngine(m["tp"], m["tc"], TStore(m["tp"], m["tc"], n_slots=2,
                                         device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# FedSim: the paper's pipeline at gemma3-1b (tail) and qwen3-32b (qk-norm)
# ---------------------------------------------------------------------------

FED = dict(n_clients=2, local_steps=2, batch=2, seq_len=96, global_steps=1,
           personal_steps=1, lr=3e-3, server_lr=2e-3, seed=0)


def _fed_data(pkg, part, vocab):
    fam = pkg.make_dataset_family("dolly", vocab_size=vocab)
    p = part.specialist_partition(FED["n_clients"], 4)
    return ([pkg.SyntheticInstructionDataset(fam, p[c], client_seed=c)
             for c in range(FED["n_clients"])],
            pkg.SyntheticInstructionDataset(fam, np.ones(4) / 4,
                                            client_seed=99))


def _batches(pkg_loader, ds, seed, n, **kw):
    rng = np.random.default_rng(seed)
    return [pkg_loader.client_batch(ds, rng, FED["batch"], FED["seq_len"],
                                    **kw) for _ in range(n)]


def _first(tree):
    if isinstance(tree, dict):
        return {k: _first(v) for k, v in tree.items()}
    return tree[0]


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-32b"])
def test_fedsim_pipeline_matches_reference(models, arch):
    """fedlora_opt: one round of stage 1, the aggregate, a stage-2 step
    and a stage-3 step, every client leaf (the tail's too) against the
    reference; the port's f64 run is the witness of AdamW's eps regime."""
    jc, tc = configs(arch)
    hp = dict(method="fedlora_opt", **FED)
    js = JSim(jc, JHyper(**hp), base=models[arch]["jp"])
    sims = []
    for dt in (torch.float32, torch.float64):
        ts = TSim(tc, THyper(**hp), base=to_port(js.base, dt), device="cpu")
        ts.client_adapters = to_port(js.client_adapters, dt)
        sims.append(ts)
    regime = EpsRegime(sims[1])
    assert (arch == "gemma3-1b") == any(
        p.startswith("tail/")
        for p, _ in tpt.tree_leaves_with_path(sims[0].client_adapters))
    j_ds, j_srv = _fed_data(j_syn, j_part, jc.vocab_size)
    t_ds, t_srv = _fed_data(t_syn, t_part, tc.vocab_size)
    n = FED["local_steps"]
    jb = _batches(j_loader, j_ds, 0, n)
    tb = _batches(t_loader, t_ds, 0, n, device="cpu")
    js.local_round(jb, jax.random.PRNGKey(0))
    for ts in sims:
        ts.local_round(tb, torch.Generator().manual_seed(0))
    assert_leaves(sims[0].client_adapters, js.client_adapters,
                  sims[1].client_adapters, regime, f"{arch} stage 1")
    j_agg = js.aggregate()
    t_aggs = [ts.aggregate() for ts in sims]
    assert_leaves(t_aggs[0], j_agg, t_aggs[1], regime, f"{arch} aggregate")
    j_sb = [_first(b) for b in _batches(j_loader, [j_srv], 1, 1)]
    t_sb = [_first(b) for b in _batches(t_loader, [t_srv], 1, 1,
                                        device="cpu")]
    j_agg = js.global_stage(j_agg, j_sb, jax.random.PRNGKey(1))
    t_aggs = [ts.global_stage(a, t_sb, torch.Generator().manual_seed(1))
              for ts, a in zip(sims, t_aggs)]
    assert_leaves(t_aggs[0], j_agg, t_aggs[1], regime, f"{arch} stage 2")
    jb = _batches(j_loader, j_ds, 2, 1)
    tb = _batches(t_loader, t_ds, 2, 1, device="cpu")
    js.personalize(jb, jax.random.PRNGKey(2))
    for ts in sims:
        ts.personalize(tb, torch.Generator().manual_seed(2))
    assert_leaves(sims[0].client_adapters, js.client_adapters,
                  sims[1].client_adapters, regime, f"{arch} stage 3")
