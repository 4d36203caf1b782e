"""SSM and hybrid models in the port against the JAX package, on the CPU:
the Mamba-2 mixer (``models/ssm.py``: ``_causal_conv``, ``mamba2_mixer``
on a prefill and on a decode step, ``init_ssm_cache``), the scan's
dispatch to the ``ssd_scan`` kernel, and the SMOKE configs of
mamba2-2.7b and jamba-v0.1-52b (attention + dense / Mamba + MoE
superblocks, and at 3 layers a tail) run, served and trained.

Parameters are drawn by the JAX package and carried across by
``checkpoint.bridge``; inputs come from numpy seeds.  The JAX runs are
shared through module fixtures, and the port's ``FedSim`` runs on one
intra-op thread.

Tolerances (f32 arithmetic summed in another order by another BLAS; the
reference carries the scan's state by an associative scan, the port by
a loop over chunks):
- ``_causal_conv`` within 1e-6 of max |y| (the same f32 products summed
  in the same order), its state equal;
- one mixer's output, prefill cache and decode step within 1e-5 of max
  |value|;
- hidden states, prefill logits and caches, decode logits within 1e-4
  of max |value| over the SMOKE configs; decode after a prefill of S − 1
  tokens against the full forward's last row within 1e-4 (the
  reference's ``tests/test_models_smoke.py`` check holds 1e-3 / 1e-4);
  greedy tokens equal;
- the sensitivity report within 1e-5 relative; checkpoints byte for
  byte;
- the scan's dispatch: the kernel branch, driven through
  ``ops.ssd_scan(..., impl="torch")`` (the kernel's plain version), bit
  for bit the plain branch's in f32, and in bf16 its y the plain y
  rounded once to bf16;
- the ``run_federated`` leaves by ``tests/test_torch_fed_methods.py``'s
  AdamW-eps rule against the port's f64 run, a leaf every client holds
  alike (the rebroadcast shared factors) counted once, not once a
  client.  Measured: jamba's q_proj dA_dir after stage 2 reads 2.8e-4 of
  its max on 2 of 1024 elements, 1.7e-4 and 9.2e-5 from the port's f64
  run, while the reference sits 1.1e-4 and 9.6e-5 from it; every other
  element within 1e-4.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.configs import get_config as j_get, get_smoke_config as j_smoke
from repro.core import fedlora as j_fedlora
from repro.core import peft as j_peft
from repro.core.sensitivity import sensitivity_report as j_sensitivity
from repro.data import loader as j_loader
from repro.data import partition as j_part
from repro.data import synthetic as j_syn
from repro.fed.simulate import FedHyper as JHyper
from repro.launch import serve as j_serve
from repro.models import model as JM
from repro.models import ssm as JS
from repro.serve import AdapterStore as JStore, ServeEngine as JEngine
from repro.utils import pytree as jpt
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import fedlora as t_fedlora
from repro_torch.core import methods as t_methods
from repro_torch.core.sensitivity import sensitivity_report as t_sensitivity
from repro_torch.data import loader as t_loader
from repro_torch.data import partition as t_part
from repro_torch.data import synthetic as t_syn
from repro_torch.fed.simulate import FedHyper as THyper
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve as t_serve
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.serve import AdapterStore as TStore, ServeEngine as TEngine
from repro_torch.utils import pytree as tpt
from test_torch_fed_methods import assert_leaves

MAMBA, JAMBA = "mamba2-2.7b", "jamba-v0.1-52b"
ARCHS = (MAMBA, JAMBA)
# (arch, layers): mamba2's 2 SMOKE layers (a stack of 2 one-sublayer
# superblocks); jamba's 2 (one superblock: attention + dense, Mamba +
# MoE) and 3 (that superblock and a tail of its first sublayer)
CASES = ((MAMBA, 2), (JAMBA, 2), (JAMBA, 3))
CASE_IDS = ["mamba2", "jamba", "jamba-tail"]
PROMPT = 40             # not a multiple of the SMOKE chunk 16: padded
N_NEW = 16


def configs(arch, **kw):
    kw = dict(lora_dropout=0.0, **kw)
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
    return dict(zip(jpt.tree_paths(tree), map(np.asarray,
                                              jax.tree.leaves(tree))))


def tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _shared_adapter(jp, jc, seed):
    """A decomposed adapter on the config's targets with B_mag moved off
    0, so that every factor changes the model."""
    shared = j_peft.add_lora(jp, jc, jax.random.PRNGKey(seed),
                             decomposed=True)
    return jpt.tree_map_with_path(
        lambda p, x: x + 0.25 if p.endswith("B_mag") else x, shared)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# configs and the parameter layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_layout_equal_the_reference(models, arch):
    """ARCH and SMOKE field for field and their block layouts; the SMOKE
    trees (jamba's also at 3 layers, with its tail) with the reference's
    paths, shapes and dtypes (the f32 A_log, D_skip, dt_bias, norm_w),
    and the fixed leaves' values."""
    assert dataclasses.asdict(t_get(arch)) == dataclasses.asdict(j_get(arch))
    for t, j in ((t_get(arch), j_get(arch)), configs(arch)[::-1]):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        (ts, tt, tp), (js, jt, jp) = t.blocks_layout(), j.blocks_layout()
        assert (ts, tt) == (js, jt)
        assert ([dataclasses.astuple(s) for s in tp]
                == [dataclasses.astuple(s) for s in jp])
    for nl in ((2, 3) if arch == JAMBA else (2,)):
        jc, tc = configs(arch, n_layers=nl)
        jtree = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                      jc))
        want = {p: (tuple(x.shape), str(x.dtype))
                for p, x in zip(jpt.tree_paths(jtree), jax.tree.leaves(jtree))}
        ttree = TM.init_params(torch.Generator().manual_seed(0), tc,
                               device="meta")
        got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for p, x in tpt.tree_leaves_with_path(ttree)}
        assert got == want
    tp = TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    want = flat(models["mamba2" if arch == MAMBA else "jamba-tail"]["jp"])
    for path in ("A_log", "D_skip", "dt_bias", "norm_w"):
        p = f"blocks/sub{1 if arch == JAMBA else 0}/ssm/{path}"
        assert rel(tpt.tree_get(tp, p), want[p]) <= 1e-6, p


# ---------------------------------------------------------------------------
# the mixer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(int(with_state))
    x = rng.normal(size=(2, 13, 24)).astype(np.float32)
    w = rng.normal(size=(24, 4)).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state \
        else None
    jy, jst = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                              None if st is None else jnp.asarray(st))
    ty, tst = TS._causal_conv(torch.as_tensor(x), torch.as_tensor(w),
                              None if st is None else torch.as_tensor(st))
    assert rel(ty, jy) <= 1e-6
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    # causal: the future does not change the past
    x2 = x.copy()
    x2[:, 9:] = 0.0
    ty2, _ = TS._causal_conv(torch.as_tensor(x2), torch.as_tensor(w),
                             None if st is None else torch.as_tensor(st))
    assert torch.equal(ty2[:, :9], ty[:, :9])


def test_init_ssm_cache_shapes():
    """The reference's shapes per row, behind the (n_sb, batch) lead the
    stacked cache takes; zeros in the given dtype."""
    _, tc = configs(MAMBA)
    jc, _ = configs(MAMBA)
    want = JS.init_ssm_cache(jc, 3, jnp.bfloat16)
    got = TS.init_ssm_cache(tc, (2, 3), torch.bfloat16, "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == (2,) + tuple(v.shape), k
        assert got[k].dtype == torch.bfloat16 and not got[k].any()
    H = tc.d_model * tc.ssm_expand // tc.ssm_headdim
    assert tuple(want["state"].shape) == (3, H, tc.ssm_headdim, tc.ssm_state)
    one = TS.init_ssm_cache(tc, 3, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in one.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


j_mixer = jax.jit(JS.mamba2_mixer,
                  static_argnames=("cfg", "lora_scale", "return_cache"))


@pytest.fixture(scope="module")
def mixer(models):
    """mamba2 SMOKE's first mixer with a decomposed adapter on x_proj and
    out_proj (B_mag off 0), unstacked, both packages'."""
    jc, tc, jp = (models["mamba2"][k] for k in ("jc", "tc", "jp"))
    merged = jpt.merge_trees(jp, _shared_adapter(jp, jc, 4))
    p = jax.tree.map(lambda x: x[0], merged["blocks"]["sub0"]["ssm"])
    assert "A_dir" in p["x_proj"] and "A_dir" in p["out_proj"]
    return jc, tc, p, to_port(p), jc.lora_alpha / jc.lora_rank


def _mixer_inputs(d, B=2, S=33, seed=5):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


@pytest.mark.parametrize("S", [32, 24])
def test_mixer_prefill_and_decode_match_reference(mixer, S):
    """A prefill of S tokens (32: two chunks of 16; 24: padded to 32)
    with its cache, then one decode step from that cache: outputs and
    caches within 1e-5 of max; the decode step also equals the full
    sequence's last row (both packages)."""
    jc, tc, jp, tp, scale = mixer
    x = _mixer_inputs(jc.d_model)[:, :S + 1]
    jy, jcache = j_mixer(jp, jnp.asarray(x[:, :S]), cfg=jc, lora_scale=scale,
                         return_cache=True)
    jd, jcache2 = j_mixer(jp, jnp.asarray(x[:, S:]), cfg=jc, cache=jcache,
                          lora_scale=scale)
    with torch.no_grad():
        ty, tcache = TS.mamba2_mixer(tp, torch.as_tensor(x[:, :S]), tc,
                                     lora_scale=scale, return_cache=True)
        assert rel(ty, jy) <= 1e-5
        for k in jcache:
            assert rel(tcache[k], jcache[k]) <= 1e-5, k
        td, tcache2 = TS.mamba2_mixer(tp, torch.as_tensor(x[:, S:]), tc,
                                      cache=tcache, lora_scale=scale)
        full, _ = TS.mamba2_mixer(tp, torch.as_tensor(x), tc,
                                  lora_scale=scale)
    assert tcache2 is tcache                       # written in place
    assert rel(td, jd) <= 1e-5
    for k in jcache2:
        assert rel(tcache2[k], jcache2[k]) <= 1e-5, k
    assert rel(td[:, 0], full[:, S]) <= 1e-5


# ---------------------------------------------------------------------------
# the scan's dispatch to the kernel
# ---------------------------------------------------------------------------

def _scan_inputs(tc, dtype, S=24, seed=6):
    """mixer-shaped scan inputs (b, S, H, P) etc. in ``dtype``; dt > 0."""
    rng = np.random.default_rng(seed)
    H = tc.d_model * tc.ssm_expand // tc.ssm_headdim

    def n(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))
    x = n(2, S, H, tc.ssm_headdim).to(dtype)
    dt = torch.nn.functional.softplus(n(2, S, H) - 1.0)
    A_log = torch.log(torch.linspace(1.0, 16.0, H))
    B = n(2, S, tc.ssm_groups, tc.ssm_state).to(dtype)
    C = n(2, S, tc.ssm_groups, tc.ssm_state).to(dtype)
    return x, dt, A_log, B, C


@pytest.fixture
def kernel_branch(monkeypatch):
    """The scan's kernel branch on the CPU: ``resolve_impl`` answers
    "cuda" for impl None, as on the card, and ``ops.ssd_scan`` runs with
    impl "torch" (the kernel's plain version, which returns y in x's
    dtype as the kernel does).  Records each call's x shape, chunk and
    impl."""
    calls = []
    real = ssd_ops.ssd_scan

    def scan(x, dt, A_log, B, C, *, chunk, impl):
        calls.append((tuple(x.shape), chunk, impl))
        return real(x, dt, A_log, B, C, chunk=chunk, impl="torch")
    monkeypatch.setattr(TS, "resolve_impl",
                        lambda impl, x, op: impl or "cuda")
    monkeypatch.setattr(ssd_ops, "ssd_scan", scan)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_dispatch_glue(kernel_branch, mixer, dtype):
    """S = 24 at chunk 16: the kernel branch gets the inputs padded to 32
    and the chunk 16, its y back in x's dtype and cut to 24; in f32 it
    is the plain branch bit for bit (and so is the whole mixer, D_skip
    added after), in bf16 its y is the plain f32 y rounded once (the
    extra rounding ``_ssd``'s docstring states) and the states equal.
    Under autograd the plain branch runs and the kernel is not called."""
    _, tc, _, tp, scale = mixer
    args = _scan_inputs(tc, dtype)
    with torch.no_grad():
        yk, sk = TS._ssd(*args, tc.ssm_chunk)
        yp, sp = TS._ssd(*args, tc.ssm_chunk, kernel_impl="torch")
    assert kernel_branch == [((2, 32) + tuple(args[0].shape[2:]), 16, "cuda")]
    assert yk.dtype == dtype and yp.dtype == torch.float32
    assert yk.shape == yp.shape == args[0].shape
    assert torch.equal(yk, yp.to(dtype)) and torch.equal(sk, sp)
    x = torch.as_tensor(_mixer_inputs(tc.d_model)[:, :24])
    p = tpt.tree_map(lambda t: t.to(dtype) if t.dim() > 1 else t, tp)
    with torch.no_grad():
        mk, ck = TS.mamba2_mixer(p, x.to(dtype), tc, lora_scale=scale,
                                 return_cache=True)
        mp, cp = TS.mamba2_mixer(p, x.to(dtype), tc, lora_scale=scale,
                                 return_cache=True, kernel_impl="torch")
    assert len(kernel_branch) == 2
    for k in cp:
        assert torch.equal(ck[k], cp[k]), k
    if dtype == torch.float32:
        assert torch.equal(mk, mp)
    else:
        assert rel(mk, mp) <= 2e-2
    n = len(kernel_branch)
    xg = x.clone().requires_grad_(True)
    y, _ = TS.mamba2_mixer(tp, xg, tc, lora_scale=scale)
    y.sum().backward()
    assert len(kernel_branch) == n and xg.grad is not None


def test_kernel_impl_cuda_raises_under_autograd_and_on_the_cpu(mixer):
    """kernel_impl="cuda" never falls back: under autograd it raises (the
    kernel has no backward), and on a CPU tensor without a gradient the
    CUDA wrapper refuses it."""
    _, tc, _, tp, scale = mixer
    x = torch.as_tensor(_mixer_inputs(tc.d_model)[:, :16])
    with pytest.raises(ValueError, match="no backward"):
        TS.mamba2_mixer(tp, x.requires_grad_(True), tc, lora_scale=scale,
                        kernel_impl="cuda")
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        TS.mamba2_mixer(tp, x.detach(), tc, kernel_impl="cuda")


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

j_forward = jax.jit(JM.forward, static_argnames="cfg")
j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "cache_len"))
j_decode = jax.jit(JM.decode_step, static_argnames="cfg")
j_greedy = jax.jit(j_serve.greedy_generate, static_argnames=("cfg", "n_new"))


@pytest.fixture(scope="module")
def models():
    """Per case: both configs, the JAX params and their port, the prompt,
    and the JAX package's hidden states and aux, prefill logits and cache
    (of the prompt but its last token), the decode step's logits from
    that cache, and greedy tokens."""
    out = {}
    for cid, (arch, nl) in zip(CASE_IDS, CASES):
        jc, tc = configs(arch, n_layers=nl)
        jp = JM.init_params(jax.random.PRNGKey(1), jc)
        prompt = tokens(jc.vocab_size, 2, PROMPT, seed=5)
        h, _, aux = j_forward(jp, {"tokens": jnp.asarray(prompt)}, cfg=jc)
        logits, cache = j_prefill(jp, {"tokens": jnp.asarray(
            prompt[:, :-1])}, cfg=jc, cache_len=PROMPT + N_NEW)
        dlog, _ = j_decode(jp, jnp.asarray(prompt[:, -1]), cache,
                           jnp.asarray(PROMPT - 1), cfg=jc)
        greedy = np.asarray(j_greedy(jp, {"tokens": jnp.asarray(prompt)},
                                     cfg=jc, n_new=N_NEW))
        out[cid] = dict(jc=jc, tc=tc, jp=jp, tp=to_port(jp), prompt=prompt,
                        hidden=np.asarray(h), aux=float(aux),
                        logits=np.asarray(logits),
                        cache=jax.tree.map(np.asarray, cache),
                        decode=np.asarray(dlog), greedy=greedy)
    return out


@pytest.mark.parametrize("case", CASE_IDS)
def test_hidden_states_and_aux_match_reference(models, case):
    m = models[case]
    with torch.no_grad():
        got, _, aux = TM.forward(m["tp"], {"tokens": torch.as_tensor(
            m["prompt"])}, m["tc"])
    assert rel(got, m["hidden"]) <= 1e-4
    assert abs(float(aux) - m["aux"]) <= 1e-6 * m["tc"].n_layers
    assert (float(aux) > 0) == (m["tc"].family == "hybrid")


@pytest.mark.parametrize("case", CASE_IDS)
def test_prefill_and_decode_match_reference_and_the_forward(models, case):
    """The prefill of the prompt but its last token (39: padded to 48 in
    the scan): logits and every cache leaf (attention k/v, SSM state and
    conv states; stack and tail); then one decode step of the last
    token: logits against the reference's and against the full forward's
    last row, and the SSM cache written in place."""
    m = models[case]
    tp, tc = m["tp"], m["tc"]
    with torch.no_grad():
        logits, cache = TM.prefill(tp, {"tokens": torch.as_tensor(
            m["prompt"][:, :-1])}, tc, cache_len=PROMPT + N_NEW)
        assert rel(logits, m["logits"]) <= 1e-4
        got, want = flat(cache), flat(m["cache"])
        assert set(got) == set(want) and any("/ssm/" in p for p in want)
        for p in want:
            assert rel(got[p], want[p]) <= 1e-4, p
        ptrs = {p: x.data_ptr() for p, x in tpt.tree_leaves_with_path(cache)}
        state = {p: x.clone() for p, x in tpt.tree_leaves_with_path(cache)
                 if p.endswith("/ssm/state")}
        dlog, cache2 = TM.decode_step(tp, torch.as_tensor(m["prompt"][:, -1]),
                                      cache, PROMPT - 1, tc)
        h, _, _ = TM.forward(tp, {"tokens": torch.as_tensor(m["prompt"])}, tc)
    assert rel(dlog, m["decode"]) <= 1e-4
    full = (h[:, -1] @ TM._head_kernel(tp, tc)).float()
    assert rel(dlog, full) <= 1e-4
    assert all(x.data_ptr() == ptrs[p]
               for p, x in tpt.tree_leaves_with_path(cache2))
    assert state and all(not torch.equal(tpt.tree_get(cache2, p), x)
                         for p, x in state.items())


@pytest.mark.parametrize("case", CASE_IDS)
def test_greedy_tokens_match_reference(models, case):
    m = models[case]
    got = t_serve.greedy_generate(m["tp"], {"tokens": m["prompt"]}, m["tc"],
                                  n_new=N_NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), m["greedy"])


def test_init_cache_mixes_attention_and_ssm_caches(models):
    """jamba at 3 layers: the stack's sub0 an attention cache and sub1 an
    SSM cache behind (n_sb, batch), the tail's sub0 an attention cache;
    the same paths and shapes as the reference's."""
    m = models["jamba-tail"]
    want = flat(JM.init_cache(m["jc"], 2, 24))
    got = flat(TM.init_cache(m["tc"], 2, 24, device="cpu"))
    assert {p: v.shape for p, v in got.items()} == {
        p: v.shape for p, v in want.items()}
    assert {"blocks/sub0/attn/k", "blocks/sub1/ssm/state",
            "tail/sub0/attn/k"} <= set(got)


# ---------------------------------------------------------------------------
# serving: the refusals, and jamba's tenants through bgmv_mag
# ---------------------------------------------------------------------------

def test_pooled_mixer_projections_are_refused(models):
    """mamba2's targets are the mixer's x_proj / out_proj.  A pooled
    dora_mag tree there: the reference's forward adds no adapter (its
    mixer passes no adapter_idx, and its linear skips pooled leaves
    without A_dir), so every tenant is served the bare backbone; the
    port raises instead."""
    m = models["mamba2"]
    shared = _shared_adapter(m["jp"], m["jc"], 7)
    js = JStore(m["jp"], m["jc"], n_slots=2, kind="dora_mag", shared=shared)
    delta = jax.tree.map(lambda x: jnp.ones_like(x), jpt.filter_tree(
        shared, lambda p: p.endswith("dB_mag")))
    js.register("t0", delta)
    pooled = jpt.merge_trees(m["jp"], js.overlay())
    assert any("pool_dB_mag" in p for p in jpt.tree_paths(pooled))
    idx = jnp.asarray([js.slot_of("t0"), js.slot_of("t0")], jnp.int32)
    h, _, _ = j_forward(pooled, {"tokens": jnp.asarray(m["prompt"]),
                                 "adapter_idx": idx}, cfg=m["jc"])
    np.testing.assert_array_equal(np.asarray(h), m["hidden"])   # bare
    ts = TStore(m["tp"], m["tc"], n_slots=2, kind="dora_mag",
                shared=to_port(shared), device="cpu")
    ts.register("t0", to_port(delta))
    with pytest.raises(ValueError, match="pooled adapter leaves"):
        t_serve.greedy_generate(
            tpt.merge_trees(m["tp"], ts.overlay()), {"tokens": m["prompt"]},
            m["tc"], n_new=2, adapter_idx=torch.tensor([0, 0]), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_refuses_ssm_and_hybrid(models, arch):
    """Both packages' ServeEngine take attention-cache families only."""
    m = models["mamba2" if arch == MAMBA else "jamba"]
    shared = _shared_adapter(m["jp"], m["jc"], 8)
    js = JStore(m["jp"], m["jc"], n_slots=2, kind="dora_mag", shared=shared)
    ts = TStore(m["tp"], m["tc"], n_slots=2, kind="dora_mag",
                shared=to_port(shared), device="cpu")
    with pytest.raises(ValueError, match="attention-cache families"):
        JEngine(m["jp"], m["jc"], js)
    with pytest.raises(ValueError, match="attention-cache families"):
        TEngine(m["tp"], m["tc"], ts, device="cpu")


def test_jamba_pooled_greedy_equals_merged(models):
    """jamba's targets (q/v) sit in its attention sublayer: two dora_mag
    tenants in one batch through greedy_generate with adapter_idx
    (``bgmv_mag``'s plain version here) equal, row by row, their merged
    models' tokens."""
    m = models["jamba-tail"]
    shared = to_port(_shared_adapter(m["jp"], m["jc"], 9))
    store = TStore(m["tp"], m["tc"], n_slots=2, kind="dora_mag",
                   shared=shared, device="cpu")
    g = torch.Generator().manual_seed(2)
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


# ---------------------------------------------------------------------------
# the generic paths on SSM trees: sensitivity, checkpoints
# ---------------------------------------------------------------------------

def test_sensitivity_report_on_ssm_adapters(models):
    """Fig. 1's report over mamba2's x_proj / out_proj adapters: zero for
    identical adapters (the reference's tests/test_ssm_ckpt.py check),
    and the reference's numbers for two tasks against their mean."""
    m = models["mamba2"]
    ads = [_shared_adapter(m["jp"], m["jc"], s) for s in (10, 11)]
    mean = jax.tree.map(lambda a, b: (a + b) / 2, *ads)
    same = t_sensitivity({"t": to_port(ads[0])}, to_port(ads[0]))
    assert same["mean"]["dM_A"] < 1e-6 and same["mean"]["dD_B"] < 1e-5
    want = j_sensitivity({"a": ads[0], "b": ads[1]}, mean)
    got = t_sensitivity({"a": to_port(ads[0]), "b": to_port(ads[1])},
                        to_port(mean))
    assert set(got) == set(want) and set(got["mean"]) == set(want["mean"])
    for k, v in want["mean"].items():
        assert abs(got["mean"][k] - v) <= 1e-5 * max(abs(v), 1e-6), k


def test_ssm_checkpoint_is_byte_identical_both_ways(models, tmp_path):
    """A mamba2 backbone with its x_proj / out_proj adapters: the port's
    file equals the reference's byte for byte, and each package restores
    the other's."""
    m = models["mamba2"]
    jtree = jpt.merge_trees(m["jp"], _shared_adapter(m["jp"], m["jc"], 12))
    ttree = to_port(jtree)
    jpath, tpath = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    j_ckpt.save_checkpoint(jpath, jtree, step=3)
    t_ckpt.save_checkpoint(tpath, ttree, step=3)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    got, step = t_ckpt.restore_checkpoint(jpath, ttree)
    assert step == 3
    for p, x in tpt.tree_leaves_with_path(got):
        assert torch.equal(x, tpt.tree_get(ttree, p)), p
    back, _ = j_ckpt.restore_checkpoint(tpath, jtree)
    want = flat(jtree)
    for p, x in flat(back).items():
        np.testing.assert_array_equal(x, want[p], err_msg=p)


# ---------------------------------------------------------------------------
# training: run_federated
# ---------------------------------------------------------------------------

C, B, S = 4, 2, 24
FED = dict(n_clients=C, rounds=1, local_steps=2, batch=B, seq_len=S,
           global_steps=1, personal_steps=1, lr=3e-3, server_lr=2e-3,
           seed=0)


def _capturing(monkeypatch, module):
    """Swap ``module.FedSim`` for a subclass that records each instance and
    the client adapters before and after each ``aggregate``."""
    made = []

    class Captured(module.FedSim):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def aggregate(self, **kw):
            self.pre_aggregate = flat(self.client_adapters)
            self.aggregated = super().aggregate(**kw)
            return self.aggregated
    monkeypatch.setattr(module, "FedSim", Captured)
    return made


def _one_copy(*trees):
    """The client-stacked trees flattened, with each leaf that every
    client holds alike in all of them (the rebroadcast shared leaves,
    dA_dir among them) cut to client 0's copy, so that an element of the
    server's is counted once, not once a client."""
    fl = [flat(t) for t in trees]
    for p in fl[0]:
        if all((f[p] == f[p][:1]).all() for f in fl):
            for f in fl:
                f[p] = f[p][:1]
    return fl


@pytest.mark.parametrize("arch", ARCHS)
def test_run_federated_pipeline_matches_reference(models, monkeypatch, arch):
    """fedlora_opt through both packages' run_federated at the SMOKE
    config (mamba2: the adapters on x_proj / out_proj, the scan under
    autograd; jamba: q / v, the MoE aux in the loss): 4 dolly clients, 1
    round of 2 steps (S = 24, padded in the scan), a stage-2 and a
    stage-3 step.  The port starts from the reference's backbone and
    adapter, and runs again in f64 as the witness."""
    m = models["mamba2" if arch == MAMBA else "jamba"]
    jc, tc = m["jc"], m["tc"]
    jm = t_methods.get_method("fedlora_opt")

    def make(base, cfg, generator):
        from repro.core.methods import get_method as jget
        _, r_ad = jax.random.split(jax.random.PRNGKey(FED["seed"]))
        dt = tpt.tree_leaves(base)[0].dtype
        return tpt.tree_map(lambda x: x.to(dt), to_port(
            jget("fedlora_opt").make_adapter(m["jp"], jc, r_ad)))
    monkeypatch.setitem(t_methods._REGISTRY, "fedlora_opt",
                        dataclasses.replace(jm, make_adapter=make))
    j_sims = _capturing(monkeypatch, j_fedlora)
    t_sims = _capturing(monkeypatch, t_fedlora)

    def data(pkg, part):
        fam = pkg.make_dataset_family("dolly", vocab_size=jc.vocab_size)
        p = part.specialist_partition(C, 4)
        return ([pkg.SyntheticInstructionDataset(fam, p[c], client_seed=c)
                 for c in range(C)],
                pkg.SyntheticInstructionDataset(fam, np.ones(4) / 4,
                                                client_seed=99))
    j_ds, j_srv = data(j_syn, j_part)
    t_ds, t_srv = data(t_syn, t_part)
    want = j_fedlora.run_federated(
        jc, JHyper(method="fedlora_opt", **FED), j_ds, j_srv,
        j_loader.eval_batches(j_srv, B, S, 1, seed=11),
        [j_loader.client_batch(j_ds, np.random.default_rng(9), B, S)],
        base=m["jp"])
    runs = []
    for dt in (torch.float32, torch.float64):
        runs.append(t_fedlora.run_federated(
            tc, THyper(method="fedlora_opt", **FED), t_ds, t_srv,
            t_loader.eval_batches(t_srv, B, S, 1, seed=11, device="cpu"),
            [t_loader.client_batch(t_ds, np.random.default_rng(9), B, S,
                                   device="cpu")],
            base=to_port(m["jp"], dt), device="cpu"))
    (js,), (ts, t64) = j_sims, t_sims
    (tg,), (jg,) = runs[0].history, want.history
    assert abs(tg["train_ce"] - jg["train_ce"]) <= 1e-5 * jg["train_ce"]
    assert abs(tg["ce"] - jg["ce"]) <= 1e-5 * jg["ce"]
    assert runs[0].comm_bytes == want.comm_bytes > 0
    assert any(f"/{'ssm/x_proj' if arch == MAMBA else 'attn/q_proj'}/" in p
               for p in ts.pre_aggregate)
    assert_leaves(ts.pre_aggregate, js.pre_aggregate, t64.pre_aggregate,
                  "stage 1")
    assert_leaves(ts.aggregated, js.aggregated, t64.aggregated, "aggregate")
    assert_leaves(*_one_copy(ts.client_adapters, js.client_adapters,
                             t64.client_adapters),
                  "client adapters after run_federated")
