"""The port's tooling against the JAX package's, on the CPU: the tokenizer,
the pytree helpers, ``sgd``, ``batch_iterator``,
``aggregate_with_personal_exclusion``, backbone pretraining and its disk
cache, the serving step factories, the input shapes, the abstract trees,
the analytic step account, and the two user examples.

The same numpy inputs (from seeds) go through both packages.
Tolerances:
- tokenizer ids, masks, counts, bytes, shapes, paths, dtypes, the
  analytic FLOPs / bytes / parameter counts and cache files: exact;
- pytree arithmetic and casts (f32 → bf16 included): bit for bit;
- ``sgd`` over 5 steps: within 1e-6 of each leaf's max |value|;
- ``pretrain_base`` (llama2-7b SMOKE in f32, 5 steps from the
  reference's own initial parameters, injected by monkeypatching the
  port module's ``init_params``): step 0's ``acc`` exactly and its
  ``ce`` within 1e-5 relative (measured 5.1e-6: the port's f32 ce
  equals its f64 run's to the last digit, the reference's is off it);
  the log lines equal; every element of every leaf within 1e-4 of the
  leaf's max |value| but where f32 cannot resolve it, as
  ``test_torch_fed_methods.py`` holds adapters: each element beyond
  must be more than 1e-5 of the leaf's max from the port's f64 run
  (the witness) in the port's f32 run or in the reference's, at most
  0.1% of the leaf's elements, and within 1e-2.  That is AdamW's eps
  regime over every backbone leaf: an element whose gradient is near
  eps = 1e-8 turns an f32 sum-order difference into an update
  difference of up to ~lr / 4 = 7.5e-4.  Measured: at most 38 of
  262,144 elements beyond 1e-4 (mlp down_proj), the largest 1.4e-3 of
  the embedding's max, each at least 5.4e-5 from the witness in one of
  the two f32 runs; both f32 runs are up to 4e-3 from the witness;
- prefill / decode logits of the step factories: within 1e-5 of max
  |logit| (f32 sums in another order).
"""
import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro import configs as j_configs
from repro.core import aggregation as j_agg
from repro.data import loader as j_loader
from repro.data import synthetic as j_syn
from repro.data.tokenizer import HashTokenizer as JTok
from repro.fed import pretrain as j_pre
from repro.launch import analysis as j_an
from repro.launch import serve as j_serve
from repro.launch import specs as j_specs
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ArchConfig as JArch
from repro.models.config import SubLayer as JSub
from repro.optim import optimizers as j_opt
from repro.utils import pytree as jpt
from repro_torch import configs as t_configs
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.core import aggregation as t_agg
from repro_torch.data import HashTokenizer as TTok
from repro_torch.data import loader as t_loader
from repro_torch.data import synthetic as t_syn
from repro_torch.examples import fed_finetune_e2e, serve_personalized
from repro_torch.fed import pretrain as t_pre
from repro_torch.launch import analysis as t_an
from repro_torch.launch import serve as t_serve
from repro_torch.launch import specs as t_specs
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as t_opt
from repro_torch.utils import pytree as tpt

ARCHS = j_configs.ARCH_IDS
PRETRAIN_TOL = 1e-4      # of each leaf's max |value|, after 5 steps ...
WITNESS_TOL = 1e-5       # ... but where an f32 run is this far off f64,
OUTLIER_SHARE = 1e-3     # on at most this share of the leaf,
OUTLIER_TOL = 1e-2       # and within this
LOGIT_TOL = 1e-5         # of max |logit|
CE_TOL = 1e-5            # relative: step 0's ce


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def bits(x):
    """A leaf as a numpy array whose bytes are the leaf's (bf16 as its
    16-bit patterns)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def jflat(tree):
    return dict(zip(jpt.tree_paths(tree), jax.tree.leaves(tree)))


def assert_bit_equal(got, want):
    """Port tree ``got`` equals JAX (or port) tree ``want`` leaf by leaf,
    bit for bit, with the same paths."""
    g = dict(tpt.tree_leaves_with_path(got))
    w = (dict(tpt.tree_leaves_with_path(want))
         if all(torch.is_tensor(x) for x in tpt.tree_leaves(want))
         else jflat(want))
    assert sorted(g) == sorted(w)
    for p in w:
        a, b = bits(g[p]), bits(w[p])
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert np.array_equal(a, b), p


def max_rel(got, want):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

TEXTS = ["", "hello world", "  leading and trailing  ", "The paper's "
         "FedLoRA-Optimizer: global and local optimization", "ünïcödé wörds "
         "日本語 テキスト", "a " * 50, "tabs\tand\nnewlines"]


@pytest.mark.parametrize("vocab", [32768, 2048])
def test_hash_tokenizer_ids_equal(vocab):
    jt, tt = JTok(vocab), TTok(vocab)
    for text in TEXTS:
        for bos in (True, False):
            ids = tt.encode(text, add_bos=bos)
            assert ids == jt.encode(text, add_bos=bos), text
            assert all(0 <= i < vocab for i in ids)
        assert tt.decode_ids(ids) == jt.decode_ids(ids)


def test_hash_tokenizer_refuses_a_vocab_of_specials_only():
    with pytest.raises(ValueError, match="reserved"):
        TTok(TTok.N_SPECIAL)


# ---------------------------------------------------------------------------
# pytree helpers
# ---------------------------------------------------------------------------

def np_tree(seed, poison=None):
    """A seeded tree of f32 leaves (a stacked and a plain one) and an int
    leaf; ``poison`` ("nan", "inf", "-inf") puts that value in one f32
    leaf."""
    rng = np.random.default_rng(seed)
    t = {"blocks": {"sub0": {"attn": {"q_proj": {
        "kernel": rng.normal(size=(2, 8, 6)).astype(np.float32),
        "lora_A": rng.normal(size=(2, 8, 4)).astype(np.float32)}}}},
        "embed": {"embedding": rng.normal(size=(16, 8)).astype(np.float32)},
        "final_norm": rng.normal(size=(8,)).astype(np.float32),
        "step": rng.integers(0, 100, size=(3,)).astype(np.int32)}
    if poison:
        t["final_norm"][3] = float(poison)
    return t


def both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            tpt.tree_map(lambda x: torch.from_numpy(x.copy()), tree))


def test_path_str_joins_keys_as_the_reference():
    j, _ = both(np_tree(0))
    for path, _ in jax.tree_util.tree_leaves_with_path(j):
        keys = [getattr(k, "key", getattr(k, "idx", k)) for k in path]
        assert tpt.path_str(keys) == jpt.path_str(path)
    seq = jax.tree_util.tree_leaves_with_path({"a": [1, {"b": 2}]})
    assert [tpt.path_str(["a", 0]), tpt.path_str(["a", 1, "b"])] == [
        jpt.path_str(p) for p, _ in seq]


def test_regex_mask_and_tree_select():
    j, t = both(np_tree(1))
    j2, t2 = both(np_tree(2))
    for rx in (r"lora_A$", r"^blocks/", r"embed|final", r"nothing"):
        jm, tm = jpt.regex_mask(j, rx), tpt.regex_mask(t, rx)
        assert dict(tpt.tree_leaves_with_path(tm)) == jflat(jm)
        assert_bit_equal(tpt.tree_select(t, tm, t2),
                         jpt.tree_select(j, jm, j2))


@pytest.mark.parametrize("op", ["add", "scale", "cast_bf16", "cast_f32"])
def test_tree_arithmetic_and_casts(op):
    j, t = both(np_tree(3))
    j2, t2 = both(np_tree(4))
    if op == "add":
        got, want = tpt.tree_add(t, t2), jpt.tree_add(j, j2)
    elif op == "scale":
        got, want = (tpt.tree_scale(t, np.float32(0.37)),
                     jpt.tree_scale(j, np.float32(0.37)))
    elif op == "cast_bf16":
        got, want = (tpt.tree_cast(t, torch.bfloat16),
                     jpt.tree_cast(j, jnp.bfloat16))
    else:
        got = tpt.tree_cast(tpt.tree_cast(t, torch.bfloat16), torch.float32)
        want = jpt.tree_cast(jpt.tree_cast(j, jnp.bfloat16), jnp.float32)
    assert_bit_equal(got, want)
    if op != "scale":               # an int leaf times a float is a float
        assert got["step"].dtype == torch.int32


def test_tree_count_params_and_bytes_on_real_and_meta_trees():
    j, t = both(np_tree(5))
    assert tpt.tree_count_params(t) == jpt.tree_count_params(j)
    assert tpt.tree_bytes(t) == jpt.tree_bytes(j)
    meta = tpt.tree_map(lambda x: torch.empty_like(x, device="meta"), t)
    assert tpt.tree_count_params(meta) == jpt.tree_count_params(j)
    assert tpt.tree_bytes(meta) == jpt.tree_bytes(j)
    jb, tb = jpt.tree_cast(j, jnp.bfloat16), tpt.tree_cast(t, torch.bfloat16)
    assert tpt.tree_bytes(tb) == jpt.tree_bytes(jb)


@pytest.mark.parametrize("poison", [None, "nan", "inf", "-inf"])
def test_tree_all_finite(poison):
    j, t = both(np_tree(6, poison))
    got = tpt.tree_all_finite(t)
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == bool(jpt.tree_all_finite(j)) == (poison is None)
    # no floating leaf: True, as the reference
    assert bool(tpt.tree_all_finite({"i": t["step"]})) is True
    assert bool(jpt.tree_all_finite({"i": j["step"]})) is True


# ---------------------------------------------------------------------------
# sgd, batch_iterator, aggregate_with_personal_exclusion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("momentum,wd", [(0.9, 1e-2), (0.0, 0.0)])
def test_sgd_matches_reference_over_five_steps(momentum, wd):
    tree = {k: v for k, v in np_tree(7).items() if k != "step"}
    jp, tp = both(tree)
    jo, to = j_opt.sgd(0.05, momentum, wd), t_opt.sgd(0.05, momentum, wd)
    js, ts = jo.init(jp), to.init(tp)
    rng = np.random.default_rng(8)
    for i in range(5):
        g = tpt.tree_map(lambda x: rng.normal(size=x.shape).astype(
            np.float32), tree)
        jg, tg = both(g)
        ju, js = jo.update(jg, js, jp, jnp.asarray(i))
        tu, ts = to.update(tg, ts, tp, i)
        jp, tp = j_opt.apply_updates(jp, ju), t_opt.apply_updates(tp, tu)
    want = jflat(jp)
    for p, x in tpt.tree_leaves_with_path(tp):
        assert max_rel(x, want[p]) <= 1e-6, p
    if momentum:
        wm = jflat(js.mom)
        for p, x in tpt.tree_leaves_with_path(ts["mom"]):
            assert x.dtype == torch.float32
            assert max_rel(x, wm[p]) <= 1e-6, p
    else:
        assert tpt.tree_leaves(ts) == [] == jax.tree.leaves(js)


def dataset(pkg, vocab):
    fam = pkg.make_dataset_family("dolly", vocab_size=vocab)
    return pkg.SyntheticInstructionDataset(fam, [1 / 3, 1 / 3, 1 / 3, 0],
                                           client_seed=0)


def test_batch_iterator_yields_the_reference_batches():
    jb = list(j_loader.batch_iterator(dataset(j_syn, 512), 4, 24, 3, seed=9))
    tb = list(t_loader.batch_iterator(dataset(t_syn, 512), 4, 24, 3, seed=9,
                                      device="cpu"))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].device.type == "cpu"
            assert np.array_equal(bits(a[k]), bits(b[k])), k


def test_aggregate_with_personal_exclusion():
    rng = np.random.default_rng(10)
    leaves = {"q_proj": {n: rng.normal(size=(3, 2, *s)).astype(np.float32)
                         for n, s in (("A_dir", (8, 4)), ("A_mag", (8,)),
                                      ("B_mag", (4,)), ("dB_mag", (4,)),
                                      ("B_dir", (4, 6)))}}
    jc, tc = both(leaves)
    got = t_agg.aggregate_with_personal_exclusion(tc)
    want = j_agg.aggregate_with_personal_exclusion(jc)
    wf = jflat(want)
    for p, x in tpt.tree_leaves_with_path(got):
        assert x.shape == wf[p].shape, p
        assert max_rel(x, wf[p]) <= 1e-7, p
    # the personal magnitudes are the clients' own, untouched
    assert got["q_proj"]["dB_mag"] is tc["q_proj"]["dB_mag"]
    for c in range(3):
        assert torch.equal(got["q_proj"]["A_dir"][c],
                           tc["q_proj"]["A_dir"].mean(0))


# ---------------------------------------------------------------------------
# pretraining and its cache
# ---------------------------------------------------------------------------

def smoke(arch, **kw):
    return (dataclasses.replace(j_configs.get_smoke_config(arch), **kw),
            dataclasses.replace(t_configs.get_smoke_config(arch), **kw))


@pytest.fixture(scope="module")
def pretrained():
    """llama2-7b SMOKE in f32: the reference's initial parameters, its
    first batch, its step-0 metrics, its log and its params after 5
    steps."""
    jc, tc = smoke("llama2-7b", dtype="float32")
    p0 = JM.init_params(jax.random.PRNGKey(0), jc)
    b0 = dataset(j_syn, jc.vocab_size).sample_batch(
        np.random.default_rng(0), 32, 48)
    _, met0 = JM.loss_and_metrics(p0, {k: jnp.asarray(v)
                                       for k, v in b0.items()}, jc)
    log = []
    p5 = j_pre.pretrain_base(jc, dataset(j_syn, jc.vocab_size), steps=5,
                             seed=0, log=log.append)
    return dict(jc=jc, tc=tc, p0=p0, met0={k: float(v)
                                            for k, v in met0.items()},
                log=log, p5=p5)


def run_port_pretrain(m, monkeypatch, dtype=None, record=None):
    """The port's ``pretrain_base`` for 5 steps from the reference's
    initial parameters (in ``dtype`` when given); ``record`` collects
    each step's metrics.  Returns (params, log)."""
    monkeypatch.setattr(t_pre, "init_params", lambda g, cfg, device:
                        params_from_numpy(jax.tree.map(np.asarray, m["p0"]),
                                          "cpu", dtype))
    if record is not None:
        def recorded(params, batch, cfg):
            loss, met = TM.loss_and_metrics(params, batch, cfg)
            record.append({k: float(v.detach()) for k, v in met.items()})
            return loss, met
        monkeypatch.setattr(t_pre, "loss_and_metrics", recorded)
    log = []
    got = t_pre.pretrain_base(m["tc"], dataset(t_syn, m["tc"].vocab_size),
                              steps=5, seed=0, log=log.append, device="cpu")
    return got, log


def test_pretrain_base_matches_reference(pretrained, monkeypatch):
    m = pretrained
    mets = []
    got, log = run_port_pretrain(m, monkeypatch, record=mets)
    assert len(mets) == 5
    assert abs(mets[0]["ce"] - m["met0"]["ce"]) <= CE_TOL * m["met0"]["ce"]
    assert mets[0]["acc"] == m["met0"]["acc"]
    assert log == m["log"]
    witness, _ = run_port_pretrain(m, monkeypatch, dtype=torch.float64)
    want, p0 = jflat(m["p5"]), jflat(m["p0"])
    got, witness = (dict(tpt.tree_leaves_with_path(t))
                    for t in (got, witness))
    assert sorted(want) == sorted(got) == sorted(witness)
    for p, w in want.items():
        g, x64, w = (np.asarray(v, np.float64) for v in (got[p], witness[p], w))
        scale = np.abs(w).max()
        err = np.abs(g - w) / scale
        out = err > PRETRAIN_TOL
        assert out.sum() <= OUTLIER_SHARE * err.size, (p, int(out.sum()))
        assert err.max() <= OUTLIER_TOL, (p, err.max())
        off64 = np.maximum(np.abs(g - x64), np.abs(w - x64))[out] / scale
        assert (off64 > WITNESS_TOL).all(), (p, err[out], off64)
        # every leaf trained
        assert not np.array_equal(g, np.asarray(p0[p])), p


def test_pretrained_base_cache_crosses_between_packages(tmp_path,
                                                       monkeypatch):
    """The same (cfg, steps, seed, family) names the same file; a file the
    reference wrote is restored by the port without training, and one the
    port wrote by the reference, every leaf bit for bit.  The reference's
    own training is stood in for by a fixed tree (its training is held
    by the test above); the port trains for real."""
    jc, tc = smoke("llama2-7b")                 # bf16 leaves
    monkeypatch.setattr(j_pre, "CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    jds, tds = dataset(j_syn, jc.vocab_size), dataset(t_syn, tc.vocab_size)
    calls = {"j": 0, "t": 0}
    fixed = JM.init_params(jax.random.PRNGKey(7), jc)

    def j_train(*a, **k):
        calls["j"] += 1
        return fixed
    monkeypatch.setattr(j_pre, "pretrain_base", j_train)
    t_train = t_pre.pretrain_base

    def t_counted(*a, **k):
        calls["t"] += 1
        return t_train(*a, **k)
    monkeypatch.setattr(t_pre, "pretrain_base", t_counted)

    # reference writes, port restores
    jp = j_pre.get_pretrained_base(jc, jds, steps=3, seed=0)
    path = t_pre.cache_path(tc, 3, 0, tds.family.name)
    assert os.path.basename(path) == (
        f"base_{jc.name}_{j_pre._key(jc, 3, 0, jds.family.name)}.msgpack")
    assert os.path.exists(path) and calls == {"j": 1, "t": 0}
    log = []
    tp = t_pre.get_pretrained_base(tc, tds, steps=3, seed=0, log=log.append,
                                   device="cpu")
    assert calls == {"j": 1, "t": 0}
    assert log == [f"restored pretrained base from {path}"]
    assert_bit_equal(tp, jp)

    # port writes (training 2 steps), reference restores
    tp2 = t_pre.get_pretrained_base(tc, tds, steps=2, seed=1, device="cpu")
    assert calls == {"j": 1, "t": 1}
    assert os.path.exists(t_pre.cache_path(tc, 2, 1, tds.family.name))
    jp2 = j_pre.get_pretrained_base(jc, jds, steps=2, seed=1)
    assert calls == {"j": 1, "t": 1}
    assert_bit_equal(tp2, jp2)
    assert_bit_equal(t_pre.get_pretrained_base(tc, tds, steps=2, seed=1,
                                               device="cpu"), tp2)
    assert calls == {"j": 1, "t": 1}


@pytest.mark.parametrize("arch", ARCHS + ["e2e-25m", "e2e-100m"])
def test_cache_key_names_the_reference_file(arch):
    """The config's repr is the reference's, so the key is too."""
    if arch.startswith("e2e-"):
        tc = fed_finetune_e2e.PROFILES[arch[4:]]
        jc = JArch(**dataclasses.asdict(tc))
        cfgs = [(jc, tc)]
    else:
        cfgs = [(j_configs.get_config(arch), t_configs.get_config(arch)),
                smoke(arch)]
    for jc, tc in cfgs:
        assert repr(tc) == repr(jc)
        assert t_pre._key(tc, 600, 0, "dolly") == j_pre._key(jc, 600, 0,
                                                             "dolly")


# ---------------------------------------------------------------------------
# serving step factories
# ---------------------------------------------------------------------------

def j_encode(jp, jc, fe):
    """The reference's encoder, built by hand as its model tests do."""
    pos = jnp.broadcast_to(jnp.arange(fe.shape[1])[None], fe.shape[:2])
    out, _, _ = JM._run_blocks(jp["encoder"]["blocks"], {}, fe,
                               [JSub("attn", "dense", "global")], jc,
                               positions=pos, causal=False, chunk_q=True)
    return JL.rms_norm(out, jp["encoder"]["final_norm"], jc.norm_eps)


@pytest.mark.parametrize("arch", ["llama2-7b", "seamless-m4t-large-v2"])
def test_prefill_and_decode_steps_match_reference(arch):
    """The prefill's last logits, then a decode step of the last prompt
    token at its own position (index S − 1) from that cache, which
    rewrites the same k / v and so must give the same logits."""
    jc, tc = smoke(arch, dtype="float32")
    jp = JM.init_params(jax.random.PRNGKey(3), jc)
    tp = to_port(jp)
    rng = np.random.default_rng(11)
    S = 12
    batch = {"tokens": rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)}
    if jc.n_enc_layers:
        batch["frontend_emb"] = rng.normal(size=(2, 10, jc.d_model)).astype(
            np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    jl, jcache = j_serve.make_prefill_step(jc)(jp, jb)
    enc = t_enc = None
    if jc.n_enc_layers:
        enc = j_encode(jp, jc, jb["frontend_emb"])
        t_enc = TM._encode(tp, tb["frontend_emb"], tc)
    tl, tcache = t_serve.make_prefill_step(tc)(tp, tb, enc_out=t_enc)
    assert max_rel(tl, jl) <= LOGIT_TOL
    last = batch["tokens"][:, -1]
    jd, _ = j_serve.make_decode_step(jc)(jp, jnp.asarray(last), jcache,
                                         jnp.asarray(S - 1), enc_out=enc)
    td, _ = t_serve.make_decode_step(tc)(tp, torch.as_tensor(last), tcache,
                                         S - 1, enc_out=t_enc)
    assert max_rel(td, jd) <= LOGIT_TOL
    assert max_rel(td, tl) <= LOGIT_TOL


# ---------------------------------------------------------------------------
# shapes, abstract trees and the analytic account
# ---------------------------------------------------------------------------

def test_shapes_and_shape_supported_equal_the_reference():
    assert t_configs.SHAPES.keys() == j_configs.SHAPES.keys()
    for name, s in t_configs.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(
            j_configs.SHAPES[name])
    assert t_configs.LONG_CONTEXT_ARCHS == j_configs.LONG_CONTEXT_ARCHS
    assert sorted(t_configs.ARCH_IDS) == sorted(ARCHS)
    for a in ARCHS:
        for name in j_configs.SHAPES:
            assert (t_configs.shape_supported(a, name)
                    == j_configs.shape_supported(a, name)), (a, name)


_ABSTRACT = {}


def abstract(arch):
    """Both packages' abstract params, adapters (4 clients) and cache
    (batch 2, 64 positions) at ``arch``'s full ARCH config, once a
    module."""
    if arch not in _ABSTRACT:
        jc, tc = j_configs.get_config(arch), t_configs.get_config(arch)
        _ABSTRACT[arch] = dict(
            jc=jc, tc=tc,
            j=(j_specs.abstract_params(jc), j_specs.abstract_adapters(jc, 4),
               j_specs.abstract_cache(jc, 2, 64)),
            t=(t_specs.abstract_params(tc), t_specs.abstract_adapters(tc, 4),
               t_specs.abstract_cache(tc, 2, 64)))
    return _ABSTRACT[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_match_reference(arch):
    a = abstract(arch)
    for jt, tt in zip(a["j"], a["t"]):
        want = {p: (tuple(x.shape), np.dtype(x.dtype).name)
                for p, x in jflat(jt).items()}
        got = {}
        for p, x in tpt.tree_leaves_with_path(tt):
            assert x.device.type == "meta", p
            got[p] = (tuple(x.shape), str(x.dtype).replace("torch.", ""))
        assert got == want
    params = a["t"][0]
    assert tpt.tree_count_params(params) == jpt.tree_count_params(a["j"][0])
    assert tpt.tree_bytes(params) == jpt.tree_bytes(a["j"][0])


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_account_equals_reference(arch):
    a = abstract(arch)
    jc, tc = a["jc"], a["tc"]
    counts = t_an.param_counts(tc, a["t"][0])
    assert counts == j_an.param_counts(jc, a["j"][0])
    n = counts["n_params"]
    n_shapes = 0
    for name, js in j_configs.SHAPES.items():
        if not j_configs.shape_supported(arch, name):
            continue
        n_shapes += 1
        ts = t_configs.SHAPES[name]
        assert t_an.analytic_step_flops(tc, ts) == \
            j_an.analytic_step_flops(jc, js)
        for n_dev, cache in ((1, 0), (4, 123_456_789)):
            assert t_an.analytic_step_bytes(tc, ts, n, n_dev, cache) == \
                j_an.analytic_step_bytes(jc, js, n, n_dev, cache)
    assert n_shapes == (4 if arch in j_configs.LONG_CONTEXT_ARCHS else 3)


def test_roofline_terms_at_the_h100_constants():
    assert (t_an.PEAK_FLOPS, t_an.HBM_BW) == (989e12, 3.35e12)
    r = t_an.roofline_terms(2 * 989e12, 3.35e12 / 2, 0, 2)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 0.5, 0.0)
    assert r.dominant == "compute"
    # the formula is the reference's with the card's constants
    jr = j_an.roofline_terms(3e15, 7e11, 0, 4)
    tr = t_an.roofline_terms(3e15, 7e11, 0, 4)
    assert tr.compute_s == jr.compute_s * j_an.PEAK_FLOPS / t_an.PEAK_FLOPS
    assert tr.memory_s == pytest.approx(jr.memory_s * j_an.HBM_BW
                                        / t_an.HBM_BW, rel=1e-15)
    # the collective term: the bytes a device sends over the card's NVLink
    # rate where the reference's divides them by its ICI link's
    assert t_an.NVLINK_BW == 450e9
    jr = j_an.roofline_terms(3e15, 7e11, 9e9, 4)
    tr = t_an.roofline_terms(3e15, 7e11, 9e9, 4)
    assert tr.collective_s == 9e9 / 450e9 == pytest.approx(
        jr.collective_s * j_an.ICI_BW / t_an.NVLINK_BW, rel=1e-15)
    assert t_an.roofline_terms(1.0, 1.0, 1e12, 1).dominant == "collective"


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def test_fed_finetune_e2e_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path / "cache"))
    argv = ["--profile", "25m", "--rounds", "1", "--pretrain-steps", "2",
            "--seq", "16", "--device", "cpu"]
    res = fed_finetune_e2e.main(argv)
    out = capsys.readouterr().out
    assert "pretrain step 0: ce=" in out and "=== results ===" in out
    assert 0.0 <= res.global_acc <= 1.0 and 0.0 <= res.local_acc <= 1.0
    assert len(res.per_client) == 3 and len(res.history) == 1
    assert (tmp_path / "experiments" / "e2e_25m.msgpack").is_file()
    cfg = fed_finetune_e2e.PROFILES["25m"]
    assert os.path.isfile(t_pre.cache_path(cfg, 2, 0, "dolly"))


def test_serve_personalized_runs_on_the_cpu(capsys):
    res = serve_personalized.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("mixed-batch continuation") == serve_personalized.N_TENANTS
    assert res["mixed_tokens_per_s"] > 0 and res["merged_tokens_per_s"] > 0
    st = res["last_run"]
    assert (st["prefills"], st["decode_steps"]) == (1, serve_personalized.CHUNK)
