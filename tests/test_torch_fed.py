"""The port's training pipeline against the JAX package's, on the CPU.

Both packages start from the same backbone and adapters (drawn by the
JAX package, carried across by ``checkpoint.bridge``, assigned to the
port's ``FedSim.client_adapters`` after construction as
``tests/test_fed.py`` does) and train on the same batches (the same
numpy generators and seeds), at ``lora_dropout = 0``: the JAX dropout
keys cannot be reproduced in torch, so dropout is held statistically.
The config is ``tests/test_fed.py``'s tiny one: 2 layers, d 64, 4 heads
over 2 kv heads, f32, rank 4.

Tolerances:
- data: byte for byte;
- loss and metrics: ``ce`` within 1e-5 relative, ``acc`` exactly (the
  same argmax with ties to the first index), gradients within 1e-5 of
  the leaf's max |g|;
- per-step ``ce`` and ``grad_norm`` within 1e-5 relative; comm bytes
  exactly;
- client adapter leaves after every stage within 1e-4 of the leaf's max
  |value|.  The f32 gradients agree to ~6e-7 (sum order), but stage 2's
  ΔA_D gradients are 1e-11 to 3e-6 (B_mag is a few 1e-3 after stage 1),
  the size of AdamW's eps = 1e-8, where the update g / (|g| + eps)
  turns an absolute gradient error δ into lr · δ · eps / (|g| + eps)².
  Measured: dA_dir 3.7e-5 of its max after stage 2, the lora baseline's
  lora_B 1.6e-5 (its gradients start as small), every other leaf
  ≤ 1.2e-6; per-step ce and grad_norm ≤ 5.2e-7 relative;
- accuracy of ``eval_global`` / ``eval_personalized`` within one answer
  token of the batch (1 / batch: one answer position a sequence).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.core import fedlora as j_fedlora
from repro.core import peft as j_peft
from repro.data import loader as j_loader
from repro.data import partition as j_part
from repro.data import synthetic as j_syn
from repro.fed.simulate import FedHyper as JHyper, FedSim as JSim
from repro.models import model as JM
from repro.models.config import ArchConfig as JArch
from repro.utils import pytree as jpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.core import fedlora as t_fedlora
from repro_torch.core import methods as t_methods
from repro_torch.data import loader as t_loader
from repro_torch.data import partition as t_part
from repro_torch.data import synthetic as t_syn
from repro_torch.fed.simulate import FedHyper as THyper, FedSim as TSim
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.utils import pytree as tpt

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
            lora_rank=4, lora_dropout=0.0)
J_CFG, T_CFG = JArch(**TINY), TArch(**TINY)
C, B, S = 3, 2, 24
HP = dict(n_clients=C, local_steps=2, batch=B, seq_len=S, global_steps=2,
          personal_steps=2, lr=3e-3, server_lr=2e-3, lam=1e-2)


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def flat(tree):
    if all(torch.is_tensor(x) for x in tpt.tree_leaves(tree)):
        return {p: x.detach().numpy() for p, x in tpt.tree_leaves_with_path(tree)}
    return dict(zip(jpt.tree_paths(tree), map(np.asarray,
                                              jax.tree.leaves(tree))))


def leaf_errs(got, want):
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    return {p: float(np.abs(got[p] - w).max() / max(np.abs(w).max(), 1e-30))
            for p, w in want.items()}


def assert_leaves(got, want, tol, what):
    errs = leaf_errs(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (what, worst, errs[worst])


def assert_rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, (what, got, want)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def datasets(pkg, family, pool_size=0, n=C, vocab=256):
    fam = pkg.make_dataset_family(family, vocab_size=vocab)
    part = (t_part if pkg is t_syn else j_part).specialist_partition(n, 4)
    return ([pkg.SyntheticInstructionDataset(fam, part[c], client_seed=c,
                                             pool_size=pool_size,
                                             pool_seq_len=S)
             for c in range(n)],
            pkg.SyntheticInstructionDataset(fam, np.ones(4) / 4,
                                            client_seed=99))


def same_batch(t_b, j_b):
    assert set(t_b) == set(j_b)
    for k in j_b:
        want = np.asarray(j_b[k])
        got = t_b[k].numpy()
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k


@pytest.mark.parametrize("family", ["dolly", "ni"])
@pytest.mark.parametrize("pool_size", [0, 8])
def test_data_batches_are_byte_identical(family, pool_size):
    t_ds, t_srv = datasets(t_syn, family, pool_size)
    j_ds, j_srv = datasets(j_syn, family, pool_size)
    t_rng, j_rng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        same_batch(t_loader.client_batch(t_ds, t_rng, B, S, device="cpu"),
                   j_loader.client_batch(j_ds, j_rng, B, S))
        same_batch(t_loader.to_device(t_srv.sample_batch(t_rng, B, S), "cpu"),
                   j_srv.sample_batch(j_rng, B, S))
    for task in (None, "qa", "sum"):
        for tb, jb in zip(t_loader.eval_batches(t_ds[0], B, S, 2, task=task,
                                                device="cpu"),
                          j_loader.eval_batches(j_ds[0], B, S, 2, task=task)):
            same_batch(tb, jb)
    np.testing.assert_array_equal(
        t_part.dirichlet_task_partition(5, 4, 0.3, seed=1),
        j_part.dirichlet_task_partition(5, 4, 0.3, seed=1))


def test_loaders_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    t_ds, _ = datasets(t_syn, "dolly")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_loader.client_batch(t_ds, np.random.default_rng(0), B, S)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSim(T_CFG, THyper(n_clients=1))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    base = JM.init_params(jax.random.PRNGKey(0), J_CFG)
    ad = j_peft.add_lora(base, J_CFG, jax.random.PRNGKey(1), decomposed=True)
    # a nonzero B_mag, so every adapter leaf has a nonzero gradient
    ad = jpt.tree_map_with_path(
        lambda p, x: x + 0.3 if p.endswith("/B_mag") else x, ad)
    return base, ad


def eval_batch(seed=0, batch=4):
    t_ds, _ = datasets(t_syn, "dolly")
    b = t_ds[1].sample_batch(np.random.default_rng(seed), batch, S)
    return b


@pytest.mark.parametrize("head,chunks", [("random", 0), ("random", 3),
                                         ("tied", 3)])
def test_loss_and_metrics_match_reference(world, head, chunks):
    """``ce``, ``acc`` and the adapter gradients; ``tied`` zeroes the
    head, so every logit ties and argmax must take index 0 (the answer
    targets are set to 0 and 1 alternately: acc 1/2 exactly)."""
    base, ad = world
    b = eval_batch()
    if head == "tied":
        base = dict(base, lm_head={"kernel": jnp.zeros_like(
            base["lm_head"]["kernel"])})
        ans = b["loss_mask"] >= 0.999
        rows, cols = np.nonzero(ans)
        b["tokens"][rows, cols + 1] = np.arange(rows.size) % 2
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = t_loader.to_device(b, "cpu")

    def j_loss(adapters):
        return JM.loss_and_metrics(jpt.merge_trees(base, adapters), jb, J_CFG,
                                   n_loss_chunks=chunks)
    (j_l, j_m), j_g = jax.value_and_grad(j_loss, has_aux=True)(ad)
    t_base, t_ad = to_port(base), to_port(ad)
    leaves = tpt.tree_map(lambda x: x.requires_grad_(True), t_ad)
    t_l, t_m = TM.loss_and_metrics(tpt.merge_trees(t_base, leaves), tb, T_CFG,
                                   n_loss_chunks=chunks)
    t_g = dict(zip(tpt.tree_paths(leaves), torch.autograd.grad(
        t_l, tpt.tree_leaves(leaves))))
    t_l, t_m = t_l.detach(), {k: v.detach() for k, v in t_m.items()}
    assert_rel(float(t_m["ce"]), float(j_m["ce"]), 1e-5, "ce")
    assert_rel(float(t_l), float(j_l), 1e-5, "loss")
    assert float(t_m["acc"]) == float(j_m["acc"])
    assert_rel(float(t_m["n_tok"]), float(j_m["n_tok"]), 1e-6, "n_tok")
    if head == "tied":
        assert float(t_m["acc"]) == 0.5
    j_g = flat(j_g)
    for p, g in t_g.items():
        assert_rel(g.numpy(), j_g[p], 1e-5, p)


# ---------------------------------------------------------------------------
# adapter dropout (statistical: the JAX keys cannot be reproduced)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_keeps_one_minus_p_and_is_unbiased(p):
    """The kept share lies within 4σ of 1 − p, σ = sqrt(p(1−p)/N); the
    mean of the dropped-out ones is 1 within 4σ, σ = sqrt(p/(1−p)/N)."""
    n = 200_000
    g = torch.Generator().manual_seed(0)
    y = TL.adapter_dropout(torch.ones(n), g, p)
    kept = float((y != 0).float().mean())
    assert abs(kept - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    assert set(torch.unique(y).tolist()) == {
        0.0, float(np.float32(1) / np.float32(1 - p))}
    assert abs(float(y.mean()) - 1) <= 4 * np.sqrt(p / (1 - p) / n)


def test_lora_delta_with_dropout_is_unbiased(world):
    """Over K draws the mean adapter output is the undropped one, within
    4 standard errors at every output element."""
    _, ad = world
    p = to_port(jax.tree.map(lambda x: x[0], ad["blocks"]["sub0"]))[
        "attn"]["q_proj"]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 64)).astype(np.float32))
    g = torch.Generator().manual_seed(1)
    K = 4000
    ys = torch.stack([TL.lora_delta(p, x, 8.0, g, 0.3) for _ in range(K)])
    ref = TL.lora_delta(p, x, 8.0)
    se = ys.std(dim=0) / np.sqrt(K)
    assert bool(((ys.mean(dim=0) - ref).abs() <= 4 * se).all())


def test_dropout_p0_with_a_generator_equals_no_generator(world):
    base, ad = world
    params = to_port(jpt.merge_trees(base, ad))
    b = t_loader.to_device(eval_batch(), "cpu")
    h0, _, _ = TM.forward(params, b, T_CFG)
    h1, _, _ = TM.forward(params, b, T_CFG, rng=torch.Generator().manual_seed(3))
    assert torch.equal(h0, h1)


def test_q_k_v_draw_different_masks(world, monkeypatch):
    """With q, k and v given one kernel and one adapter, their outputs are
    equal without dropout and differ with it: each projection draws its
    own mask.  The fused branch is never taken while dropout is active."""
    base, ad = world
    params = to_port(jpt.merge_trees(base, ad))
    lay = tpt.tree_map(lambda x: x[0], params["blocks"]["sub0"])["attn"]
    cfg = dataclasses.replace(T_CFG, n_kv_heads=4, lora_dropout=0.5,
                              lora_targets=("q_proj", "k_proj", "v_proj"),
                              use_fused_dora=True)
    same = {"kernel": torch.randn(64, 64, generator=torch.Generator()
                                  .manual_seed(4)), **{
        k: v for k, v in lay["q_proj"].items() if k != "kernel"}}
    lay = dict(lay, q_proj=same, k_proj=same, v_proj=same)
    seen = []
    real = TL.linear

    def spy(p, x, **kw):
        y = real(p, x, **kw)
        seen.append(y)
        return y

    import repro_torch.kernels as K

    def no_fused(*a, **k):
        raise AssertionError("fused branch taken under dropout")
    monkeypatch.setattr(TL, "linear", spy)
    monkeypatch.setattr(K, "fused_dora", no_fused)
    x = torch.randn(2, 8, 64, generator=torch.Generator().manual_seed(5))
    pos = torch.arange(8)[None].expand(2, 8)
    TL.attention(lay, x, pos, dataclasses.replace(cfg, lora_dropout=0.0,
                                                  use_fused_dora=False),
                 lora_scale=8.0)
    q, k, v = seen[:3]
    assert torch.equal(q, k) and torch.equal(k, v)
    seen.clear()
    TL.attention(lay, x, pos, cfg, lora_scale=8.0,
                 dropout_gen=torch.Generator().manual_seed(6))
    q, k, v = seen[:3]
    assert not torch.equal(q, k) and not torch.equal(k, v) \
        and not torch.equal(q, v)


# ---------------------------------------------------------------------------
# the pipeline against the reference
# ---------------------------------------------------------------------------

def both_batches(t_ds, j_ds, seed):
    """Per-step stacked batches of both packages from one numpy seed."""
    t_rng, j_rng = np.random.default_rng(seed), np.random.default_rng(seed)

    def step():
        return (t_loader.client_batch(t_ds, t_rng, B, S, device="cpu"),
                j_loader.client_batch(j_ds, j_rng, B, S))
    return step


def sims(method, hp=HP):
    """Both sims, the port's carrying the reference's base and initial
    client adapters."""
    js = JSim(J_CFG, JHyper(method=method, **hp))
    ts = TSim(T_CFG, THyper(method=method, **hp),
              base=to_port(js.base), device="cpu")
    ts.client_adapters = to_port(js.client_adapters)
    return js, ts


def step_by_step(js, ts, step, n, what):
    """``n`` stage-1 steps, one local_round each, holding per-step ce and
    grad_norm."""
    for i in range(n):
        tb, jb = step()
        jm = js.local_round([jb], jax.random.PRNGKey(i))
        tm = ts.local_round([tb], torch.Generator().manual_seed(i))
        for k in ("ce", "grad_norm"):
            assert_rel(tm[k], jm[k], 1e-5, f"{what} step {i} {k}")
        assert set(tm) == set(jm)


def check_acc(t_acc, j_acc, what):
    assert abs(np.asarray(t_acc) - np.asarray(j_acc)).max() <= 1.0 / B, what


def test_fedlora_opt_pipeline_matches_reference():
    """Two rounds (stage 1, aggregation, stage 2), then stage 3; every
    client leaf after every stage, per-step metrics, comm bytes, and the
    global / personalized accuracy."""
    js, ts = sims("fedlora_opt")
    t_ds, t_srv = datasets(t_syn, "dolly")
    j_ds, j_srv = datasets(j_syn, "dolly")
    step = both_batches(t_ds, j_ds, 0)
    srv = both_batches([t_srv], [j_srv], 1)
    ev = both_batches(t_ds, j_ds, 2)
    evals = [ev() for _ in range(2)]
    t_ev_g = [tpt.tree_map(lambda x: x[0], t) for t, _ in evals]
    j_ev_g = [jax.tree.map(lambda x: x[0], j) for _, j in evals]
    for rnd in range(2):
        step_by_step(js, ts, step, HP["local_steps"], f"round {rnd}")
        assert_leaves(ts.client_adapters, js.client_adapters, 1e-4,
                      f"round {rnd} stage 1")
        j_agg, t_agg = js.aggregate(), ts.aggregate()
        assert_leaves(t_agg, j_agg, 1e-4, f"round {rnd} aggregate")
        assert_leaves(ts.client_adapters, js.client_adapters, 1e-4,
                      f"round {rnd} rebroadcast")
        assert ts.comm_bytes == js.comm_bytes
        sb = [srv() for _ in range(HP["global_steps"])]
        j_agg = js.global_stage(j_agg, [jax.tree.map(lambda x: x[0], j)
                                        for _, j in sb],
                                jax.random.PRNGKey(rnd))
        t_agg = ts.global_stage(t_agg, [tpt.tree_map(lambda x: x[0], t)
                                        for t, _ in sb],
                                torch.Generator().manual_seed(rnd))
        assert_leaves(t_agg, j_agg, 1e-4, f"round {rnd} stage 2")
        assert_leaves(ts.client_adapters, js.client_adapters, 1e-4,
                      f"round {rnd} stage 2 rebroadcast")
        jg, tg = js.eval_global(j_agg, j_ev_g), ts.eval_global(t_agg, t_ev_g)
        check_acc(tg["acc"], jg["acc"], "eval_global")
        assert_rel(tg["ce"], jg["ce"], 1e-5, "eval_global ce")
    pb = [step() for _ in range(HP["personal_steps"])]
    js.personalize([j for _, j in pb], jax.random.PRNGKey(7))
    ts.personalize([t for t, _ in pb], torch.Generator().manual_seed(7))
    assert_leaves(ts.client_adapters, js.client_adapters, 1e-4, "stage 3")
    jp = js.eval_personalized([j for _, j in evals])
    tp = ts.eval_personalized([t for t, _ in evals])
    check_acc(tp["per_client"], jp["per_client"], "eval_personalized")
    check_acc(tp["acc"], jp["acc"], "eval_personalized mean")
    assert ts.comm_bytes == js.comm_bytes > 0


def test_lora_round_matches_reference():
    js, ts = sims("lora")
    t_ds, _ = datasets(t_syn, "ni")
    j_ds, _ = datasets(j_syn, "ni")
    step = both_batches(t_ds, j_ds, 3)
    step_by_step(js, ts, step, HP["local_steps"], "lora")
    assert_leaves(ts.client_adapters, js.client_adapters, 1e-4, "lora stage 1")
    assert_leaves(ts.aggregate(), js.aggregate(), 1e-4, "lora aggregate")
    assert_leaves(ts.client_adapters, js.client_adapters, 1e-4,
                  "lora rebroadcast")
    assert ts.comm_bytes == js.comm_bytes > 0
    pb = [step() for _ in range(HP["personal_steps"])]
    js.personalize([j for _, j in pb], jax.random.PRNGKey(7))
    ts.personalize([t for t, _ in pb], torch.Generator().manual_seed(7))
    assert_leaves(ts.client_adapters, js.client_adapters, 1e-4,
                  "lora personalize")


def test_local_round_matches_both_reference_loops():
    """The port's one Python loop against the reference's scanned
    ``local_round`` and its per-step ``local_round_reference``, over two
    rounds of three steps (state and step counter carried)."""
    hp = dict(HP, local_steps=3)
    js, ts = sims("fedlora_opt", hp)
    jr = JSim(J_CFG, JHyper(method="fedlora_opt", **hp))
    t_ds, _ = datasets(t_syn, "dolly")
    j_ds, _ = datasets(j_syn, "dolly")
    step = both_batches(t_ds, j_ds, 4)
    for rnd in range(2):
        bs = [step() for _ in range(3)]
        jm = js.local_round([j for _, j in bs], jax.random.PRNGKey(rnd))
        rm = jr.local_round_reference([j for _, j in bs],
                                      jax.random.PRNGKey(rnd))
        tm = ts.local_round([t for t, _ in bs],
                            torch.Generator().manual_seed(rnd))
        for ref, name in ((js, "local_round"), (jr, "local_round_reference")):
            assert_leaves(ts.client_adapters, ref.client_adapters, 1e-4,
                          f"round {rnd} vs {name}")
        for m in (jm, rm):
            for k in ("ce", "grad_norm"):
                assert_rel(tm[k], m[k], 1e-5, f"round {rnd} {k}")
        assert ts._step == int(js._step) == int(jr._step) == 3 * (rnd + 1)


def test_unported_options_raise_naming_their_item(tmp_path):
    """Mixed-rank fleets, client weights and the FedProx term construct
    (held against the reference by ``tests/test_torch_het_ranks.py``,
    ``test_torch_het_fed.py``, ``test_torch_methods.py`` and
    ``test_torch_fed_methods.py``), cohort rounds run (held against the
    reference by ``tests/test_torch_cohort.py``), checkpoints save and
    load (held against the reference by ``tests/test_torch_ckpt.py``),
    and the fused-DoRA path, which has no backward, is refused."""
    ts = TSim(T_CFG, THyper(client_ranks=(2, 4, 4, 4)), device="cpu")
    assert ts.alloc_rank == 4 and ts.rank_mask is not None
    ts = TSim(T_CFG, THyper(client_weights=(1, 1, 1, 2)), device="cpu")
    assert ts._base_weights.tolist() == [1.0, 1.0, 1.0, 2.0]
    ts = TSim(T_CFG, THyper(method="fedprox", prox_mu=0.1), device="cpu")
    assert ts._prox_mu == 0.1
    ts = TSim(T_CFG, THyper(n_clients=2), device="cpu")
    ts.aggregate(participation=[1, 0], staleness=[0, 2])
    assert ts.comm_bytes == ts.client_comm_bytes() > 0
    ts.run_cohort_round([], None, participation=[0, 0])
    assert ts.comm_bytes == ts.client_comm_bytes()
    ts.save(str(tmp_path / "sim.msgpack"), round_idx=3)
    assert ts.load(str(tmp_path / "sim.msgpack")) == 3
    with pytest.raises(ValueError, match="use_fused_dora"):
        TSim(dataclasses.replace(T_CFG, use_fused_dora=True), THyper(),
             device="cpu")


@pytest.fixture
def carried_method():
    """A port method that returns the adapter the reference's FedSim
    draws (``split(PRNGKey(seed))[1]``), removed from the registry after
    the test."""
    name = "fedlora_opt_carried"

    def make(base, cfg, generator):
        _, r_ad = jax.random.split(jax.random.PRNGKey(0))
        j_base = jax.tree.map(jnp.asarray, jax.tree.map(
            lambda x: x.numpy(), base))
        return to_port(j_peft.add_lora(j_base, J_CFG, r_ad, decomposed=True))
    t_methods.register(dataclasses.replace(
        t_methods.get_method("fedlora_opt"), name=name, make_adapter=make))
    yield name
    del t_methods._REGISTRY[name]


def capturing(monkeypatch, module):
    """Swap ``module.FedSim`` for a subclass that records each instance,
    so a test can read the sim that ``module.run_federated`` built."""
    made = []

    class Captured(module.FedSim):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)
    monkeypatch.setattr(module, "FedSim", Captured)
    return made


def test_run_federated_matches_reference(carried_method, monkeypatch):
    """End to end through both ``run_federated``s: history, accuracies and
    comm bytes, and every client adapter leaf after the run (stage 3's
    batches and generator included) within 1e-4 of its max |value|; the
    accuracies alone would not see stage 3 at random tiny weights."""
    hp = dict(HP, rounds=2, seed=0)
    j_base = JM.init_params(jax.random.PRNGKey(0), J_CFG)
    t_ds, t_srv = datasets(t_syn, "dolly")
    j_ds, j_srv = datasets(j_syn, "dolly")
    ev = both_batches(t_ds, j_ds, 9)
    evals = [ev() for _ in range(2)]
    t_g = t_loader.eval_batches(t_srv, B, S, 2, seed=11, device="cpu")
    j_g = j_loader.eval_batches(j_srv, B, S, 2, seed=11)
    j_sims = capturing(monkeypatch, j_fedlora)
    t_sims = capturing(monkeypatch, t_fedlora)
    want = j_fedlora.run_federated(J_CFG, JHyper(method="fedlora_opt", **hp),
                                   j_ds, j_srv, j_g, [j for _, j in evals],
                                   base=j_base)
    got = t_fedlora.run_federated(T_CFG, THyper(method=carried_method, **hp),
                                  t_ds, t_srv, t_g, [t for t, _ in evals],
                                  base=to_port(j_base), device="cpu")
    assert len(j_sims) == len(t_sims) == 1
    assert_leaves(t_sims[0].client_adapters, j_sims[0].client_adapters, 1e-4,
                  "client adapters after run_federated")
    assert got.comm_bytes == want.comm_bytes
    assert len(got.history) == len(want.history) == 2
    for tg, jg in zip(got.history, want.history):
        assert tg["round"] == jg["round"]
        assert_rel(tg["train_ce"], jg["train_ce"], 1e-5, "train_ce")
        assert_rel(tg["ce"], jg["ce"], 1e-5, "global ce")
        check_acc(tg["acc"], jg["acc"], "global acc")
    check_acc(got.global_acc, want.global_acc, "global_acc")
    check_acc(got.local_acc, want.local_acc, "local_acc")
    check_acc(got.per_client, want.per_client, "per_client")
