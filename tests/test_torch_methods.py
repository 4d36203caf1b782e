"""The baselines' adapter kinds, masks, aggregators, comm accounting and
Fig. 1's sensitivity report in the port, against the JAX package, on
the CPU.

Adapters are drawn by the JAX package and carried across by
``checkpoint.bridge`` (the JAX key streams cannot be reproduced in
torch); client stacks are numpy draws.  The config is
``tests/test_fed.py``'s tiny one: 2 layers, d 64, 4 heads over 2 kv
heads, f32, rank 4.

Tolerances:
- forward logits within 1e-5 of max |logit|, the adapters' gradients
  within 1e-4 of each leaf's max |g| (f32 sums in another order);
- masks, registry fields, comm bytes and error messages exactly;
- the mean-family aggregators within 1e-6 of the leaf's max |value|;
  top-k picks the same coordinates as the reference (tie-free draws);
- q8 (its stream cannot match the reference's): every coordinate within
  one quantization step of its input, all-zero leaves exactly zero, and
  the mean over N draws within 5 standard errors of the input;
- ``sensitivity_report``, ``decompose_lora_pair`` and
  ``effective_delta_w`` within 1e-6 (relative).
"""
import re

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.core import aggregation as jagg
from repro.core import dora as jdora
from repro.core import methods as jmeth
from repro.core import peft as jpeft
from repro.core import sensitivity as jsens
from repro.data import synthetic as jsyn
from repro.models import model as JM
from repro.models.config import ArchConfig as JArch
from repro.utils import pytree as jpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core import dora as tdora
from repro_torch.core import methods as tmeth
from repro_torch.core import peft as tpeft
from repro_torch.core import sensitivity as tsens
from repro_torch.data import loader as tloader
from repro_torch.fed.simulate import FedHyper as THyper, FedSim as TSim
from repro_torch.models import model as TM
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.utils import pytree as tpt

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
            lora_rank=4, lora_dropout=0.0)
J_CFG, T_CFG = JArch(**TINY), TArch(**TINY)
NEW = ("ffa_lora", "fedprox", "prompt", "adapter", "fedalt", "lora_trimmed",
       "lora_fedbuff", "lora_fedavg_q8", "lora_fedavg_topk")
HET = ("lora_zeropad", "lora_replication", "lora_exact")     # rank-aware


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def flat(tree):
    if all(torch.is_tensor(x) for x in tpt.tree_leaves(tree)):
        return {p: x.detach().numpy() for p, x in
                tpt.tree_leaves_with_path(tree)}
    return dict(zip(jpt.tree_paths(tree), map(np.asarray,
                                              jax.tree.leaves(tree))))


def assert_close(got, want, tol, what=""):
    got, want = flat(got), flat(want)
    assert set(got) == set(want), what
    for p, w in want.items():
        err = np.abs(got[p] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (what, p, err)


@pytest.fixture(scope="module")
def base():
    return JM.init_params(jax.random.PRNGKey(0), J_CFG)


def batch(seed=0, n=3, S=24):
    fam = jsyn.make_dataset_family("dolly", vocab_size=256)
    ds = jsyn.SyntheticInstructionDataset(fam, np.ones(4) / 4, client_seed=1)
    return ds.sample_batch(np.random.default_rng(seed), n, S)


# ---------------------------------------------------------------------------
# adapter kinds: forward and gradients
# ---------------------------------------------------------------------------

def kind_adapters(base, kind):
    """The JAX package's adapter of ``kind``, with its zero-initialized
    factor made nonzero so every leaf has a gradient (the Houlsby pair
    drawn at fan-in scale, so gelu sees O(1) inputs, where its tanh
    form and the exact one differ)."""
    key = jax.random.PRNGKey(3)
    noise = np.random.default_rng(4)

    def fill(scale):
        return lambda x: jnp.asarray(noise.normal(size=x.shape) * scale,
                                     jnp.float32)
    if kind == "dual":
        ad = jpeft.add_dual_lora(base, J_CFG, key)
        return jpt.tree_map_with_path(
            lambda p, x: fill(0.3)(x) if p.endswith("local_B") else x, ad)
    if kind == "houlsby":
        ad = jpeft.add_adapter_tuning(base, J_CFG, key)
        return jpt.tree_map_with_path(
            lambda p, x: fill(2.0 / np.sqrt(x.shape[-2]))(x)
            if p.endswith(("adapter_down", "adapter_up")) else x, ad)
    return jpeft.add_prompt_tuning(base, J_CFG, key)


@pytest.mark.parametrize("kind", ["dual", "houlsby", "prompt"])
def test_adapter_kind_forward_and_grads_match_reference(base, kind):
    ad = kind_adapters(base, kind)
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = tloader.to_device(b, "cpu")
    head = base["lm_head"]["kernel"]

    def j_loss(a):                 # one program: loss, logits, gradients
        params = jpt.merge_trees(base, a)
        h, _, _ = JM.forward(params, jb, J_CFG)
        loss, _ = JM.loss_and_metrics(params, jb, J_CFG)
        return loss, h @ head
    (j_l, j_logits), j_g = jax.jit(jax.value_and_grad(j_loss,
                                                      has_aux=True))(ad)
    t_base, t_ad = to_port(base), to_port(ad)
    t_h, _, _ = TM.forward(tpt.merge_trees(t_base, t_ad), tb, T_CFG)
    assert t_h.shape == (3, 24, 64)
    assert_close({"logits": t_h @ torch.from_numpy(np.array(head))},
                 {"logits": j_logits}, 1e-5, "logits")
    leaves = tpt.tree_map(lambda x: x.requires_grad_(True), t_ad)
    t_l, _ = TM.loss_and_metrics(tpt.merge_trees(t_base, leaves), tb, T_CFG)
    t_g = dict(zip(tpt.tree_paths(leaves), torch.autograd.grad(
        t_l, tpt.tree_leaves(leaves))))
    assert abs(float(t_l.detach()) - float(j_l)) <= 1e-5 * abs(float(j_l))
    j_g = flat(j_g)
    assert set(t_g) == set(j_g)
    for p, g in t_g.items():
        assert np.abs(j_g[p]).max() > 0, p
        err = np.abs(g.numpy() - j_g[p]).max() / np.abs(j_g[p]).max()
        assert err <= 1e-4, (p, err)


def test_fedalt_pair_shares_the_dropout_mask(base):
    """One mask per projection, drawn once: with local_A = lora_A and
    local_B = lora_B the dual pair's delta is exactly twice the shared
    pair's, under dropout too."""
    from repro_torch.models import layers as TL
    ad = to_port(jpeft.add_dual_lora(base, J_CFG, jax.random.PRNGKey(5)))
    p = tpt.tree_map(lambda x: x[0], ad["blocks"]["sub0"])["attn"]["q_proj"]
    p = dict(p, local_A=p["lora_A"], local_B=p["lora_B"])
    shared = {k: p[k] for k in ("lora_A", "lora_B")}
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(6))
    y2 = TL.lora_delta(p, x, 2.0, torch.Generator().manual_seed(7), 0.5)
    y1 = TL.lora_delta(shared, x, 2.0, torch.Generator().manual_seed(7), 0.5)
    assert torch.allclose(y2, 2 * y1, rtol=1e-6, atol=0)


def test_houlsby_trains_in_bf16_where_the_reference_raises(base):
    """ROADMAP C, caveat 3: the reference's f32 adapter_up promotes a
    bf16 block to f32 and its superblock scan refuses the carry; the
    port casts the factors to the activation dtype."""
    ad = kind_adapters(base, "houlsby")
    b = batch()
    bf = dict(TINY, dtype="bfloat16")
    j_bf = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                        if x.dtype == jnp.float32 else x, base)
    with pytest.raises(TypeError, match="carry"):
        JM.forward(jpt.merge_trees(j_bf, ad), {k: jnp.asarray(v) for k, v
                                               in b.items()}, JArch(**bf))
    t_base = tpt.tree_map(lambda x: x.to(torch.bfloat16)
                          if x.dtype == torch.float32 else x, to_port(base))
    leaves = tpt.tree_map(lambda x: x.requires_grad_(True), to_port(ad))
    t_l, _ = TM.loss_and_metrics(tpt.merge_trees(t_base, leaves),
                                 tloader.to_device(b, "cpu"), TArch(**bf))
    grads = torch.autograd.grad(t_l, tpt.tree_leaves(leaves))
    assert torch.isfinite(t_l)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               and float(g.abs().max()) > 0 for g in grads)


def test_prompt_tuned_models_are_not_served(base):
    params = to_port(jpt.merge_trees(base, kind_adapters(base, "prompt")))
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    with pytest.raises(ValueError, match="prompt"):
        TM.prefill(params, toks, T_CFG)
    cache = TM.init_cache(T_CFG, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="prompt"):
        TM.decode_step(params, torch.zeros((1,), dtype=torch.int32), cache,
                       0, T_CFG)


def test_adapter_factories_draw_the_reference_shapes(base):
    t_base = to_port(base)
    g = torch.Generator().manual_seed(0)
    for name, kw in (("add_dual_lora", {}), ("add_prompt_tuning", {}),
                     ("add_adapter_tuning", {}), ("add_dual_lora",
                                                  {"rank": 2})):
        want = getattr(jpeft, name)(base, J_CFG, jax.random.PRNGKey(0), **kw)
        got = getattr(tpeft, name)(t_base, T_CFG, g, **kw)
        w, t = flat(want), flat(got)
        assert {p: v.shape for p, v in t.items()} == {
            p: v.shape for p, v in w.items()}, name
        for p, v in t.items():
            # the zero-initialized factors are exactly zero in both
            assert (not w[p].any()) == (not v.any()), (name, p)


# ---------------------------------------------------------------------------
# registry and masks
# ---------------------------------------------------------------------------

def flat_mask(m):
    return {p: bool(x) for p, x in tpt.tree_leaves_with_path(m)}


def j_flat_mask(m):
    return dict(zip(jpt.tree_paths(m), map(bool, jax.tree.leaves(m))))


@pytest.mark.parametrize("name", NEW + HET)
def test_registered_method_matches_reference(base, name):
    j, t = jmeth.get_method(name), tmeth.get_method(name)
    for f in ("keep_local", "prox", "pipeline", "server_zero_rx",
              "het_ranks", "rank_aware", "description"):
        assert getattr(t, f) == getattr(j, f), f
    assert tagg.comm_class(t) == jagg.comm_class(j)
    assert tagg.aggregate_zero_rx(t) == jagg.aggregate_zero_rx(j)
    if j.collective is not None:
        for f in ("comm", "topk_ratio"):
            assert getattr(t.collective, f) == getattr(j.collective, f), f
    ad = j.make_adapter(base, J_CFG, jax.random.PRNGKey(1))
    t_ad = to_port(ad)
    for stage in ("local_pretrain", "global", "local"):
        assert flat_mask(t.stage_mask(t_ad, stage)) == j_flat_mask(
            j.stage_mask(ad, stage)), stage
    assert (t.personal_reg is None) == (j.personal_reg is None)
    if name == "ffa_lora":
        assert {p for p, m in flat_mask(tpeft.mask_ffa(t_ad)).items()
                if m} == {p for p in flat(t_ad) if p.endswith("lora_B")}


def test_registry_lists_the_ported_methods():
    assert tmeth.available_methods() == sorted(
        NEW + HET + ("fedlora_opt", "lora"))
    assert tmeth.available_methods() == jmeth.available_methods()


# ---------------------------------------------------------------------------
# aggregators on numpy stacks
# ---------------------------------------------------------------------------

def stack(C, seed=0, zero_leaf=False):
    rng = np.random.default_rng(seed)
    tree = {"blocks": {"q_proj": {
        "lora_A": rng.normal(size=(C, 2, 16, 4)).astype(np.float32),
        "lora_B": rng.normal(size=(C, 2, 4, 16)).astype(np.float32) * 1e-2,
        "local_A": rng.normal(size=(C, 2, 16, 4)).astype(np.float32),
        "local_B": rng.normal(size=(C, 2, 4, 16)).astype(np.float32)}}}
    if zero_leaf:
        tree["blocks"]["q_proj"]["lora_B"][:] = 0
    return ({"blocks": jax.tree.map(jnp.asarray, tree["blocks"])},
            tpt.tree_map(torch.from_numpy, tree))


@pytest.mark.parametrize("C", [3, 4, 5, 8])
def test_trimmed_fedavg_matches_reference(C):
    j, t = stack(C)
    w = np.arange(1, C + 1, dtype=np.float32)
    want = jagg.trimmed_fedavg(j, trim_ratio=0.25)
    assert_close(tagg.trimmed_fedavg(t, torch.from_numpy(w), trim_ratio=0.25),
                 want, 1e-6)
    k = int(0.25 * C)
    if k and 2 * k < C:         # the trimmed mean, not the plain one
        assert not np.allclose(flat(want)["blocks/q_proj/lora_A"],
                               flat(jagg.fedavg(j))["blocks/q_proj/lora_A"])


@pytest.mark.parametrize("weighted", [False, True])
def test_fedavg_excluding_and_keep_components_match_reference(weighted):
    j, t = stack(4)
    w = np.asarray([1, 2, 3, 4], np.float32) if weighted else None
    rx = r"local_[AB]$"
    got = tagg.fedavg_excluding(t, None if w is None else torch.from_numpy(w),
                                exclude_rx=rx)
    assert_close(got, jagg.fedavg_excluding(
        j, None if w is None else jnp.asarray(w), exclude_rx=rx), 1e-6)
    for p, x in tpt.tree_leaves_with_path(got):
        assert (not bool(x.any())) == bool(re.search(rx, p)), p
    assert_close(tagg.keep_components(tpt.tree_map(lambda x: x[0], t), rx),
                 jagg.keep_components(jax.tree.map(lambda x: x[0], j), rx),
                 0.0)


@pytest.mark.parametrize("staleness", [None, (0, 0, 0, 0), (0, 1, 3, 7)])
@pytest.mark.parametrize("weighted", [False, True])
def test_staleness_fedavg_matches_reference(staleness, weighted):
    j, t = stack(4)
    w = np.asarray([1, 2, 3, 4], np.float32) if weighted else None
    s = None if staleness is None else np.asarray(staleness, np.float32)
    want = jagg.StalenessFedAvg(alpha=0.5)(
        j, None if w is None else jnp.asarray(w),
        staleness=None if s is None else jnp.asarray(s))
    got = tagg.StalenessFedAvg(alpha=0.5)(
        t, None if w is None else torch.from_numpy(w),
        staleness=None if s is None else torch.from_numpy(s))
    assert_close(got, want, 1e-6)
    assert tagg.StalenessFedAvg.needs_staleness
    np.testing.assert_allclose(
        tagg.staleness_scale(torch.tensor([0.0, 1.0, 3.0]), 0.5).numpy(),
        np.asarray(jagg.staleness_scale(jnp.asarray([0.0, 1.0, 3.0]), 0.5)),
        rtol=1e-6)


@pytest.mark.parametrize("ratio", [0.05, 0.3, 1.0])
def test_topk_picks_the_reference_coordinates(ratio):
    j, t = stack(4, seed=1)
    for c in range(4):
        want = jagg.compress_update(jax.tree.map(lambda x: x[c], j),
                                    mode="topk", topk_ratio=ratio)
        got = tagg.compress_update(tpt.tree_map(lambda x: x[c], t),
                                   mode="topk", topk_ratio=ratio)
        assert_close(got, want, 0.0)
        for p, x in tpt.tree_leaves_with_path(got):
            k = min(x.numel(), int(np.ceil(ratio * x.numel())))
            assert int(torch.count_nonzero(x)) == k, p
    agg = tagg.CompressedFedAvg(mode="topk", topk_ratio=ratio)
    assert_close(agg(t, step=3), jagg.CompressedFedAvg(
        mode="topk", topk_ratio=ratio)(j, step=3), 1e-6)


def test_q8_roundtrip_is_within_a_step_and_unbiased():
    """Each coordinate lands on one of the two codes around it, all-zero
    leaves stay exactly zero, and over N draws the mean is within 5
    standard errors (σ ≤ scale / 2) of the input at every coordinate."""
    _, t = stack(4, seed=2, zero_leaf=True)
    one = tpt.tree_map(lambda x: x[0], t)
    N = 400
    draws = [tagg.compress_update(one, mode="q8", step=s, client_idx=1)
             for s in range(N)]
    for p, x in tpt.tree_leaves_with_path(one):
        ys = torch.stack([tpt.tree_get(d, p) for d in draws])
        if not bool(x.any()):
            assert not bool(ys.any()), p
            continue
        scale = float(x.abs().max()) / 127.0
        assert float((ys - x).abs().max()) <= scale * (1 + 1e-6), p
        se = 0.5 * scale / np.sqrt(N)
        assert float((ys.mean(0) - x).abs().max()) <= 5 * se, p
    # the stream is keyed by (seed, step, client, leaf): deterministic
    again = tagg.compress_update(one, mode="q8", step=0, client_idx=1)
    other = tagg.compress_update(one, mode="q8", step=0, client_idx=2)
    assert all(torch.equal(a, b) for a, b in zip(
        tpt.tree_leaves(again), tpt.tree_leaves(draws[0])))
    assert not all(torch.equal(a, b) for a, b in zip(
        tpt.tree_leaves(other), tpt.tree_leaves(draws[0])) if a.any())
    with pytest.raises(ValueError, match="compression mode"):
        tagg.compress_update(one, mode="q4")


def test_q8_aggregate_is_within_a_step_of_the_mean():
    j, t = stack(4, seed=3)
    got = tagg.CompressedFedAvg(mode="q8")(t, step=5)
    want = jax.jit(jagg.CompressedFedAvg(mode="q8"))(j, step=5)
    mean = tagg.fedavg(t)
    for p, x in tpt.tree_leaves_with_path(t):
        step = float(np.mean([float(x[c].abs().max()) / 127.0
                              for c in range(4)]))
        assert float((tpt.tree_get(got, p) - tpt.tree_get(mean, p))
                     .abs().max()) <= step * (1 + 1e-5), p
        # the reference's draws obey the same bound
        assert np.abs(flat(want)[p] - tpt.tree_get(mean, p).numpy()
                      ).max() <= step * (1 + 1e-5), p


@pytest.mark.parametrize("weights,n,match", [
    ((1, 1, 1), 4, "3 entries for 4 clients"),
    ((1, 0, 1, 1), 4, "must be > 0"),
    ((1, -2, 1, 1), 4, "must be > 0")])
def test_validate_client_weights_errors_match_reference(weights, n, match):
    msgs = []
    for fn in (jpeft.validate_client_weights, tpeft.validate_client_weights):
        with pytest.raises(ValueError, match=match) as e:
            fn(weights, n)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match=match):
        THyper(n_clients=n, client_weights=weights)
    tpeft.validate_client_weights((1, 2, 3, 4), 4)


def test_client_weights_reach_the_aggregate(base):
    """``FedHyper.client_weights`` and the ``weights=`` override give the
    weighted mean of the clients' adapters."""
    hp = THyper(method="lora", n_clients=3, client_weights=(1, 2, 5))
    sim = TSim(T_CFG, hp, base=to_port(base), device="cpu")
    g = torch.Generator().manual_seed(0)
    sim.client_adapters = tpt.tree_map(
        lambda x: x + torch.randn(x.shape, generator=g), sim.client_adapters)
    clients = sim.client_adapters
    got = sim.aggregate()
    assert_close(got, tagg.fedavg(clients, torch.tensor([1.0, 2.0, 5.0])),
                 1e-6)
    sim.client_adapters = clients
    assert_close(sim.aggregate(weights=[1, 1, 1]), tagg.fedavg(clients), 1e-6)


# ---------------------------------------------------------------------------
# comm accounting and FedProx
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
def test_comm_bytes_per_method_match_reference(base, name):
    j, t = jmeth.get_method(name), tmeth.get_method(name)
    ad = j.make_adapter(base, J_CFG, jax.random.PRNGKey(1))
    ratio = getattr(j.collective, "topk_ratio", 0.01)
    want = jagg.comm_bytes_per_round(ad, exclude_rx=j.keep_local,
                                     comm=jagg.comm_class(j), n_clients=4,
                                     topk_ratio=ratio)
    got = tagg.comm_bytes_per_round(to_port(ad), exclude_rx=t.keep_local,
                                    comm=tagg.comm_class(t), n_clients=4,
                                    topk_ratio=tagg.topk_ratio(t))
    assert got == want > 0


def test_prox_term_matches_reference(base):
    """The FedProx stage-1 loss and gradients at θ ≠ θ_ref: the loss is
    the plain loss plus ½µ‖θ − θ_ref‖², within 1e-5 relative."""
    from repro.fed.simulate import FedHyper as JHyper, FedSim as JSim
    mu = 0.5
    js = JSim(J_CFG, JHyper(method="fedprox", n_clients=1, prox_mu=mu),
              base=base)
    ts = TSim(T_CFG, THyper(method="fedprox", n_clients=1, prox_mu=mu),
              base=to_port(base), device="cpu")
    ref = js.adapter_template
    rng = np.random.default_rng(8)
    theta = jax.tree.map(lambda x: x + jnp.asarray(
        rng.normal(size=x.shape) * 0.1, jnp.float32), ref)
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def j_loss(a):
        return js._loss(js.base, a, jb, None, 0.0, ref, mu)
    (j_l, _), j_g = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(theta)
    t_l, _, t_g = ts.loss_and_grad(to_port(theta), tloader.to_device(b, "cpu"),
                                   prox_ref=to_port(ref))
    plain, _, _ = ts.loss_and_grad(to_port(theta),
                                   tloader.to_device(b, "cpu"))
    sq = sum(float(np.sum((flat(theta)[p] - flat(ref)[p]) ** 2))
             for p in flat(ref))
    assert abs(float(t_l) - float(j_l)) <= 1e-5 * abs(float(j_l))
    assert abs(float(t_l) - (float(plain) + 0.5 * mu * sq)) <= 1e-5 * float(t_l)
    assert_close(t_g, j_g, 1e-4, "prox grads")


# ---------------------------------------------------------------------------
# Fig. 1 and the D-M helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decomposed", [False, True])
def test_sensitivity_report_matches_reference(base, decomposed):
    rng = np.random.default_rng(9)
    ad = jpeft.add_lora(base, J_CFG, jax.random.PRNGKey(2),
                        decomposed=decomposed)

    def jitter(s):
        return jpt.tree_map_with_path(
            lambda p, x: x + jnp.asarray(rng.normal(size=x.shape) * s,
                                         jnp.float32)
            if not p.endswith(("dA_dir", "dB_mag")) else x, ad)
    tasks = {f"t{i}": jitter(0.05 * (i + 1)) for i in range(3)}
    want = jsens.sensitivity_report(tasks, ad)
    got = tsens.sensitivity_report({k: to_port(v) for k, v in tasks.items()},
                                   to_port(ad))
    assert set(got) == set(want) and set(got["per_task"]) == set(tasks)
    for task, row in want["per_task"].items():
        for k, v in row.items():
            assert got["per_task"][task][k] == pytest.approx(v, rel=1e-6), k
    for k in ("obs1_dir_ratio_A_over_B", "obs2_mag_ratio_B_over_A"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def test_dora_pair_helpers_match_reference():
    rng = np.random.default_rng(10)
    A = rng.normal(size=(2, 16, 4)).astype(np.float32)
    B = rng.normal(size=(2, 4, 12)).astype(np.float32)
    want = jdora.decompose_lora_pair(jnp.asarray(A), jnp.asarray(B))
    got = tdora.decompose_lora_pair(torch.from_numpy(A), torch.from_numpy(B))
    assert_close(got, want, 1e-6)
    c = dict(want, dA_dir=jnp.asarray(rng.normal(size=A.shape) * 0.1,
                                      jnp.float32),
             dB_mag=jnp.asarray(rng.normal(size=(2, 4)), jnp.float32))
    assert_close({"w": tdora.effective_delta_w(to_port(c), 2.0)},
                 {"w": jdora.effective_delta_w(c, 2.0)}, 1e-6)
    # without the deltas, ΔW is scale · A · B of the pair itself
    plain = tdora.effective_delta_w(got, 2.0)
    np.testing.assert_allclose(plain.numpy(), 2.0 * A @ B, rtol=1e-5,
                               atol=1e-5)
