"""Mixed-rank fleets in the port against the JAX package, on the CPU:
the rank axis, fleet validation, the rank masks, the three rank-aware
aggregators, the rank re-mask of the rebroadcast and rank billing; and,
port only, one ``FedSim`` round of every ``het_ranks`` method keeping
the rows above each client's rank at exactly 0, and a trained fleet
served from the adapter store at each client's own rank.

Adapters are drawn by the JAX package on ``tests/test_fed.py``'s tiny
config (2 layers, d 64, 4 heads over 2 kv heads, f32, rank 4) and
carried across by ``checkpoint.bridge``; client stacks are numpy draws,
masked to the fleet (1, 2, 3, 4) at allocation 4.

Tolerances:
- rank axes, fleet ranks, error messages, masks, rebroadcasts and comm
  bytes exactly;
- zero-pad and replication aggregates within 1e-6 of each leaf's max
  |value| (f32 sums in another order);
- exact aggregates: the products A·B within 1e-5 of their max |value|,
  the factors within 1e-5 after each rank column's sign is aligned to
  the reference's (QR and SVD fix a column only up to its sign); with
  r_out ≥ Σrᵢ the product equals Σwᵢ·AᵢBᵢ (f64) within 1e-5, with
  r_out < Σrᵢ its residual equals the Eckart-Young tail of an f64 SVD
  within 1e-5 of ‖Σwᵢ·AᵢBᵢ‖_F;
- zero rows exactly 0, bit for bit;
- served logits of each tenant within 1e-5 of max |logit| of its own
  adapter through the plain adapter path.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.core import aggregation as jagg
from repro.core import methods as jmeth
from repro.core import peft as jpeft
from repro.models import model as JM
from repro.models.config import ArchConfig as JArch
from repro.utils import pytree as jpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.core import aggregation as tagg
from repro_torch.core import methods as tmeth
from repro_torch.core import peft as tpeft
from repro_torch.data import loader, partition, synthetic
from repro_torch.fed.simulate import FedHyper, FedSim, client
from repro_torch.models import model as TM
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.serve import AdapterStore
from repro_torch.utils import pytree as tpt

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
            lora_rank=4, lora_dropout=0.0)
J_CFG, T_CFG = JArch(**TINY), TArch(**TINY)
RANKS = (1, 2, 3, 4)
C = len(RANKS)
HET = [n for n in jmeth.available_methods()
       if jmeth.get_method(n).het_ranks]
WEIGHTS = (None, (1.0, 2.0, 3.0, 4.0))


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def flat(tree):
    if all(torch.is_tensor(x) for x in tpt.tree_leaves(tree)):
        return {p: x.detach().numpy() for p, x in
                tpt.tree_leaves_with_path(tree)}
    return dict(zip(jpt.tree_paths(tree), map(np.asarray,
                                              jax.tree.leaves(tree))))


@pytest.fixture(scope="module")
def base():
    return JM.init_params(jax.random.PRNGKey(0), J_CFG)


@pytest.fixture(scope="module")
def adapters(base):
    """The JAX package's raw, decomposed and dual adapters."""
    key = jax.random.PRNGKey(1)
    return {"raw": jpeft.add_lora(base, J_CFG, key),
            "decomposed": jpeft.add_lora(base, J_CFG, key, decomposed=True),
            "dual": jpeft.add_dual_lora(base, J_CFG, key)}


# ---------------------------------------------------------------------------
# the rank axis, fleet validation, masks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jmeth.available_methods())
def test_rank_axis_matches_reference(base, name):
    ad = jmeth.get_method(name).make_adapter(base, J_CFG,
                                             jax.random.PRNGKey(1))
    axes = {p: tpeft.rank_axis(p) for p in jpt.tree_paths(ad)}
    assert axes == {p: jpeft.rank_axis(p) for p in axes}
    # a het_ranks method's adapter has a rank axis on some leaf
    assert any(a is not None for a in axes.values()) == (name in HET)


@pytest.mark.parametrize("ranks,n,server", [
    ((1, 2, 3, 4), 4, 0), ((2, 2, 2, 2), 4, 0), ((1, 2, 3, 4), 4, 10),
    ((4, 4, 4, 4), 4, 4), ([3, 1], 2, 0)])
def test_fleet_alloc_rank_matches_reference(ranks, n, server):
    assert (tpeft.fleet_alloc_rank(ranks, n, server)
            == jpeft.fleet_alloc_rank(ranks, n, server))


@pytest.mark.parametrize("ranks,n,server", [
    ((1, 2, 3), 4, 0), ((0, 2, 3, 4), 4, 0), ((1, 2, 3, 8), 4, 6)])
def test_fleet_alloc_rank_errors_match_reference(ranks, n, server):
    with pytest.raises(ValueError) as want:
        jpeft.fleet_alloc_rank(ranks, n, server)
    with pytest.raises(ValueError) as got:
        tpeft.fleet_alloc_rank(ranks, n, server)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as hp:
        FedHyper(n_clients=n, client_ranks=ranks, server_rank=server)
    assert str(hp.value) == str(want.value)


@pytest.mark.parametrize("kind", ["raw", "decomposed", "dual"])
@pytest.mark.parametrize("ranks", [RANKS, (4, 1, 3, 2)])
def test_client_rank_masks_match_reference(adapters, kind, ranks):
    ad = adapters[kind]
    want = flat(jpeft.client_rank_masks(ad, jnp.asarray(ranks)))
    got = flat(tpeft.client_rank_masks(to_port(ad), ranks))
    assert set(got) == set(want)
    for p, w in want.items():
        assert got[p].dtype == w.dtype and got[p].shape == w.shape, p
        assert np.array_equal(got[p], w), p


# ---------------------------------------------------------------------------
# the rank-aware aggregators on numpy stacks
# ---------------------------------------------------------------------------

def stack(seed=0, ranks=RANKS, r=4):
    """A client stack of two raw-LoRA pairs and one leaf without a rank
    axis, masked to ``ranks`` at allocation ``r``."""
    rng = np.random.default_rng(seed)
    n = len(ranks)

    def pair(d_in, d_out):
        return {"lora_A": rng.normal(size=(n, 2, d_in, r)),
                "lora_B": rng.normal(size=(n, 2, r, d_out)) * 0.1}
    tree = {"blocks": {"q_proj": pair(16, 12), "v_proj": pair(16, 8),
                       "norm": {"A_mag": rng.normal(size=(n, 2, 16))}}}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    masks = jpeft.client_rank_masks(jax.tree.map(lambda x: x[0], tree),
                                    jnp.asarray(ranks))
    return jax.tree.map(lambda x, m: np.asarray(x * m), tree, masks)


def both(tree):
    return jax.tree.map(jnp.asarray, tree), to_port(tree)


def assert_within(got, want, tol, what=""):
    got, want = flat(got), flat(want)
    assert set(got) == set(want), what
    for p, w in want.items():
        err = np.abs(got[p] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (what, p, err)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("fn", ["zeropad_fedavg", "replication_fedavg"])
def test_mean_family_matches_reference(fn, weights):
    j, t = both(stack())
    jw = None if weights is None else jnp.asarray(weights)
    tw = None if weights is None else torch.tensor(weights)
    want = getattr(jagg, fn)(j, jw, ranks=jnp.asarray(RANKS))
    got = getattr(tagg, fn)(t, tw, ranks=RANKS)
    assert_within(got, want, 1e-6, fn)


@pytest.mark.parametrize("weights", WEIGHTS)
def test_replication_on_a_uniform_fleet_is_fedavg(weights):
    _, t = both(stack(ranks=(4, 4, 4, 4)))
    tw = None if weights is None else torch.tensor(weights)
    assert_within(tagg.replication_fedavg(t, tw, ranks=(4,) * 4),
                  tagg.fedavg(t, tw), 1e-6)


def pairs(tree):
    """{prefix: (A, B)} of a tree without the client axis, as numpy."""
    f = flat(tree)
    return {p[:-len("/lora_A")]: (f[p], f[p[:-1] + "B"])
            for p in f if p.endswith("/lora_A")}


def exact_sum(tree, weights):
    """Σ wᵢ·AᵢBᵢ of each pair of a client stack, in f64."""
    w = np.ones(C) if weights is None else np.asarray(weights, np.float64)
    w = w / w.sum()
    f = flat(tree)
    return {p[:-len("/lora_A")]: np.einsum(
        "c,c...ir,c...ro->...io", w, f[p].astype(np.float64),
        f[p[:-1] + "B"].astype(np.float64))
        for p in f if p.endswith("/lora_A")}


def sign_aligned(a, b, ref_a):
    """(a, b) with each rank column's sign flipped to agree with
    ``ref_a``'s column (flipping A's column j and B's row j together
    leaves A·B unchanged)."""
    s = np.sign(np.sum(a * ref_a, axis=-2, keepdims=True))
    s[s == 0] = 1
    return a * s, b * np.swapaxes(s, -1, -2)


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("r_out", [None, 10])
def test_exact_fedavg_matches_reference(weights, r_out):
    j, t = both(stack())
    jw = None if weights is None else jnp.asarray(weights)
    tw = None if weights is None else torch.tensor(weights)
    want = jagg.exact_fedavg(j, jw, ranks=jnp.asarray(RANKS), r_out=r_out)
    got = tagg.exact_fedavg(t, tw, ranks=RANKS, r_out=r_out)
    assert_within(got["blocks"]["norm"], want["blocks"]["norm"], 1e-6)
    exact = exact_sum(stack(), weights)
    for p, (ga, gb) in pairs(got).items():
        wa, wb = pairs(want)[p]
        assert ga.shape == wa.shape and gb.shape == wb.shape, p
        prod = ga @ gb
        assert (np.abs(prod - wa @ wb).max()
                <= 1e-5 * np.abs(wa @ wb).max()), p
        ga, gb = sign_aligned(ga, gb, wa)
        for x, y in ((ga, wa), (gb, wb)):
            assert np.abs(x - y).max() <= 1e-5 * np.abs(y).max(), p
        norm = np.linalg.norm(exact[p], axis=(-2, -1))
        resid = np.linalg.norm(prod - exact[p], axis=(-2, -1))
        if r_out is not None:            # r_out = Σrᵢ: exact
            assert (resid <= 1e-5 * norm).all(), (p, resid / norm)
        else:                            # r_out = 4 < Σrᵢ: Eckart-Young
            s = np.linalg.svd(exact[p], compute_uv=False)
            tail = np.sqrt(np.sum(s[..., 4:] ** 2, axis=-1))
            assert (np.abs(resid - tail) <= 1e-5 * norm).all(), p
            assert (tail > 1e-3 * norm).all(), p     # truncation bites


def test_exact_fedavg_refuses_trees_without_pairs(adapters):
    ad = adapters["decomposed"]
    with pytest.raises(ValueError) as got:
        tagg.exact_fedavg(tagg.broadcast_to_clients(to_port(ad), C))
    with pytest.raises(ValueError) as want:
        jagg.exact_fedavg(jagg.broadcast_to_clients(ad, C))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["q8", "topk"])
def test_compressed_uplink_keeps_zero_rows(mode):
    """Rows above a client's rank go through the q8 and top-k uplinks as
    exact zeros (q8 maps 0 to 0; top-k keeps only nonzero coordinates
    of a leaf with more nonzeros than k)."""
    _, t = both(stack())
    for c, r in enumerate(RANKS):
        up = tagg.compress_update(client(t, c), mode=mode, step=3,
                                  client_idx=c, topk_ratio=0.3)
        for p, x in tpt.tree_leaves_with_path(up):
            ax = tpeft.rank_axis(p)
            if ax is not None:
                assert not torch.count_nonzero(x.movedim(ax, 0)[r:]), (p, c)


# ---------------------------------------------------------------------------
# rebroadcast re-mask and rank billing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keep", [None, r"dB_mag$"])
def test_rebroadcast_with_rank_masks_matches_reference(adapters, keep):
    ad = adapters["decomposed"]
    rng = np.random.default_rng(5)
    agg_j = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=x.shape), jnp.float32), ad)
    clients_j = jax.tree.map(
        lambda x: jnp.asarray(rng.normal(size=(C,) + x.shape), jnp.float32),
        ad)
    masks_j = jpeft.client_rank_masks(ad, jnp.asarray(RANKS))
    want = jagg.rebroadcast_keep_personal(agg_j, clients_j, keep, masks_j)
    t_masks = tpeft.client_rank_masks(to_port(ad), RANKS)
    got = tagg.rebroadcast_keep_personal(to_port(agg_j), to_port(clients_j),
                                         keep, t_masks)
    assert flat(got).keys() == flat(want).keys()
    for p, w in flat(want).items():
        assert np.array_equal(flat(got)[p], w), p
    for c in range(C):                  # the per-client form, client c
        one_j = jagg.client_rebroadcast(
            agg_j, jax.tree.map(lambda x: x[c], clients_j), keep,
            jax.tree.map(lambda m: m[c], masks_j))
        one_t = tagg.client_rebroadcast(
            to_port(agg_j), client(to_port(clients_j), c), keep,
            client(t_masks, c))
        for p, w in flat(one_j).items():
            assert np.array_equal(flat(one_t)[p], w), (p, c)


@pytest.mark.parametrize("kind,keep", [("decomposed", r"dB_mag$"),
                                       ("raw", None),
                                       ("dual", r"local_[AB]$")])
@pytest.mark.parametrize("comm", ["psum", "all_gather", "q8", "topk"])
def test_rank_billing_matches_reference(adapters, kind, keep, comm):
    ad = adapters[kind]
    t_ad = to_port(ad)
    for rank in (None, 1, 3, 4, 9):
        kw = dict(exclude_rx=keep, rank=rank, comm=comm, n_clients=C,
                  topk_ratio=0.05)
        assert (tagg.comm_bytes_per_round(t_ad, **kw)
                == jagg.comm_bytes_per_round(ad, **kw)), rank


# ---------------------------------------------------------------------------
# port only: one FedSim round of every het_ranks method, and serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    fam = synthetic.make_dataset_family("dolly", vocab_size=256)
    p = partition.specialist_partition(C, 4)
    cds = [synthetic.SyntheticInstructionDataset(fam, p[c], client_seed=c)
           for c in range(C)]
    srv = synthetic.SyntheticInstructionDataset(fam, np.ones(4) / 4,
                                                client_seed=99)
    return cds, srv


def zero_rows_above_ranks(tree, what):
    """Every rank-axis leaf of a client stack exactly 0 above each
    client's rank."""
    for p, x in tpt.tree_leaves_with_path(tree):
        ax = tpeft.rank_axis(p)
        if ax is None:
            continue
        for c, r in enumerate(RANKS):
            rows = x[c].movedim(ax, 0)[r:]
            assert not torch.count_nonzero(rows), (what, p, c)


def trained(method, data, base, **hp):
    """A port FedSim of ``method`` on the fleet, after one round of 2
    steps, the aggregate, the global stage (pipeline methods) and one
    personalization step, with the zero rows held after each."""
    cds, srv = data
    sim = FedSim(T_CFG, FedHyper(method=method, n_clients=C,
                                 client_ranks=RANKS, batch=2, seq_len=24,
                                 lr=3e-3, prox_mu=0.5, **hp),
                 base=base, device="cpu")
    zero_rows_above_ranks(sim.client_adapters, "init")
    rng = np.random.default_rng(0)

    def batches(n):
        return [loader.client_batch(cds, rng, 2, 24, device="cpu")
                for _ in range(n)]
    sim.local_round(batches(2))
    zero_rows_above_ranks(sim.client_adapters, "stage 1")
    agg = sim.aggregate()
    zero_rows_above_ranks(sim.client_adapters, "aggregate")
    if sim.method.pipeline:
        agg = sim.global_stage(agg, [loader.to_device(
            srv.sample_batch(rng, 2, 24), "cpu")])
        zero_rows_above_ranks(sim.client_adapters, "stage 2")
    sim.personalize(batches(1))
    zero_rows_above_ranks(sim.client_adapters, "stage 3")
    return sim, agg


@pytest.fixture(scope="module")
def t_base(base):
    return to_port(base)


@pytest.mark.parametrize("method", HET)
def test_fedsim_round_keeps_zero_rows(data, t_base, method):
    sim, _ = trained(method, data, t_base)
    assert sim.alloc_rank == 4
    m = tmeth.get_method(method)
    assert m.het_ranks and m.rank_aware == jmeth.get_method(method).rank_aware
    # each client billed at its own rank
    assert sim.comm_bytes == sum(tagg.comm_bytes_per_round(
        sim.adapter_template, exclude_rx=m.keep_local, rank=r,
        comm=tagg.comm_class(m), n_clients=C,
        topk_ratio=tagg.topk_ratio(m)) for r in RANKS)


@pytest.mark.parametrize("method", ["prompt", "adapter"])
def test_methods_without_ranks_refuse_a_fleet(method):
    with pytest.raises(ValueError, match="het_ranks=False"):
        FedSim(T_CFG, FedHyper(method=method, client_ranks=RANKS),
               device="cpu")


def logits(t_base, overlay, batch):
    h, _, _ = TM.forward(tpt.merge_trees(t_base, overlay), batch, T_CFG)
    return h @ TM._head_kernel(t_base, T_CFG)


def served_logits(t_base, store, tenants, tokens):
    return logits(t_base, store.overlay(), {
        "tokens": tokens, "adapter_idx": torch.tensor(
            [store.slot_of(t) for t in tenants], dtype=torch.int32)})


@pytest.mark.parametrize("method,kind", [("fedlora_opt", "dora_mag"),
                                         ("lora_exact", "pairs")])
def test_trained_fleet_serves_each_client_at_its_rank(data, t_base, method,
                                                      kind):
    """The trained fleet at allocation 8 (server_rank) in a pool of rank
    8: fedlora_opt's clients as dora_mag tenants over the stage-2 server
    model (whose rows above a small rank are nonzero, so the slot's rank
    mask decides them), lora_exact's as pairs tenants.  Each tenant's
    served logits equal its own adapter's through the plain path."""
    sim, agg = trained(method, data, t_base, server_rank=8)
    if kind == "dora_mag":
        above = [p for p, x in tpt.tree_leaves_with_path(agg)
                 if p.endswith("dA_dir") and torch.count_nonzero(x[..., 1:])]
        assert above                    # the server's dA_dir is full rank
        store = AdapterStore(t_base, T_CFG, n_slots=4, kind="dora_mag",
                             shared=agg, device="cpu")
        own = {c: tpt.filter_tree(client(sim.client_adapters, c),
                                  lambda p: p.endswith("dB_mag"))
               for c in range(C)}
    else:
        store = AdapterStore(t_base, T_CFG, n_slots=4, kind="pairs",
                             rank=sim.alloc_rank, device="cpu")
        own = {c: client(sim.client_adapters, c) for c in range(C)}
    assert store.rank == 8
    tenants = [f"client{c}" for c in range(C)]
    for c, t in enumerate(tenants):
        store.register(t, own[c], rank=RANKS[c])
        assert store.rank_of(t) == RANKS[c]
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, 256, size=(C, 12)), dtype=torch.int32)
    got = served_logits(t_base, store, tenants, tokens)
    want = [logits(t_base, client(sim.client_adapters, c),
                   {"tokens": tokens[c:c + 1]})[0] for c in range(C)]
    for c in range(C):
        err = float((got[c] - want[c]).abs().max() / want[c].abs().max())
        assert err <= 1e-5, (c, err)
    if kind == "dora_mag":
        # client 0's dB_mag served at the pool's full rank reads the
        # server's rows above rank 1: another model
        store.register("full", own[0])
        full = served_logits(t_base, store, ["full"], tokens[:1])[0]
        assert float((full - want[0]).abs().max()) > 1e-3 * float(
            want[0].abs().max())
