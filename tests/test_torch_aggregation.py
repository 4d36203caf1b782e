"""The port's aggregation, comm accounting and method registry against
the JAX package's, on the CPU.

Client-stacked adapter trees come from the reference's ``add_lora`` (on
the tiny config of ``tests/test_fed.py``), carried across by
``checkpoint.bridge`` and desynchronized per client by numpy draws.
Tolerance: the means within 1e-6 of the reference's, relative to the
leaf's max |value| (f32 sums over C clients in another order); the
keep-local restore and the comm bytes exactly.
"""
import dataclasses

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
from repro_torch.utils import pytree as tpt

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
            lora_rank=4, lora_dropout=0.0)
C = 3


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def flat(tree):
    if all(torch.is_tensor(x) for x in tpt.tree_leaves(tree)):
        return {p: x.numpy() for p, x in tpt.tree_leaves_with_path(tree)}
    return dict(zip(jpt.tree_paths(tree), map(np.asarray,
                                              jax.tree.leaves(tree))))


@pytest.fixture(scope="module", params=[True, False],
                ids=["decomposed", "raw"])
def world(request):
    cfg = JArch(**TINY)
    base = JM.init_params(jax.random.PRNGKey(0), cfg)
    ad = jpeft.add_lora(base, cfg, jax.random.PRNGKey(1),
                        decomposed=request.param)
    rng = np.random.default_rng(2)
    stacked = jax.tree.map(
        lambda x: jnp.asarray(np.asarray(x)[None] + rng.normal(
            size=(C,) + x.shape).astype(np.float32)), ad)
    return ad, stacked


def assert_close(got, want, tol=1e-6):
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for p, w in want.items():
        err = np.abs(got[p] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (p, err)


@pytest.mark.parametrize("fn", ["fedavg", "decomposed_fedavg"])
@pytest.mark.parametrize("weighted", [False, True])
def test_means_match_reference(world, fn, weighted):
    _, stacked = world
    w = np.asarray([1.0, 3.0, 0.5], np.float32) if weighted else None
    want = getattr(jagg, fn)(stacked, None if w is None else jnp.asarray(w))
    got = getattr(tagg, fn)(to_port(stacked),
                            None if w is None else torch.from_numpy(w))
    assert_close(got, want)


def test_rebroadcast_keeps_personal_leaves_bit_for_bit(world):
    _, stacked = world
    t_stacked = to_port(stacked)
    aggd = tagg.fedavg(t_stacked)
    out = tagg.rebroadcast_keep_personal(aggd, t_stacked, r"dB_mag$")
    want = jagg.rebroadcast_keep_personal(jagg.fedavg(stacked), stacked,
                                          r"dB_mag$")
    assert_close(out, want)
    for p, x in tpt.tree_leaves_with_path(out):
        if p.endswith("dB_mag"):
            assert torch.equal(x, tpt.tree_get(t_stacked, p)), p
        else:
            for c in range(C):
                assert torch.equal(x[c], tpt.tree_get(aggd, p)), p
    # client_rebroadcast is the per-client form of the same restore
    one = tagg.client_rebroadcast(aggd, tpt.tree_map(lambda x: x[1],
                                                     t_stacked), r"dB_mag$")
    for p, x in tpt.tree_leaves_with_path(one):
        assert torch.equal(x, tpt.tree_get(out, p)[1]), p


@pytest.mark.parametrize("method", ["fedlora_opt", "lora"])
@pytest.mark.parametrize("comm", ["psum", "all_gather", "q8", "topk"])
@pytest.mark.parametrize("topk_ratio", [0.01, 0.3])
def test_comm_bytes_match_reference(world, method, comm, topk_ratio):
    ad, _ = world
    keep = jmeth.get_method(method).keep_local
    assert keep == tmeth.get_method(method).keep_local
    kw = dict(exclude_rx=keep, comm=comm, n_clients=C,
              topk_ratio=topk_ratio)
    assert (tagg.comm_bytes_per_round(to_port(ad), **kw)
            == jagg.comm_bytes_per_round(ad, **kw))


@pytest.mark.parametrize("method", ["fedlora_opt", "lora"])
def test_registered_methods_match_reference(world, method):
    ad, _ = world
    j, t = jmeth.get_method(method), tmeth.get_method(method)
    assert tagg.comm_class(t) == jagg.comm_class(j) == "psum"
    t_fields = {f.name for f in dataclasses.fields(tmeth.FedMethod)}
    assert {f.name for f in dataclasses.fields(jmeth.FedMethod)} == t_fields
    for name in sorted(t_fields - {"make_adapter", "aggregate", "train_mask",
                                   "global_mask", "local_mask",
                                   "personal_reg"}):
        assert getattr(t, name) == getattr(j, name), name
    assert not (j.prox or j.rank_aware or j.server_zero_rx)
    t_ad = to_port(ad)
    for stage in ("local_pretrain", "global", "local"):
        assert (flat_mask(t.stage_mask(t_ad, stage))
                == flat_mask(j.stage_mask(ad, stage))), stage
    if j.personal_reg is not None:
        assert flat_mask(t.personal_reg(t_ad)) == flat_mask(
            j.personal_reg(ad))


def flat_mask(m):
    return {p: bool(x) for p, x in (tpt.tree_leaves_with_path(m)
                                    if isinstance(m, dict) else m)}


def test_unported_methods_raise_naming_a8():
    """No method is left unported: each of the reference's 14 resolves
    to the port's method of that name (none raises naming A8b), and an
    unknown name still raises."""
    names = jmeth.available_methods()
    assert len(names) == 14
    assert tmeth.available_methods() == names
    assert not hasattr(tmeth, "UNPORTED")
    for name in names:
        assert tmeth.get_method(name).name == name
    with pytest.raises(ValueError, match="unknown"):
        tmeth.get_method("no_such_method")


def test_stage_masks_match_reference(world):
    ad, _ = world
    t_ad = to_port(ad)
    for name in ("mask_all", "mask_stage_local_pretrain",
                 "mask_stage_global", "mask_stage_local", "reg_mask_dB"):
        assert (flat_mask(getattr(tpeft, name)(t_ad))
                == flat_mask(getattr(jpeft, name)(ad))), name
