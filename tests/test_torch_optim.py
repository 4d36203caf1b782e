"""The port's optimizers and schedules against the JAX package's, on the
CPU.

Both packages get the same f32 parameters and gradients (numpy draws from
a seed, carried across by ``checkpoint.bridge``).  Tolerance: one
``chain_clip(masked(adamw))`` step within 1e-6 of the reference's
update, relative to that leaf's max |update| (the same f32 arithmetic;
the clip norm sums its leaves in another order).  Exact: a masked leaf's
update and a zero gradient's update are 0, bit for bit.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro import optim as jopt
from repro.optim import schedules as jsched
from repro.utils import pytree as jpt
from repro_torch import optim as topt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.optim import schedules as tsched
from repro_torch.utils import pytree as tpt

PATHS = ("q/A_dir", "q/B_mag", "q/dA_dir", "q/dB_mag", "v/A_dir", "v/B_mag")
SHAPES = {"A_dir": (16, 4), "B_mag": (4,), "dA_dir": (16, 4), "dB_mag": (4,)}


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = {}
    for p in PATHS:
        jpt.set_leaf(out, p, (rng.normal(size=SHAPES[p.split("/")[1]])
                              * scale).astype(np.float32))
    return out


def mask_of(t, rx):
    import re
    return jpt.path_mask(t, lambda p: re.search(rx, p) is None)


def both(np_tree):
    return jax.tree.map(jnp.asarray, np_tree), params_from_numpy(np_tree, "cpu")


def leaves(t):
    if isinstance(t, dict) and all(torch.is_tensor(x) for x in tpt.tree_leaves(t)):
        return {p: x.numpy() for p, x in tpt.tree_leaves_with_path(t)}
    return dict(zip(jpt.tree_paths(t), map(np.asarray, jax.tree.leaves(t))))


def nest(flat):
    out = {}
    for p, x in flat.items():
        jpt.set_leaf(out, p, x)
    return out


def rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("clip", [1.0, 0.05])
def test_masked_clipped_adamw_steps_match_reference(clip):
    """Three steps (bias correction at step + 1, moments carried) on
    identical gradients; clip 0.05 scales every gradient, clip 1.0 none."""
    params, grads = tree(0), [tree(s, 0.1) for s in (1, 2, 3)]
    jp, tp = both(params)
    mask = mask_of(params, r"d[AB]_")
    j_o = jopt.chain_clip(jopt.masked(jopt.adamw(1e-3, weight_decay=0.01),
                                      mask), clip)
    t_o = topt.chain_clip(topt.masked(topt.adamw(1e-3, weight_decay=0.01),
                                      mask), clip)
    js, ts = j_o.init(jp), t_o.init(tp)
    for step, g in enumerate(grads):
        jg, tg = both(g)
        ju, js = j_o.update(jg, js, jp, jnp.asarray(step, jnp.int32))
        tu, ts = t_o.update(tg, ts, tp, step)
        ju, tu = leaves(ju), leaves(tu)
        for p in PATHS:
            assert tu[p].dtype == np.float32
            if "/d" in p:       # masked out: exactly zero
                assert not tu[p].any(), p
            else:
                assert rel(tu[p], ju[p]) <= 1e-6, (step, p, rel(tu[p], ju[p]))
        jp = jopt.optimizers.apply_updates(jp, both(nest(ju))[0])
        tp = topt.apply_updates(tp, params_from_numpy(nest(tu), "cpu"))


def test_masked_leaves_carry_no_state():
    params = tree(0)
    _, tp = both(params)
    st = topt.masked(topt.adamw(1e-3), mask_of(params, r"d[AB]_")).init(tp)
    for p, x in tpt.tree_leaves_with_path(st["mu"]):
        assert x.numel() == (0 if "/d" in p else tpt.tree_get(tp, p).numel())


def test_zero_gradient_gives_zero_update():
    """B_mag = 0 at init makes the first gradients of A_dir, A_mag, B_dir
    and dA_dir exactly 0: AdamW must give exactly 0 (0 / (0 + eps))."""
    params = tree(0)
    _, tp = both(params)
    zero = tpt.tree_zeros_like(tp)
    o = topt.chain_clip(topt.masked(topt.adamw(1e-3), tpt.path_mask(
        tp, lambda p: True)), 1.0)
    upd, st = o.update(zero, o.init(tp), tp, 0)
    for x in tpt.tree_leaves(upd) + tpt.tree_leaves(st["mu"]):
        assert torch.equal(x, torch.zeros_like(x))


def test_clip_norm_counts_masked_leaves():
    """The clip scales by the norm of every gradient leaf, frozen ones
    included (chain_clip wraps masked): a large frozen gradient shrinks
    the trainable leaves' update."""
    params = tree(0)
    _, tp = both(params)
    mask = mask_of(params, r"d[AB]_")
    g = params_from_numpy(tree(1, 0.1), "cpu")
    big = tpt.tree_map_with_path(lambda p, x: x * 1e4 if "/d" in p else x, g)
    norm = float(tpt.global_norm(big))
    assert norm > 100 * float(tpt.global_norm(
        tpt.filter_tree(big, lambda p: "/d" not in p)))
    clipped = topt.clip_by_global_norm(big, 1.0)
    np.testing.assert_allclose(float(tpt.global_norm(clipped)), 1.0,
                               rtol=1e-6)
    # with lr 1 and no history the update is -m̂/(√v̂ + eps), so only a
    # gradient near eps shows the scale: compare the moments instead
    o = topt.chain_clip(topt.masked(topt.adamw(1e-3), mask), 1.0)
    _, st = o.update(big, o.init(tp), tp, 0)
    mu = tpt.tree_get(st["mu"], "q/A_dir")
    np.testing.assert_allclose(mu.numpy(), 0.1 * g["q"]["A_dir"].numpy()
                               / norm, rtol=1e-5)


def test_tree_helpers_match_reference():
    a, b = tree(0), tree(1)
    (ja, ta), (jb, tb) = both(a), both(b)
    np.testing.assert_allclose(float(tpt.global_norm(ta)),
                               float(jpt.global_norm(ja)), rtol=1e-6)
    np.testing.assert_allclose(float(tpt.tree_dot(ta, tb)),
                               float(jpt.tree_dot(ja, jb)), rtol=1e-5)
    for p, x in leaves(tpt.tree_sub(ta, tb)).items():
        np.testing.assert_array_equal(x, leaves(jpt.tree_sub(ja, jb))[p])
    assert (leaves(tpt.path_mask(ta, lambda p: "/d" in p))
            == leaves(jpt.path_mask(ja, lambda p: "/d" in p)))


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (3e-4,)),
    ("cosine_schedule", (1e-3, 100, 0.1)),
    ("linear_warmup_cosine", (1e-3, 10, 100, 0.05)),
])
def test_schedules_match_reference(name, args):
    j_fn, t_fn = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(j_fn(jnp.asarray(step, jnp.int32)))
        got = float(t_fn(step))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (step, got,
                                                                 want)
