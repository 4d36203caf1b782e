"""The sequence-split KV cache (``seq_shard_kv``) and the meta grid, with
no processes.

- ``launch/specs.cache_specs(seq_shard_kv=True)`` gives the reference's
  specs leaf by leaf for every SMOKE config on 1 x 2, 2 x 2 and 1 x 4
  abstract meshes wherever the two layouts agree: every k / v cache the
  reference's rule splits on its sequence (rows that divide over the
  data axes, kv heads that do not divide over 'model', slots that do),
  and every cache where the kv heads divide, which the variant leaves as
  the baseline's (so does the port).  Where the kv heads do not divide
  and the slots do not either, or the rows do not divide, the port's
  layout stands beside the reference's dh split (``launch/specs.py``).
- ``model.init_cache`` on a grid with the layout on gives every rank the
  shapes ``shard_tree`` cuts from the whole cache by those specs, and a
  decode step resolves each cache's layout from the grid's ``kv_len``
  (``layers._decode_split``), refusing a cache of neither layout.
- ``launch/mesh.MetaGroup`` counts its collectives as a real group does
  and makes the outputs' shapes; its seconds are 0.
The decode itself on a grid of gloo ranks, against the unsharded port
and the reference's sequence-split decode, is in
``tests/test_torch_tp.py``.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import AbstractGrid, MetaGroup, make_meta_grid
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.utils import pytree as pt

MESHES = ((1, 2), (2, 2), (1, 4))


def leaves(tree):
    return dict(pt.tree_leaves_with_path(tree))


@pytest.mark.parametrize("size", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_seq_shard_kv_specs_match_the_reference(arch, size):
    pytest.importorskip("jax")
    from jax.sharding import AbstractMesh, NamedSharding
    from repro.configs import get_smoke_config as j_smoke
    from repro.launch import specs as JSP
    from repro.utils import pytree as jpt
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    grid, mesh = AbstractGrid(size), AbstractMesh(size, ("data", "model"))
    dp, tp = size
    for batch, S in ((4, 64), (1, 64), (4, 63)):
        cache = SP.abstract_cache(cfg, batch, S)
        got = leaves(SP.cache_specs(cfg, grid, cache, batch,
                                    seq_shard_kv=True))
        base = leaves(SP.cache_specs(cfg, grid, cache, batch))
        want = {}
        jpt.tree_map_with_path(lambda p, s: want.__setitem__(
            p, tuple(s.spec if isinstance(s, NamedSharding) else s)) or s,
            JSP.cache_specs(jcfg, mesh, JSP.abstract_cache(jcfg, batch, S),
                            batch, seq_shard_kv=True))
        jbase = {}
        jpt.tree_map_with_path(lambda p, s: jbase.__setitem__(
            p, tuple(s.spec)) or s,
            JSP.cache_specs(jcfg, mesh, JSP.abstract_cache(jcfg, batch, S),
                            batch))
        assert set(got) == set(want), (arch, size)
        rows = batch >= dp and batch % dp == 0
        for p, x in leaves(cache).items():
            if not p.endswith(("/k", "/v")):
                assert got[p] == base[p], (arch, p)
                continue
            K, Sc = x.shape[-2], x.shape[-3]
            if K % tp == 0:            # the variant changes nothing
                assert got[p] == base[p] and want[p] == jbase[p], (arch, p)
                if rows:
                    assert got[p] == want[p], (arch, size, batch, p)
            elif rows and Sc % tp == 0:     # split on the sequence
                assert got[p] == want[p], (arch, size, batch, S, p)
                assert got[p][-3:] == ("model", None, None)
            else:                      # the port's layout: heads whole
                assert got[p] == base[p], (arch, p)
                assert got[p][-3:] == (None, None, None)


@pytest.mark.parametrize("S", (64, 63, 24))
@pytest.mark.parametrize("size", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ("gemma3-1b", "granite-34b", "qwen2-vl-2b",
                                  "jamba-v0.1-52b", "llama2-7b"))
def test_init_cache_gives_each_rank_its_cut(arch, size, S):
    """Every rank's ``init_cache(mesh=)`` on the layout has the shapes
    and dtypes of its cut of the whole cache by ``cache_specs(
    seq_shard_kv=True)``, and a decode step reads each of its caches as
    the layout it is (gemma3-1b's rings of 64 slots beside the global
    caches; 63 and 24 positions do not split over 4 ranks, 63 not over
    2)."""
    cfg = get_smoke_config(arch)
    if arch == "gemma3-1b":
        cfg = dataclasses.replace(cfg, n_layers=7)
    B = 4
    whole = SP.abstract_cache(cfg, B, S)
    specs = SP.cache_specs(cfg, AbstractGrid(size), whole, B,
                           seq_shard_kv=True)
    split = False
    for rank in range(size[0] * size[1]):
        grid = make_meta_grid(*size, rank=rank).replace(seq_shard_kv=True,
                                                        kv_len=S)
        mine = leaves(M.init_cache(cfg, B // size[0], S, device="meta",
                                   mesh=grid))
        cut = leaves(SP.shard_tree(whole, specs, grid))
        assert {p: (tuple(x.shape), x.dtype) for p, x in mine.items()} == \
            {p: (tuple(x.shape), x.dtype) for p, x in cut.items()}
        for p, x in mine.items():
            if not p.endswith("/k"):
                continue
            sub = cfg.pattern()[int(p.split("/")[1][3:])]
            window = cfg.sliding_window if sub.attn_kind == "local" else None
            got = L._decode_split(cfg, size[1], x.shape[-3], window, S)
            assert got == (x.shape[-3] != pt.tree_get(whole, p).shape[-3])
            split |= got
    # init_cache's rings hold min(S, 64) slots: every cache S long here
    assert split == (cfg.n_kv_heads % size[1] != 0 and S % size[1] == 0)


def test_decode_split_refuses_what_it_cannot_place():
    cfg = get_smoke_config("granite-34b")           # one kv head
    assert L._decode_split(cfg, 2, 36, None, 72)    # 72 slots, 36 a rank
    assert not L._decode_split(cfg, 2, 35, None, 35)    # odd: whole
    assert L._decode_split(cfg, 2, 35, None, 70)        # 70: 35 a rank
    with pytest.raises(ValueError, match="kv_len"):
        L._decode_split(cfg, 2, 36, None, 0)
    with pytest.raises(ValueError, match="not one of"):
        L._decode_split(cfg, 2, 72, None, 72)       # a whole, dividing one
    g = get_smoke_config("gemma3-1b")               # rings of 64
    assert L._decode_split(g, 2, 32, 64, 100)       # the prefill's ring
    assert L._decode_split(g, 2, 16, 64, 32)        # init_cache's 32 slots
    assert not L._decode_split(get_smoke_config("llama2-7b"), 2, 72, None,
                               72)                  # kv heads divide


def test_meta_group_counts_as_a_group_does():
    """A MetaGroup of 2 ranks on meta tensors: one all-reduce a dtype of
    its list, the bytes this rank sends once, the outputs' shapes; the
    all-gather's stacked parts, the all-to-all's and the max's buffers;
    no seconds."""
    g = MetaGroup(1, 2)

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    out = g.all_reduce([meta(3, 4), meta(5), meta(2, dtype=torch.bfloat16)])
    assert [tuple(t.shape) for t in out] == [(3, 4), (5,), (2,)]
    assert g.stats["all_reduce"]["calls"] == 2
    assert g.stats["all_reduce"]["bytes"] == 17 * 4 + 2 * 2
    got = g.all_gather([meta(3, 2)])[0]
    assert tuple(got.shape) == (2, 3, 2)
    assert g.stats["all_gather"] == {"calls": 1, "bytes": 24, "seconds": 0.0}
    assert tuple(g.exchange(meta(4, 3)).shape) == (4, 3)
    assert tuple(g.reduce_max(meta(2, 1)).shape) == (2, 1)
    assert g.stats["all_to_all"]["bytes"] == 48
    assert g.stats["all_reduce"]["calls"] == 3
    assert all(st["seconds"] == 0.0 for st in g.stats.values())
    grid = make_meta_grid(2, 2, rank=3)
    assert (grid.coords, grid.data.rank, grid.model.rank) == (
        {"data": 1, "model": 1}, 1, 1)
    assert grid.device.type == "meta" and grid.backend == "meta"
    seq = grid.replace(seq_shard_kv=True, kv_len=72)
    assert (seq.seq_shard_kv, seq.kv_len, grid.seq_shard_kv) == (True, 72,
                                                                 False)
    with pytest.raises(ValueError, match="not on a 2 x 2 grid"):
        make_meta_grid(2, 2, rank=4)
