"""The sharding rules and specs of the port's grid (``utils/sharding.py``,
``launch/specs.py``), against the reference's on abstract meshes (no
devices, no processes).

Every SMOKE config's backbone and adapter trees: ``spec_for`` /
``tree_specs`` over both rule tables give the reference's spec leaf for
leaf on ('data', 'model') and ('pod', 'data', 'model') meshes;
``param_specs`` and ``cache_specs`` give the reference's but where the
port lays a tensor out otherwise (``launch/specs.py``: kv heads that do
not divide over 'model' stay whole; a batch that does not divide over the
data axes is not split), ``cache_specs(seq_shard_kv=True)`` the
reference's sequence split; ``shard_tree`` over every rank's coordinates and
a concatenation give back the whole tree.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import AbstractGrid
from repro_torch.launch.train import base_manual_specs
from repro_torch.models import model as M
from repro_torch.utils import pytree as pt
from repro_torch.utils import sharding as shd

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.launch.train import base_manual_specs as j_base_manual  # noqa: E402
from repro.utils import pytree as jpt  # noqa: E402
from repro.utils import sharding as jshd  # noqa: E402

ARCHS = tuple(ARCH_IDS)
MESHES = {"data-model": ((2, 2), ("data", "model")),
          "pod-data-model": ((2, 2, 2), ("pod", "data", "model"))}
RULES = {"default": (shd.DEFAULT_PARAM_RULES, jshd.DEFAULT_PARAM_RULES),
         "fsdp": (shd.FSDP_PARAM_RULES, jshd.FSDP_PARAM_RULES)}


def meshes(name):
    sizes, axes = MESHES[name]
    return AbstractGrid(sizes, axes), AbstractMesh(sizes, axes)


def flat_specs(tree):
    """{path: spec tuple} of a reference spec tree (PartitionSpec or
    NamedSharding leaves)."""
    out = {}

    def put(p, s):
        out[p] = tuple(s.spec if isinstance(s, NamedSharding) else s)
        return s
    jpt.tree_map_with_path(put, tree)
    return out


def port_flat(tree):
    return dict(pt.tree_leaves_with_path(tree))


@pytest.fixture(scope="module")
def trees():
    """Per config: the port's and the reference's abstract backbone and
    adapter trees."""
    out = {}
    for arch in ARCHS:
        cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
        out[arch] = dict(
            cfg=cfg, jcfg=jcfg,
            base=SP.abstract_params(cfg), ad=SP.abstract_adapters(cfg),
            jbase=JSP.abstract_params(jcfg), jad=JSP.abstract_adapters(jcfg))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_rule_tables_give_the_reference_specs(trees, arch):
    """Both rule tables, both meshes, backbone and adapters, leaf for
    leaf."""
    t = trees[arch]
    for (mname, (port_rules, ref_rules)), kind in itertools.product(
            itertools.product(MESHES, RULES.values()), ("base", "ad")):
        grid, mesh = meshes(mname)
        got = port_flat(shd.tree_specs(t[kind], port_rules, grid))
        want = flat_specs(jshd.tree_specs(t["j" + kind], ref_rules, mesh))
        assert got == want, (arch, mname, kind)
        for p, x in pt.tree_leaves_with_path(t[kind]):
            assert shd.spec_for(p, x.dim(), port_rules, grid) == tuple(
                jshd.spec_for(p, x.dim(), ref_rules, mesh)), (arch, p)


@pytest.mark.parametrize("mname", MESHES)
def test_client_and_batch_specs_match_the_reference(trees, mname):
    grid, mesh = meshes(mname)
    ad = trees["llama2-7b"]["ad"]
    jad = trees["llama2-7b"]["jad"]
    assert shd.data_axis_names(grid) == jshd.data_axis_names(mesh)
    assert shd.client_axis(grid) == jshd.client_axis(mesh)
    assert shd.client_vector_spec(grid) == tuple(jshd.client_vector_spec(mesh))
    assert port_flat(shd.client_specs(ad, grid)) == flat_specs(
        jshd.client_specs(jad, mesh))
    assert port_flat(shd.replicated_specs(ad)) == flat_specs(
        jshd.replicated_specs(jad))
    for ndim, axis in ((2, 0), (3, 1)):
        assert shd.batch_spec(grid, ndim, axis) == tuple(
            jshd.batch_spec(mesh, ndim, axis))
    for client_axis in (False, True):
        got = port_flat(SP.adapter_specs(grid, ad, client_axis))
        want = flat_specs(JSP.adapter_specs(mesh, jad, client_axis))
        assert got == want, (mname, client_axis)


def whole_kv(path, cfg, tp):
    return (cfg.n_kv_heads % tp != 0
            and path.endswith(("k_proj/kernel", "v_proj/kernel")))


def mixer_split(path, cfg, tp):
    """The port's head split of the Mamba-2 mixer where the rule table
    replicates a leaf (``launch/specs.py``): the last two entries of its
    spec, or None where the port keeps the table's."""
    if "/ssm/" not in path:
        return None
    groups = "model" if cfg.ssm_groups % tp == 0 else None
    if path.endswith(("z_proj/kernel", "x_proj/kernel", "dt_proj/kernel")):
        return (None, "model")
    if path.endswith(("B_proj/kernel", "C_proj/kernel")):
        return (None, groups)
    if path.endswith("conv_x"):
        return ("model", None)
    if path.endswith(("conv_B", "conv_C")):
        return (groups, None)
    return None


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_reference_rules_but_for_whole_kv(trees, arch):
    """The rule table's specs, but k_proj / v_proj whole where the kv
    heads do not divide over 'model' (granite-34b, gemma3-1b), and the
    Mamba-2 mixer split by heads (z_proj / x_proj / dt_proj columns,
    conv_x channels; B_proj / C_proj / conv_B / conv_C by groups where
    they divide, else whole), on grids of one and two model ranks."""
    t = trees[arch]
    cfg = t["cfg"]
    for size in ((4, 1), (2, 2)):
        grid, mesh = AbstractGrid(size), AbstractMesh(size, ("data", "model"))
        got = port_flat(SP.param_specs(cfg, grid, t["base"]))
        want = flat_specs(JSP.param_specs(t["jcfg"], mesh, t["jbase"]))
        assert set(got) == set(want)
        for p, w in want.items():
            mixer = mixer_split(p, cfg, size[1])
            if whole_kv(p, cfg, size[1]):
                assert got[p] == (None,) * len(w), (arch, p)
            elif mixer is not None:
                assert w == (None,) * len(w), (arch, p)   # the table's
                assert got[p] == w[:-2] + mixer, (arch, p)
            else:
                assert got[p] == w, (arch, p)


@pytest.mark.parametrize("arch", ARCHS)
def test_base_manual_specs_match_the_reference(trees, arch):
    t = trees[arch]
    got = port_flat(base_manual_specs(t["base"], t["cfg"]))
    assert got == flat_specs(j_base_manual(t["jbase"], t["jcfg"]))


@pytest.mark.parametrize("batch", (4, 1))
@pytest.mark.parametrize("arch", ("llama2-7b", "granite-34b", "gemma3-1b",
                                  "qwen3-moe-30b-a3b", "mamba2-2.7b"))
def test_cache_specs_match_the_reference_where_the_layouts_agree(arch,
                                                                 batch):
    """Rows over 'data' when the batch divides, kv heads over 'model'
    when they divide: the reference's.  Where they do not, the port's
    layout (rows on every data rank, kv heads whole) stands beside the
    reference's sequence split and dh split.  With ``seq_shard_kv``, a
    cache whose rows divide and kv heads do not is split on its sequence
    over 'model', as the reference's variant splits it."""
    cfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    tp = 1 if any(s.mixer == "ssm" for s in cfg.pattern()) else 2
    size = (2, tp)
    grid, mesh = AbstractGrid(size), AbstractMesh(size, ("data", "model"))
    got = port_flat(SP.cache_specs(cfg, grid, SP.abstract_cache(cfg, batch, 64),
                                   batch))
    want = flat_specs(JSP.cache_specs(jcfg, mesh,
                                      JSP.abstract_cache(jcfg, batch, 64),
                                      batch))
    assert set(got) == set(want)
    for p, w in want.items():
        g = got[p]
        if p.endswith(("/k", "/v")):
            K = cfg.n_kv_heads
            lead = (None,) * (len(w) - 4)
            rows = "data" if batch % 2 == 0 else None
            assert g == lead + (rows, None, "model" if K % tp == 0 else None,
                                None), (arch, p, g)
            if rows and K % tp == 0:
                assert g == w, (arch, p)
        else:
            assert g == w, (arch, p)
    # the seq_shard_kv variant: the reference's sequence split where the
    # rows divide and the kv heads do not; elsewhere the layout above
    seq = port_flat(SP.cache_specs(cfg, grid, SP.abstract_cache(cfg, batch,
                                                                64),
                                   batch, seq_shard_kv=True))
    jseq = flat_specs(JSP.cache_specs(jcfg, mesh,
                                      JSP.abstract_cache(jcfg, batch, 64),
                                      batch, seq_shard_kv=True))
    for p, w in jseq.items():
        if (p.endswith(("/k", "/v")) and batch % 2 == 0
                and cfg.n_kv_heads % tp):
            assert seq[p] == w and w[-3] == "model", (arch, p)
        else:
            assert seq[p] == got[p], (arch, p)


def reassemble(shards, specs, grid_shape, axes):
    """The whole tree from every rank's shard: each leaf's blocks put
    back at their coordinates' offsets."""
    first = next(iter(shards.values()))
    out = {}
    for p in first:
        spec = pt.tree_get(specs, p)
        parts = {c: s[p] for c, s in shards.items()}
        shape = list(first[p].shape)
        for dim, entry in enumerate(spec):
            if entry is not None:
                names = (entry,) if isinstance(entry, str) else entry
                shape[dim] *= int(np.prod([grid_shape[a] for a in names]))
        whole = torch.full(shape, float("nan"), dtype=first[p].dtype)
        for coords, x in parts.items():
            c = dict(zip(axes, coords))
            idx = []
            for dim, entry in enumerate(spec):
                if entry is None:
                    idx.append(slice(None))
                    continue
                names = (entry,) if isinstance(entry, str) else entry
                k = 0
                for a in names:
                    k = k * grid_shape[a] + c[a]
                n = x.shape[dim]
                idx.append(slice(k * n, (k + 1) * n))
            block = whole[tuple(idx)]
            assert torch.isnan(block).all() or torch.equal(block, x), p
            whole[tuple(idx)] = x
        out[p] = whole
    return out


@pytest.mark.parametrize("rules", ("param_specs", "fsdp"))
@pytest.mark.parametrize("arch", ("llama2-7b", "granite-34b", "gemma3-1b",
                                  "qwen3-moe-30b-a3b", "mixtral-8x22b",
                                  "qwen2-vl-2b", "mamba2-2.7b",
                                  "jamba-v0.1-52b", "seamless-m4t-large-v2"))
def test_shard_tree_and_a_concatenation_give_back_the_whole_tree(arch,
                                                                 rules):
    """Every rank's shard of a SMOKE backbone, put back together: the
    whole tree bit for bit (``param_specs`` on a 2 x 2 grid; the FSDP
    table's tuple entries on a 2 x 2 x 2 pod grid)."""
    cfg = get_smoke_config(arch)
    if arch == "mixtral-8x22b":
        cfg = dataclasses.replace(cfg, ep_fsplit=2)
    base = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    if rules == "param_specs":
        sizes, axes = (2, 2), ("data", "model")
        grid = AbstractGrid(sizes, axes)
        specs = SP.param_specs(cfg, grid, base)
    else:
        sizes, axes = (2, 2, 2), ("pod", "data", "model")
        grid = AbstractGrid(sizes, axes)
        specs = shd.tree_specs(base, shd.FSDP_PARAM_RULES, grid)
    shards = {}
    for coords in itertools.product(*(range(n) for n in sizes)):
        mine = SP.shard_tree(base, specs, AbstractGrid(
            sizes, axes, dict(zip(axes, coords))))
        shards[coords] = port_flat(mine)
        for p, x in shards[coords].items():
            assert x.is_contiguous() and x.untyped_storage().data_ptr() != \
                pt.tree_get(base, p).untyped_storage().data_ptr(), p
    whole = reassemble(shards, specs, grid.shape, axes)
    for p, x in pt.tree_leaves_with_path(base):
        assert torch.equal(whole[p], x), p
    split = [p for p, s in pt.tree_leaves_with_path(specs)
             if any(e is not None for e in s)]
    assert split, arch


def test_shard_tree_refuses_a_dimension_that_does_not_split():
    grid = AbstractGrid((2, 2), coords={"data": 0, "model": 1})
    with pytest.raises(ValueError, match="does not split"):
        SP.shard_tree({"w": torch.zeros(3, 5)}, {"w": (None, "model")}, grid)
