"""The port's checkpoint layer against the JAX package's, on the CPU.

- The codec: ``msgpack_codec.packb`` gives ``msgpack.packb(obj,
  use_bin_type=True)``'s bytes and ``unpackb`` decodes what
  ``msgpack.unpackb(raw=False)`` decodes, at every size boundary of
  every form (fix / 8 / 16 / 32-bit lengths, every int width), wider
  forms than the smallest included; any other type byte raises.
- Files: ``save_checkpoint`` of a tree carried across by
  ``bridge.params_from_numpy`` writes the JAX package's bytes (bf16,
  f32, int32, int64, uint8, bool, 0-d and (C, 0) leaves, dict keys in
  an order that only per-level sorting gets right), each package
  restores the other's file bit for bit, and the shard helpers name and
  find the same files.
- ``FedSim``: a JAX sim after one round (uniform, and at ranks 2 / 4 /
  8) loads into the port's bit for bit, saves again to the same bytes,
  and both continue one round to client leaves within 1e-4 of each
  leaf's max |value| (``tests/test_torch_fed.py``'s standard); a fleet
  with other ranks refuses the file; FedProx's anchor saved mid-cycle
  survives and the resumed run equals the uninterrupted one exactly.

Config: the reference's ``hetck-t`` (2 layers, d 32, rank 8, f32,
dropout 0); the JAX sims are built once, in a module fixture.
"""
import io
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import msgpack
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.fed.simulate import FedHyper as JHyper, FedSim as JSim
from repro.models.config import ArchConfig as JArch
from repro.utils import pytree as jpt
from repro_torch.checkpoint import ckpt as t_ckpt
from repro_torch.checkpoint import msgpack_codec as codec
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.fed.simulate import FedHyper as THyper, FedSim as TSim
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.utils import pytree as tpt

HETCK = dict(name="hetck-t", family="dense", n_layers=2, d_model=32,
             n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
             dtype="float32", lora_rank=8, lora_dropout=0.0)
J_CFG, T_CFG = JArch(**HETCK), TArch(**HETCK)


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
        2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31,
        -2**31 - 1, -2**63]
CASES = (
    [("int", n) for n in INTS]
    + [(f"str{n}", "s" * n) for n in (0, 31, 32, 255, 256, 65535, 65536)]
    + [("str_utf8", "é" * 20)]
    + [(f"bin{n}", b"\x07" * n) for n in (0, 255, 256, 65535, 65536)]
    + [(f"array{n}", list(range(n))) for n in (0, 15, 16, 65535, 65536)]
    + [(f"map{n}", {f"k{i}": i for i in range(n)})
       for n in (0, 15, 16, 65535, 65536)]
    + [("nested", {"step": 3, "leaves": {"a/b": {
        "d": "<f4", "s": [2, 0], "b": b""}, "z": [[1, -2], ("t", b"u")]}})]
)


@pytest.mark.parametrize("obj", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_codec_matches_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    got = codec.packb(obj)
    assert got == want
    f = io.BytesIO()
    codec.pack_to(f, obj)
    assert f.getvalue() == want
    assert codec.unpackb(want) == msgpack.unpackb(want, raw=False)


WIDE = {                      # wider forms than the smallest, and their value
    "uint64_1": b"\xcf" + (1).to_bytes(8, "big"),
    "int64_-1": b"\xd3" + (-1).to_bytes(8, "big", signed=True),
    "int16_5": b"\xd1\x00\x05",
    "str32": b"\xdb\x00\x00\x00\x02ab",
    "str16": b"\xda\x00\x01a",
    "bin32": b"\xc6\x00\x00\x00\x01z",
    "array32": b"\xdd\x00\x00\x00\x01\x05",
    "map32": b"\xdf\x00\x00\x00\x01\xa1k\x01",
    "map16_bin_key": b"\xde\x00\x01\xc4\x01k\x02",
}


@pytest.mark.parametrize("name", sorted(WIDE))
def test_codec_decodes_wide_forms(name):
    assert codec.unpackb(WIDE[name]) == msgpack.unpackb(WIDE[name],
                                                        raw=False)


@pytest.mark.parametrize("data", [b"\xc0", b"\xc2", b"\xc3",
                                  b"\xca" + b"\0" * 4, b"\xcb" + b"\0" * 8,
                                  b"\xd4\x01\x00", b"\xc7\x01\x01\x00",
                                  b"\xc1"], ids=lambda d: f"0x{d[0]:02x}")
def test_codec_refuses_other_types(data):
    with pytest.raises(ValueError, match=f"0x{data[0]:02x}"):
        codec.unpackb(data)


def test_codec_refuses_truncation_trailing_bytes_and_int_keys():
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(msgpack.packb("abcdef")[:-1])
    with pytest.raises(ValueError, match="trailing"):
        codec.unpackb(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError, match="map key"):
        codec.unpackb(b"\x81\x01\x02")
    with pytest.raises(TypeError):
        codec.packb(1.5)
    with pytest.raises(OverflowError):
        codec.packb(2**64)


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def leaf_tree():
    """Every dtype the trees carry, 0-d and (C, 0) leaves, and keys whose
    order differs between per-level sorting ("a" < "a-b") and sorting of
    the joined paths ("a-b" < "a/x")."""
    rng = np.random.default_rng(0)
    return {
        "z": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16),
        "a-b": np.asarray(2**40 + 1, np.int64),
        "a": {"y": jnp.asarray(rng.normal(size=(4,)), jnp.float32),
              "b": jnp.arange(6, dtype=jnp.int32).reshape(2, 3),
              "x": np.arange(3, dtype=np.int64) - 2**35},
        "u8": jnp.asarray(rng.integers(0, 255, size=(7,)), jnp.uint8),
        "mask": jnp.asarray([True, False, True]),
        "empty": jnp.zeros((3, 0), jnp.float32),
        "scalar": jnp.asarray(1.25, jnp.float32)}


@pytest.fixture
def files(tmp_path):
    j_tree = leaf_tree()
    t_tree = to_port(j_tree)
    paths = {"j": str(tmp_path / "j.msgpack"), "t": str(tmp_path / "t.msgpack")}
    j_ckpt.save_checkpoint(paths["j"], j_tree, step=9)
    t_ckpt.save_checkpoint(paths["t"], t_tree, step=9)
    return j_tree, t_tree, paths


def test_save_checkpoint_is_byte_identical(files):
    j_tree, t_tree, paths = files
    assert read(paths["t"]) == read(paths["j"])
    assert not os.path.exists(paths["t"] + ".tmp")
    assert t_ckpt.checkpoint_leaf_paths(paths["t"]) == \
        j_ckpt.checkpoint_leaf_paths(paths["j"])
    assert list(codec.unpackb(read(paths["t"]))["leaves"])[:3] == \
        ["a/b", "a/x", "a/y"]


def test_each_package_restores_the_others_file(files):
    j_tree, t_tree, paths = files
    got, step = t_ckpt.restore_checkpoint(paths["j"], t_tree)
    assert step == 9
    for p, x in tpt.tree_leaves_with_path(t_tree):
        y = tpt.tree_get(got, p)
        assert y.dtype == x.dtype and torch.equal(y, x), p
    back, step = j_ckpt.restore_checkpoint(paths["t"], j_tree)
    assert step == 9
    for p, x in zip(jpt.tree_paths(j_tree), jax.tree.leaves(j_tree)):
        y = jpt.tree_get(back, p)
        assert np.asarray(y).dtype == np.asarray(x).dtype, p
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                      err_msg=p)
    flat, step = t_ckpt.load_checkpoint_flat(paths["j"])
    assert flat["z"].dtype == torch.bfloat16 and torch.equal(
        flat["z"], t_tree["z"])
    assert flat["a-b"].dtype == np.int64 and flat["a-b"] == 2**40 + 1


def test_restore_places_leaves_and_to_host_is_writable(files):
    _, t_tree, paths = files
    like = dict(t_tree, a=dict(t_tree["a"], y=t_tree["a"]["y"].numpy()))
    got, _ = t_ckpt.restore_checkpoint(paths["j"], like)
    assert isinstance(got["a"]["y"], np.ndarray)           # host state
    assert torch.is_tensor(got["a"]["b"])
    host, _ = t_ckpt.restore_checkpoint(paths["j"], t_tree, to_host=True)
    for p, x in tpt.tree_leaves_with_path(host):
        if p == "z":
            assert x.dtype == torch.bfloat16                # numpy has none
            continue
        assert isinstance(x, np.ndarray) and x.flags.writeable, p
        x[...] = 0                                          # not read-only
    dev, _ = t_ckpt.restore_checkpoint(paths["j"], like, device="cpu")
    assert torch.is_tensor(dev["a"]["y"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_ckpt.restore_checkpoint("not-read", like, device="cuda")


def test_restore_checkpoint_missing_leaf_policy(tmp_path):
    path = str(tmp_path / "t.msgpack")
    t_ckpt.save_checkpoint(path, {"a": torch.ones(2)}, step=1)
    like = {"a": torch.zeros(2), "b": torch.full((3,), 7.0)}
    with pytest.raises(KeyError, match="allow_missing"):
        t_ckpt.restore_checkpoint(path, like)
    with pytest.raises(KeyError):
        t_ckpt.restore_checkpoint(path, like, allow_missing=r"^zzz$")
    for kwargs in ({"strict": False}, {"allow_missing": r"^b$"}):
        tree, _ = t_ckpt.restore_checkpoint(path, like, **kwargs)
        assert torch.equal(tree["a"], torch.ones(2))
        assert torch.equal(tree["b"], torch.full((3,), 7.0))
    with pytest.raises(AssertionError, match="'a'"):
        t_ckpt.restore_checkpoint(path, {"a": torch.zeros(3)})


def test_restore_checkpoint_keeps_int64(tmp_path):
    """int64 counters come back as int64 tensors, exactly, past 2³²."""
    path = str(tmp_path / "t.msgpack")
    j_ckpt.save_checkpoint(path, {"n": np.asarray(2**40 + 1, np.int64)})
    tree, _ = t_ckpt.restore_checkpoint(
        path, {"n": torch.tensor(0, dtype=torch.int64)})
    assert tree["n"].dtype == torch.int64 and int(tree["n"]) == 2**40 + 1


def test_shards_match_reference(tmp_path):
    tree = {"leaves": {"blocks.attn.q_proj": {"pool_dB_mag": np.arange(
        6, dtype=np.float32).reshape(2, 3)}}, "rank": np.asarray(3, np.int32)}
    for key in ("tenant-0", "ünïcode", "x" * 64):
        assert t_ckpt.shard_path("d", key) == j_ckpt.shard_path("d", key)
        j_ckpt.save_shard(str(tmp_path / "j"), key, tree)
        t_ckpt.save_shard(str(tmp_path / "t"), key, to_port(tree))
        assert read(t_ckpt.shard_path(str(tmp_path / "t"), key)) == \
            read(j_ckpt.shard_path(str(tmp_path / "j"), key))
        assert t_ckpt.has_shard(str(tmp_path / "j"), key)
        flat, _ = t_ckpt.load_shard_flat(str(tmp_path / "j"), key)
        np.testing.assert_array_equal(
            flat["leaves/blocks.attn.q_proj/pool_dB_mag"],
            tree["leaves"]["blocks.attn.q_proj"]["pool_dB_mag"])
    (tmp_path / "t" / "notes.txt").write_text("not a shard")
    (tmp_path / "t" / "zz.msgpack").write_text("not hex")
    assert t_ckpt.list_shards(str(tmp_path / "t")) == \
        j_ckpt.list_shards(str(tmp_path / "j")) == \
        sorted(("tenant-0", "ünïcode", "x" * 64))
    assert t_ckpt.list_shards(str(tmp_path / "none")) == []


# ---------------------------------------------------------------------------
# FedSim
# ---------------------------------------------------------------------------

C, B, S = 3, 2, 16
FLEETS = {"uniform": None, "ranks": (2, 4, 8)}


def batches(n, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(5, 64, size=(C, B, S)).astype(np.int32),
             "loss_mask": np.ones((C, B, S), np.float32)} for _ in range(n)]


def jax_batches(bs):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in bs]


def torch_batches(bs):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in bs]


def hyper(pkg, ranks, method="fedlora_opt"):
    return pkg(method=method, n_clients=C, local_steps=2, lr=3e-3,
               client_ranks=ranks)


@pytest.fixture(scope="module")
def ref_sims(tmp_path_factory):
    """Per fleet: the JAX sim after one round (2 steps + aggregate), its
    file, and the JAX sim's client leaves after one more round."""
    out = {}
    d = tmp_path_factory.mktemp("sims")
    for name, ranks in FLEETS.items():
        sim = JSim(J_CFG, hyper(JHyper, ranks))
        sim.local_round(jax_batches(batches(2, 0)), jax.random.PRNGKey(0))
        sim.aggregate()
        path = str(d / f"{name}.msgpack")
        sim.save(path, round_idx=1)
        state = jax.tree.map(np.asarray, sim.state_tree())
        sim.local_round(jax_batches(batches(2, 1)), jax.random.PRNGKey(1))
        sim.aggregate()
        out[name] = dict(base=sim.base, path=path, state=state,
                         after=jax.tree.map(np.asarray, sim.client_adapters),
                         comm=sim.comm_bytes)
    return out


def port_sim(ref, ranks, method="fedlora_opt", base=None):
    return TSim(T_CFG, hyper(THyper, ranks, method),
                base=base if base is not None else to_port(ref["base"]),
                device="cpu")


@pytest.mark.parametrize("fleet", sorted(FLEETS))
def test_fedsim_resumes_a_reference_checkpoint(ref_sims, fleet, tmp_path):
    ref = ref_sims[fleet]
    ts = port_sim(ref, FLEETS[fleet])
    assert ts.load(ref["path"]) == 1
    state = ts.state_tree()
    want = dict(zip(jpt.tree_paths(ref["state"]),
                    jax.tree.leaves(ref["state"])))
    got = dict(t_ckpt._sorted_leaves(state))
    assert list(got) == list(want)
    for p, w in want.items():
        x = np.asarray(got[p])
        assert x.dtype == w.dtype and x.shape == w.shape, p
        assert x.tobytes() == w.tobytes(), p
    assert ts._step == 2 and state["step"].dtype == torch.int32
    mine = str(tmp_path / "again.msgpack")
    ts.save(mine, round_idx=1)
    assert read(mine) == read(ref["path"])
    ts.local_round(torch_batches(batches(2, 1)))
    ts.aggregate()
    assert ts.comm_bytes == ref["comm"]
    after = dict(zip(jpt.tree_paths(ref["after"]),
                     jax.tree.leaves(ref["after"])))
    for p, x in tpt.tree_leaves_with_path(ts.client_adapters):
        w = after[p]
        err = np.abs(x.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-4, (p, err)


def test_fedsim_load_rejects_another_fleet(ref_sims, tmp_path):
    """The same allocation with the ranks permuted: every shape matches,
    and only the recorded rank vector catches it."""
    ref = ref_sims["ranks"]
    other = port_sim(ref, (8, 4, 2))
    with pytest.raises(ValueError, match="ranks"):
        other.load(ref["path"])
    uniform = port_sim(ref, None)
    path = str(tmp_path / "u.msgpack")
    uniform.save(path, round_idx=1)
    assert uniform.load(path) == 1
    assert uniform.state_tree()["client_ranks"].tolist() == [8] * C
    with pytest.raises(ValueError, match="ranks"):
        port_sim(ref, (8, 8, 8)).load(ref_sims["ranks"]["path"])


def test_fedsim_prox_anchor_survives_midcycle_save(ref_sims, tmp_path):
    """A fedprox checkpoint after local_round, before aggregate, restores
    the anchor (not the current adapters), and the resumed round equals
    the uninterrupted one exactly."""
    ref = ref_sims["uniform"]
    base = to_port(ref["base"])
    hp = THyper(method="fedprox", n_clients=2, local_steps=2, lr=1e-2,
                prox_mu=0.1)
    bs = [{k: v[:2] for k, v in b.items()} for b in batches(3, 4)]
    sim = TSim(T_CFG, hp, base=base, device="cpu")
    sim.local_round(torch_batches(bs[:2]))
    anchor = tpt.tree_leaves(sim._round_ref)
    assert any(not torch.equal(a, b) for a, b in
               zip(anchor, tpt.tree_leaves(sim.client_adapters)))
    path = str(tmp_path / "prox.msgpack")
    sim.save(path)
    sim2 = TSim(T_CFG, hp, base=base, device="cpu")
    sim2.load(path)
    assert all(torch.equal(a, b) for a, b in
               zip(anchor, tpt.tree_leaves(sim2._round_ref)))
    for s in (sim, sim2):
        s.local_round(torch_batches(bs[2:]))
    assert all(torch.equal(a, b) for a, b in
               zip(tpt.tree_leaves(sim.client_adapters),
                   tpt.tree_leaves(sim2.client_adapters)))
