"""The port's SSD chunked scan against the JAX package's on the CPU.

The same numpy inputs go through ``repro.kernels.ssd_scan`` (the Pallas
body in interpret mode, as tests/test_kernels.py runs it), its
``ssd_naive`` recurrence and ``repro.models.ssm._ssd_chunked``, and
through the port's ``ssd_scan`` on CPU tensors (the plain ``ssd_ref``),
``ssd_naive`` and ``repro_torch.models.ssm._ssd_chunked``.

Tolerances: the scan against the Pallas body and the recurrence at
rtol 1e-3, atol 1e-4, the bounds of tests/test_kernels.py's ssd sweep.
``_ssd_chunked`` against the JAX one: f32 at rtol = atol = 1e-5 (the
state is carried by a loop instead of an associative scan, so sums run
in another order); bf16 inputs at 1e-3 of max |y| (both round B, C, x·dt
and the decays to bf16 at the same points, and each rounds what its own
f32 sums give).  At mamba2's init magnitudes (A_log = log(linspace(1, 16,
H)), dt = softplus(z − 2), chunk 128) the scan and ``_ssd_chunked``
against the JAX scan in interpret mode, ``ssd_naive`` and ``_ssd_chunked``
at 1e-4 of max |y| (and of max |state|): the port sums the log-decay in
f64 and rounds it once, the reference sums it in f32.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.kernels import ssd_naive as j_naive
from repro.kernels import ssd_scan as j_scan
from repro.models.ssm import _ssd_chunked as j_chunked
from repro_torch.kernels import ssd_naive, ssd_ref, ssd_scan
from repro_torch.kernels.ssd_scan import ssd_scan as K
from repro_torch.models.ssm import _ssd_chunked

SWEEP = [   # tests/test_kernels.py::test_ssd_scan_sweep: b, S, H, G, P, N, Q
    (2, 64, 4, 2, 16, 8, 16),
    (1, 128, 2, 1, 32, 16, 32),
    (2, 32, 4, 4, 8, 8, 8),
    (1, 64, 2, 2, 16, 16, 64),   # single chunk
]


def _inputs(b, S, H, G, P, N, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(b, S, H, P)).astype(np.float32),
        dt=rng.uniform(0.01, 0.2, size=(b, S, H)).astype(np.float32),
        A_log=np.log(rng.uniform(0.5, 4.0, size=(H,))).astype(np.float32),
        B=rng.normal(size=(b, S, G, N)).astype(np.float32),
        C=rng.normal(size=(b, S, G, N)).astype(np.float32))


ORDER = ("x", "dt", "A_log", "B", "C")


def _mamba2_init(b, S, H, G, P, N, seed):
    """As init_params draws the mixer (src/repro/models/model.py:73-75)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, S, H))
    return dict(
        x=rng.normal(size=(b, S, H, P)).astype(np.float32),
        dt=np.logaddexp(0.0, z - 2.0).astype(np.float32),
        A_log=np.log(np.linspace(1.0, 16.0, H)).astype(np.float32),
        B=rng.normal(size=(b, S, G, N)).astype(np.float32),
        C=rng.normal(size=(b, S, G, N)).astype(np.float32))


def _t(v, dtype=torch.float32):
    return [torch.from_numpy(v[k]).to(dtype if k in ("x", "B", "C")
                                      else torch.float32) for k in ORDER]


def _j(v, dtype=jnp.float32):
    return [jnp.asarray(v[k], dtype if k in ("x", "B", "C") else jnp.float32)
            for k in ORDER]


def close(got, want, rtol=1e-3, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("b,S,H,G,P,N,Q", SWEEP)
def test_scan_matches_jax_pallas_interpret_and_naive(b, S, H, G, P, N, Q):
    v = _inputs(b, S, H, G, P, N, seed=S + H)
    y, st = ssd_scan(*_t(v), chunk=Q)
    assert y.shape == (b, S, H, P) and st.shape == (b, H, P, N)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    y_k, st_k = j_scan(*_j(v), chunk=Q, interpret=True)
    y_n, st_n = j_naive(*_j(v))
    for want_y, want_st in ((y_k, st_k), (y_n, st_n)):
        close(y.numpy(), want_y)
        close(st.numpy(), want_st)
    y_p, st_p = ssd_naive(*_t(v))
    close(y_p.numpy(), y_n)
    close(st_p.numpy(), st_n)


def test_scan_at_mamba2_init_magnitudes_matches_jax():
    # the log-decay reaches hundreds within a chunk of 128 here
    v = _mamba2_init(1, 256, 8, 1, 16, 32, seed=21)
    ports = {"ssd_scan": ssd_scan(*_t(v), chunk=128),
             "_ssd_chunked": _ssd_chunked(*_t(v), 128)}
    wants = {"pallas": j_scan(*_j(v), chunk=128, interpret=True),
             "naive": j_naive(*_j(v)), "_ssd_chunked": j_chunked(*_j(v), 128)}
    for pn, (y, st) in ports.items():
        for wn, (y_w, st_w) in wants.items():
            for what, got, want in (("y", y, y_w), ("state", st, st_w)):
                want = np.asarray(want)
                rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
                print(f"{what}: port {pn} vs JAX {wn}: {rel:.3e} of max |ref|")
                assert rel <= 1e-4


@pytest.mark.parametrize("b,S,H,G,P,N,Q", [SWEEP[0], SWEEP[1]])
def test_chunked_matches_jax_f32(b, S, H, G, P, N, Q):
    v = _inputs(b, S, H, G, P, N, seed=1)
    y, st = _ssd_chunked(*_t(v), Q)
    y_j, st_j = j_chunked(*_j(v), Q)
    close(y.numpy(), y_j, rtol=1e-5, atol=1e-5)
    close(st.numpy(), st_j, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,S,H,G,P,N,Q", [SWEEP[0], (1, 256, 4, 1, 64, 128, 128)])
def test_chunked_matches_jax_bf16(b, S, H, G, P, N, Q):
    v = _inputs(b, S, H, G, P, N, seed=2)
    y, st = _ssd_chunked(*_t(v, torch.bfloat16), Q)
    y_j, st_j = j_chunked(*_j(v, jnp.bfloat16), Q)
    y_j = np.asarray(y_j.astype(jnp.float32))
    scale = np.abs(y_j).max()
    assert y.dtype == torch.float32                # as the reference returns it
    assert np.abs(y.numpy() - y_j).max() <= 1e-3 * scale
    st_j = np.asarray(st_j)
    assert np.abs(st.numpy() - st_j).max() <= 1e-3 * np.abs(st_j).max()


def test_dispatcher_rounds_y_to_x_dtype_and_keeps_the_state_f32():
    v = _inputs(1, 32, 2, 1, 8, 4, seed=3)
    y, st = ssd_scan(*_t(v, torch.bfloat16), chunk=16)
    y_r, st_r = ssd_ref(*_t(v, torch.bfloat16), 16)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert torch.equal(y, y_r.to(torch.bfloat16)) and torch.equal(st, st_r)


def test_dispatcher_chunk_is_capped_at_S_and_must_divide_it():
    v = _inputs(1, 48, 2, 1, 8, 4, seed=4)
    y, st = ssd_scan(*_t(v), chunk=256)                 # one chunk of 48
    y_n, st_n = ssd_naive(*_t(v))
    close(y.numpy(), y_n.numpy())
    close(st.numpy(), st_n.numpy())
    for impl in (None, "cuda"):
        with pytest.raises(ValueError, match="not a multiple of the chunk"):
            ssd_scan(*_t(v), chunk=32, impl=impl)
    bad = _inputs(1, 16, 3, 2, 8, 4, seed=5)
    with pytest.raises(ValueError, match="do not split"):
        ssd_scan(*_t(bad), chunk=16)


def test_dispatcher_flattens_heads_and_transposes_the_state(monkeypatch):
    # the CUDA route's layout code, with the plain version in the kernel's
    # (b·H, S, P) layout standing in for the kernel
    from repro_torch.kernels.ssd_scan import ops
    b, S, H, G, P, N = 2, 32, 4, 2, 8, 4
    calls = []

    def fake(x, dt, a_log, B, C, *, chunk):
        calls.append((x.shape, dt.shape, a_log.shape, B.shape, chunk))
        assert all(t.is_contiguous() for t in (x, dt, a_log, B, C))
        return _per_head(x, dt, a_log, B, C, chunk)
    monkeypatch.setattr(ops, "ssd_scan_bh_cuda", fake)
    v = _inputs(b, S, H, G, P, N, seed=6)
    y, st = ssd_scan(*_t(v), chunk=16, impl="cuda")
    assert calls == [((b * H, S, P), (b * H, S), (b * H,), (b * G, S, N), 16)]
    y_n, st_n = ssd_naive(*_t(v))
    close(y.numpy(), y_n.numpy())
    close(st.numpy(), st_n.numpy())


def _per_head(x, dt, a_log, B, C, chunk):
    """The plain scan, one flattened head at a time: (BH,S,P) → y, and the
    state in the kernel's (BH, N, P) layout."""
    rep = x.shape[0] // B.shape[0]
    ys, sts = [], []
    for h in range(x.shape[0]):
        g = h // rep
        y, st = ssd_ref(x[h][None, :, None], dt[h][None, :, None],
                        a_log[h:h + 1], B[g][None, :, None],
                        C[g][None, :, None], chunk)
        ys.append(y[0, :, 0])
        sts.append(st[0, 0].T)                         # (P,N) → (N,P)
    return torch.stack(ys), torch.stack(sts)


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    v = _inputs(1, 16, 2, 1, 8, 4, seed=7)
    K.reset_launches()
    ssd_scan(*_t(v), chunk=8)
    x, dt, a, B, C = _t(v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.ssd_scan_bh_cuda(x[0].transpose(0, 1).contiguous(), dt[0].T.contiguous(),
                           a, B[0].transpose(0, 1).contiguous(),
                           C[0].transpose(0, 1).contiguous(), chunk=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_scan(*_t(v), chunk=8, impl="cuda")
    with pytest.raises(ValueError, match="unknown ssd_scan impl"):
        ssd_scan(*_t(v), chunk=8, impl="pallas")
    assert K.LAUNCHES == {"ssd_scan": 0}


# --- ref.bf16_bound: the elementwise bound every bf16 kernel output is
# held to (chip_smoke.py phases 2 and 6, tests/test_torch_ssd_scan_gpu.py).
# Inputs at mamba2's init magnitudes, bf16, chunk 128 (the kernel's column
# tiles are 32 wide, its row tiles 128); the largest |y − ref| / bound over
# all elements, measured on the CPU at these cases and seeds: plain bf16
# ssd_ref and ssd_cast_points 0.19–0.38, the Pallas body 0.12–0.15; the
# carried state term left out 12.7–41×, the column tile 32–63 left out
# 20.7–43.6×, chunk 1's end state left out 9.7–41×.

from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    bf16_bound, cast_point_interval, ssd_cast_points)

BOUND_CASES = {   # b, S, H, G, P, N, chunk
    "mamba2": (1, 512, 8, 1, 64, 128, 128),
    "groups": (1, 512, 8, 2, 16, 32, 128),     # rep 4
    "ragged": (2, 512, 4, 4, 24, 20, 128),     # P 24, N 20, rep 1
}


def _bf16_case(case, seed):
    b, S, H, G, P, N, Q = BOUND_CASES[case]
    return _t(_mamba2_init(b, S, H, G, P, N, seed), torch.bfloat16), Q


def _ratio(y, ref_bound):
    ref, bound = ref_bound
    return ((y.double() - ref.double()).abs()
            / bound.double().clamp_min(1e-300)).max().item()


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_bf16_bound_holds_the_plain_and_cast_point_versions(case):
    """The plain bf16 ssd_ref (the reference's cast points) and
    ssd_cast_points (the kernel's) lie within the bound, as ssd_ref on f32
    values lies within it trivially."""
    t, Q = _bf16_case(case, seed=11)
    rb = bf16_bound(*t, Q)
    assert rb[0].shape == t[0].shape and rb[1].shape == t[0].shape
    y = ssd_cast_points(*t, Q)[0]
    assert y.dtype == torch.bfloat16
    plain = ssd_ref(*t, Q)[0].to(torch.bfloat16)
    assert not torch.equal(y, plain)            # they round at other points
    assert _ratio(y, rb) <= 1.0
    assert _ratio(plain, rb) <= 1.0


@pytest.mark.parametrize("case", ["groups", "ragged"])
def test_bf16_bound_holds_the_pallas_body(case):
    """The Pallas kernel body (interpret mode) on the same bf16 values:
    f32 products of the upcasts, one rounding of y."""
    b, S, H, G, P, N, Q = BOUND_CASES[case]
    v = _mamba2_init(b, 256, H, G, P, N, seed=5)
    y = j_scan(*_j(v, jnp.bfloat16), chunk=Q, interpret=True)[0]
    y = torch.from_numpy(np.array(y.astype(jnp.float32)))
    assert _ratio(y, bf16_bound(*_t(v, torch.bfloat16), Q)) <= 1.0


@pytest.mark.parametrize("omit", ["state", "column_tile", "chunk_state"])
@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_bf16_bound_sees_a_left_out_piece(case, omit):
    """A kernel that left out the carried state term, one column tile of
    the triangle or one chunk's end state reads many times the bound."""
    t, Q = _bf16_case(case, seed=13)
    rb = bf16_bound(*t, Q)
    assert _ratio(ssd_cast_points(*t, Q, omit=omit)[0], rb) > 8.0


# --- ref.cast_point_interval: the kernel's bf16 y against its own cast
# points, where only the order of f32 sums and exps may differ.  Measured
# on the CPU at the cases above, seeds 11, 13, 19: ssd_cast_points in f32
# lies inside at every output; with the low half of the state split left
# out (the carried state rounded once to bf16) 121–313 outputs lie
# outside, while that version reads only 0.19–0.44 of bf16_bound.

@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_cast_point_interval_holds_the_cast_point_version(case):
    """ssd_cast_points with f32 sums in torch's order rounds every output
    into the interval taken around the same cast points with exact sums;
    the interval is one value wide at most outputs."""
    t, Q = _bf16_case(case, seed=11)
    lo, hi = cast_point_interval(*t, Q)
    assert lo.dtype == hi.dtype == torch.bfloat16
    assert lo.shape == hi.shape == t[0].shape and bool((lo <= hi).all())
    y = ssd_cast_points(*t, Q)[0]
    assert bool(((y >= lo) & (y <= hi)).all())
    assert (lo != hi).float().mean().item() < 0.5


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_cast_point_interval_sees_the_state_rounded_once(case):
    """A kernel that carried the entering state as one bf16 value (the
    split's low half left out) rounds many outputs outside the interval."""
    t, Q = _bf16_case(case, seed=13)
    lo, hi = cast_point_interval(*t, Q)
    y = ssd_cast_points(*t, Q, omit="lo")[0]
    assert ((y < lo) | (y > hi)).sum().item() >= 100


def test_cast_points_in_f32_are_the_scan():
    """With f32 inputs every rounding of ssd_cast_points is the identity,
    so it computes the scan: within 1e-5 of ssd_ref's max |y|."""
    v = _mamba2_init(1, 512, 4, 2, 16, 32, seed=17)
    y, st = ssd_cast_points(*_t(v), 128)
    y_r, st_r = ssd_ref(*_t(v), 128)
    assert (y - y_r).abs().max() <= 1e-5 * y_r.abs().max()
    assert (st - st_r).abs().max() <= 1e-5 * st_r.abs().max()
