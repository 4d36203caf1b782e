"""The Mamba-2 mixer on the card: the scan's kernel branch (``ssd_scan``'s
CUDA kernel, ``models/ssm._ssd`` without a gradient) against its plain
branch (``_ssd_chunked``) at mamba2-2.7b's and jamba-v0.1's SSM widths,
and the decode step's cache written in place.

Imports no JAX.  The ``gpu`` tests need a card and skip without one
(decided inside the fixture); on the GPU run them with ``python -m
pytest -q -m gpu tests/test_torch_ssm_gpu.py``.

Tolerances:
- bf16, mixer-shaped inputs of 1 x 1000 tokens (padded to 1024, chunk
  128): the kernel's y on the padded inputs it was given elementwise
  within ``ssd_scan/ref.py::bf16_bound`` of the f32 scan of the same
  bf16 values and inside ``cast_point_interval``; then each branch's
  y + D_skip·x rounded to bf16, as the mixer rounds it, within
  ``bf16_bound`` plus one bf16 ulp of |ref + D_skip·x| (the kernel's y
  is rounded to bf16 before D_skip·x is added, the plain branch's is
  not: one rounding more); the final states within 2e-2 of max (each
  branch's own cast points; ``chip_smoke.py`` phase 6's bf16 tolerance);
- f32: one mixer at full width, 1 x 1000 tokens, kernel against plain
  branch, the output and the prefill cache within 1e-5 of max |value|
  (TF32 off);
- decode: mamba2 at 2 layers of full width in f32, a prefill of 999
  tokens and one decode step: the logits within 1e-4 of the full
  forward's last row, every cache leaf written in place.
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ssd_scan as ssd_mod
from repro_torch.kernels.ssd_scan.ref import bf16_bound, cast_point_interval
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.utils import pytree as tpt

ARCHS = ("mamba2-2.7b", "jamba-v0.1-52b")
S = 1000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ssd_scan kernel branch of the "
                    "Mamba-2 mixer runs only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _bf16_ulp(v):
    """One bf16 ulp of |v| (8 significant bits)."""
    _, e = torch.frexp(v.float().abs())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _scan_inputs(cfg, cuda, dtype, seed=0):
    """What the mixer hands ``_ssd``: x (1, S, H, P), dt = softplus(·) in
    f32, A_log = log(linspace(1, 16, H)), B, C (1, S, G, N)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    H = cfg.d_model * cfg.ssm_expand // cfg.ssm_headdim

    def n(*shape):
        return torch.randn(shape, generator=g, device=cuda)
    x = n(1, S, H, cfg.ssm_headdim).to(dtype)
    dt = F.softplus(n(1, S, H) - 2.0)
    A_log = torch.log(torch.linspace(1.0, 16.0, H, device=cuda))
    B = n(1, S, cfg.ssm_groups, cfg.ssm_state).to(dtype)
    C = n(1, S, cfg.ssm_groups, cfg.ssm_state).to(dtype)
    return x, dt, A_log, B, C


@pytest.fixture
def spy(monkeypatch):
    """Each ``ops.ssd_scan`` call's inputs and outputs."""
    seen = []
    real = ssd_ops.ssd_scan

    def scan(*args, **kw):
        out = real(*args, **kw)
        seen.append((args, kw, out))
        return out
    monkeypatch.setattr(ssd_ops, "ssd_scan", scan)
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_branch_bf16_within_bound(cuda, spy, arch):
    cfg = get_config(arch)
    x, dt, A_log, B, C = _scan_inputs(cfg, cuda, torch.bfloat16)
    ssd_mod.reset_launches()
    with torch.no_grad():
        yk, sk = TS._ssd(x, dt, A_log, B, C, cfg.ssm_chunk)
        yp, sp = TS._ssd(x, dt, A_log, B, C, cfg.ssm_chunk,
                         kernel_impl="torch")
    assert ssd_mod.LAUNCHES["ssd_scan"] == 1 and len(spy) == 1
    (xa, dta, al, Ba, Ca), kw, (y_pad, _) = spy[0]
    Q = kw["chunk"]
    assert kw["impl"] == "cuda" and Q == cfg.ssm_chunk
    assert xa.shape[1] == -(-S // Q) * Q
    assert yk.dtype == torch.bfloat16 and yp.dtype == torch.float32
    ref, bound = bf16_bound(xa, dta, al, Ba, Ca, Q)
    assert ((y_pad.float() - ref).abs() <= bound).all()
    lo, hi = cast_point_interval(xa, dta, al, Ba, Ca, Q)
    assert ((y_pad >= lo) & (y_pad <= hi)).all()
    assert torch.equal(yk, y_pad[:, :S])
    assert _rel(sk, sp) <= 2e-2
    D = torch.ones(x.shape[2], device=cuda)
    want = ref[:, :S] + D[:, None] * x.float()
    slack = bound[:, :S] + _bf16_ulp(want)
    for y in (yk, yp):
        got = (y.float() + D[:, None] * x.float()).to(torch.bfloat16)
        assert ((got.float() - want).abs() <= slack).all()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_branch_f32_one_mixer(cuda, arch):
    cfg = dataclasses.replace(get_config(arch), n_layers=1, dtype="float32",
                              attn_every=0, family="ssm", n_experts=0)
    params = TM.init_params(torch.Generator(device=cuda).manual_seed(1), cfg,
                            device=cuda)
    p = tpt.tree_map(lambda t: t[0], params["blocks"]["sub0"]["ssm"])
    x = torch.randn((1, S, cfg.d_model), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    ssd_mod.reset_launches()
    with torch.no_grad():
        yk, ck = TS.mamba2_mixer(p, x, cfg, return_cache=True)
        yp, cp = TS.mamba2_mixer(p, x, cfg, return_cache=True,
                                 kernel_impl="torch")
    assert ssd_mod.LAUNCHES["ssd_scan"] == 1
    assert _rel(yk, yp) <= 1e-5
    for k in cp:
        assert _rel(ck[k], cp[k]) <= 1e-5, k


@pytest.mark.gpu
def test_decode_writes_the_cache_in_place(cuda):
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=2,
                              dtype="float32")
    params = TM.init_params(torch.Generator(device=cuda).manual_seed(3), cfg,
                            device=cuda)
    tok = torch.randint(0, cfg.vocab_size, (1, S), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(4))
    with torch.no_grad():
        _, cache = TM.prefill(params, {"tokens": tok[:, :-1]}, cfg)
        ptrs = {p: x.data_ptr() for p, x in tpt.tree_leaves_with_path(cache)}
        before = {p: x.clone() for p, x in tpt.tree_leaves_with_path(cache)}
        ssd_mod.reset_launches()
        logits, cache2 = TM.decode_step(params, tok[:, -1], cache, S - 1,
                                        cfg)
        assert ssd_mod.LAUNCHES["ssd_scan"] == 0
        h, _, _ = TM.forward(params, {"tokens": tok}, cfg)
    full = (h[:, -1] @ TM._head_kernel(params, cfg)).float()
    assert _rel(logits, full) <= 1e-4
    for p, x in tpt.tree_leaves_with_path(cache2):
        assert x.data_ptr() == ptrs[p], p
        assert not torch.equal(x, before[p]), p
