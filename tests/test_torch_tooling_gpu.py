"""Backbone pretraining on the card against itself on the CPU.

Imports no JAX.  The ``gpu`` tests need a card and skip without one
(pretraining runs through torch autograd, so the CPU holds the card's
arithmetic).  Config: llama2-7b SMOKE in f32; TF32 off; both devices
start from one CPU-drawn backbone (the port module's ``init_params``
monkeypatched to return it).  Tolerances: one full-parameter step's
loss within 1e-5 relative and every leaf's gradient within 1e-4 of the
leaf's max |g|; after 3 ``pretrain_base`` steps every element within
1e-4 of its leaf's max |value| but where f32 cannot resolve it (AdamW's
eps regime, ``tests/test_torch_tooling.py``): each element beyond is
more than 1e-5 of the leaf's max off the CPU's f64 run in one of the two
f32 runs, at most 0.1% of the leaf, and within 2 · lr · steps of the
CPU's (an AdamW step moves an element by about lr at most, in each run;
measured on an H100: one embedding element 1.23e-2 of the leaf's max
off, 1.1e-3 absolute, against 1.8e-2).  The disk cache on the
card: a trained base written and restored bit for bit, on the card and
on the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import (SyntheticInstructionDataset, make_dataset_family,
                              to_device)
from repro_torch.fed import pretrain as pre
from repro_torch.fed.simulate import value_and_grad
from repro_torch.models import model as M
from repro_torch.utils import pytree as pt

CFG = dataclasses.replace(get_smoke_config("llama2-7b"), dtype="float32")
STEPS, LR = 3, 3e-3      # pretrain_base's steps and learning rate here


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this holds backbone pretraining on "
                    "the GPU against the CPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def mix():
    fam = make_dataset_family("dolly", vocab_size=CFG.vocab_size)
    return SyntheticInstructionDataset(fam, [1 / 3, 1 / 3, 1 / 3, 0],
                                       client_seed=0)


def base():
    return M.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")


@pytest.mark.gpu
def test_full_parameter_gradient_on_card_matches_cpu(cuda):
    p = base()
    batch = mix().sample_batch(np.random.default_rng(0), 4, 48)
    out = {}
    for dev in ("cpu", cuda):
        b = to_device(batch, dev)
        out[str(dev)] = value_and_grad(
            lambda q: M.loss_and_metrics(q, b, CFG),
            pt.tree_map(lambda t: t.to(dev), p))
    (l_cpu, _, g_cpu), (l_gpu, _, g_gpu) = out["cpu"], out["cuda"]
    assert abs(float(l_gpu) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu))
    for path, want in pt.tree_leaves_with_path(g_cpu):
        scale = float(want.abs().max())
        assert scale > 0, path
        got = pt.tree_get(g_gpu, path).cpu()
        assert float((got - want).abs().max()) <= 1e-4 * scale, path


@pytest.mark.gpu
def test_pretrain_base_on_card_matches_cpu(cuda, monkeypatch):
    p0 = base()
    runs = {}
    for name, dev, dtype in (("cpu", "cpu", None), ("cuda", cuda, None),
                             ("f64", "cpu", torch.float64)):
        monkeypatch.setattr(pre, "init_params", lambda g, cfg, device:
                            pt.tree_map(lambda t: t.to(device, dtype), p0))
        log = []
        out = pre.pretrain_base(CFG, mix(), steps=STEPS, lr=LR, seed=0,
                                log=log.append, device=dev)
        runs[name] = ({k: v.cpu().double().numpy()
                       for k, v in pt.tree_leaves_with_path(out)}, log)
    assert runs["cuda"][1][0].startswith("pretrain step 0: ce=")
    cpu, gpu, f64 = runs["cpu"][0], runs["cuda"][0], runs["f64"][0]
    for path, want in cpu.items():
        scale = np.abs(want).max()
        err = np.abs(gpu[path] - want) / scale
        out = err > 1e-4
        assert out.sum() <= 1e-3 * err.size, (path, int(out.sum()))
        assert np.abs(gpu[path] - want).max() <= 2 * LR * STEPS, path
        off64 = np.maximum(np.abs(gpu[path] - f64[path]),
                           np.abs(want - f64[path]))[out] / scale
        assert (off64 > 1e-5).all(), (path, err[out], off64)


@pytest.mark.gpu
def test_pretrained_base_cache_round_trip_on_card(cuda, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("REPRO_CACHE", str(tmp_path))
    calls = []
    inner = pre.pretrain_base

    def counted(*a, **k):
        calls.append(1)
        return inner(*a, **k)
    monkeypatch.setattr(pre, "pretrain_base", counted)
    first = pre.get_pretrained_base(CFG, mix(), steps=2, seed=3, device=cuda)
    assert len(calls) == 1
    assert (tmp_path / pre.cache_path(CFG, 2, 3, "dolly").split("/")[-1]
            ).is_file()
    for dev in (cuda, "cpu"):
        got = pre.get_pretrained_base(CFG, mix(), steps=2, seed=3, device=dev)
        assert len(calls) == 1
        assert pt.tree_paths(got) == pt.tree_paths(first)
        for path, x in pt.tree_leaves_with_path(got):
            want = pt.tree_get(first, path).cpu()
            assert x.device.type == torch.device(dev).type
            assert x.dtype == want.dtype and torch.equal(x.cpu(), want), path
