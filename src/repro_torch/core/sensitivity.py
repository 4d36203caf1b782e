"""Fig. 1's sensitivity analysis (paper Eqs. 2-3); port of
``repro/core/sensitivity.py``.

Given adapters fine-tuned per downstream task and adapters fine-tuned on
the all-task mixture, measure for each LoRA factor:

  ΔM (Eq. 2):  mean over columns of |m_task − m_all|        (magnitude)
  ΔD (Eq. 3):  mean over columns of 1 − cos(dir_task, dir_all) (direction)

averaged over layers and targets.  The paper's observations:
  Obs. 1  ΔD(A) ≈ 1.7 × ΔD(B)
  Obs. 2  ΔM(B) ≈ 41 × ΔM(A)

The adapters may live on any device; the arithmetic runs in numpy on
f32 copies, as the reference's does.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import dora
from repro_torch.utils import pytree as pt


def _np(x) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _collect_factors(adapters: Any) -> dict[str, list]:
    """The raw or recomposed LoRA factors of every target:
    {'A': [...], 'B': [...]} as f32 numpy arrays."""
    by_prefix: dict[str, dict[str, torch.Tensor]] = {}
    for path, x in pt.tree_leaves_with_path(adapters):
        prefix, name = path.rsplit("/", 1)
        by_prefix.setdefault(prefix, {})[name] = x
    factors: dict[str, list] = {"A": [], "B": []}
    for d in by_prefix.values():
        if "lora_A" in d:
            A, B = d["lora_A"], d["lora_B"]
        elif "A_dir" in d:
            A, B = dora.recompose_lora_pair(d)
        else:
            continue
        factors["A"].append(_np(A))
        factors["B"].append(_np(B))
    return factors


def _delta_m(x_task: np.ndarray, x_all: np.ndarray) -> float:
    m_t = np.linalg.norm(x_task, axis=-1)
    m_a = np.linalg.norm(x_all, axis=-1)
    return float(np.mean(np.abs(m_t - m_a)))            # Eq. 2


def _delta_d(x_task: np.ndarray, x_all: np.ndarray) -> float:
    eps = 1e-12
    n_t = np.linalg.norm(x_task, axis=-1, keepdims=True)
    n_a = np.linalg.norm(x_all, axis=-1, keepdims=True)
    cos = np.sum((x_task / (n_t + eps)) * (x_all / (n_a + eps)), axis=-1)
    # zero-magnitude columns (B_mag = 0 at the decomposed init) have no
    # direction: they are left out rather than counted as 1 − cos(0, 0)
    valid = (n_t[..., 0] > 1e-9) & (n_a[..., 0] > 1e-9)
    if not np.any(valid):
        return 0.0
    return float(np.mean((1.0 - cos)[valid]))           # Eq. 3


def sensitivity_report(task_adapters: dict[str, Any],
                       all_adapters: Any) -> dict:
    """task_adapters: {task name: adapter tree}; all_adapters: the
    all-task fine-tune.  Returns the per-task and mean ΔM / ΔD of A and
    B and the two observation ratios."""
    ref = _collect_factors(all_adapters)
    rows = {}
    for task, ad in task_adapters.items():
        fac = _collect_factors(ad)
        rows[task] = {
            f"{name}_{f}": float(np.mean([fn(t, a) for t, a in
                                          zip(fac[f], ref[f])]))
            for name, fn in (("dM", _delta_m), ("dD", _delta_d))
            for f in ("A", "B")}
    mean = {k: float(np.mean([r[k] for r in rows.values()]))
            for k in ("dM_A", "dM_B", "dD_A", "dD_B")}
    eps = 1e-12
    return {
        "per_task": rows,
        "mean": mean,
        "obs1_dir_ratio_A_over_B": mean["dD_A"] / (mean["dD_B"] + eps),
        "obs2_mag_ratio_B_over_A": mean["dM_B"] / (mean["dM_A"] + eps),
    }
