"""Learning-rate schedules: functions of an int step returning a 0-d f32
tensor (port of ``repro/optim/schedules.py``)."""
from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def constant_schedule(lr: float):
    def fn(step):
        return _f32(lr)

    return fn


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup: int, total_steps: int,
                         final_frac: float = 0.0):
    def fn(step):
        step = _f32(step)
        warm = lr * torch.clamp(step / max(warmup, 1), max=1.0)
        t = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                        0.0, 1.0)
        cos = lr * (final_frac + (1.0 - final_frac) * 0.5
                    * (1.0 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return fn
