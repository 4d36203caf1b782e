"""Device resolution for the port's entry points.

Entry points default to ``"cuda"`` and raise when no card is present:
the CPU is used only when the caller asks for it (the tests pass
``device="cpu"``), never as a silent fallback.  ``"meta"`` is the dry
run's device (``launch/dryrun.py``): tensors with shapes and dtypes and
no storage, on which a step runs to be accounted, never to compute.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(
            f"unsupported device {device!r} (cuda, cpu or meta)")
    return dev


def check_on(tensor: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise unless ``tensor`` lives on ``device`` (index-insensitive for
    the default card)."""
    if tensor.device.type != device.type or (
            device.index is not None and tensor.device.index != device.index):
        raise ValueError(f"{what} is on {tensor.device}, expected {device}")
