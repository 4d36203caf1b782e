"""Architecture registry of the port, and the input shapes.

Each ported architecture is one module exposing ARCH (exact published
hyperparameters, source cited) and SMOKE (the reduced same-family
variant used by CPU tests).  ``get_config("<id>")`` resolves either
spelling (hyphens or underscores).  These are the reference's 11
architectures.  ``SHAPES`` are the reference's four input shapes, and
``shape_supported`` says which (architecture, shape) pairs it runs.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ArchConfig

ARCH_IDS = ["deepseek-7b", "gemma3-1b", "granite-34b", "jamba-v0.1-52b",
            "llama2-7b", "mamba2-2.7b", "mixtral-8x22b", "qwen2-vl-2b",
            "qwen3-32b", "qwen3-moe-30b-a3b", "seamless-m4t-large-v2"]


def _modname(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def _module(arch_id: str):
    known = {_modname(a): a for a in ARCH_IDS}
    if _modname(arch_id) not in known:
        raise KeyError(f"unknown architecture {arch_id!r}")
    return importlib.import_module(f"repro_torch.configs.{_modname(arch_id)}")


def get_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).ARCH


def get_smoke_config(arch_id: str) -> ArchConfig:
    return _module(arch_id).SMOKE


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# long_500k needs bounded attention state: SSM / hybrid always; dense
# only with a sliding-window or local/global variant.
LONG_CONTEXT_ARCHS = {"jamba-v0.1-52b", "mamba2-2.7b", "gemma3-1b",
                      "mixtral-8x22b"}


def shape_supported(arch_id: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_CONTEXT_ARCHS
    return True
