"""Abstract parameter, adapter and cache trees (port of the first half of
``repro/launch/specs.py``).

Each is a tree of ``device="meta"`` tensors with the shapes, dtypes and
leaf paths of the real tree, built by the same code that builds the real
one (``init_params``, ``peft.add_lora``, ``init_cache`` on the meta
device), so the shapes have one source.  They allocate nothing: a
full-size model's tree is free to build and to count
(``utils.pytree.tree_bytes``, ``launch.analysis.param_counts``).

The sharding specs and batch specs of the reference's dry run have no
counterpart yet: there is one card (ROADMAP A13).
"""
from __future__ import annotations

from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt


def abstract_params(cfg: ArchConfig):
    """The backbone tree ``init_params`` draws, on the meta device."""
    return M.init_params(None, cfg, device="meta")


def abstract_adapters(cfg: ArchConfig, n_clients: int = 0):
    """The decomposed adapter overlay (``add_lora(decomposed=True)``) on
    the meta device, with a leading client axis of ``n_clients`` when
    given."""
    ad = peft.add_lora(abstract_params(cfg), cfg, None, decomposed=True)
    if n_clients:
        ad = pt.tree_map(lambda x: x[None].expand(n_clients, *x.shape), ad)
    return ad


def abstract_cache(cfg: ArchConfig, batch: int, seq_len: int):
    """The decode cache ``init_cache`` allocates, on the meta device."""
    return M.init_cache(cfg, batch, seq_len, device="meta")
