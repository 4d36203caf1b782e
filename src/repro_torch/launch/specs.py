"""Abstract parameter, adapter and cache trees and the step inputs of
every (architecture × input shape) pair (port of
``repro/launch/specs.py``).

Each is a tree of ``device="meta"`` tensors with the shapes, dtypes and
leaf paths of the real tree, built by the same code that builds the real
one (``init_params``, ``peft.add_lora``, ``init_cache`` on the meta
device), so the shapes have one source.  They allocate nothing: a
full-size model's tree is free to build and to count
(``utils.pytree.tree_bytes``, ``launch.analysis.param_counts``), and the
dry run (``launch/dryrun.py``) runs a step on them.

The batch specs (``train_batch_specs``, ``serve_batch_specs``,
``decode_specs``) have the reference's shapes and dtypes and no
shardings: there is one card, and the reference's sharding rules
(``param_specs``, ``adapter_specs``, ``cache_specs``) have no
counterpart.  ``cache_index`` is a Python int, as ``decode_step`` takes
it.
"""
from __future__ import annotations

import torch

from repro_torch.configs import InputShape
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


def _dt(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_rows(cfg: ArchConfig, S: int) -> int:
    """The rows of ``frontend_emb`` in a batch of S positions: a
    decoder-only model's patches min(frontend_tokens, S // 2), an
    encoder-decoder's S // 2 frames; 0 without a frontend."""
    if cfg.n_enc_layers:
        return S // 2
    if cfg.frontend:
        return min(cfg.frontend_tokens, S // 2)
    return 0


def train_batch_specs(cfg: ArchConfig, shape: InputShape, n_clients: int):
    """The stacked federated batch: tokens and loss_mask (C, B_c, S_tok)
    and, with a frontend, frontend_emb (C, B_c, F, D), where S_tok + F =
    S (an encoder-decoder's S // 2 frames and S // 2 tokens)."""
    B_c, S = shape.global_batch // n_clients, shape.seq_len
    F = _frontend_rows(cfg, S)
    S_tok = S // 2 if cfg.n_enc_layers else S - F
    batch = {"tokens": _meta((n_clients, B_c, S_tok), torch.int32),
             "loss_mask": _meta((n_clients, B_c, S_tok), torch.float32)}
    if F:
        batch["frontend_emb"] = _meta((n_clients, B_c, F, cfg.d_model),
                                      _dt(cfg))
    return batch


def serve_batch_specs(cfg: ArchConfig, shape: InputShape):
    """Prefill inputs: tokens (B, S_tok) and, with a frontend,
    frontend_emb (B, F, D), split as ``train_batch_specs`` splits S."""
    B, S = shape.global_batch, shape.seq_len
    F = _frontend_rows(cfg, S)
    S_tok = S // 2 if cfg.n_enc_layers else S - F
    batch = {"tokens": _meta((B, S_tok), torch.int32)}
    if F:
        batch["frontend_emb"] = _meta((B, F, cfg.d_model), _dt(cfg))
    return batch


def decode_specs(cfg: ArchConfig, shape: InputShape):
    """One-token decode: new_token (B,), the cache of S positions (an
    encoder-decoder's decoder: S // 2), cache_index and, for an
    encoder-decoder, enc_out (B, S // 2, D).  The cache is full and the
    token is its last position: cache_index = S_cache - 1."""
    B, S = shape.global_batch, shape.seq_len
    S_cache = S // 2 if cfg.n_enc_layers else S
    args = {"new_token": _meta((B,), torch.int32),
            "cache": abstract_cache(cfg, B, S_cache),
            "cache_index": S_cache - 1}
    if cfg.n_enc_layers:
        args["enc_out"] = _meta((B, S // 2, cfg.d_model), _dt(cfg))
    return args
