"""Abstract parameter, adapter and cache trees, the step inputs of
every (architecture × input shape) pair, and the grid's sharding specs
(port of ``repro/launch/specs.py``).

Each tree is a tree of ``device="meta"`` tensors with the shapes, dtypes
and leaf paths of the real tree, built by the same code that builds the
real one (``init_params``, ``peft.add_lora``, ``init_cache`` on the meta
device), so the shapes have one source.  They allocate nothing: a
full-size model's tree is free to build and to count
(``utils.pytree.tree_bytes``, ``launch.analysis.param_counts``), and the
dry run (``launch/dryrun.py``) runs a step on them.

The batch specs (``train_batch_specs``, ``serve_batch_specs``,
``decode_specs``) have the reference's shapes and dtypes and no
shardings (one card's step).  ``cache_index`` is a Python int, as
``decode_step`` takes it.

The sharding specs are spec tuples (``utils/sharding.py``) over a grid
(``launch/mesh.Grid`` or ``AbstractGrid``): ``param_specs`` (the
reference's rule table), ``adapter_specs`` (a leading client axis over
the data axes, else replicated) and ``cache_specs`` (the rows over the
data axes, kv heads and SSM heads over 'model').  ``shard_tree`` cuts a
whole tree to one rank's shard by them.  Where the port lays a tensor
out otherwise than the reference's rules, it says so (ROADMAP C):

  * k_proj / v_proj and the cache's kv heads stay whole on every rank
    when the kv heads do not divide over 'model' (granite-34b's MQA,
    gemma3-1b): the reference's rules split k_proj's columns (one head's
    dh) and the cache's dh, and XLA gathers them;
  * the Mamba-2 mixer is split by heads: z_proj, x_proj and dt_proj by
    columns and conv_x by channels over 'model' (a rank's H / n_model
    contiguous heads), B_proj / C_proj / conv_B / conv_C by groups where
    the groups divide over 'model', else whole on every rank (both
    configs have one group).  The reference's rules replicate the five
    projections and the convs (its ``ssm/in_proj`` matches no leaf) and
    split A_log, D_skip, dt_bias, norm_w and out_proj's rows, and XLA
    moves the data; the port computes a rank's heads from its column
    shard, so heads that do not divide over 'model' raise;
  * a served batch that does not divide over the data axes is the same
    rows on every data rank (the small-batch path), so its cache is not
    split: the reference splits its sequence over the data axes.

``cache_specs(seq_shard_kv=True)`` is the reference's variant, leaf by
leaf: a k / v cache whose rows divide over the data axes, whose kv heads
do not divide over 'model' and whose slots do is split on its sequence
over 'model' (``models/layers.seq_split``; a grid's ``seq_shard_kv``
mode runs it); where the kv heads divide it changes nothing, and a cache
whose rows do not divide stays as above.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs import InputShape
from repro_torch.core import peft
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt
from repro_torch.utils.sharding import (DEFAULT_PARAM_RULES, data_axis_names,
                                        spec_for)


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


# ---------------------------------------------------------------------------
# sharding specs over a grid
# ---------------------------------------------------------------------------

def _bspec(mesh):
    ax = data_axis_names(mesh)
    return ax if len(ax) > 1 else (ax[0] if ax else None)


def _dp(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axis_names(mesh))


def _tp(mesh) -> int:
    return mesh.shape.get("model", 1)


def _ssm_heads(cfg: ArchConfig) -> int:
    return cfg.d_model * cfg.ssm_expand // cfg.ssm_headdim


def _mixer_spec(path: str, ndim: int, groups_split: bool):
    """The mixer's head split (module docstring), or None for a leaf the
    rule table places (A_log, D_skip, dt_bias, norm_w, out_proj, the
    adapters)."""
    if "/ssm/" not in path:
        return None
    lead = (None,) * (ndim - 2)
    if path.endswith(("/z_proj/kernel", "/x_proj/kernel", "/dt_proj/kernel")):
        return lead + (None, "model")
    if path.endswith("/conv_x"):
        return lead + ("model", None)
    if path.endswith(("/B_proj/kernel", "/C_proj/kernel")):
        return lead + (None, "model" if groups_split else None)
    if path.endswith(("/conv_B", "/conv_C")):
        return lead + ("model" if groups_split else None, None)
    return None


def param_specs(cfg: ArchConfig, mesh, tree):
    """The backbone's specs: ``DEFAULT_PARAM_RULES``, but k_proj and
    v_proj whole where the kv heads do not divide over 'model', and the
    Mamba-2 mixer split by heads (module docstring).  Raises where the
    mixer's heads do not divide over 'model'."""
    tp = _tp(mesh)
    whole_kv = cfg.n_kv_heads % tp != 0
    ssm = "model" in mesh.axis_names and any(
        sub.mixer == "ssm" for sub in cfg.pattern())
    if ssm and _ssm_heads(cfg) % tp:
        raise ValueError(
            f"{cfg.name}: the SSM mixer's {_ssm_heads(cfg)} heads do not "
            f"divide over {tp} model ranks")
    groups_split = ssm and cfg.ssm_groups % tp == 0

    def fn(path, x):
        if whole_kv and (path.endswith("k_proj/kernel")
                         or path.endswith("v_proj/kernel")):
            return (None,) * len(x.shape)
        spec = (_mixer_spec(path, len(x.shape), groups_split) if ssm
                else None)
        if spec is not None:
            return spec
        return spec_for(path, len(x.shape), DEFAULT_PARAM_RULES, mesh)
    return pt.tree_map_with_path(fn, tree)


def adapter_specs(mesh, tree, client_axis: bool):
    """Adapters are replicated, but for a leading client axis (when
    ``client_axis``), split over the data axes: one client a shard."""
    b = _bspec(mesh)
    if client_axis:
        return pt.tree_map(lambda x: (b,) + (None,) * (len(x.shape) - 1),
                           tree)
    return pt.tree_map(lambda _: (), tree)


def cache_specs(cfg: ArchConfig, mesh, tree, batch: int,
                seq_shard_kv: bool = False):
    """The decode cache's specs: rows over the data axes when ``batch``
    divides over them (else the same rows on every data rank), kv heads
    over 'model' when they divide (else whole); an SSM state's heads and
    conv_x's channels over 'model', conv_B / conv_C's over it only where
    their kernels are split (the groups divide: ``param_specs``), so that
    every cache shard is what the rank's mixer writes.  ``seq_shard_kv``:
    a k / v cache whose rows split, whose kv heads do not divide over
    'model' and whose slots do, split on its sequence over 'model'
    instead (the reference's variant)."""
    b, dp, tp = _bspec(mesh), _dp(mesh), _tp(mesh)
    rows = b if batch >= dp and batch % dp == 0 else None
    groups = "model" if cfg.ssm_groups % tp == 0 else None

    def split(n):
        return "model" if n % tp == 0 else None

    def fn(path, x):
        shp = x.shape
        if path.endswith("/k") or path.endswith("/v"):
            lead = [None] * (len(shp) - 4)       # (n_sb?, B, S, K, dh)
            if seq_shard_kv and rows and shp[-2] % tp and shp[-3] % tp == 0:
                return tuple(lead + [rows, "model", None, None])
            return tuple(lead + [rows, None, split(shp[-2]), None])
        if path.endswith("/state"):
            lead = [None] * (len(shp) - 4)       # (n_sb?, B, H, P, N)
            return tuple(lead + [rows, split(shp[-3]), None, None])
        if path.endswith(("/conv_x", "/conv_B", "/conv_C")):
            lead = [None] * (len(shp) - 3)       # (n_sb?, B, k-1, C)
            ch = (split(shp[-1]) if path.endswith("/conv_x") else groups)
            return tuple(lead + [rows, None, ch])
        return ()
    return pt.tree_map_with_path(fn, tree)


def _cut(x, spec, grid):
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, idx = 1, 0
        for a in axes:
            n *= grid.shape[a]
            idx = idx * grid.shape[a] + grid.coords[a]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axes} ({n} ranks)")
        size = x.shape[dim] // n
        x = x.narrow(dim, idx * size, size)
    return x


def shard_tree(tree, specs, grid):
    """This rank's shard of a whole tree: each leaf cut along every split
    dimension of its spec to the block at the rank's coordinates
    (``grid.coords``; a tuple of axes is split over their product, the
    first the slowest), as a contiguous tensor of its own, so that the
    rank does not hold the whole tree's storage."""
    return pt.tree_map_with_path(
        lambda path, x: _cut(x, pt.tree_get(specs, path), grid).clone(
            memory_format=torch.contiguous_format), tree)
