"""The multi-architecture transformer (port of ``repro/models/model.py``:
the dense, MoE, SSM, hybrid, vision-language and encoder-decoder
families).

Layer params are stacked ``(n_superblocks, ...)`` as in the reference;
the reference's ``lax.scan`` over superblocks is a Python loop over
``blocks[...][i]`` views here.  A superblock is ``cfg.pattern()``'s
sublayers (``sub0``…``sub{P-1}``; gemma3's 5 local + 1 global); layer
counts the pattern does not divide end in an unstacked ``tail`` that
runs the pattern's first sublayers.  A sublayer's mixer is attention
or the Mamba-2 mixer (``models/ssm.py``; mamba2's pattern is one SSM
sublayer with no FFN, jamba's 1 attention + 7 SSM sublayers); its FFN
is dense, MoE or none.  An MoE sublayer's FFN is
``layers.moe_ffn_local``; its load-balance aux is summed over the
sublayers, the stack and the tail, and ``loss_and_metrics`` adds
``aux_weight · aux`` to the CE.

Frontends are stubs, as in the reference: a decoder-only model with
``cfg.frontend`` (qwen2-vl) takes ``batch["frontend_emb"]`` (B, F, D),
projected patch embeddings prepended to the token embeddings, with
M-RoPE over (B, F + S, 3) positions; an encoder-decoder
(``cfg.n_enc_layers``, seamless-m4t) takes it as the frame embeddings
its non-causal encoder (``params["encoder"]``) reads.  The decoder's
layers are then ``cfg.dec_pattern()``: self-attention with no FFN, then
cross-attention over the encoder's output with a dense FFN.

On a grid (``mesh=``: a ``launch/mesh.Grid``) each rank runs its own rows with its shard of the
backbone (``launch/specs.shard_tree``): attention and the dense FFN
split over the model group (``layers``), the embedding and the lm_head
over the vocabulary (a masked lookup and an all-reduce; logits gathered,
the CE's max and sum-exp all-reduced in f32), MoE slots over the data
group with an all-to-all (``layers.moe_ffn_ep``, or ``moe_ffn_manual``
on the engine's grid, whose ``manual`` is set), the Mamba-2 mixer over
the rank's heads (``ssm.mamba2_mixer``), and an encoder-decoder's
encoder over the rank's heads too, its output whole on every rank of the
model group for the decoder's cross-attention.  Every family runs on a
grid.

Entry points:
  init_params(generator, cfg, device=)      → param tree (no adapters)
  forward(params, batch, cfg, ...)          → (hidden, cache, aux)
  loss_and_metrics(params, batch, cfg, ...) → (loss, metrics), training
  prefill(...) / decode_step(...)           → serving path with caches
  init_cache(cfg, batch, seq_len, device=)  → per-layer cache tree
"""
from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ArchConfig, SubLayer
from repro_torch.utils import pytree as pt
from repro_torch.utils.collectives import (copy_to, gather_from, model_group,
                                           reduce_from, scale_grad)

Params = Any


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


ENC_PATTERN = [SubLayer("attn", "dense", "global")]   # an encoder layer


def _layout(cfg: ArchConfig):
    """(n_sb, tail, pattern) of the decoder's stack: ``blocks_layout``,
    or for an encoder-decoder ``dec_pattern`` n_layers times, no tail."""
    if cfg.n_enc_layers:
        return cfg.n_layers, 0, cfg.dec_pattern()
    return cfg.blocks_layout()


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(g, shape, scale, dtype, device):
    """N(0, scale²) drawn in f32 on the generator's device, stored in
    ``dtype`` on ``device`` (on "meta", shapes only: nothing is drawn)."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=g, device=g.device)
            * scale).to(dtype).to(device)


def _init_stack(g, lead, shape, scale, dtype, device):
    """(*lead, *shape) stack (lead (n,) or ()) drawn layer by layer, so
    no f32 copy of more than one layer's ``shape`` is ever made."""
    if not lead:
        return _normal(g, shape, scale, dtype, device)
    w = torch.empty((*lead, *shape), dtype=dtype, device=device)
    for i in range(lead[0]):
        w[i] = _normal(g, shape, scale, dtype, device)
    return w


def _init_sublayers(g, cfg: ArchConfig, sub: SubLayer, lead: tuple, dtype,
                    device):
    """An attention or Mamba-2 sublayer with a dense, MoE or no FFN,
    stacked over ``lead`` ((n_sb,) in the stack, () in the tail).  MoE:
    an f32 router (D, E) and expert slots (E·fsplit, D, F/fsplit) /
    (E·fsplit, F/fsplit, D) in the model dtype.  SSM: the projections and
    the depthwise convs (N(0, 0.1²)) in the model dtype, and the
    reference's fixed f32 A_log = log(linspace(1, 16, H)), D_skip = 1,
    dt_bias = −2 and norm_w = 1."""
    D, Fd = cfg.d_model, cfg.d_ff
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    sc = 0.02
    out_sc = 0.02 / math.sqrt(max(2 * cfg.n_layers, 1))

    def lin(d_in, d_out, s):
        return {"kernel": _init_stack(g, lead, (d_in, d_out), s, dtype,
                                      device)}

    def fill(values):
        return values.to(device).expand((*lead, values.shape[0])).clone()

    def ones(d):
        return fill(torch.ones(d))

    p = {"input_norm": ones(D)}
    if sub.mixer == "ssm":
        Hs = D * cfg.ssm_expand // cfg.ssm_headdim
        d_inner, GN = Hs * cfg.ssm_headdim, cfg.ssm_groups * cfg.ssm_state
        k = cfg.ssm_conv
        p["ssm"] = {
            "z_proj": lin(D, d_inner, sc), "x_proj": lin(D, d_inner, sc),
            "B_proj": lin(D, GN, sc), "C_proj": lin(D, GN, sc),
            "dt_proj": lin(D, Hs, sc),
            "conv_x": _init_stack(g, lead, (d_inner, k), 0.1, dtype, device),
            "conv_B": _init_stack(g, lead, (GN, k), 0.1, dtype, device),
            "conv_C": _init_stack(g, lead, (GN, k), 0.1, dtype, device),
            "A_log": fill(torch.log(torch.linspace(1.0, 16.0, Hs))),
            "D_skip": ones(Hs), "dt_bias": fill(torch.full((Hs,), -2.0)),
            "norm_w": ones(d_inner), "out_proj": lin(d_inner, D, out_sc)}
    else:
        p["attn"] = {"q_proj": lin(D, H * dh, sc),
                     "k_proj": lin(D, K * dh, sc),
                     "v_proj": lin(D, K * dh, sc),
                     "o_proj": lin(H * dh, D, out_sc)}
        if cfg.qk_norm:
            p["attn"]["q_norm"], p["attn"]["k_norm"] = ones(dh), ones(dh)
    if sub.ffn == "none":
        return p
    p["ffn_norm"] = ones(D)
    if sub.ffn == "moe":
        E, fs = cfg.n_experts * cfg.ep_fsplit, cfg.ep_fsplit
        p["moe"] = {
            "router": {"kernel": _init_stack(g, lead, (D, cfg.n_experts), sc,
                                             torch.float32, device)},
            "experts": {
                "gate": _init_stack(g, lead, (E, D, Fd // fs), sc, dtype,
                                    device),
                "up": _init_stack(g, lead, (E, D, Fd // fs), sc, dtype,
                                  device),
                "down": _init_stack(g, lead, (E, Fd // fs, D), out_sc, dtype,
                                    device)}}
    else:
        p["mlp"] = {"gate_proj": lin(D, Fd, sc), "up_proj": lin(D, Fd, sc),
                    "down_proj": lin(Fd, D, out_sc)}
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig, *,
                device="cuda") -> Params:
    """Random backbone drawn from ``generator`` (on its own device; pass a
    CUDA generator to draw a full-size model on the card).  On
    ``device="meta"`` the tree has the shapes and dtypes only.  An
    encoder-decoder also gets ``params["encoder"]``: ``blocks`` (one
    attention + dense sublayer, stacked n_enc_layers) and its own
    ``final_norm``."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    dtype = _dtype(cfg)
    n_sb, tail, pattern = _layout(cfg)
    g = generator
    params: dict = {
        "embed": {"embedding": _normal(g, (cfg.vocab_size, cfg.d_model),
                                       0.02, dtype, dev)},
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=dev),
        "blocks": ({f"sub{i}": _init_sublayers(g, cfg, sub, (n_sb,), dtype,
                                               dev)
                    for i, sub in enumerate(pattern)} if n_sb else {}),
    }
    if tail:
        params["tail"] = {f"sub{i}": _init_sublayers(g, cfg, pattern[i], (),
                                                     dtype, dev)
                          for i in range(tail)}
    if cfg.n_enc_layers:
        params["encoder"] = {
            "blocks": {"sub0": _init_sublayers(
                g, cfg, ENC_PATTERN[0], (cfg.n_enc_layers,), dtype, dev)},
            "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                     device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"kernel": _normal(
            g, (cfg.d_model, cfg.vocab_size), 0.02, dtype, dev)}
    return params


# ---------------------------------------------------------------------------
# sublayers and the block loop
# ---------------------------------------------------------------------------

def _seq_kv(mesh):
    """The grid's ``seq_shard_kv`` layout for ``layers.attention``: None
    where it is off or the served rows do not split over the data ranks
    (the reference's rule keeps such a cache's sequence whole), else the
    whole decode cache's positions (``kv_len``)."""
    if getattr(mesh, "seq_shard_kv", False) and getattr(mesh, "rows_split",
                                                        True):
        return mesh.kv_len
    return None


def _apply_sublayer(p, x, sub: SubLayer, cfg, *, positions, cache=None,
                    cache_index=None, enc_out=None, causal=True,
                    lora_scale=0.0, dropout_gen=None, return_cache=False,
                    cache_len=0, adapter_idx=None, kernel_impl=None,
                    mesh=None):
    """One sublayer: its mixer (attention; cross-attention over
    ``enc_out``, never causal and with no cache; or the Mamba-2 mixer, to
    which the reference passes no ``adapter_idx``), then its FFN (dense,
    MoE or none).  Returns (x, new_cache, aux: the MoE aux, None without
    one).  ``mesh``: the grid (module docstring)."""
    new_cache = {}
    tp = model_group(mesh)
    h = L.rms_norm(x, p["input_norm"], cfg.norm_eps)
    key = "ssm" if sub.mixer == "ssm" else "attn"
    mcache = cache.get(key) if cache else None
    if key == "ssm":
        y, nc = S.mamba2_mixer(p["ssm"], h, cfg, cache=mcache,
                               lora_scale=lora_scale, dropout_gen=dropout_gen,
                               return_cache=return_cache,
                               kernel_impl=kernel_impl, tp=tp)
    else:
        cross = sub.mixer == "cross_attn"
        y, nc = L.attention(p["attn"], h, positions, cfg, kind=sub.attn_kind,
                            causal=causal and not cross,
                            kv_source=enc_out if cross else None,
                            cache=mcache, cache_index=cache_index,
                            lora_scale=lora_scale, dropout_gen=dropout_gen,
                            return_cache=return_cache,
                            cache_len=cache_len, adapter_idx=adapter_idx,
                            kernel_impl=kernel_impl, tp=tp,
                            seq_kv=_seq_kv(mesh))
    if nc is not None:
        new_cache[key] = nc
    x = x + y
    if sub.ffn == "none":
        return x, new_cache, None
    h = L.rms_norm(x, p["ffn_norm"], cfg.norm_eps)
    if sub.ffn == "moe":
        if getattr(mesh, "manual", False):
            y, aux = L.moe_ffn_manual(p["moe"], h, cfg, mesh)
        elif mesh is not None and mesh.size > 1:
            y, aux = L.moe_ffn_ep(p["moe"], h, cfg, mesh)
        else:
            y, aux = L.moe_ffn_local(p["moe"], h, cfg)
        return x + y, new_cache, aux
    x = x + L.dense_ffn(p["mlp"], h, cfg, lora_scale, adapter_idx=adapter_idx,
                        kernel_impl=kernel_impl, tp=tp)
    return x, new_cache, None


def _add_aux(total, a):
    """Running sum of the MoE sublayers' aux (None: none yet)."""
    if a is None:
        return total
    return a if total is None else total + a


def _superblock(x, p_sb, cache_sb, pattern, cfg, **kw):
    """→ (x, new_cache, aux summed over its MoE sublayers or None)."""
    new_cache, aux = {}, None
    scale = cfg.lora_alpha / cfg.lora_rank
    for i, sub in enumerate(pattern):
        key = f"sub{i}"
        if key not in p_sb:                   # the tail runs pattern[:tail]
            continue
        c = cache_sb.get(key) if cache_sb else None
        x, nc, a = _apply_sublayer(p_sb[key], x, sub, cfg, cache=c,
                                   lora_scale=scale, **kw)
        aux = _add_aux(aux, a)
        if nc:
            new_cache[key] = nc
    return x, new_cache, aux


def _dots_saveable():
    """remat="dots": keep the matmul outputs, recompute the rest (the
    reference's ``dots_saveable`` policy)."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    aten = torch.ops.aten
    return create_selective_checkpoint_contexts(
        [aten.mm.default, aten.bmm.default, aten.addmm.default,
         aten.baddbmm.default])


def _remat_superblock(x, p_sb, pattern, cfg, remat, kw):
    """One superblock under ``torch.utils.checkpoint``: its activations
    are recomputed in the backward pass ("dots": all but the matmul
    outputs).  The dropout generator is explicit, and ``checkpoint``
    restores only the default generators' state, so the recomputation
    rewinds it to where the forward pass started the block (the same
    masks) and puts it back afterwards; after the block it stands where
    the forward pass left it.  Returns (y, aux): the MoE aux comes out of
    the checkpointed body too."""
    gen = kw.get("dropout_gen")
    start = gen.get_state() if gen is not None else None
    after = []

    def body(h):
        if gen is None:
            y, _, aux = _superblock(h, p_sb, None, pattern, cfg, **kw)
            return y, aux
        here = gen.get_state()
        gen.set_state(start)
        try:        # a recomputation may stop early, by an exception
            y, _, aux = _superblock(h, p_sb, None, pattern, cfg, **kw)
            if not after:
                after.append(gen.get_state())
            return y, aux
        finally:
            gen.set_state(here)

    extra = {} if remat is True else {"context_fn": _dots_saveable}
    y, aux = checkpoint(body, x, use_reentrant=False, **extra)
    if gen is not None:
        gen.set_state(after[0])
    return y, aux


def _run_blocks(blocks, tail, x, pattern, cfg, *, positions, cache=None,
                cache_index=None, enc_out=None, causal=True,
                dropout_gen=None, return_cache=False, cache_len=0,
                adapter_idx=None, kernel_impl=None, remat=False, mesh=None):
    """Loop over the stacked superblocks, then the unstacked ``tail``
    (``{}``: none).  A decode cache is updated in place and returned; a
    prefill cache (return_cache) is stacked back to the (n_sb, ...)
    layout, with the tail's beside it.  ``remat`` (True | "dots" |
    False): each superblock, and the tail, under
    ``torch.utils.checkpoint`` (training only).  Returns (x, cache,
    aux), aux summed over the MoE sublayers of the stack and the tail (a
    0-d f32 zero without one)."""
    kw = dict(positions=positions, cache_index=cache_index,
              enc_out=enc_out, causal=causal,
              dropout_gen=dropout_gen, return_cache=return_cache,
              cache_len=cache_len,
              adapter_idx=adapter_idx, kernel_impl=kernel_impl, mesh=mesh)
    if remat and (cache is not None or return_cache):
        raise ValueError("remat is for training; it keeps no cache")
    leaves = pt.tree_leaves(blocks)
    n_sb = leaves[0].shape[0] if leaves else 0
    fresh, aux = [], None
    for i in range(n_sb):
        p_sb = pt.tree_map(lambda t: t[i], blocks)
        if remat:
            x, a = _remat_superblock(x, p_sb, pattern, cfg, remat, kw)
            aux = _add_aux(aux, a)
            continue
        c_sb = (pt.tree_map(lambda t: t[i], cache["blocks"])
                if cache is not None else None)
        x, nc, a = _superblock(x, p_sb, c_sb, pattern, cfg, **kw)
        aux = _add_aux(aux, a)
        fresh.append(nc)
    new_cache = {"blocks": None, "tail": {}}
    if cache is not None:
        new_cache["blocks"] = cache["blocks"]
    elif return_cache and fresh:
        new_cache["blocks"] = pt.tree_map_with_path(
            lambda path, _: torch.stack([pt.tree_get(f, path)
                                         for f in fresh]), fresh[0])
    if tail:
        if remat:
            x, a = _remat_superblock(x, tail, pattern, cfg, remat, kw)
        else:
            x, nc, a = _superblock(x, tail, cache["tail"] if cache is not None
                                   else None, pattern, cfg, **kw)
            new_cache["tail"] = nc
        aux = _add_aux(aux, a)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, new_cache, aux


def _encode(params, frontend_emb, cfg: ArchConfig, *, rng=None,
            kernel_impl=None, remat=False, mesh=None):
    """An encoder-decoder's encoder: the frame embeddings (B, S_enc, D),
    cast to the model dtype, through ``cfg.n_enc_layers`` non-causal
    attention + dense layers at positions 0 … S_enc − 1 (a long input
    through ``_long_attention``'s non-causal form), then the encoder's
    ``final_norm``.  Returns enc_out (B, S_enc, D).  ``mesh``: the grid;
    ``params`` is the rank's shard and ``frontend_emb`` its rows; each
    layer runs over the rank's heads and d_ff (row-parallel outputs
    all-reduced), so enc_out is whole on every rank of the model group.

    No ``adapter_idx``, as in the reference, whose ``linear`` then adds
    nothing for pooled leaves without ``A_dir`` or ``lora_A``: a pooled
    tree on the encoder would serve every tenant the bare encoder, so
    the port refuses it (ROADMAP C)."""
    enc = params["encoder"]
    for path in pt.tree_paths(enc):
        if path.endswith(("/pool_A", "/pool_dB_mag")):
            raise ValueError(
                f"the encoder carries pooled adapter leaves "
                f"(encoder/{path}), but it takes no per-row adapters (the "
                f"reference would serve every tenant the bare encoder); "
                f"serve merged per-tenant models instead (merge_adapters + "
                f"greedy_generate)")
    x = frontend_emb.to(params["embed"]["embedding"].dtype)
    B, Se = x.shape[0], x.shape[1]
    pos = torch.arange(Se, device=x.device)[None].expand(B, Se)
    x, _, _ = _run_blocks(enc["blocks"], {}, x, ENC_PATTERN, cfg,
                          positions=pos, causal=False, dropout_gen=rng,
                          kernel_impl=kernel_impl, remat=remat, mesh=mesh)
    return L.rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _embed(params, tokens, cfg: ArchConfig, frontend_emb=None, tp=None):
    """Token embeddings (B, S, D); with ``cfg.frontend`` and a
    ``frontend_emb`` (B, F, D), that cast to the embedding dtype in
    front: (B, F + S, D).  ``tp``: the table is this rank's rows of the
    vocabulary; each rank looks up the tokens it holds (zeros for the
    rest) and an all-reduce sums them, exactly (one term is nonzero)."""
    table = params["embed"]["embedding"]
    tokens = tokens.to(torch.int64)
    if tp is None:
        emb = table[tokens]
    else:
        Vl = table.shape[0]
        local = tokens - tp.rank * Vl
        own = (local >= 0) & (local < Vl)
        emb = reduce_from(table[local.clamp(0, Vl - 1)]
                          * own[..., None].to(table.dtype), tp)
    if cfg.frontend and frontend_emb is not None:
        emb = torch.cat([frontend_emb.to(emb.dtype), emb], dim=1)
    return emb


def forward(params, batch, cfg: ArchConfig, *, rng=None,
            return_cache=False, cache_len=0, kernel_impl=None, remat=False,
            enc_out=None, mesh=None):
    """Training / prefill forward → (hidden (B,S,D), cache, aux).
    ``batch`` holds ``tokens`` (B, S) and optionally ``positions``
    ((B, S) or M-RoPE's (B, S, 3), over every row the blocks see),
    ``adapter_idx`` and ``frontend_emb``.  A decoder-only model with a
    frontend prepends ``frontend_emb`` (B, F, D), so hidden is
    (B, F + S, D); an encoder-decoder encodes it (``_encode``) and the
    decoder's cross-attention reads that, or ``enc_out`` when the caller
    has it already.  ``rng``: a torch.Generator on the params' device
    for adapter dropout at cfg.lora_dropout (training); its draws run on
    through the layers (the encoder's first), so each projection's mask
    is its own.  A ``prompt_embed`` leaf (n_p, D) is prepended to every
    sequence, the positions run over every row, and the prompt rows are
    dropped before the final norm.  ``remat``: checkpoint each
    superblock (True) or keep only its matmul outputs ("dots"), as the
    reference's.  ``mesh``: the grid; the batch is this rank's rows."""
    fe = None if cfg.n_enc_layers else batch.get("frontend_emb")
    tp = model_group(mesh)
    x = _embed(params, batch["tokens"], cfg, fe, tp)
    B, S = x.shape[0], x.shape[1]
    n_p = 0
    if "prompt_embed" in params:                 # prompt-tuning baseline
        pe = params["prompt_embed"]
        if tp is not None:          # whole on every rank: a 1/n share each
            pe = scale_grad(pe, 1.0 / tp.size)
        n_p = pe.shape[0]
        x = torch.cat([pe[None].to(x.dtype).expand(B, n_p, x.shape[-1]), x],
                      dim=1)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S + n_p, device=x.device)[None].expand(
            B, S + n_p)
    if cfg.n_enc_layers and enc_out is None:
        enc_out = _encode(params, batch["frontend_emb"], cfg, rng=rng,
                          kernel_impl=kernel_impl, remat=remat, mesh=mesh)
    x, cache, aux = _run_blocks(
        params["blocks"], params.get("tail", {}), x, _layout(cfg)[2], cfg,
        positions=positions, enc_out=enc_out,
        dropout_gen=rng, return_cache=return_cache, cache_len=cache_len,
        adapter_idx=batch.get("adapter_idx"), kernel_impl=kernel_impl,
        remat=remat, mesh=mesh)
    x = L.rms_norm(x[:, n_p:], params["final_norm"], cfg.norm_eps)
    return x, cache, aux


def _head_kernel(params, cfg):
    if cfg.tie_embeddings or "lm_head" not in params:
        return params["embed"]["embedding"].T
    return params["lm_head"]["kernel"]


def _ce_chunk(kern, hb, tb, mb):
    """Summed CE, correct answers and answer positions of one sequence
    chunk; run under ``checkpoint``, so its (B, Sc, V) logits are
    recomputed in the backward pass instead of kept."""
    logits = hb @ kern.to(hb.dtype)
    lse = torch.logsumexp(L.wide(logits), dim=-1)
    tgt = L.wide(torch.gather(logits, -1, tb[..., None])[..., 0])
    loss = torch.sum((lse - tgt) * mb)
    # accuracy counts only full-weight (answer) positions; fractional
    # mask weights are auxiliary LM signal
    amb = (mb >= 0.999).float()
    correct = torch.sum((argmax_first(logits) == tb) * amb)
    return loss, correct, torch.sum(amb)


def _ce_chunk_tp(kern, hb, tb, mb, tp):
    """``_ce_chunk`` over a vocabulary split over ``tp``: ``kern`` is this
    rank's (D, V/n) columns (vocabulary ids from rank · V/n).  The
    log-sum-exp's max (no gradient) and sum of exps are all-reduced in
    f32, the target's logit comes from the rank that holds it, and the
    greedy pick is ``argmax_over_shards``."""
    logits = hb @ kern.to(hb.dtype)
    lf = L.wide(logits)
    Vl = logits.shape[-1]
    gmax = tp.reduce_max(lf.detach().amax(dim=-1))
    se = reduce_from(torch.exp(lf - gmax[..., None]).sum(dim=-1), tp)
    lse = torch.log(se) + gmax
    local = tb - tp.rank * Vl
    own = (local >= 0) & (local < Vl)
    tgt = torch.gather(logits, -1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    tgt = reduce_from(L.wide(tgt) * own, tp)
    loss = torch.sum((lse - tgt) * mb)
    amb = (mb >= 0.999).float()
    correct = torch.sum((argmax_over_shards(logits.detach(), tp) == tb) * amb)
    return loss, correct, torch.sum(amb)


def loss_and_metrics(params, batch, cfg: ArchConfig, *, rng=None,
                     n_loss_chunks: int = 0, aux_weight=0.01, remat=False,
                     mesh=None):
    """Masked next-token CE → (loss, {ce, acc, aux, n_tok}), 0-d tensors.

    The CE over the vocabulary runs in sequence chunks, each under
    ``torch.utils.checkpoint``, so no (B, S, V) logits are kept for the
    backward pass.  ``acc`` counts positions where loss_mask ≥ 0.999,
    argmax ties going to the first index; ``task_id`` is ignored.
    ``remat``: as ``forward``'s.  A decoder-only model's ``frontend_emb``
    rows are dropped before the CE (the loss is over the tokens).
    ``mesh``: the grid; the CE is vocab-parallel (``_ce_chunk_tp``), and
    every rank of a model row computes the same loss."""
    hidden, _, aux = forward(params, batch, cfg, rng=rng, remat=remat,
                             mesh=mesh)
    tp = model_group(mesh)
    if cfg.frontend and not cfg.n_enc_layers and "frontend_emb" in batch:
        hidden = hidden[:, batch["frontend_emb"].shape[1]:]
    tokens, mask = batch["tokens"].to(torch.int64), batch["loss_mask"]
    B, Stot, D = hidden.shape
    targets, h, m = tokens[:, 1:], hidden[:, :-1], mask[:, :-1]
    Sl = Stot - 1
    kern = _head_kernel(params, cfg)
    V = kern.shape[-1] * (tp.size if tp is not None else 1)
    if n_loss_chunks <= 0:
        n_loss_chunks = max(1, min(32, (B * Sl * V) // (1 << 26)))
    while Sl % n_loss_chunks:
        n_loss_chunks -= 1
    Sc = Sl // n_loss_chunks
    tot_loss = tot_correct = tot_ans = 0.0
    if tp is not None:
        h = copy_to(h, tp)
        chunk = lambda *a: _ce_chunk_tp(*a, tp)     # noqa: E731
    else:
        chunk = _ce_chunk
    for i in range(n_loss_chunks):
        sl = slice(i * Sc, (i + 1) * Sc)
        l_c, a_c, n_c = checkpoint(chunk, kern, h[:, sl], targets[:, sl],
                                   m[:, sl], use_reentrant=False)
        tot_loss, tot_correct, tot_ans = (tot_loss + l_c, tot_correct + a_c,
                                          tot_ans + n_c)
    denom = torch.clamp(torch.sum(m), min=1.0)
    ce = tot_loss / denom
    return ce + aux_weight * aux, {
        "ce": ce, "acc": tot_correct / torch.clamp(tot_ans, min=1.0),
        "aux": aux, "n_tok": denom}


def argmax_first(logits):
    """Greedy pick with ties broken to the FIRST index, as ``jnp.argmax``
    does (bf16 logits over a 32k vocabulary do tie)."""
    m = logits.max(dim=-1, keepdim=True).values
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(logits == m, ids, logits.shape[-1]).min(dim=-1).values


def argmax_over_shards(logits, tp):
    """``argmax_first`` over a vocabulary split over ``tp`` (this rank's
    logits are ids rank · V/n …): each rank's max and its first index,
    gathered; the first rank holding the greatest max wins, so a tie
    goes to the lower index."""
    Vl = logits.shape[-1]
    vals, = tp.all_gather([logits.amax(dim=-1).float()])    # (n, ...)
    ids, = tp.all_gather([argmax_first(logits) + tp.rank * Vl])
    n = vals.shape[0]
    rank = torch.arange(n, device=vals.device).reshape((n,) + (1,) * (
        vals.dim() - 1))
    first = torch.where(vals == vals.amax(dim=0, keepdim=True), rank,
                        n).amin(dim=0)
    return torch.gather(ids, 0, first[None])[0]


def _logits(x, params, cfg, tp):
    """f32 logits (..., V) of the final hidden rows ``x``; on a grid each
    rank computes its vocabulary columns and they are gathered."""
    x = copy_to(x, tp)
    return gather_from((x @ _head_kernel(params, cfg).to(x.dtype)).float(),
                       tp, -1)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device="cuda",
               mesh=None):
    """Zero decode caches, per sublayer {"attn": k/v buffers} or {"ssm":
    state and conv states}, stacked (n_sb, batch, ...) in ``blocks`` and
    (batch, ...) in ``tail``.  A cross-attention sublayer has none (its
    k and v come from the encoder's output each step), and is left out,
    as the reference leaves it out.  On ``device="meta"`` the tree has
    the shapes and dtypes only.  ``mesh``: a grid (abstract or not);
    the caches are a rank's of ``batch`` rows: its kv heads where they
    divide over 'model' (else all of them, and with the grid's
    ``seq_shard_kv`` layout its share of their slots where
    ``layers.seq_split`` splits them), its SSM heads and conv_x channels,
    and conv_B / conv_C split only where the groups divide
    (``launch/specs.cache_specs``)."""
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    n_sb, tail, pattern = _layout(cfg)
    dtype = _dtype(cfg)
    shape = getattr(mesh, "shape", None)
    n = shape.get("model", 1) if isinstance(shape, dict) else 1
    seq = _seq_kv(mesh)

    def one(sub, lead):
        if sub.mixer == "ssm":
            return {"ssm": S.init_ssm_cache(cfg, lead, dtype, dev,
                                            n_model=n)}
        return {"attn": L.init_attn_cache(cfg, lead, seq_len, sub.attn_kind,
                                          dtype, dev, n_model=n,
                                          seq_shard=seq is not None)}
    blocks = ({f"sub{i}": one(sub, (n_sb, batch))
               for i, sub in enumerate(pattern) if sub.mixer != "cross_attn"}
              if n_sb else {})
    tail_c = {f"sub{i}": one(pattern[i], batch) for i in range(tail)}
    return {"blocks": blocks, "tail": tail_c}


def decode_step(params, new_token, cache, cache_index, cfg: ArchConfig, *,
                enc_out=None, adapter_idx=None, mesh=None):
    """One-token decode.  new_token: (B,) int; cache_index: int / 0-d
    shared position or (B,) int per-row positions (mixed batching; under
    M-RoPE the position is repeated over the three components).  An
    encoder-decoder needs ``enc_out`` (B, S_enc, D), the encoder's output
    (``_encode``), which each cross-attention sublayer reads.  Writes the
    cache in place.  Returns (logits (B,V) f32, cache).  ``mesh``: the
    grid; new_token and the cache are this rank's rows, the cache its kv
    heads, or with the grid's ``seq_shard_kv`` layout its slots of the
    sequence where they split (its ``kv_len`` the whole cache's
    positions); the logits cover the whole vocabulary; ``enc_out`` is whole
    on every rank of the model group (``_encode`` on the grid)."""
    _refuse_prompt(params, "decode_step")
    tp = model_group(mesh)
    if cfg.n_enc_layers and enc_out is None:
        raise ValueError("decode_step: an encoder-decoder model needs the "
                         "encoder's output (enc_out); without it the "
                         "reference's cross-attention attends the new "
                         "token alone")
    x = _embed(params, new_token[:, None], cfg, tp=tp)
    B = x.shape[0]
    if torch.is_tensor(cache_index) and cache_index.dim() == 1:
        positions = cache_index[:, None].to(torch.int64)
    else:
        positions = torch.full((B, 1), int(cache_index), dtype=torch.int64,
                               device=x.device)
    x, new_cache, _ = _run_blocks(
        params["blocks"], params.get("tail", {}), x, _layout(cfg)[2], cfg,
        positions=positions, cache=cache, cache_index=cache_index,
        enc_out=enc_out, adapter_idx=adapter_idx, mesh=mesh)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(x[:, 0], params, cfg, tp), new_cache


def _refuse_prompt(params, what):
    """A prompt-tuned model cannot be served coherently: the reference's
    ``decode_step`` ignores ``prompt_embed`` while its ``prefill`` leaves
    the cache offset by the prompt's length (ROADMAP C)."""
    if "prompt_embed" in params:
        raise ValueError(
            f"{what}: a prompt-tuned model (prompt_embed) cannot be served: "
            "the reference's decode_step ignores the prompt while its "
            "prefill offsets the cache by it")


def prefill(params, batch, cfg: ArchConfig, *, cache_len=0, enc_out=None,
            mesh=None):
    """Process a prompt (with its ``frontend_emb`` and ``positions`` when
    given), returning (last_logits, cache).  cache_len pads the caches
    with headroom for subsequent decode steps; a frontend's F rows sit
    in front of the tokens', so a decode step continues at F + S.  An
    encoder-decoder encodes ``frontend_emb`` here unless ``enc_out`` is
    given.  ``mesh``: the grid (as ``decode_step``'s); with its
    ``seq_shard_kv`` layout each split cache is cut to the rank's slots
    (the padded or rolled cache narrowed, then cloned)."""
    _refuse_prompt(params, "prefill")
    hidden, cache, _ = forward(params, batch, cfg, return_cache=True,
                               cache_len=cache_len, enc_out=enc_out,
                               mesh=mesh)
    return _logits(hidden[:, -1], params, cfg, model_group(mesh)), cache
