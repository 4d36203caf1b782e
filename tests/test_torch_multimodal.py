"""M-RoPE, the frontend stubs and the encoder-decoder in the port against
the JAX package, on the CPU: ``layers.apply_mrope``, cross-attention
(``attention(kv_source=)``), the non-causal long-prefill chunk, and the
SMOKE configs of qwen2-vl-2b (patch embeddings in front of the tokens,
3-section positions) and seamless-m4t-large-v2 (a non-causal encoder
over frame embeddings, decoder layers of self- and cross-attention) run,
served and trained.

Parameters are drawn by the JAX package and carried across by
``checkpoint.bridge``; inputs come from numpy seeds.  The JAX runs are
shared through module fixtures, and the port's ``FedSim`` runs on one
intra-op thread.

The reference's ``greedy_generate`` has two faults on this path (ROADMAP
C, caveats 4-5): it decodes inside a frontend's prefix, and drops the
encoder's output in every decode step.  Its tokens are not a target
here; the port's greedy tokens are held against the reference's own
``prefill`` + ``decode_step`` run at the right index with ``enc_out``,
and against the argmax of the port's full forward over the same tokens.

Tolerances (f32 arithmetic summed in another order by another BLAS):
- ``apply_mrope`` within 1e-5 of max |value| (f32 sin / cos of angles
  up to 500 rad in two libraries: measured 2.7e-6), and with repeated
  positions equal to ``apply_rope`` bit for bit;
- one attention sublayer (cross or non-causal) and the chunked
  attention within 1e-5 of max |value|;
- hidden states, loss and metrics, prefill logits and caches, decode
  logits within 1e-4 of max |value| over the SMOKE configs (the
  reference's ``tests/test_models_smoke.py`` holds 5e-4 absolute for the
  decode step against the forward); greedy tokens equal;
- the ``FedSim`` leaves by ``tests/test_torch_dense_attention.py``'s
  AdamW-eps rule against the port's f64 run.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.configs import get_config as j_get, get_smoke_config as j_smoke
from repro.core import peft as j_peft
from repro.core.methods import get_method as j_method
from repro.data import loader as j_loader
from repro.data import partition as j_part
from repro.data import synthetic as j_syn
from repro.fed.simulate import FedHyper as JHyper, FedSim as JSim
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import SubLayer as JSub
from repro.serve import AdapterStore as JStore, ServeEngine as JEngine
from repro.utils import pytree as jpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import peft as t_peft
from repro_torch.core.methods import get_method as t_method
from repro_torch.data import loader as t_loader
from repro_torch.data import partition as t_part
from repro_torch.data import synthetic as t_syn
from repro_torch.fed.simulate import FedHyper as THyper, FedSim as TSim
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serve import AdapterStore as TStore, ServeEngine as TEngine
from repro_torch.utils import pytree as tpt
from test_torch_dense_attention import EpsRegime, assert_leaves

VL, ENC = "qwen2-vl-2b", "seamless-m4t-large-v2"
ARCHS = (VL, ENC)
PROMPT = 12             # tokens
N_NEW = 6
FRAMES = 16             # seamless's encoder input: not the decoder's length
GRID = (2, 4)           # qwen2-vl's 8 SMOKE patches as an h x w grid


def configs(arch, **kw):
    kw = dict(lora_dropout=0.0, **kw)
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(t_smoke(arch), **kw))


def to_port(tree, dtype=None):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu", dtype)


def np_(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x)


def rel(got, want):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def flat(tree):
    if all(torch.is_tensor(x) for x in tpt.tree_leaves(tree)):
        return {p: x.detach().numpy()
                for p, x in tpt.tree_leaves_with_path(tree)}
    return dict(zip(jpt.tree_paths(tree), map(np.asarray,
                                              jax.tree.leaves(tree))))


def n_front(cfg):
    """Frontend rows of a prompt: the patch embeddings of a decoder-only
    model, the encoder's frames of an encoder-decoder."""
    return FRAMES if cfg.n_enc_layers else cfg.frontend_tokens


def mrope_positions(B, F, S):
    """Qwen2-VL-style (B, F + S, 3) ids: the F patches a GRID at t = 0
    (h = i // w, w = i % w), then the text from max(GRID) on with all
    three components equal."""
    i = np.arange(F)
    img = np.stack([np.zeros(F), i // GRID[1], i % GRID[1]], -1)
    txt = np.repeat((max(GRID) + np.arange(S))[:, None], 3, -1)
    return np.broadcast_to(np.concatenate([img, txt])[None],
                           (B, F + S, 3)).astype(np.int32)


def prompt_batch(cfg, B=2, S=PROMPT, seed=5):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "frontend_emb": rng.normal(size=(B, n_front(cfg), cfg.d_model)
                                       ).astype(np.float32)}


def jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tx(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def j_encode(jp, jc, fe):
    """The reference's encoder, as its tests/test_models_smoke.py builds
    it by hand for a decode step."""
    fe = jnp.asarray(fe)
    pos = jnp.broadcast_to(jnp.arange(fe.shape[1])[None], fe.shape[:2])
    out, _, _ = JM._run_blocks(jp["encoder"]["blocks"], {}, fe,
                               [JSub("attn", "dense", "global")], jc,
                               positions=pos, causal=False, chunk_q=True)
    return JL.rms_norm(out, jp["encoder"]["final_norm"], jc.norm_eps)


def _shared_adapter(jp, jc, seed):
    """A decomposed adapter on the config's targets with B_mag moved off
    0, so that every factor changes the model."""
    shared = j_peft.add_lora(jp, jc, jax.random.PRNGKey(seed),
                             decomposed=True)
    return jpt.tree_map_with_path(
        lambda p, x: x + 0.25 if p.endswith("B_mag") else x, shared)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


j_forward = jax.jit(JM.forward, static_argnames="cfg")
j_loss = jax.jit(JM.loss_and_metrics, static_argnames="cfg")
j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "cache_len"))
j_decode = jax.jit(JM.decode_step, static_argnames="cfg")


def j_greedy_loop(jp, jc, batch, n_new):
    """The reference's prefill and decode_step, run as greedy decoding
    must run them: the cache padded for the F + S prompt rows, decoding
    from F + S, each step with the encoder's output."""
    Stot = batch["tokens"].shape[1] + (0 if jc.n_enc_layers
                                       else batch["frontend_emb"].shape[1])
    enc = (j_encode(jp, jc, batch["frontend_emb"]) if jc.n_enc_layers
           else None)
    logits, cache = j_prefill(jp, jx(batch), cfg=jc, cache_len=Stot + n_new)
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = [tok]
    for i in range(n_new - 1):
        logits, cache = j_decode(jp, tok, cache, jnp.asarray(Stot + i),
                                 cfg=jc, enc_out=enc)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.stack(out, 1))


@pytest.fixture(scope="module")
def models():
    """Per architecture: both configs, the JAX params (with a decomposed
    adapter on q / v, B_mag off 0) and their port, the prompt batch, and
    the JAX package's hidden states, loss and metrics, prefill logits and
    cache (of the prompt but its last token), the decode step's logits
    from that cache, and greedy tokens by the correct loop; for qwen2-vl
    also with 3-section positions."""
    out = {}
    for arch in ARCHS:
        jc, tc = configs(arch)
        base = JM.init_params(jax.random.PRNGKey(1), jc)
        jp = jpt.merge_trees(base, _shared_adapter(base, jc, 3))
        b = prompt_batch(jc)
        Stot = PROMPT + (0 if jc.n_enc_layers else jc.frontend_tokens)
        lb = dict(b, loss_mask=np.random.default_rng(6).uniform(
            size=b["tokens"].shape).round().astype(np.float32))
        h, _, _ = j_forward(jp, jx(b), cfg=jc)
        loss, met = j_loss(jp, jx(lb), cfg=jc)
        short = dict(b, tokens=b["tokens"][:, :-1])
        logits, cache = j_prefill(jp, jx(short), cfg=jc,
                                  cache_len=Stot + N_NEW)
        enc = j_encode(jp, jc, b["frontend_emb"]) if jc.n_enc_layers else None
        dlog, _ = j_decode(jp, jnp.asarray(b["tokens"][:, -1]), cache,
                           jnp.asarray(Stot - 1), cfg=jc, enc_out=enc)
        m = dict(jc=jc, tc=tc, jp=jp, tp=to_port(jp), base=base, batch=b,
                 loss_batch=lb, Stot=Stot, hidden=np.asarray(h),
                 loss=float(loss), metrics={k: float(v)
                                            for k, v in met.items()},
                 logits=np.asarray(logits),
                 cache=jax.tree.map(np.asarray, cache),
                 decode=np.asarray(dlog),
                 greedy=j_greedy_loop(jp, jc, b, N_NEW))
        if jc.mrope:
            pb = dict(b, positions=mrope_positions(2, jc.frontend_tokens,
                                                   PROMPT))
            m["mrope_batch"] = pb
            m["hidden_mrope"] = np.asarray(j_forward(jp, jx(pb), cfg=jc)[0])
            m["greedy_mrope"] = j_greedy_loop(jp, jc, pb, N_NEW)
        out[arch] = m
    return out


# ---------------------------------------------------------------------------
# configs and the parameter layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_layout_equal_the_reference(arch):
    """ARCH and SMOKE field for field, the decoder pattern, and the SMOKE
    trees' paths, shapes and dtypes (seamless: ``encoder`` with its own
    blocks and final_norm; decoder layers of self-attention with no FFN
    and cross-attention with a dense FFN, no tail)."""
    assert dataclasses.asdict(t_get(arch)) == dataclasses.asdict(j_get(arch))
    jc, tc = configs(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert ([dataclasses.astuple(s) for s in tc.dec_pattern()]
            == [dataclasses.astuple(s) for s in jc.dec_pattern()])
    jtree = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jc))
    want = {p: (tuple(x.shape), str(x.dtype))
            for p, x in zip(jpt.tree_paths(jtree), jax.tree.leaves(jtree))}
    ttree = TM.init_params(torch.Generator().manual_seed(0), tc,
                           device="meta")
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in tpt.tree_leaves_with_path(ttree)}
    assert got == want
    assert ("encoder/final_norm" in got) == (arch == ENC)
    if arch == ENC:
        assert {"blocks/sub0/attn/q_proj/kernel",
                "blocks/sub1/attn/q_proj/kernel", "blocks/sub1/mlp/up_proj/"
                "kernel"} <= set(got)
        assert not any(p.startswith(("blocks/sub0/mlp", "tail/"))
                       for p in got)


# ---------------------------------------------------------------------------
# layers: M-RoPE, cross-attention, the non-causal chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections", ["three", "repeated"])
def test_apply_mrope_matches_reference(sections):
    """dh 128 (qwen2-vl's: 16 / 24 / 24 bands), 3-section positions or a
    (B, S) tensor repeated to three components; repeated ones equal
    apply_rope bit for bit."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 20, 3, 128)).astype(np.float32)
    if sections == "three":
        pos = mrope_positions(2, 8, 12)
    else:
        pos = np.repeat(rng.integers(0, 500, (2, 20, 1)), 3, -1).astype(
            np.int32)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = TL.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6)
    assert rel(got, want) <= 1e-5
    rope = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[..., 0]),
                         1e6)
    assert torch.equal(got, rope) == (sections == "repeated")


def _layer(jp, sub="sub1"):
    """Layer 0's attention sublayer ``sub`` (seamless's sub1: the
    cross-attention), with its adapter, unstacked."""
    return jax.tree.map(lambda x: x[0], jp["blocks"][sub]["attn"])


@pytest.mark.parametrize("S", [10, 1], ids=["prefill", "decode"])
def test_cross_attention_matches_reference(models, S):
    """kv_source: q from the decoder's S rows (10: a prefill; 1: a decode
    step), k and v from 16 encoder rows through the adapted projections,
    no rotary, no mask, no cache."""
    m = models[ENC]
    jc, tc = m["jc"], m["tc"]
    p = _layer(m["jp"])
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, S, jc.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, FRAMES, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None] + 7, (2, S)).astype(np.int32)
    scale = jc.lora_alpha / jc.lora_rank
    want, _ = JL.attention(p, jnp.asarray(x), jnp.asarray(pos), jc,
                           causal=False, kv_source=jnp.asarray(enc),
                           lora_scale=scale)
    with torch.no_grad():
        got, cache = TL.attention(to_port(p), torch.as_tensor(x),
                                  torch.as_tensor(pos), tc, causal=False,
                                  kv_source=torch.as_tensor(enc),
                                  lora_scale=scale, return_cache=True)
    assert cache is None
    assert rel(got, want) <= 1e-5


@pytest.mark.parametrize("Sk", [2048, 4096])
def test_sdpa_chunked_non_causal_matches_reference(Sk):
    """causal=False over 2048 queries: the encoder's square case and
    cross-attention over 4096 keys, narrow heads (GQA 4 / 2, dh 8)."""
    rng = np.random.default_rng(Sk)
    q = rng.normal(size=(1, 2048, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(1, Sk, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = JL._sdpa_chunked(*map(jnp.asarray, (q, k, v)), 0.35, None, False)
    with torch.no_grad():
        got = TL._sdpa_chunked(*map(torch.as_tensor, (q, k, v)), 0.35, None,
                               False)
    assert rel(got, want) <= 1e-5
    assert TL._causal_window_mask(3, 5, 2, None, "cpu", False).all()


def test_long_non_causal_attention_dispatches_to_flash(monkeypatch):
    """Without a gradient a long encoder layer and a long cross-attention
    (2048 queries over 4096 keys) go to ``flash_attention`` with
    causal=False (its plain version here, through the kernel branch, as
    on the card), equal to the plain chunked path; under autograd the
    plain path runs and the kernel is not called."""
    calls = []
    real = flash_ops.flash_attention

    def flash(q, k, v, *, causal, window, scale, impl):
        calls.append((q.shape[1], k.shape[1], causal, window, impl))
        return real(q, k, v, causal=causal, window=window, scale=scale,
                    impl="torch")
    monkeypatch.setattr(TL, "resolve_impl", lambda impl, x, op: impl or "cuda")
    monkeypatch.setattr(flash_ops, "flash_attention", flash)
    _, tc = configs(ENC, d_model=32, n_heads=2, n_kv_heads=2, d_head=16)
    p = TM.init_params(torch.Generator().manual_seed(0),
                       dataclasses.replace(tc, n_layers=1, n_enc_layers=1),
                       device="cpu")["blocks"]["sub1"]["attn"]
    p = tpt.tree_map(lambda t: t[0], p)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(1, 2048, 32)).astype(np.float32))
    enc = torch.as_tensor(rng.normal(size=(1, 4096, 32)).astype(np.float32))
    pos = torch.arange(2048)[None]
    with torch.no_grad():
        for kv, causal in ((None, False), (enc, True)):
            kw = dict(causal=causal, kv_source=kv)
            y = TL.attention(p, x, pos, tc, **kw)[0]
            y_plain = TL.attention(p, x, pos, tc, kernel_impl="torch",
                                   **kw)[0]
            assert rel(y, y_plain) <= 1e-5
    assert calls == [(2048, 2048, False, None, "cuda"),
                     (2048, 4096, False, None, "cuda")]
    grad_p = tpt.tree_map(lambda t: t.clone().requires_grad_(True), p)
    y = TL.attention(grad_p, x, pos, tc, kv_source=enc)[0]
    assert y.requires_grad and len(calls) == 2


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["vl", "vl-mrope", "vl-prompt", "encdec"])
def test_hidden_states_match_reference(models, case):
    """qwen2-vl with default and 3-section positions (F + S rows out), and
    with a prompt_embed leaf in front (its rows dropped); seamless with 16
    frames into the encoder and 12 tokens into the decoder."""
    m = models[ENC if case == "encdec" else VL]
    jp, tp, b, want = m["jp"], m["tp"], m["batch"], m["hidden"]
    if case == "vl-mrope":
        b, want = m["mrope_batch"], m["hidden_mrope"]
    if case == "vl-prompt":
        pe = j_peft.add_prompt_tuning(jp, m["jc"], jax.random.PRNGKey(4), 5)
        pe = jax.tree.map(lambda x: x * 50.0, pe)    # large enough to matter
        jp = jpt.merge_trees(jp, pe)
        tp = tpt.merge_trees(tp, to_port(pe))
        want = np.asarray(j_forward(jp, jx(b), cfg=m["jc"])[0])
        assert rel(want, m["hidden"]) > 1e-3
    with torch.no_grad():
        got, _, aux = TM.forward(tp, tx(b), m["tc"])
    assert got.shape == (2, m["Stot"], m["tc"].d_model)
    assert rel(got, want) <= 1e-4 and float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_match_reference(models, arch):
    """The CE over the tokens only (qwen2-vl's F frontend rows dropped),
    a half-open loss mask: loss, ce, acc, aux, n_tok."""
    m = models[arch]
    with torch.no_grad():
        loss, met = TM.loss_and_metrics(m["tp"], tx(m["loss_batch"]),
                                        m["tc"])
    assert abs(float(loss) - m["loss"]) <= 1e-5 * m["loss"]
    assert set(met) == set(m["metrics"])
    for k, v in m["metrics"].items():
        assert abs(float(met[k]) - v) <= 1e-5 * max(abs(v), 1.0), k


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_tree_matches_reference(models, arch):
    """init_cache and a prefill's cache: the reference's paths and shapes,
    self-attention only (no entry for seamless's cross-attention), and
    the prefill's values."""
    m = models[arch]
    want = flat(JM.init_cache(m["jc"], 2, 24))
    got = flat(TM.init_cache(m["tc"], 2, 24, device="cpu"))
    assert {p: v.shape for p, v in got.items()} == {
        p: v.shape for p, v in want.items()}
    assert not any(p.startswith("blocks/sub1/") for p in got)
    assert "blocks/sub0/attn/k" in got
    short = dict(m["batch"], tokens=m["batch"]["tokens"][:, :-1])
    with torch.no_grad():
        logits, cache = TM.prefill(m["tp"], tx(short), m["tc"],
                                   cache_len=m["Stot"] + N_NEW)
    assert rel(logits, m["logits"]) <= 1e-4
    got, want = flat(cache), flat(m["cache"])
    assert set(got) == set(want)
    for p in want:
        assert rel(got[p], want[p]) <= 1e-4, p


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference_and_the_forward(models, arch):
    """From the prefill of the prompt but its last token, one decode step
    of it at F + S − 1 (seamless: with enc_out): the logits against the
    reference's and against the full forward's last row."""
    m = models[arch]
    tc, tp, b = m["tc"], m["tp"], m["batch"]
    short = dict(b, tokens=b["tokens"][:, :-1])
    with torch.no_grad():
        enc = (TM._encode(tp, torch.as_tensor(b["frontend_emb"]), tc)
               if tc.n_enc_layers else None)
        _, cache = TM.prefill(tp, tx(short), tc, cache_len=m["Stot"] + N_NEW)
        dlog, _ = TM.decode_step(tp, torch.as_tensor(b["tokens"][:, -1]),
                                 cache, m["Stot"] - 1, tc, enc_out=enc)
        h, _, _ = TM.forward(tp, tx(b), tc)
    assert rel(dlog, m["decode"]) <= 1e-4
    full = (h[:, -1] @ TM._head_kernel(tp, tc)).float()
    assert rel(dlog, full) <= 1e-4


@pytest.mark.parametrize("case", ["vl", "vl-mrope", "encdec"])
def test_greedy_tokens_match_the_correct_loop_and_the_forward(models, case):
    """greedy_generate's tokens equal the reference's prefill +
    decode_step run at F + S with enc_out (not its greedy_generate:
    ROADMAP C, caveats 4-5); with default positions they also equal the
    argmax of the port's full forward over the prompt and the generated
    tokens (teacher forcing)."""
    m = models[ENC if case == "encdec" else VL]
    b, want = ((m["mrope_batch"], m["greedy_mrope"]) if case == "vl-mrope"
               else (m["batch"], m["greedy"]))
    tc, tp = m["tc"], m["tp"]
    got = t_serve.greedy_generate(tp, b, tc, n_new=N_NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "vl-mrope":
        return
    full = dict(tx(b), tokens=torch.cat([torch.as_tensor(b["tokens"]),
                                         got[:, :-1].int()], 1))
    with torch.no_grad():
        h, _, _ = TM.forward(tp, full, tc)
    rows = h[:, m["Stot"] - 1:]
    assert torch.equal(TM.argmax_first(rows @ TM._head_kernel(tp, tc)), got)


def test_decode_step_without_enc_out_is_refused(models):
    """The reference's decode_step, given no enc_out, attends the new
    token alone in its cross-attention; the port's raises."""
    m = models[ENC]
    with torch.no_grad():
        _, cache = TM.prefill(m["tp"], tx(m["batch"]), m["tc"],
                              cache_len=PROMPT + 2)
        with pytest.raises(ValueError, match="enc_out"):
            TM.decode_step(m["tp"], torch.as_tensor(m["batch"]["tokens"][:, 0]),
                           cache, PROMPT, m["tc"])


# ---------------------------------------------------------------------------
# adapters and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_adapter_paths_and_stage_masks_match_reference(models, arch):
    """add_lora(decomposed=True) lands on the same paths and shapes
    (seamless: the encoder's, the self- and the cross-attention's q / v),
    and every stage mask, fedlora_opt's keep-local rule and Eq. 11's
    regularizer mask picks the same leaves."""
    m = models[arch]
    jad = j_peft.add_lora(m["base"], m["jc"], jax.random.PRNGKey(0),
                          decomposed=True)
    tad = t_peft.add_lora(to_port(m["base"]), m["tc"],
                          torch.Generator().manual_seed(0), decomposed=True)
    jf, tf = flat(jad), flat(tad)
    assert {p: v.shape for p, v in tf.items()} == {p: v.shape
                                                  for p, v in jf.items()}
    if arch == ENC:
        assert {"encoder/blocks/sub0/attn/q_proj/A_dir",
                "blocks/sub0/attn/v_proj/B_mag",
                "blocks/sub1/attn/q_proj/dA_dir"} <= set(tf)
    for name in ("mask_stage_local_pretrain", "mask_stage_global",
                 "mask_stage_local", "mask_ffa", "reg_mask_dB"):
        assert flat(getattr(t_peft, name)(tad)) == {
            p: bool(v) for p, v in flat(getattr(j_peft, name)(jad)).items()
        }, name
    import re
    keep_t = re.compile(t_method("fedlora_opt").keep_local)
    keep_j = re.compile(j_method("fedlora_opt").keep_local)
    assert ({p for p in tf if keep_t.search(p)}
            == {p for p in jf if keep_j.search(p)} != set())


def _tenants(m, seed):
    """A dora_mag store over a shared decomposed adapter (B_mag off 0)
    with two tenants, each its own random ΔB_M."""
    g = torch.Generator().manual_seed(seed)
    shared = tpt.tree_map_with_path(
        lambda p, x: x + 0.3 if p.endswith("B_mag") else x,
        t_peft.add_lora(to_port(m["base"]), m["tc"], g, decomposed=True))
    store = TStore(to_port(m["base"]), m["tc"], n_slots=2, kind="dora_mag",
                   shared=shared, device="cpu")
    deltas = [tpt.tree_map(lambda x: torch.randn(x.shape, generator=g),
                           tpt.filter_tree(shared,
                                           lambda p: p.endswith("/dB_mag")))
              for _ in range(2)]
    for t, d in enumerate(deltas):
        store.register(f"t{t}", d)
    idx = torch.tensor([store.slot_of("t0"), store.slot_of("t1")])
    return shared, store, deltas, idx


def test_vl_pooled_greedy_equals_merged(models):
    """qwen2-vl: two dora_mag tenants in one batch, each row with its own
    patch embeddings, through greedy_generate with adapter_idx (the plain
    BGMV path on the CPU): each row's tokens equal its merged model's."""
    m = models[VL]
    shared, store, deltas, idx = _tenants(m, 2)
    base = to_port(m["base"])
    pooled = t_serve.greedy_generate(
        tpt.merge_trees(base, store.overlay()), m["batch"], m["tc"],
        n_new=N_NEW, adapter_idx=idx, device="cpu")
    for t, d in enumerate(deltas):
        row = {k: v[t:t + 1] for k, v in m["batch"].items()}
        merged = t_serve.greedy_generate(
            tpt.merge_trees(base, tpt.merge_trees(shared, d)), row, m["tc"],
            n_new=N_NEW, device="cpu")
        assert torch.equal(pooled[t:t + 1], merged), t


def test_pooled_encoder_leaves_are_refused(models):
    """seamless's encoder carries q / v adapters.  A pooled dora_mag tree
    there: the reference runs its encoder with no adapter_idx, and its
    linear adds nothing for pooled leaves, so every tenant gets the bare
    encoder; the port raises instead (serve merged models)."""
    m = models[ENC]
    _, store, _, idx = _tenants(m, 5)
    pooled = tpt.merge_trees(to_port(m["base"]), store.overlay())
    assert any(p.startswith("encoder/") and p.endswith("pool_dB_mag")
               for p in tpt.tree_paths(pooled))
    with pytest.raises(ValueError, match="encoder carries pooled"):
        t_serve.greedy_generate(pooled, m["batch"], m["tc"], n_new=2,
                                adapter_idx=idx, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_refuses_vlm_and_audio(models, arch):
    """Both packages' ServeEngine take the attention-cache families only;
    these are served through greedy_generate."""
    m = models[arch]
    with pytest.raises(ValueError, match="attention-cache families"):
        JEngine(m["base"], m["jc"], JStore(m["base"], m["jc"], n_slots=2))
    base = to_port(m["base"])
    with pytest.raises(ValueError, match="attention-cache families"):
        TEngine(base, m["tc"], TStore(base, m["tc"], n_slots=2,
                                      device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# training: a FedSim pipeline round with frontend_emb in every batch
# ---------------------------------------------------------------------------

FED = dict(n_clients=2, local_steps=2, batch=2, seq_len=24, global_steps=1,
           personal_steps=1, lr=3e-3, server_lr=2e-3, seed=0)


def _fed_data(pkg, part, vocab):
    fam = pkg.make_dataset_family("dolly", vocab_size=vocab)
    p = part.specialist_partition(FED["n_clients"], 4)
    return ([pkg.SyntheticInstructionDataset(fam, p[c], client_seed=c)
             for c in range(FED["n_clients"])],
            pkg.SyntheticInstructionDataset(fam, np.ones(4) / 4,
                                            client_seed=99))


def _batches(cfg, loader, ds, seed, n, lead=None, **kw):
    """n client batches (C, B, S) from the loader, each with N(0, 1)
    frontend_emb (C, B, F, D); ``lead`` (B,) cuts the client axis (a
    server batch)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = loader.client_batch(ds, rng, FED["batch"], FED["seq_len"], **kw)
        fe = rng.normal(size=(len(ds), FED["batch"], n_front(cfg),
                              cfg.d_model)).astype(np.float32)
        b = dict(b, frontend_emb=(torch.as_tensor(fe) if kw
                                  else jnp.asarray(fe)))
        out.append({k: v[0] for k, v in b.items()} if lead else b)
    return out


def _one_copy(*trees):
    """The client-stacked trees flattened, with each leaf that every
    client holds alike in all of them (the rebroadcast shared factors,
    dA_dir among them) cut to client 0's copy, so that an element of the
    server's is counted once, not once a client."""
    fl = [flat(t) for t in trees]
    for p in fl[0]:
        if all((f[p] == f[p][:1]).all() for f in fl):
            for f in fl:
                f[p] = f[p][:1]
    return fl


@pytest.mark.parametrize("arch", ARCHS)
def test_fedsim_pipeline_matches_reference(models, arch):
    """fedlora_opt from the reference's base and a decomposed adapter
    with B_mag off 0 (at the method's B_mag = 0 the first step gives the
    A factors no gradient), the same on every client: one round of stage
    1, the aggregate, a stage-2 step and a stage-3 step, on batches that
    carry frontend_emb; every client leaf (seamless: the encoder's and
    the cross-attention's too) against the reference, the port's f64 run
    the witness of AdamW's eps regime, the rebroadcast shared leaves
    counted once.  Stages 2 and 3 start each sim from the reference's
    state before them, so that each stage is held on its own inputs (as
    chip_smoke.py's phase 12 holds the engine): a stage-2 step from zero
    is AdamW's first, sign(g)·lr wherever |g| >> eps, and an element
    whose gradient the previous stage's f32 rounding moves across zero
    flips whole.  Measured so: qwen2-vl within 1e-4 everywhere;
    seamless's cross-attention q_proj dA_dir after stage 2 reads 4.9e-4
    and 1.3e-4 of its max on 2 of 2048 elements, where both packages'
    f32 runs sit 2.6e-4-1.1e-3 from the f64 run (chained from stage 1's
    output instead, 4 elements read 1.1-3.7e-4)."""
    m = models[arch]
    jc, tc = m["jc"], m["tc"]
    hp = dict(method="fedlora_opt", **FED)
    js = JSim(jc, JHyper(**hp), base=m["base"])
    start = _shared_adapter(m["base"], jc, 7)
    js.client_adapters = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (FED["n_clients"],) + x.shape),
        start)
    sims = []
    for dt in (torch.float32, torch.float64):
        ts = TSim(tc, THyper(**hp), base=to_port(js.base, dt), device="cpu")
        ts.client_adapters = to_port(js.client_adapters, dt)
        sims.append(ts)
    regime = EpsRegime(sims[1])
    assert (arch == ENC) == any(
        p.startswith("encoder/")
        for p, _ in tpt.tree_leaves_with_path(sims[0].client_adapters))
    j_ds, j_srv = _fed_data(j_syn, j_part, jc.vocab_size)
    t_ds, t_srv = _fed_data(t_syn, t_part, tc.vocab_size)
    n = FED["local_steps"]
    js.local_round(_batches(jc, j_loader, j_ds, 0, n), jax.random.PRNGKey(0))
    tb = _batches(tc, t_loader, t_ds, 0, n, device="cpu")
    for ts in sims:
        ts.local_round(tb, torch.Generator().manual_seed(0))
    assert_leaves(sims[0].client_adapters, js.client_adapters,
                  sims[1].client_adapters, regime, f"{arch} stage 1")
    j_agg = js.aggregate()
    t_aggs = [ts.aggregate() for ts in sims]
    assert_leaves(t_aggs[0], j_agg, t_aggs[1], regime, f"{arch} aggregate")
    t_sb = _batches(tc, t_loader, [t_srv], 1, 1, lead=True, device="cpu")
    agg_in = j_agg
    j_agg = js.global_stage(j_agg, _batches(jc, j_loader, [j_srv], 1, 1,
                                            lead=True),
                            jax.random.PRNGKey(1))
    t_aggs = [ts.global_stage(to_port(agg_in, dt), t_sb,
                              torch.Generator().manual_seed(1))
              for ts, dt in zip(sims, (torch.float32, torch.float64))]
    assert_leaves(t_aggs[0], j_agg, t_aggs[1], regime, f"{arch} stage 2")
    clients_in = js.client_adapters
    js.personalize(_batches(jc, j_loader, j_ds, 2, 1), jax.random.PRNGKey(2))
    tb = _batches(tc, t_loader, t_ds, 2, 1, device="cpu")
    for ts, dt in zip(sims, (torch.float32, torch.float64)):
        ts.client_adapters = to_port(clients_in, dt)
        ts.personalize(tb, torch.Generator().manual_seed(2))
    assert_leaves(*_one_copy(sims[0].client_adapters, js.client_adapters,
                             sims[1].client_adapters), regime,
                  f"{arch} stage 3")
