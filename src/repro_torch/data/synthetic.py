"""Synthetic heterogeneous instruction tasks (a copy of
``repro/data/synthetic.py``: numpy only, so the same seeds give the same
batches byte for byte in both packages).

The paper fine-tunes on Databricks-Dolly-15k / Natural-Instructions task
mixtures (causal reasoning, QA, information extraction, ...).  Those
datasets are not available offline, so we build *structured* synthetic
instruction tasks whose answers are computable functions of the context —
a model must actually learn the task to score, and task types differ
enough that client mixtures create genuine statistical heterogeneity
(the paper's "heterogeneous data scenario").

Task types (token-id native; sequences end with  SEP <query> ANS <answer> EOS):

  causal : next-token dynamics from a client-specific permutation table;
           the query is a token, the answer is its successor π(q).
           (stands in for "causal reasoning" — learn the world's rule)
  qa     : context is key/value pairs  k1 v1 k2 v2 ...; query is some ki,
           answer is vi.  (retrieval QA)
  ie     : context is noise with one MARK token followed by an entity;
           answer = the entity.  (information extraction / copying)
  sum    : context tokens are drawn around a theme token that appears most
           often; answer = the theme.  (summarize the gist)

Heterogeneity knobs:
  * per-client task mixture (Dirichlet over the 4 tasks),
  * per-client vocabulary sub-range (domain shift),
  * per-client causal permutation tables (concept shift).

A "dataset family" (dolly-like vs ni-like) fixes the vocab regions and
noise levels so benchmarks can report two dataset columns like Table I.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

PAD, BOS, EOS, SEP, ANS, MARK = 0, 1, 2, 3, 4, 5
N_SPECIAL = 8

TASK_TYPES = ("causal", "qa", "ie", "sum")


@dataclasses.dataclass(frozen=True)
class FamilyConfig:
    name: str
    vocab_size: int = 512
    key_lo: int = N_SPECIAL          # key/entity token range
    key_hi: int = 200
    val_lo: int = 200                # value/answer token range
    val_hi: int = 400
    noise_lo: int = 400              # filler range
    noise_hi: int = 512
    noise_level: float = 0.0         # prob of corrupting a context token
    n_pairs: int = 4                 # qa pairs per example


def make_dataset_family(name: str, vocab_size: int = 512) -> FamilyConfig:
    """Two families mimic the paper's two datasets: 'dolly' (clean, short)
    and 'ni' (noisier, more pairs) — different difficulty profiles."""
    third = (vocab_size - N_SPECIAL) // 3
    if name == "dolly":
        return FamilyConfig(
            name=name, vocab_size=vocab_size,
            key_lo=N_SPECIAL, key_hi=N_SPECIAL + third,
            val_lo=N_SPECIAL + third, val_hi=N_SPECIAL + 2 * third,
            noise_lo=N_SPECIAL + 2 * third, noise_hi=vocab_size,
            noise_level=0.0, n_pairs=4)
    if name == "ni":
        return FamilyConfig(
            name=name, vocab_size=vocab_size,
            key_lo=N_SPECIAL, key_hi=N_SPECIAL + third,
            val_lo=N_SPECIAL + third, val_hi=N_SPECIAL + 2 * third,
            noise_lo=N_SPECIAL + 2 * third, noise_hi=vocab_size,
            noise_level=0.05, n_pairs=6)
    raise ValueError(f"unknown family {name}")


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    generate: Callable  # (rng, fam, client_state, seq_len) -> (tokens, loss_mask)


class SyntheticInstructionDataset:
    """Per-client sampler over a task mixture."""

    AUX_LM_WEIGHT = 0.1

    def __init__(self, family: FamilyConfig, task_probs, client_seed: int = 0,
                 pool_size: int = 0, pool_seq_len: int = 48):
        """pool_size > 0 makes the client's TRAINING data finite (the
        paper's setting: a 15k-sample dataset split across clients gives
        each client a small fixed shard) — full-capacity personalization
        can then overfit, which is exactly the failure mode the paper's
        magnitude-only local optimizer avoids.  Eval paths
        (sample_task_batch) always generate fresh held-out samples."""
        self.family = family
        self.task_probs = np.asarray(task_probs, np.float64)
        self.task_probs = self.task_probs / self.task_probs.sum()
        self.client_seed = client_seed
        rng = np.random.default_rng(10_000 + client_seed)
        # client-specific causal permutation over the key range
        n_keys = family.key_hi - family.key_lo
        self.perm = family.val_lo + rng.permutation(
            family.val_hi - family.val_lo)[:n_keys] if n_keys <= (
            family.val_hi - family.val_lo) else family.val_lo + rng.integers(
            0, family.val_hi - family.val_lo, size=n_keys)
        self._pool = None
        if pool_size:
            prng = np.random.default_rng(77_000 + client_seed)
            toks = np.zeros((pool_size, pool_seq_len), np.int32)
            msk = np.zeros((pool_size, pool_seq_len), np.float32)
            tid = np.zeros((pool_size,), np.int32)
            for i in range(pool_size):
                toks[i], msk[i], tid[i] = self._fresh_sample(prng,
                                                             pool_seq_len)
            self._pool = (toks, msk, tid)

    # ---- task generators ------------------------------------------------
    def _gen_causal(self, rng, S):
        f = self.family
        q = rng.integers(f.key_lo, f.key_hi)
        a = self.perm[q - f.key_lo]
        # context: demonstration transitions k -> π(k); the query's own
        # pair is guaranteed present (solvable by induction OR memory)
        ctx = []
        for _ in range((S - 6) // 2 - 1):
            k = rng.integers(f.key_lo, f.key_hi)
            ctx += [k, self.perm[k - f.key_lo]]
        ins = rng.integers(0, max(len(ctx) // 2, 1)) * 2
        ctx = ctx[:ins] + [q, a] + ctx[ins:]
        return self._assemble(rng, ctx, q, a, S)

    def _gen_qa(self, rng, S):
        f = self.family
        ks = rng.choice(np.arange(f.key_lo, f.key_hi), size=f.n_pairs,
                        replace=False)
        vs = rng.integers(f.val_lo, f.val_hi, size=f.n_pairs)
        i = rng.integers(0, f.n_pairs)
        ctx = [t for kv in zip(ks, vs) for t in kv]
        return self._assemble(rng, ctx, int(ks[i]), int(vs[i]), S)

    def _gen_ie(self, rng, S):
        f = self.family
        n_ctx = max(4, S - 6)
        ctx = list(rng.integers(f.noise_lo, f.noise_hi, size=n_ctx))
        ent = int(rng.integers(f.val_lo, f.val_hi))
        pos = rng.integers(0, n_ctx - 1)
        ctx[pos] = MARK
        ctx[pos + 1] = ent
        return self._assemble(rng, ctx, MARK, ent, S)

    def _gen_sum(self, rng, S):
        f = self.family
        theme = int(rng.integers(f.val_lo, f.val_hi))
        n_ctx = max(4, S - 6)
        ctx = list(rng.integers(f.noise_lo, f.noise_hi, size=n_ctx))
        idx = rng.choice(n_ctx, size=max(2, n_ctx // 2), replace=False)
        for j in idx:
            ctx[j] = theme
        return self._assemble(rng, ctx, SEP, theme, S)

    def _assemble(self, rng, ctx, query, answer, S):
        f = self.family
        toks = [BOS] + list(ctx)
        toks = toks[: S - 4]
        if f.noise_level > 0:
            toks = [
                int(rng.integers(f.noise_lo, f.noise_hi))
                if (t > N_SPECIAL and rng.random() < f.noise_level) else t
                for t in toks
            ]
        toks += [SEP, int(query), ANS, int(answer)]
        pad = S - len(toks)
        toks += [EOS] * min(pad, 1) + [PAD] * max(pad - 1, 0)
        toks = np.asarray(toks[:S], np.int32)
        # next-token targets: model predicts toks[1:].  The answer position
        # carries weight 1.0; in-context positions carry a small auxiliary
        # LM weight (dense signal — with only 1/48 supervised tokens the
        # tasks are unlearnable at bench scale).  Accuracy is measured only
        # where mask == 1.0 (see models.loss_and_metrics).
        ans_pos = S - max(pad, 0) - 1
        mask = np.zeros(S, np.float32)
        mask[: ans_pos - 1] = self.AUX_LM_WEIGHT
        mask[ans_pos - 1] = 1.0  # predicting toks[ans_pos]
        return toks, mask

    _GEN = {"causal": _gen_causal, "qa": _gen_qa, "ie": _gen_ie,
            "sum": _gen_sum}

    # ---- public API -------------------------------------------------------
    def _fresh_sample(self, rng: np.random.Generator, seq_len: int):
        t = rng.choice(len(TASK_TYPES), p=self.task_probs)
        name = TASK_TYPES[t]
        toks, mask = self._GEN[name](self, rng, seq_len)
        return toks, mask, t

    def sample(self, rng: np.random.Generator, seq_len: int):
        if self._pool is not None:
            toks, msk, tid = self._pool
            assert seq_len == toks.shape[1], "pool_seq_len mismatch"
            i = rng.integers(0, toks.shape[0])
            return toks[i], msk[i], tid[i]
        return self._fresh_sample(rng, seq_len)

    def sample_batch(self, rng: np.random.Generator, batch: int, seq_len: int):
        toks = np.zeros((batch, seq_len), np.int32)
        mask = np.zeros((batch, seq_len), np.float32)
        tid = np.zeros((batch,), np.int32)
        for b in range(batch):
            toks[b], mask[b], tid[b] = self.sample(rng, seq_len)
        return {"tokens": toks, "loss_mask": mask, "task_id": tid}

    def sample_task_batch(self, rng, batch: int, seq_len: int, task: str):
        toks = np.zeros((batch, seq_len), np.int32)
        mask = np.zeros((batch, seq_len), np.float32)
        for b in range(batch):
            # lint: ok[R3] numpy Generator — stateful, sequential reuse is the API
            toks[b], mask[b] = self._GEN[task](self, rng, seq_len)
        tid = np.full((batch,), TASK_TYPES.index(task), np.int32)
        return {"tokens": toks, "loss_mask": mask, "task_id": tid}
