"""Hashed word-level tokenizer (a copy of ``repro/data/tokenizer.py``:
pure Python, so the same text gives the same ids in both packages).

No sentencepiece or HF tokenizer offline.  The synthetic instruction
tasks are token-id native; this serves the text-facing demo paths:
deterministic word-level hashing (blake2s) into a fixed vocabulary with
reserved specials.  Round-trip is not required for training; eval
compares ids.
"""
from __future__ import annotations

import hashlib


class HashTokenizer:
    PAD, BOS, EOS, SEP, ANS = 0, 1, 2, 3, 4
    N_SPECIAL = 8

    def __init__(self, vocab_size: int = 32768):
        if vocab_size <= self.N_SPECIAL:
            raise ValueError(f"vocab_size {vocab_size} must exceed the "
                             f"{self.N_SPECIAL} reserved specials")
        self.vocab_size = vocab_size

    def _hash(self, word: str) -> int:
        h = int.from_bytes(hashlib.blake2s(word.encode()).digest()[:4],
                           "little")
        return self.N_SPECIAL + h % (self.vocab_size - self.N_SPECIAL)

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = [self.BOS] if add_bos else []
        ids += [self._hash(w) for w in text.strip().split()]
        return ids

    def decode_ids(self, ids) -> str:
        return " ".join(f"<{int(i)}>" for i in ids)
