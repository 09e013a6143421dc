"""Deterministic hash tokenizer (no external vocab files).

Word-level with hashed fallback: frequent-token ids are stable given the
training corpus; unseen words map into a hashed bucket range.  Good
enough to train the router LM and to exercise the data pipeline with
realistic id distributions; NOT a BPE replacement (documented limitation).
"""
from __future__ import annotations

import hashlib
import re

_TOKEN_RE = re.compile(r"[a-z0-9_]+|[^\sa-z0-9_]")

PAD, BOS, EOS, UNK = 0, 1, 2, 3
_RESERVED = 4


class HashTokenizer:
    def __init__(self, vocab_size: int = 8192, hash_buckets: int = 1024):
        self.vocab_size = vocab_size
        self.hash_buckets = min(hash_buckets, vocab_size // 4)
        self._word_to_id: dict[str, int] = {}
        self._id_to_word: dict[int, str] = {}

    def fit(self, texts: list[str]) -> "HashTokenizer":
        from collections import Counter
        counts = Counter()
        for t in texts:
            counts.update(_TOKEN_RE.findall(t.lower()))
        budget = self.vocab_size - self.hash_buckets - _RESERVED
        for i, (w, _) in enumerate(counts.most_common(budget)):
            self._word_to_id[w] = _RESERVED + i
            self._id_to_word[_RESERVED + i] = w
        return self

    def _hash_id(self, w: str) -> int:
        h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "big")
        return self.vocab_size - self.hash_buckets + h % self.hash_buckets

    def encode(self, text: str, add_special: bool = True) -> list[int]:
        ids = [self._word_to_id.get(w, self._hash_id(w))
               for w in _TOKEN_RE.findall(text.lower())]
        return [BOS] + ids + [EOS] if add_special else ids

    def decode(self, ids) -> str:
        return " ".join(self._id_to_word.get(int(i), "<unk>")
                        for i in ids if int(i) >= _RESERVED)
