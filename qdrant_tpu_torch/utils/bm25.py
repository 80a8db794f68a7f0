"""BM25 sparse embedding (server-side inference for Document inputs).

Reference: lib/bm25/src/lib.rs — standalone BM25 embedding with murmur3
token ids (lib.rs:19,106,166), used by the inference service
(src/common/inference/bm25_inference.rs) so clients can upsert/query raw
text against a sparse vector field.

Documents embed as tf-saturated weights  tf·(k1+1)/(tf + k1·(1-b+b·|d|/avg))
over murmur3-hashed token ids; queries embed as weight-1 token sets (the
IDF part comes from the sparse index's `modifier: idf`).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional

from ..types import SparseVector
from .text import STOPWORDS, porter_stem

DEFAULT_K1 = 1.2
DEFAULT_B = 0.75
DEFAULT_AVG_LEN = 256.0


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86 32-bit (public domain algorithm)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    length = len(data)
    rounded = length - (length % 4)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i : i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


class Bm25:
    def __init__(
        self,
        k1: float = DEFAULT_K1,
        b: float = DEFAULT_B,
        avg_len: float = DEFAULT_AVG_LEN,
        language: Optional[str] = "english",
        stem: bool = True,
    ):
        self.k1 = k1
        self.b = b
        self.avg_len = avg_len
        self.stopwords = STOPWORDS.get(language or "", frozenset())
        self.stem = stem

    def tokenize(self, text: str) -> List[str]:
        import re

        tokens = [t.lower() for t in re.findall(r"[^\W_]+", text, re.UNICODE)]
        tokens = [t for t in tokens if t not in self.stopwords]
        if self.stem:
            tokens = [porter_stem(t) for t in tokens]
        return tokens

    def token_id(self, token: str) -> int:
        return murmur3_32(token.encode("utf-8"))

    def embed_document(self, text: str) -> SparseVector:
        tokens = self.tokenize(text)
        n = len(tokens)
        counts = Counter(self.token_id(t) for t in tokens)
        indices, values = [], []
        norm = self.k1 * (1.0 - self.b + self.b * n / self.avg_len)
        for tid in sorted(counts):
            tf = counts[tid]
            indices.append(tid)
            values.append(tf * (self.k1 + 1.0) / (tf + norm))
        return SparseVector(indices, values)

    def embed_query(self, text: str) -> SparseVector:
        ids = sorted(set(self.token_id(t) for t in self.tokenize(text)))
        return SparseVector(ids, [1.0] * len(ids))
