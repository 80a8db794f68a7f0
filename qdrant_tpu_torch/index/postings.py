"""Bitpacked posting-list storage for the sealed sparse index.

Reference behavior: qdrant packs posting ids in 128-element chunks with a
per-chunk bit width (BitPacker4x, `lib/posting_list/src/lib.rs:16`) and
keeps compressed inverted indexes resident
(`lib/sparse/src/index/inverted_index/`). Here the packed form replaces
the flat int32 CSR ids retained after seal — the device holds its own
padded copy of the postings, so the host copy exists only for the rare
rebuild paths (top-W window extraction, legacy dict view) and can afford
a decode on access.

Layout per 128-id chunk:
* monotonic chunk  → delta mode: store [0, d1, …, d127] plus an int64
  base; ids = base + cumsum.
* non-monotonic    → absolute mode: raw values (happens only where a
  chunk straddles a posting-run boundary, or for weight-sorted runs).
* width = max bit-length of the stored values (0 → no words at all);
  values packed little-endian into uint32 words, CHUNK*width/32 words
  per chunk.

Packing loops over lanes (128) per distinct width — a few thousand
vectorized column ops at any scale — never per chunk or per element.
Weights stay f32 (exact scores; the reference's default compressed
variant keeps f32 weights too).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CHUNK = 128
_MASK32 = np.uint64(0xFFFFFFFF)


class PackedPostings:
    """Immutable bitpacked ids + f32 weights for one flat posting array."""

    __slots__ = ("n", "base", "widths", "delta", "word_offs", "words", "weights")

    def __init__(self, n, base, widths, delta, word_offs, words, weights):
        self.n = n
        self.base = base          # [n_chunks] int64 first id of each chunk
        self.widths = widths      # [n_chunks] uint8 bits per value
        self.delta = delta        # [n_chunks] bool: delta vs absolute mode
        self.word_offs = word_offs  # [n_chunks] int64 offset into words
        self.words = words        # [W] uint32 packed payload
        self.weights = weights    # [n] f32 (unpacked, exact)

    # ------------------------------------------------------------------
    @classmethod
    def pack(cls, ids: np.ndarray, weights: np.ndarray) -> "PackedPostings":
        ids = np.asarray(ids)
        weights = np.ascontiguousarray(weights, dtype=np.float32)
        n = len(ids)
        if n == 0:
            return cls(
                0,
                np.zeros(0, np.int64),
                np.zeros(0, np.uint8),
                np.zeros(0, bool),
                np.zeros(0, np.int64),
                np.zeros(0, np.uint32),
                weights,
            )
        if ids.min() < 0:
            raise ValueError("posting ids must be non-negative")
        n_chunks = (n + CHUNK - 1) // CHUNK
        a = np.empty(n_chunks * CHUNK, np.int64)
        a[:n] = ids
        a[n:] = int(ids[-1])  # pad repeats the last id (delta 0)
        a = a.reshape(n_chunks, CHUNK)
        base = a[:, 0].copy()
        d = np.diff(a, axis=1)
        delta = (d >= 0).all(axis=1)
        vals = np.empty_like(a)
        vals[:, 0] = 0
        vals[:, 1:] = d
        vals = np.where(delta[:, None], vals, a).astype(np.uint64)
        maxv = vals.max(axis=1)
        widths = np.zeros(n_chunks, np.uint8)
        nz = maxv > 0
        # exact for maxv < 2^53; posting ids/deltas are < 2^31
        widths[nz] = (
            np.floor(np.log2(maxv[nz].astype(np.float64))).astype(np.uint8) + 1
        )
        words_per = (widths.astype(np.int64) * CHUNK + 31) // 32
        word_offs = np.concatenate([[0], np.cumsum(words_per)])
        words = np.zeros(int(word_offs[-1]), np.uint32)
        for b in np.unique(widths):
            b = int(b)
            if b == 0:
                continue
            sel = np.flatnonzero(widths == b)
            v = vals[sel]  # [C, 128] uint64, each < 2^b
            w_cnt = (b * CHUNK + 31) // 32
            out = np.zeros((len(sel), w_cnt + 1), np.uint32)
            for lane in range(CHUNK):
                p = lane * b
                wi, sh = p // 32, np.uint64(p % 32)
                x = v[:, lane]
                out[:, wi] |= ((x << sh) & _MASK32).astype(np.uint32)
                if sh:
                    out[:, wi + 1] |= (x >> (np.uint64(32) - sh)).astype(
                        np.uint32
                    )
            idx = word_offs[sel][:, None] + np.arange(w_cnt)[None, :]
            words[idx.ravel()] = out[:, :w_cnt].ravel()
        return cls(n, base, widths, delta, word_offs[:-1], words, weights)

    # ------------------------------------------------------------------
    def unpack(self) -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids [n] int32, weights [n] f32) — exact roundtrip."""
        if self.n == 0:
            return np.zeros(0, np.int32), self.weights
        n_chunks = len(self.base)
        vals = np.zeros((n_chunks, CHUNK), np.uint64)
        for b in np.unique(self.widths):
            b = int(b)
            if b == 0:
                continue
            sel = np.flatnonzero(self.widths == b)
            w_cnt = (b * CHUNK + 31) // 32
            idx = self.word_offs[sel][:, None] + np.arange(w_cnt)[None, :]
            blk = np.zeros((len(sel), w_cnt + 1), np.uint64)
            blk[:, :w_cnt] = self.words[idx.ravel()].reshape(len(sel), w_cnt)
            mask = np.uint64((1 << b) - 1)
            for lane in range(CHUNK):
                p = lane * b
                wi, sh = p // 32, np.uint64(p % 32)
                x = blk[:, wi] >> sh
                if sh:
                    x |= blk[:, wi + 1] << (np.uint64(32) - sh)
                vals[sel, lane] = x & mask
            del blk
        ids = np.where(
            self.delta[:, None],
            self.base[:, None] + np.cumsum(vals, axis=1).astype(np.int64),
            vals.astype(np.int64),
        )
        return ids.reshape(-1)[: self.n].astype(np.int32), self.weights

    # ------------------------------------------------------------------
    @property
    def packed_nbytes(self) -> int:
        return int(
            self.words.nbytes
            + self.base.nbytes
            + self.widths.nbytes
            + self.delta.nbytes
            + self.word_offs.nbytes
        )

    def memory_usage_bytes(self):
        return {
            "host_bytes": self.packed_nbytes + int(self.weights.nbytes),
            "device_bytes": 0,
            "disk_bytes": 0,
        }
