"""Sparse vector storage + inverted index (counterpart of
qdrant_tpu/index/sparse.py).

Reference: lib/sparse/ (InvertedIndexRam / compressed / mmap variants,
vector storage in lib/segment's sparse storages) and the IDF modifier
(lib/segment/src/index/vector_index_base.rs:57 fill_idf_statistics).

Host keeps per-point sparse rows (mutable, append-only); the index compacts
a CSR inverted index whose flat arrays live on the device for the search
programs of ops/sparse.py. The host side (store, CSR build, hot / window /
forward tables, query preparation) is the JAX package's numpy code, so the
tables are bit-identical to its own and a `sparse_*/` directory written by
either package loads in the other; the device side is torch.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import default_device, tensor_bytes
from ..ops.sparse import sparse_search
from ..types import SparseVector

# posting window cap on device: longest postings are truncated to the
# heaviest `WINDOW` entries (weight-sorted), qdrant-style pruning analogue
DEFAULT_WINDOW = 4096


def _sort_by_key_desc_weight(keys: np.ndarray, w: np.ndarray) -> np.ndarray:
    """argsort by (key asc, |w| desc) via ONE combined int64 key (faster
    than np.lexsort at tens of millions of postings). Non-negative f32 bit patterns
    are monotonic, so (0x7FFFFFFF - bits(|w|)) orders descending. Keys must
    fit in 32 bits (u32 dims / point offsets)."""
    bits = np.abs(w).astype(np.float32).view(np.int32).astype(np.int64)
    # key * 2^31 + 31-bit weight part: max key 2^32-1 lands exactly at
    # int64 max, no overflow
    combined = keys.astype(np.int64) * (1 << 31) + (0x7FFFFFFF - bits)
    return np.argsort(combined, kind="stable")


class SparseVectorStore:
    """Per-point sparse rows, host-resident."""

    def __init__(self):
        self._indices: List[Optional[np.ndarray]] = []
        self._values: List[Optional[np.ndarray]] = []
        self._count = 0
        self._deleted_count = 0
        # flat-concat cache: (all_dims, all_w, row_lens, row_offsets) over
        # LIVE rows — np.concatenate over a million per-row arrays is slow,
        # so it runs once and invalidates on mutation (add_flat seeds it for
        # free)
        self._flat: Optional[Tuple] = None

    def __len__(self) -> int:
        return self._count

    @property
    def deleted_count(self) -> int:
        return self._deleted_count

    @property
    def available_count(self) -> int:
        return self._count - self._deleted_count

    def memory_usage_bytes(self):
        """Host bytes of the live rows + flat-concat cache. Per-row numpy
        object overhead (~160 B/row) is excluded — posting payload bytes
        dominate at any scale where the number matters."""
        from ..utils.memsize import merge, sizeof, sizeof_attrs

        rows = sum(
            i.nbytes + v.nbytes
            for i, v in zip(self._indices, self._values)
            # views (add_flat rows share the _flat base arrays, counted
            # below) would double the payload bytes
            if i is not None and v is not None and i.base is None
        )
        acc = merge(sizeof_attrs(self, "_flat"))
        acc["host_bytes"] += rows
        return acc

    def add(self, vectors: List[SparseVector]) -> np.ndarray:
        offsets = []
        self._flat = None
        for vec in vectors:
            sv = vec.sorted()
            self._indices.append(np.asarray(sv.indices, dtype=np.int64))
            self._values.append(np.asarray(sv.values, dtype=np.float32))
            offsets.append(self._count)
            self._count += 1
        return np.asarray(offsets, dtype=np.int32)

    def flat_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """→ (all_dims, all_w, row_lens, row_offsets) concatenated over
        live rows, cached until the next mutation."""
        if self._flat is None:
            live = [
                (off, i, v)
                for off, (i, v) in enumerate(zip(self._indices, self._values))
                if i is not None
            ]
            if live:
                all_dims = np.concatenate([r[1] for r in live])
                all_w = np.concatenate([r[2] for r in live]).astype(np.float32)
                lens = np.asarray([len(r[1]) for r in live], dtype=np.int64)
                offs = np.asarray([r[0] for r in live], dtype=np.int64)
            else:
                all_dims = np.zeros(0, np.int64)
                all_w = np.zeros(0, np.float32)
                lens = np.zeros(0, np.int64)
                offs = np.zeros(0, np.int64)
            self._flat = (all_dims, all_w, lens, offs)
        return self._flat

    def add_flat(
        self, lens: np.ndarray, indices: np.ndarray, values: np.ndarray
    ) -> np.ndarray:
        """Bulk ingest from flat CSR-style arrays (row i owns
        indices[bounds[i]:bounds[i+1]]). Rows must be index-sorted with no
        duplicate dims — the vectorized path skips the per-row
        normalization that `add` performs."""
        lens = np.asarray(lens, dtype=np.int64)
        indices = np.asarray(indices, dtype=np.int64)
        values = np.asarray(values, dtype=np.float32)
        bounds = np.concatenate([[0], np.cumsum(lens)])
        offsets = np.arange(self._count, self._count + len(lens), dtype=np.int32)
        for i in range(len(lens)):
            self._indices.append(indices[bounds[i] : bounds[i + 1]])
            self._values.append(values[bounds[i] : bounds[i + 1]])
        if self._count == 0 and self._flat is None:
            # seed the flat cache — the bulk arrays ARE the concatenation
            self._flat = (indices, values, lens, offsets.astype(np.int64))
        else:
            self._flat = None
        self._count += len(lens)
        return offsets

    def set(self, offset: int, vector: SparseVector) -> None:
        sv = vector.sorted()
        self._flat = None
        if self._indices[offset] is None:
            self._deleted_count -= 1
        self._indices[offset] = np.asarray(sv.indices, dtype=np.int64)
        self._values[offset] = np.asarray(sv.values, dtype=np.float32)

    def delete(self, offset: int) -> bool:
        if offset >= self._count or self._indices[offset] is None:
            return False
        self._indices[offset] = None
        self._values[offset] = None
        self._deleted_count += 1
        self._flat = None
        return True

    def is_deleted(self, offset: int) -> bool:
        return offset >= self._count or self._indices[offset] is None

    def get(self, offset: int) -> Optional[SparseVector]:
        if self.is_deleted(offset):
            return None
        return SparseVector(
            self._indices[offset].tolist(), self._values[offset].tolist()
        )

    def iter_rows(self):
        for off in range(self._count):
            if self._indices[off] is not None:
                yield off, self._indices[off], self._values[off]

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        lens = np.asarray(
            [0 if i is None else len(i) for i in self._indices], dtype=np.int64
        )
        deleted = np.asarray([i is None for i in self._indices], dtype=bool)
        if self._count:
            all_idx = np.concatenate(
                [i for i in self._indices if i is not None]
                or [np.zeros(0, dtype=np.int32)]
            )
            all_val = np.concatenate(
                [v for v in self._values if v is not None]
                or [np.zeros(0, dtype=np.float32)]
            )
        else:
            all_idx = np.zeros(0, dtype=np.int32)
            all_val = np.zeros(0, dtype=np.float32)
        np.savez(
            os.path.join(path, "sparse.npz"),
            lens=lens,
            deleted=deleted,
            indices=all_idx,
            values=all_val,
        )

    @classmethod
    def load(cls, path: str) -> "SparseVectorStore":
        store = cls()
        file = os.path.join(path, "sparse.npz")
        if not os.path.exists(file):
            return store
        data = np.load(file)
        lens, deleted = data["lens"], data["deleted"]
        all_idx, all_val = data["indices"], data["values"]
        pos = 0
        for i, ln in enumerate(lens):
            if deleted[i]:
                store._indices.append(None)
                store._values.append(None)
                store._deleted_count += 1
            else:
                store._indices.append(all_idx[pos : pos + ln].copy())
                store._values.append(all_val[pos : pos + ln].copy())
            pos += int(ln)
            store._count += 1
        return store


class SparseIndex:
    """Inverted index over a SparseVectorStore with a device CSR mirror.

    Two device formulations (ops/sparse.py):

    * **Hybrid (default at scale)** — the top-H highest-df terms live as a
      dense [N, H] f32 matrix scored block-wise in one product; cold terms
      (whose postings are all shorter than the H-th hottest by
      construction) go through a windowed gather + scatter-add, and the
      oversampled winners are f32-rescored against the hot rows and the
      cold forward rows inside the same call.
    * **Legacy windowed** (small stores, or `QDRANT_TPU_SPARSE_EXACT=1`) —
      impact-budgeted chunk SpMV, optionally chunking every posting for
      bit-exact scores.
    """

    def __init__(self, store: SparseVectorStore, modifier: Optional[str] = None):
        self.store = store
        self.modifier = modifier  # None | "idf"
        self._dev: Optional[Tuple] = None
        self._dirty = True
        self._packed = None  # bitpacked host CSR (large sealed stores)

    def invalidate(self) -> None:
        self._dirty = True

    def memory_usage_bytes(self):
        """Host (CSR arrays, chunk-max tables) + device (padded postings,
        hot matrix, forward rescore rows) byte accounting. The reference
        sizes its inverted index for telemetry/optimizers
        (lib/sparse/src/index/inverted_index/mod.rs); here the dominant
        entries are the [N, H] hot matrix and forward tables on the device."""
        from ..utils.memsize import merge, sizeof, sizeof_attrs

        tensors = []
        for attr in ("_dev", "_hot", "_fwd", "_fwd_cold", "_win", "_mask_cache"):
            val = getattr(self, attr, None)
            for t in val if isinstance(val, tuple) else (val,):
                if isinstance(t, torch.Tensor):
                    tensors.append(t)
        return merge(
            sizeof(self.store),
            sizeof_attrs(  # the numpy members; the walker does not know torch
                self,
                "_csr_host",
                "_packed",
                "_tids_store",
                "_dim_maxes",
                "_chunk_maxes",
                "_hot",
                "_win",
            ),
            {"device_bytes": tensor_bytes(*tensors)},
        )

    def _build_csr_arrays(self):
        """Compact postings (dim → [offsets, weights] weight-sorted desc)
        plus the sorted dim table as ARRAYS (queries look dims up with one
        vectorized searchsorted instead of a python dict lookup per term).

        → (flat_ids [L], flat_w [L], sorted_dims [U], d_starts [U],
           d_lens [U])"""
        all_dims, all_w, row_lens, row_offs = self.store.flat_arrays()
        if len(all_dims) == 0:
            return (
                np.zeros(0, dtype=np.int32),
                np.zeros(0, dtype=np.float32),
                np.zeros(0, dtype=np.int64),
                np.zeros(0, dtype=np.int32),
                np.zeros(0, dtype=np.int32),
            )
        all_offs = np.repeat(row_offs.astype(np.int32), row_lens)
        # At SPLADE scale the (dim, |w| desc) combined-key sort is the
        # slowest host step; weight order WITHIN a posting list only matters for
        # the legacy windowed truncation (small stores) — the hybrid path
        # covers every cold chunk and takes chunk maxes via reduceat. So:
        # big stores sort by dim only (radix), small stores keep the full
        # weight-sorted order.
        self._postings_weight_sorted = len(all_dims) <= 5_000_000
        if self._postings_weight_sorted:
            order = _sort_by_key_desc_weight(all_dims, all_w)
        elif all_dims.max(initial=0) < 2**31:
            # the int32 radix argsort beats the int64 one
            order = np.argsort(all_dims.astype(np.int32), kind="stable")
        else:
            # hashed-vocabulary dims (murmur3/BM25 token ids) exceed int31 —
            # a cast would wrap negative and break every searchsorted lookup
            order = np.argsort(all_dims, kind="stable")
        flat_ids = np.ascontiguousarray(all_offs[order])
        flat_w = np.ascontiguousarray(all_w[order])
        dims_sorted = all_dims[order]
        # boundaries of the sorted dim runs (np.unique would re-sort)
        change = np.flatnonzero(np.diff(dims_sorted)) + 1
        starts = np.concatenate([[0], change]).astype(np.int64)
        uniq = dims_sorted[starts]
        counts = np.diff(np.concatenate([starts, [len(dims_sorted)]]))
        # per-posting compact tid in STORE order — _fwd_cold_device reuses
        # this instead of a fresh searchsorted over every posting
        tids_store = np.empty(len(all_dims), dtype=np.int32)
        tids_store[order] = np.repeat(
            np.arange(len(uniq), dtype=np.int32), counts
        )
        self._tids_store = tids_store
        return (
            flat_ids,
            flat_w,
            uniq.astype(np.int64),
            starts.astype(np.int32),
            counts.astype(np.int32),
        )

    def _csr_flats(self) -> Tuple[np.ndarray, np.ndarray]:
        """Flat (ids, weights) of the sealed CSR. Large stores retain only
        the bitpacked form (index/postings.py — the reference keeps
        compressed inverted indexes resident, lib/posting_list/src/lib.rs:16);
        the raw arrays are decoded on access, which only the rare rebuild
        paths (top-W window extraction) pay."""
        fi, fw = self._csr_host[0], self._csr_host[1]
        if fi is not None:
            return fi, fw
        ids, w = self._packed.unpack()
        return ids, w

    def _device(self):
        if self._dirty or self._dev is None:
            csr = self._build_csr_arrays()
            flat_ids, flat_w, sorted_dims, d_starts, d_lens = csr
            self._csr_host = csr
            # pad flat arrays so any window slice is in-bounds
            pad = DEFAULT_WINDOW
            flat_ids_p = np.concatenate(
                [flat_ids, np.full(pad, len(self.store), dtype=np.int32)]
            )
            flat_w_p = np.concatenate([flat_w, np.zeros(pad, dtype=np.float32)])
            n_pad = max(8, 1 << (max(len(self.store), 1) - 1).bit_length())
            dim_table: Dict[int, Tuple[int, int]] = {
                int(d): (int(s), int(c))
                for d, s, c in zip(sorted_dims, d_starts, d_lens)
            }
            self._dev = None  # free the old tables before the new upload
            self._hot = self._fwd = self._fwd_cold = self._win = None
            self._mask_cache = None
            dev = default_device()
            self._dev = (
                torch.from_numpy(flat_ids_p).to(dev),
                torch.from_numpy(flat_w_p).to(dev),
                dim_table,
                n_pad,
            )
            # per-dim (and per-chunk) max-weights — drive impact-ordered
            # chunk selection at query time (the WAND max_next_weight
            # analogue, search_context.rs:25-80). Weight-sorted postings:
            # a chunk's max is its first entry; dim-sorted (big stores):
            # one reduceat pass gives per-dim maxes, used as the bound for
            # every chunk of that dim.
            self._chunk_maxes = {}
            if len(d_starts):
                self._dim_maxes = np.maximum.reduceat(
                    np.abs(flat_w), d_starts.astype(np.int64)
                )
            else:
                self._dim_maxes = np.zeros(0, np.float32)
            ws = getattr(self, "_postings_weight_sorted", True)
            for i, (d, start, ln) in enumerate(
                zip(sorted_dims, d_starts, d_lens)
            ):
                pos = np.arange(start, start + ln, DEFAULT_WINDOW)
                if ws:
                    self._chunk_maxes[int(d)] = np.abs(flat_w[pos])
                else:
                    self._chunk_maxes[int(d)] = np.full(
                        len(pos), self._dim_maxes[i], dtype=np.float32
                    )
            self._dirty = False
            self._fwd = None  # forward rows rebuild lazily
            self._fwd_cold = None
            self._win = None  # top-W window CSR rebuilds lazily
            self._hot = None  # hot matrix rebuilds lazily
            self._hot_built = False
            self._mask_cache = None
            # large sealed stores keep the host CSR ids bitpacked only
            # (much smaller; the device holds its own padded copy) —
            # small/dynamic stores skip the pack cost on every rebuild
            pack_min = int(
                os.environ.get("QDRANT_TPU_SPARSE_PACK_MIN", 2_000_000)
            )
            if len(flat_ids) >= pack_min:
                from .postings import PackedPostings

                self._packed = PackedPostings.pack(flat_ids, flat_w)
                self._csr_host = (None, None, sorted_dims, d_starts, d_lens)
            else:
                self._packed = None
        return self._dev

    # -- hybrid hot/cold split -------------------------------------------

    def _hot_device(self):
        """Build (lazily) the dense hot-term matrix for the hybrid path.

        → (hot [N_pad, H] f32, hot_col_of_dim [U] int32 host) or None when
        the store is too small / budget is 0. f32 (not bf16): with true f32
        products the hot contribution is exact to f32 rounding, so the
        candidate rescore only needs the narrow COLD forward rows
        (_fwd_cold_device), not a full-row table."""
        self._device()
        if self._hot_built:
            return self._hot
        self._hot_built = True
        flat_ids_d, flat_w_d, _table, n_pad = self._dev
        _fi, _fw, sorted_dims, d_starts, d_lens = self._csr_host
        u = len(sorted_dims)
        budget = int(
            os.environ.get("QDRANT_TPU_SPARSE_HOT_BYTES", 4_600_000_000)
        )
        cap = int(os.environ.get("QDRANT_TPU_SPARSE_HOT_MAX", 4096))
        h = min(cap, budget // max(4 * n_pad, 1))
        if u == 0 or n_pad < 1024 or h < 128:
            self._hot = None
            return None
        h = 1 << (h.bit_length() - 1)  # pow2 floor
        u_pow = 1 << max(u - 1, 0).bit_length() if u > 1 else 8
        h = min(h, max(u_pow, 128))
        # hot columns = top-h dims by document frequency
        n_hot = min(h, u)
        top = np.argsort(-d_lens, kind="stable")[:n_hot]
        hot_col_of_dim = np.full(u, -1, dtype=np.int32)
        hot_col_of_dim[top] = np.arange(n_hot, dtype=np.int32)
        from ..ops.sparse import build_hot_matrix

        dev = flat_ids_d.device
        hot = build_hot_matrix(
            flat_ids_d,
            flat_w_d,
            torch.from_numpy(np.ascontiguousarray(d_starts)).to(dev),
            torch.from_numpy(hot_col_of_dim).to(dev),
            torch.zeros((n_pad, h), dtype=torch.float32, device=dev),
        )
        self._hot = (hot, hot_col_of_dim)
        return self._hot

    def _forward_device(self):
        """Device forward rows [N_pad, J] (compact term ids + weights) for
        exact candidate rescoring. Term ids are the rank of each dim in the
        sorted dim table; rows longer than J keep their J HEAVIEST entries
        (weight-sorted — keeping the first J in dim order silently dropped
        a long row's heaviest terms). Returns None when the store is empty
        or the table would exceed the device budget (rescore then falls
        back to windowed scores)."""
        if getattr(self, "_fwd", None) is not None:
            return self._fwd
        self._device()
        _fi, _fw, sorted_dims, _ds, _dl = self._csr_host
        n_pad = self._dev[3]
        if len(sorted_dims) == 0:
            return None
        tid_of = {int(d): i for i, d in enumerate(sorted_dims)}
        all_dims, all_w, row_lens, row_offs = self.store.flat_arrays()
        lens_arr = row_lens if len(row_lens) else np.asarray([1])
        j_need = int(np.percentile(lens_arr, 99.5))
        j = max(8, 1 << (max(j_need, 1) - 1).bit_length())
        j = min(j, 512)
        budget = int(
            os.environ.get("QDRANT_TPU_SPARSE_FWD_MAX_BYTES", 2_000_000_000)
        )
        if n_pad * j * 8 > budget:
            self._fwd = None
            return None
        terms = np.full((n_pad, j), -1, dtype=np.int32)
        weights = np.zeros((n_pad, j), dtype=np.float32)
        if len(all_dims):
            # fully vectorized: one searchsorted over every posting, then a
            # (row, within-row-position) scatter
            all_offs = np.repeat(row_offs, row_lens)
            tids = np.searchsorted(sorted_dims, all_dims)
            tids = np.clip(tids, 0, len(sorted_dims) - 1)
            valid = sorted_dims[tids] == all_dims
            starts = np.concatenate([[0], np.cumsum(row_lens)[:-1]])
            within = np.arange(len(all_dims)) - np.repeat(starts, row_lens)
            # truncation at J must keep each row's HEAVIEST terms — but
            # only rows longer than J (~0.5% by construction of J) need a
            # weight sort; everyone else keeps all entries in stored order.
            long_rows = row_lens > j
            if long_rows.any():
                sel = np.repeat(long_rows, row_lens)
                l_offs, l_w = all_offs[sel], all_w[sel]
                order = _sort_by_key_desc_weight(l_offs, l_w)
                l_offs = l_offs[order]
                l_w = l_w[order]
                l_tids = tids[sel][order]
                l_valid = valid[sel][order]
                l_lens = row_lens[long_rows]
                l_starts = np.concatenate([[0], np.cumsum(l_lens)[:-1]])
                l_within = np.arange(len(l_offs)) - np.repeat(l_starts, l_lens)
                keep = l_valid & (l_within < j)
                terms[l_offs[keep], l_within[keep]] = l_tids[keep].astype(
                    np.int32
                )
                weights[l_offs[keep], l_within[keep]] = l_w[keep]
                short = ~np.repeat(long_rows, row_lens)
                keep = valid & short
            else:
                keep = valid
            terms[all_offs[keep], within[keep]] = tids[keep].astype(np.int32)
            weights[all_offs[keep], within[keep]] = all_w[keep]
        # packed [N_pad, 2J] int32: [tids | f32 weight bits] — one device
        # row gather per candidate in the rescore instead of two
        packed = np.concatenate([terms, weights.view(np.int32)], axis=1)
        self._fwd = (torch.from_numpy(packed).to(default_device()), tid_of)
        return self._fwd

    def _window_device(self):
        """Top-W window CSR for the hybrid SELECTION pass: per dim, its W
        heaviest postings as a compact device CSR (w_ids, w_w) with host
        (w_starts, w_lens). This preserves the WAND max_next_weight
        invariant (search_context.rs:25-80) WITHOUT weight-sorting the full
        CSR: Σ min(df, W) is a few percent of the postings, extracted with
        one argpartition per dim and uploaded once."""
        if getattr(self, "_win", None) is not None:
            return self._win
        self._device()
        _fi, _fw, sorted_dims, d_starts, d_lens = self._csr_host
        flat_ids, flat_w = self._csr_flats()
        u = len(sorted_dims)
        if u == 0:
            return None
        w_cap = int(os.environ.get("QDRANT_TPU_SPARSE_WINDOW", 64))
        w_lens = np.minimum(d_lens, w_cap).astype(np.int32)
        w_starts = np.concatenate([[0], np.cumsum(w_lens)[:-1]]).astype(
            np.int32
        )
        total = int(w_lens.sum())
        n = len(self.store)
        w_ids = np.full(total + w_cap, n, dtype=np.int32)
        w_w = np.zeros(total + w_cap, dtype=np.float32)
        ws = getattr(self, "_postings_weight_sorted", True)
        for i in range(u):
            s, ln, wl = int(d_starts[i]), int(d_lens[i]), int(w_lens[i])
            dst = slice(int(w_starts[i]), int(w_starts[i]) + wl)
            if ws or ln <= wl:
                w_ids[dst] = flat_ids[s : s + wl]
                w_w[dst] = flat_w[s : s + wl]
            else:
                seg_w = flat_w[s : s + ln]
                idx = np.argpartition(-np.abs(seg_w), wl - 1)[:wl]
                w_ids[dst] = flat_ids[s : s + ln][idx]
                w_w[dst] = seg_w[idx]
        dev = default_device()
        self._win = (
            torch.from_numpy(w_ids).to(dev), torch.from_numpy(w_w).to(dev),
            w_starts, w_lens,
        )
        return self._win

    def _fwd_cold_device(self):
        """Cold-only packed forward rows [N_pad, 2*Jc] int32 for the exact
        hybrid rescore: per point, only the entries whose dim is NOT a hot
        column (those score exactly through the hot matrix), as
        [compact tids | f32 weight bits]. Hot terms absorb the head of the
        document-frequency distribution, so cold rows are several times
        narrower than full forward rows — and the rescore's element-gather
        count (B*k_fetch*Jc) shrinks with them. Rows with more than Jc cold
        entries keep their Jc
        HEAVIEST (weight-sorted before truncation); Jc is the 99.9th
        percentile, so this touches ~0.1% of rows."""
        if getattr(self, "_fwd_cold", None) is not None:
            return self._fwd_cold
        if self._hot is None:
            return None
        _hot, hot_col_of_dim = self._hot
        _fi, _fw, sorted_dims, _ds, _dl = self._csr_host
        n_pad = self._dev[3]
        if len(sorted_dims) == 0:
            return None
        all_dims, all_w, row_lens, row_offs = self.store.flat_arrays()
        if not len(all_dims):
            return None
        all_offs = np.repeat(row_offs, row_lens)
        tids = getattr(self, "_tids_store", None)
        if tids is None or len(tids) != len(all_dims):
            tids = np.searchsorted(sorted_dims, all_dims)
            tids = np.clip(tids, 0, len(sorted_dims) - 1)
            valid = sorted_dims[tids] == all_dims
        else:
            valid = np.ones(len(all_dims), bool)  # cache covers live rows
        coldmask = valid & (hot_col_of_dim[tids] < 0)
        s_offs = all_offs[coldmask].astype(np.int64)
        s_w = all_w[coldmask]
        s_tids = tids[coldmask].astype(np.int32)
        n_rows = len(self.store)
        c_lens = np.bincount(s_offs, minlength=n_rows).astype(np.int64)
        jc_need = int(np.percentile(c_lens, 99.9)) if len(c_lens) else 1
        jc = max(8, 1 << (max(jc_need, 1) - 1).bit_length())
        jc = min(jc, 256)
        budget = int(
            os.environ.get("QDRANT_TPU_SPARSE_FWD_MAX_BYTES", 2_000_000_000)
        )
        if n_pad * jc * 8 > budget:
            self._fwd_cold = None
            return None
        terms = np.full((n_pad, jc), -1, dtype=np.int32)
        weights = np.zeros((n_pad, jc), dtype=np.float32)
        # within-row positions over the cold subset (entries arrive in
        # row-major store order, so positions are a prefix-sum offset)
        starts = np.concatenate([[0], np.cumsum(c_lens)[:-1]])
        within = np.arange(len(s_offs)) - starts[s_offs]
        long_rows = c_lens > jc
        if long_rows.any():
            sel = long_rows[s_offs]
            l_offs, l_w, l_tids = s_offs[sel], s_w[sel], s_tids[sel]
            order = np.lexsort((-np.abs(l_w), l_offs))
            l_offs, l_w, l_tids = l_offs[order], l_w[order], l_tids[order]
            l_lens = c_lens[long_rows]
            l_starts = np.concatenate([[0], np.cumsum(l_lens)[:-1]])
            l_within = np.arange(len(l_offs)) - np.repeat(l_starts, l_lens)
            keep = l_within < jc
            terms[l_offs[keep], l_within[keep]] = l_tids[keep]
            weights[l_offs[keep], l_within[keep]] = l_w[keep]
            keep = ~sel
        else:
            keep = np.ones(len(s_offs), bool)
        terms[s_offs[keep], within[keep]] = s_tids[keep]
        weights[s_offs[keep], within[keep]] = s_w[keep]
        packed = np.concatenate([terms, weights.view(np.int32)], axis=1)
        self._fwd_cold = torch.from_numpy(packed).to(default_device())
        return self._fwd_cold

    def idf(self, dim: int) -> float:
        """BM25-style IDF (reference: idf_statistics / modifier=idf)."""
        _, _, dim_table, _ = self._device()
        n = self.store.available_count
        df = dim_table.get(int(dim), (0, 0))[1]
        return math.log(((n - df + 0.5) / (df + 0.5)) + 1.0)

    def remap_query(self, query: SparseVector) -> SparseVector:
        if self.modifier == "idf":
            return SparseVector(
                list(query.indices),
                [w * self.idf(d) for d, w in zip(query.indices, query.values)],
            )
        return query

    def search(
        self,
        queries: List[SparseVector],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
        window: int = DEFAULT_WINDOW,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores [B, k], offsets [B, k]); -1 = no result.

        Default path at scale: hot-dense + cold-sparse hybrid with fused
        exact rescore (ops/sparse.py::sparse_hybrid_search) — exact scores
        for every returned point. Small stores and
        QDRANT_TPU_SPARSE_EXACT=1 use the windowed/chunked SpMV (exact f32
        up to summation order in exact mode). QDRANT_TPU_SPARSE_RESCORE=0
        disables the rescore phase on the legacy path."""
        if not queries:
            return (
                np.zeros((0, k), np.float32),
                np.full((0, k), -1, np.int32),
            )
        if self._hybrid_ready():
            out = [
                self._search_hybrid(
                    queries[i : i + 256], k, filter_mask, window
                )
                for i in range(0, len(queries), 256)
            ]
            return (
                np.concatenate([o[0] for o in out]),
                np.concatenate([o[1] for o in out]),
            )
        return self._search_legacy(queries, k, filter_mask, window)

    def _hybrid_ready(self) -> bool:
        from ..utils.flags import flag_env

        if flag_env("sparse_exact_search", "QDRANT_TPU_SPARSE_EXACT"):
            return False
        return (
            self._hot_device() is not None
            and self._fwd_cold_device() is not None
            and self._window_device() is not None
        )

    def search_many(
        self,
        batches: List[List[SparseVector]],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
        window: int = DEFAULT_WINDOW,
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Pipelined multi-batch sparse search: launch every batch's device
        work before syncing any result, then fetch ALL results in one
        device→host copy, as the dense scan does.
        → one (scores [B_i, k], ids [B_i, k]) per batch."""
        if not self._hybrid_ready():
            return [
                self.search(q, k, filter_mask=filter_mask, window=window)
                for q in batches
            ]
        from .plain import fetch_to_host

        handles = []
        for q in batches:
            handles.append(
                [
                    self._search_hybrid_dispatch(
                        q[i : i + 256], k, filter_mask, window
                    )
                    for i in range(0, len(q), 256)
                ]
            )
        flat = [h for hs in handles for h in hs]
        fetched = fetch_to_host([(s, i) for s, i, _, _ in flat])
        by_id = {id(h): f for h, f in zip(flat, fetched)}
        out = []
        for chunk_handles in handles:
            parts = [
                self._finish_hybrid(*by_id[id(h)], h[2], h[3])
                for h in chunk_handles
            ]
            if not parts:
                out.append(
                    (
                        np.zeros((0, k), np.float32),
                        np.full((0, k), -1, np.int32),
                    )
                )
                continue
            out.append(
                (
                    np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]),
                )
            )
        return out

    def _remap_weights_idf(
        self, qidx: np.ndarray, tids: np.ndarray, w: np.ndarray
    ) -> np.ndarray:
        """Vectorized BM25-IDF weighting for the hybrid path."""
        if self.modifier != "idf":
            return w
        _fi, _fw, _sd, _ds, d_lens = self._csr_host
        n = self.store.available_count
        df = d_lens[tids].astype(np.float64)
        return (w * np.log((n - df + 0.5) / (df + 0.5) + 1.0)).astype(
            np.float32
        )

    def _search_hybrid(
        self,
        queries: List[SparseVector],
        k: int,
        filter_mask: Optional[np.ndarray],
        window: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        from .plain import fetch_to_host

        s_dev, i_dev, b, kk = self._search_hybrid_dispatch(
            queries, k, filter_mask, window
        )
        [(s_host, i_host)] = fetch_to_host([(s_dev, i_dev)])
        return self._finish_hybrid(s_host, i_host, b, kk)

    @staticmethod
    def _finish_hybrid(s_host, i_host, b, k) -> Tuple[np.ndarray, np.ndarray]:
        scores = np.asarray(s_host, dtype=np.float32)[:b]
        ids = np.asarray(i_host, dtype=np.int32)[:b]
        ids = np.where(np.isfinite(scores), ids, -1)
        k_eff = scores.shape[1]
        if k_eff < k:
            scores = np.pad(
                scores, ((0, 0), (0, k - k_eff)), constant_values=-np.inf
            )
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return scores, ids

    def _search_hybrid_dispatch(
        self,
        queries: List[SparseVector],
        k: int,
        filter_mask: Optional[np.ndarray],
        window: int,
    ):
        """Async: launch the hybrid device work, return
        (scores_dev, ids_dev, b, k) without waiting for the result."""
        from ..ops.sparse import sparse_hybrid_search

        flat_ids_d, flat_w_d, _table, n_pad = self._dev
        sorted_dims = self._csr_host[2]
        d_starts, d_lens = self._csr_host[3], self._csr_host[4]
        hot, hot_col_of_dim = self._hot
        h = hot.shape[1]
        u = len(sorted_dims)
        b = len(queries)
        # the pow-2 batch / term / entry buckets are the JAX package's
        # (one compiled program per shape there); no result depends on them
        b_pad = max(8, 1 << (b - 1).bit_length())

        # --- vectorized query prep (no per-term python) ---
        q_lens = np.asarray([len(q.indices) for q in queries], dtype=np.int64)
        all_d = (
            np.concatenate([np.asarray(q.indices, dtype=np.int64) for q in queries])
            if q_lens.sum()
            else np.zeros(0, np.int64)
        )
        all_w = (
            np.concatenate([np.asarray(q.values, dtype=np.float32) for q in queries])
            if q_lens.sum()
            else np.zeros(0, np.float32)
        )
        qidx = np.repeat(np.arange(b, dtype=np.int32), q_lens)
        tids = np.searchsorted(sorted_dims, all_d)
        tids = np.clip(tids, 0, max(u - 1, 0))
        valid = (sorted_dims[tids] == all_d) if u else np.zeros(len(all_d), bool)
        qidx, tids, all_w = qidx[valid], tids[valid].astype(np.int32), all_w[valid]
        all_w = self._remap_weights_idf(qidx, tids, all_w)
        # A term repeated inside one query is summed here, in query order,
        # so every slot of the device's dense query vector receives exactly
        # one addend: no returned score depends on the order of an atomic sum.
        key = qidx.astype(np.int64) * max(u, 1) + tids
        if len(key) and len(np.unique(key)) < len(key):
            uniq, inv = np.unique(key, return_inverse=True)
            summed = np.zeros(len(uniq), dtype=np.float32)
            np.add.at(summed, inv, all_w)
            qidx = (uniq // max(u, 1)).astype(np.int32)
            tids, all_w = (uniq % max(u, 1)).astype(np.int32), summed

        # hot query matrix [B, H] built on host (tiny: B x H x 4 bytes)
        hc = hot_col_of_dim[tids]
        hot_sel = hc >= 0
        qhot = np.zeros((b_pad, h), dtype=np.float32)
        np.add.at(qhot, (qidx[hot_sel], hc[hot_sel]), all_w[hot_sel])

        # full query term lists [B, Tq] — the device scatter-builds a dense
        # [B, U] query vector from these for the exact candidate rescore
        q_count = np.bincount(qidx, minlength=b)
        tq = int(q_count.max()) if len(qidx) else 1
        tq_pad = max(8, 1 << (max(tq, 1) - 1).bit_length())
        q_tids = np.full((b_pad, tq_pad), -1, dtype=np.int32)
        q_wmat = np.zeros((b_pad, tq_pad), dtype=np.float32)
        if len(qidx):
            qpos = np.arange(len(qidx)) - np.searchsorted(qidx, np.arange(b))[qidx]
            q_tids[qidx, qpos] = tids
            q_wmat[qidx, qpos] = all_w

        # cold terms ship as per-TERM window descriptors (start, len, qw) —
        # a few KB per batch; the device expands them to entry positions
        # itself. Windows come from the top-W window CSR — each cold
        # term's W heaviest postings (the WAND max_next_weight analogue,
        # search_context.rs:25-80); truncation only affects candidate
        # SELECTION — reported scores are exact via the cold-forward-row
        # rescore.
        w_ids_d, w_w_d, w_starts, w_lens = self._win
        cold = ~hot_sel
        cq, ct, cw = qidx[cold], tids[cold], all_w[cold]
        starts_c = w_starts[ct]
        lens_c = w_lens[ct]
        if len(cq):
            post = np.arange(len(cq)) - np.searchsorted(cq, np.arange(b))[cq]
            tc = int(post.max()) + 1 if len(post) else 1
            totals = np.bincount(cq, weights=lens_c, minlength=b)
            e_max = int(totals.max()) if len(totals) else 1
        else:
            tc, e_max = 1, 1
        t_pad = max(8, 1 << (tc - 1).bit_length())
        e_pad = max(8, 1 << (max(e_max, 1) - 1).bit_length())
        cold_starts = np.zeros((b_pad, t_pad), dtype=np.int32)
        cold_lens = np.zeros((b_pad, t_pad), dtype=np.int32)
        cold_qw = np.zeros((b_pad, t_pad), dtype=np.float32)
        if len(cq):
            cold_starts[cq, post] = starts_c
            cold_lens[cq, post] = lens_c
            cold_qw[cq, post] = cw

        c_min = int(os.environ.get("QDRANT_TPU_SPARSE_CANDIDATES", 256))
        k_fetch = min(max(4 * k, c_min), n_pad)
        u_pad = max(8, 1 << (max(u, 1) - 1).bit_length())
        mask = self._mask_device(filter_mask, n_pad)

        dev = hot.device
        scores, ids = sparse_hybrid_search(
            hot,
            torch.from_numpy(qhot).to(dev),
            w_ids_d,
            w_w_d,
            torch.from_numpy(cold_starts).to(dev),
            torch.from_numpy(cold_lens).to(dev),
            torch.from_numpy(cold_qw).to(dev),
            self._fwd_cold,
            torch.from_numpy(q_tids).to(dev),
            torch.from_numpy(q_wmat).to(dev),
            mask,
            u_pad,
            e_pad,
            k_fetch,
            k,
        )
        return scores, ids, b, k

    def _mask_device(
        self, filter_mask: Optional[np.ndarray], n_pad: int
    ) -> torch.Tensor:
        if filter_mask is None:
            if self._mask_cache is None:
                self._mask_cache = _mask_to_dev(None, n_pad, len(self.store))
            return self._mask_cache
        return _mask_to_dev(filter_mask, n_pad, len(self.store))

    def _search_legacy(
        self,
        queries: List[SparseVector],
        k: int,
        filter_mask: Optional[np.ndarray] = None,
        window: int = DEFAULT_WINDOW,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Windowed/impact-budgeted SpMV (reference: search_context.rs
        exact merge with max_next_weight pruning): a windowed SpMV over the
        heaviest postings yields candidates, then the top max(4k, 128)
        candidates are EXACTLY rescored against the device forward rows.
        QDRANT_TPU_SPARSE_EXACT=1 instead chunks EVERY posting through the
        SpMV (exact f32 scores for all points up to summation order, higher
        cost)."""
        flat_ids, flat_w, dim_table, n_pad = self._device()
        b = len(queries)
        queries = [self.remap_query(q) for q in queries]
        from ..utils.flags import flag_env

        exact = flag_env("sparse_exact_search", "QDRANT_TPU_SPARSE_EXACT")
        rescore = (
            not exact
            and os.environ.get("QDRANT_TPU_SPARSE_RESCORE", "1") != "0"
        )

        entries = []  # per query: [(start, len, weight), ...] posting chunks
        max_chunks = int(
            os.environ.get("QDRANT_TPU_SPARSE_MAX_CHUNKS", 4096)
        )
        # candidate-generation budget: how many posting chunks each query
        # may touch, allocated across terms by IMPACT (query weight x chunk
        # max weight — the WAND max_next_weight bound). One chunk per term
        # only covers each term's heaviest postings; at SPLADE scale the
        # true top-k accumulate from mid-weight postings of many terms, so
        # the budget must reach deep chunks of impactful terms.
        budget = int(os.environ.get("QDRANT_TPU_SPARSE_CHUNK_BUDGET", 512))
        for q in queries:
            row = []
            if exact:
                for d, w in zip(q.indices, q.values):
                    entry = dim_table.get(int(d))
                    if entry is None:
                        continue
                    start, ln = entry
                    off = 0
                    while off < ln and len(row) < max_chunks:
                        row.append((start + off, min(window, ln - off), w))
                        off += window
            else:
                chunks = []  # (impact, start, len, w)
                for d, w in zip(q.indices, q.values):
                    entry = dim_table.get(int(d))
                    if entry is None:
                        continue
                    start, ln = entry
                    maxes = self._chunk_maxes.get(int(d))
                    n_ch = len(maxes) if maxes is not None else 1
                    for j in range(n_ch):
                        off = j * window
                        impact = abs(w) * (
                            float(maxes[j]) if maxes is not None else 1.0
                        )
                        chunks.append(
                            (impact, start + off, min(window, ln - off), w)
                        )
                chunks.sort(key=lambda t: -t[0])
                row = [(s, ln, w) for _imp, s, ln, w in chunks[:budget]]
            entries.append(row)
        t_max = max([len(r) for r in entries] + [1])
        t_pad = max(8, 1 << (t_max - 1).bit_length())
        q_starts = np.full((b, t_pad), -1, dtype=np.int32)
        q_lens = np.zeros((b, t_pad), dtype=np.int32)
        q_w = np.zeros((b, t_pad), dtype=np.float32)
        for i, row in enumerate(entries):
            for j, (s, ln, w) in enumerate(row):
                q_starts[i, j] = s
                q_lens[i, j] = ln
                q_w[i, j] = w

        fwd = self._forward_device() if rescore else None
        c_min = int(os.environ.get("QDRANT_TPU_SPARSE_CANDIDATES", 512))
        k_fetch = (
            min(max(4 * k, c_min), n_pad) if fwd is not None else min(k, n_pad)
        )
        dev = flat_ids.device
        scores, ids = sparse_search(
            flat_ids,
            flat_w,
            torch.from_numpy(q_starts).to(dev),
            torch.from_numpy(q_lens).to(dev),
            torch.from_numpy(q_w).to(dev),
            window,
            n_pad,
            k_fetch,
            _mask_to_dev(filter_mask, n_pad, len(self.store)),
        )
        if fwd is not None:
            from ..ops.sparse import rescore_sparse_packed

            fwd_rows, tid_of = fwd
            v = len(tid_of)
            qvec = np.zeros((b, v), dtype=np.float32)
            for i, q in enumerate(queries):
                for d, w in zip(q.indices, q.values):
                    tid = tid_of.get(int(d))
                    if tid is not None:
                        qvec[i, tid] += w
            cand = torch.where(torch.isfinite(scores), ids, -1)
            exact_scores = rescore_sparse_packed(
                cand, fwd_rows, torch.from_numpy(qvec).to(dev)
            )
            k_eff = min(k, k_fetch)
            scores, ti = torch.topk(exact_scores, k_eff, dim=1)
            ids = torch.gather(cand, 1, ti)
        else:
            k_eff = min(k, n_pad)
            scores, ids = scores[:, :k_eff], ids[:, :k_eff]
        from .plain import fetch_to_host

        [(scores, ids)] = fetch_to_host([(scores, ids)])
        ids = np.where(np.isfinite(scores), ids, -1)
        if k_eff < k:
            scores = np.pad(scores, ((0, 0), (0, k - k_eff)), constant_values=-np.inf)
            ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return scores, ids


def _mask_to_dev(filter_mask: Optional[np.ndarray], n_pad: int, n: int):
    mask = np.zeros(n_pad, dtype=bool)
    if filter_mask is not None:
        mask[: len(filter_mask)] = filter_mask[:n_pad]
    else:
        mask[:n] = True
    return torch.from_numpy(mask).to(default_device())
