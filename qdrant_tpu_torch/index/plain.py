"""Plain (exact full-scan) vector index (counterpart of
qdrant_tpu/index/plain.py).

Segments of SCAN_THRESHOLD rows or more run the fused scan kernel
(ops/fused_scan.py) and an exact f32 rescore of its oversampled winners, on
every shard of the store's mesh ScanIndex where it has one; smaller ones
score every row with one matrix product and a top-k. Either way only [B, k]
scores and ids leave the device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..types import Distance

from ..ops.distances import preprocess_vectors, score_and_topk
from ..storage.vectors import DenseVectorStore

# Above this size the fused scan beats materializing [B, N] scores + top-k.
SCAN_THRESHOLD = 65536


def finalize_device_result(
    scores_host, ids_host, b: int, k_eff: int, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Convert fetched search output to the host (scores, ids) convention:
    trim padding rows, -1 out ids without a finite score, pad columns up to
    k. Shared by the sync and segment-dispatch paths so they cannot drift."""
    scores = np.asarray(scores_host, dtype=np.float32)[:b]
    ids = np.asarray(ids_host, dtype=np.int32)[:b]
    ids = np.where(np.isfinite(scores), ids, -1)
    if k_eff < k:
        scores = np.pad(
            scores, ((0, 0), (0, k - k_eff)), constant_values=-np.inf
        )
        ids = np.pad(ids, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return scores, ids


def fetch_to_host(pairs: List[Tuple[Any, Any]]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Bring device (scores, ids) pairs to the host in ONE device→host copy:
    scores and int32 ids (bit-cast to f32) are flattened, concatenated and
    copied together, then split on the host."""
    if not pairs:
        return []
    parts, shapes = [], []
    for s, i in pairs:
        s = s.to(torch.float32)
        i = i.to(torch.int32)
        shapes.append((s.shape, i.shape))
        parts += [s.reshape(-1), i.reshape(-1).view(torch.float32)]
    flat = torch.cat(parts).cpu().numpy()
    out, off = [], 0
    for s_shape, i_shape in shapes:
        ns, ni = int(np.prod(s_shape)), int(np.prod(i_shape))
        s = flat[off : off + ns].reshape(s_shape)
        i = flat[off + ns : off + ns + ni].view(np.int32).reshape(i_shape)
        out.append((s, i))
        off += ns + ni
    return out


class PlainIndex:
    def __init__(self, store: DenseVectorStore):
        self.store = store

    def search(
        self,
        queries: np.ndarray,  # [B, D] raw (un-preprocessed) queries
        k: int,
        filter_mask: Optional[np.ndarray] = None,  # [n] bool over offsets
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores [B, k], offsets [B, k]); offset -1 = no result."""
        scores_dev, ids_dev, b, k_eff = self.search_device(
            queries, k, filter_mask
        )
        [(s, i)] = fetch_to_host([(scores_dev, ids_dev)])
        return finalize_device_result(s, i, b, k_eff, k)

    def search_many(
        self,
        batches,  # iterable of [B_i, D] query batches
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ):
        """Dispatch every batch before syncing any result, then fetch all of
        them in one device→host copy. → list of (scores, ids)."""
        outs = [self.search_device(q, k, filter_mask) for q in batches]
        fetched = fetch_to_host([(s, i) for s, i, _, _ in outs])
        return [
            finalize_device_result(s, i, b, k_eff, k)
            for (s, i), (_, _, b, k_eff) in zip(fetched, outs)
        ]

    def search_device(
        self,
        queries: np.ndarray,
        k: int,
        filter_mask: Optional[np.ndarray] = None,
    ):
        """Async variant: launches the search and returns DEVICE-resident
        (scores [B', k_eff], ids [B', k_eff], b, k_eff) without waiting for
        the result. Scores are exact (euclid: -(q-v)^2)."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        q = preprocess_vectors(queries, self.store.distance)
        b = q.shape[0]
        if (
            len(self.store) >= SCAN_THRESHOLD
            and self.store.distance is not Distance.MANHATTAN
        ):
            return self._scan_search_device(q, k, filter_mask)
        vectors, valid = self.store.device_block()
        if filter_mask is not None:
            fm = np.zeros(vectors.shape[0], dtype=bool)
            fm[: len(filter_mask)] = filter_mask
            valid = valid & torch.from_numpy(fm).to(valid.device)
        k_eff = min(k, int(vectors.shape[0]))
        scores, ids = score_and_topk(
            torch.from_numpy(q).to(vectors.device), vectors,
            self.store.distance.value, k_eff, valid,
        )
        return scores, ids, b, k_eff

    def _scan_search_device(
        self, q: np.ndarray, k: int, filter_mask: Optional[np.ndarray]
    ):
        """Large-N path: fused scan survivors + exact f32 rescore of an
        oversampled candidate set (recovers exact ordering from the bf16
        scan scores). Output stays on the device."""
        from ..ops.fused_scan import fused_scan_rescore, scan_grid

        scan = self.store.scan_index()
        bias = scan._mask
        if filter_mask is not None:
            combined = (~self.store.deleted_mask) & np.asarray(
                filter_mask[: len(self.store)], dtype=bool
            )
            bias = scan.mask_device_cached(combined)
        b = q.shape[0]
        b_pad = max(8, (b + 7) // 8 * 8)
        qp = np.zeros((b_pad, scan.d_pad), dtype=np.float32)
        qp[:b, : q.shape[1]] = q
        vectors, _ = self.store.device_block()
        if scan.mesh is not None:
            # multi-device: the fused scan + f32 rescore on every shard, merged
            s, ids = scan._search_mesh_device(qp, k, bias, rows=vectors)
            return s, ids, b, s.shape[1]
        k_fetch = min(max(2 * k, k + 8), scan.n)
        k_eff = min(k, k_fetch)
        euclid = self.store.distance in (Distance.EUCLID,)
        qp_dev = torch.from_numpy(qp).to(scan.device)  # scan + rescore query
        blk, slots = scan_grid(scan.n_pad, k_fetch, scan.block)
        top_s, top_i = fused_scan_rescore(
            qp_dev,
            qp_dev,
            scan._v,
            bias,
            vectors,
            k_fetch,
            k_eff,
            blk=blk,
            slots=slots,
            euclid=euclid,
        )
        return top_s, top_i, b, k_eff
