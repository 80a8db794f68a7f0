"""Device-resident blocked-scan searcher (counterpart of the single-device
bf16 part of qdrant_tpu/ops/scan.py::ScanIndex).

The block is stored as the fused scan kernel wants it (ops/fused_scan.py):
bf16 rows padded to [n_pad, d_pad], pre-scaled by 2 for euclid so the
kernel's product yields 2*q.v, plus an f32 bias table (-||v||^2 for live rows,
NEG_INF for deleted, filtered and pad rows). The JAX package sizes its block
and query tile to the TPU's VMEM window; here rows are padded to 4,096-row
blocks and a search scans with 16 slots (2,048 survivor bins) at every width,
widened only for large limits (fused_scan.scan_grid).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import default_device
from .fused_scan import (
    DEFAULT_BLK,
    NEG_INF,
    fused_scan_topk,
    pad_rows,
    scan_grid,
)

_UPLOAD_ROWS = 131072  # host→device upload chunk (bounds the f32 staging copy)


class ScanIndex:
    """Blocked-scan searcher over a frozen [N, D] block (distance-
    preprocessed f32 host rows)."""

    def __init__(
        self,
        vectors: np.ndarray,  # [N, D] f32, distance-preprocessed
        valid_mask: Optional[np.ndarray] = None,
        euclid: bool = False,
        block: int = DEFAULT_BLK,
        device: Optional[torch.device] = None,
    ):
        n, d = vectors.shape
        self.device = device or default_device()
        self.n = n
        self.d = d
        self.block = block
        self.euclid = euclid
        self.d_pad = max((d + 127) // 128 * 128, 128)
        self.n_pad = pad_rows(n, block)
        v = torch.zeros((self.n_pad, self.d_pad), dtype=torch.bfloat16,
                        device=self.device)
        vsq = np.zeros(self.n_pad, dtype=np.float32)
        for i in range(0, n, _UPLOAD_ROWS):
            rows = np.zeros((min(_UPLOAD_ROWS, n - i), self.d_pad), np.float32)
            rows[:, :d] = vectors[i : i + len(rows)]
            if euclid:  # summed over the padded width, as the JAX index does
                vsq[i : i + len(rows)] = (rows * rows).sum(axis=1)
            chunk = torch.from_numpy(rows).to(self.device)
            v[i : i + len(rows)] = (2.0 * chunk if euclid else chunk).to(
                torch.bfloat16
            )
        self._v = v
        self._vsq_host = vsq  # host copy to rebuild the bias on mask updates
        self._mask = self.mask_device(valid_mask)

    @classmethod
    def from_arrays(
        cls,
        v_bf16: torch.Tensor,  # [n_pad, d_pad] bf16, pre-scaled for euclid
        vsq_host: np.ndarray,  # [n_pad] f32 ||v||^2 (zeros unless euclid)
        bias: torch.Tensor,  # [n_pad] f32
        n: int,
        euclid: bool,
        block: int = DEFAULT_BLK,
    ) -> "ScanIndex":
        """Wrap operands that already have the kernel's layout (convert.py)."""
        self = cls.__new__(cls)
        self.device = v_bf16.device
        self.n, self.block, self.euclid = n, block, euclid
        self.n_pad, self.d_pad = v_bf16.shape
        self.d = self.d_pad
        self._v = v_bf16
        self._vsq_host = np.asarray(vsq_host, dtype=np.float32)
        self._mask = bias
        return self

    def memory_usage_bytes(self):
        return {
            "host_bytes": int(self._vsq_host.nbytes),
            "device_bytes": int(
                self._v.numel() * self._v.element_size()
                + self._mask.numel() * self._mask.element_size()
            ),
            "disk_bytes": 0,
        }

    def mask_device(self, valid_mask: Optional[np.ndarray]) -> torch.Tensor:
        """Bias table for a validity mask: -||v||^2 (zeros unless euclid) for
        valid rows, NEG_INF for the rest. The mask may be shorter than n (pad
        rows stay invalid)."""
        mask = np.zeros(self.n_pad, dtype=bool)
        if valid_mask is None:
            mask[: self.n] = True
        else:
            m = np.asarray(valid_mask[: self.n], dtype=bool)
            mask[: len(m)] = m
        bias = np.where(mask, -self._vsq_host, NEG_INF).astype(np.float32)
        return torch.from_numpy(bias).to(self.device)

    def update_mask(self, valid_mask: np.ndarray) -> None:
        self._mask = self.mask_device(valid_mask)
        if hasattr(self, "_mask_cache"):
            self._mask_cache.clear()

    def mask_device_cached(self, valid_mask: np.ndarray) -> torch.Tensor:
        """mask_device with a small digest-keyed cache: repeated searches
        with the same filter reuse the device bias instead of re-uploading
        [N] floats per call."""
        if not hasattr(self, "_mask_cache"):
            self._mask_cache = {}
        key = hashlib.blake2b(
            np.ascontiguousarray(valid_mask), digest_size=16
        ).digest()
        hit = self._mask_cache.get(key)
        if hit is None:
            if len(self._mask_cache) >= 16:
                self._mask_cache.pop(next(iter(self._mask_cache)))
            hit = self._mask_cache[key] = self.mask_device(valid_mask)
        return hit

    def search(
        self, queries: np.ndarray, k: int, mask: Optional[torch.Tensor] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ host (scores [B, k], ids [B, k]); -1 = no result. Euclid scores
        are -(q-v)^2 from the bf16 scan (||q||^2 subtracted host-side)."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b, d = queries.shape
        b_pad = max(8, (b + 7) // 8 * 8)
        q = np.zeros((b_pad, self.d_pad), dtype=np.float32)
        q[:b, :d] = queries
        k_eff = min(k, self.n)
        blk, slots = scan_grid(self.n_pad, k_eff, self.block)
        s, ids = fused_scan_topk(
            torch.from_numpy(q).to(self.device),
            self._v,
            mask if mask is not None else self._mask,
            k_eff,
            blk=blk,
            slots=slots,
        )
        s = s.cpu().numpy()[:b]
        ids = ids.cpu().numpy().astype(np.int32)[:b]
        if self.euclid:
            q_sq = (queries * queries).sum(axis=1, keepdims=True)
            s = np.where(ids >= 0, s - q_sq, -np.inf)
        if k > s.shape[1]:
            pad = k - s.shape[1]
            s = np.pad(s, ((0, 0), (0, pad)), constant_values=-np.inf)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return s.astype(np.float32), ids
