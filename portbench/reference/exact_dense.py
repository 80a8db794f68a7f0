"""Plain torch reference for dense search: exact top-k and exact scores.

It imports nothing of the port, nor jax or the JAX package, and takes only
the raw rows and queries that the benchmark handed to both sides: it
normalises Cosine rows itself and builds nothing the port made (no store, no
codes, no graph). Scores follow the REST convention: Euclid returns the
distance (lower is better), Cosine the cosine and Dot the product (higher is
better).

`precision="f32"` ranks by f32 products with TF32 off, then re-ranks the best
`k + SLACK` candidates of every query by their exact score (float64,
straight from the rows), so the returned ids are the exact top-k.
`precision="tf32"` is the control: the same reference computed one step
below, with its products in TF32 (operands rounded to TF32's 10-bit
mantissa, and TF32 on where the device has it) and its scores taken from
those products, as a program that computed in TF32 would return them.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Tuple

import numpy as np
import torch

SLACK = 32  # candidates kept past k for the exact re-rank
ROW_BLOCK = 1 << 18
QUERY_BLOCK = 1024
SCORE_BLOCK = 4096


def lower_is_better(distance: str) -> bool:
    return distance == "Euclid"


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest value with a 10-bit mantissa (TF32's operands)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextmanager
def _matmul_precision(precision: str):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class Exact:
    """The rows on `device` (f32), searched and scored exactly."""

    def __init__(self, rows: np.ndarray, distance: str, device: torch.device):
        if distance not in ("Euclid", "Cosine", "Dot"):
            raise ValueError(f"no reference for distance {distance!r}")
        self.distance = distance
        self.device = torch.device(device)
        self.x = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32)).to(self.device)
        self.x_rank = self.x
        if distance == "Cosine":
            self.x_rank = self.x / self.x.norm(dim=1, keepdim=True).clamp_min(1e-30)
        self.x_sq = (self.x * self.x).sum(dim=1)

    def _key(self, q: torch.Tensor, lo: int, hi: int, precision: str) -> torch.Tensor:
        """Higher is better: 2 q.x - |x|^2 (Euclid), q.x otherwise."""
        xb = self.x_rank[lo:hi]
        if precision == "tf32":
            q, xb = _round_tf32(q), _round_tf32(xb)
        with _matmul_precision(precision):
            s = q @ xb.T
        if self.distance == "Euclid":
            s = 2.0 * s - self.x_sq[lo:hi][None, :]
        return s

    def topk(self, queries: np.ndarray, k: int,
             precision: str = "f32") -> Tuple[np.ndarray, np.ndarray]:
        """→ (ids int64 [Q, k], scores float64 [Q, k]), best first."""
        if precision not in ("f32", "tf32"):
            raise ValueError(precision)
        n = self.x.shape[0]
        keep = min(n, k + SLACK if precision == "f32" else k)
        ids_out = np.empty((len(queries), k), dtype=np.int64)
        sc_out = np.empty((len(queries), k), dtype=np.float64)
        for a in range(0, len(queries), QUERY_BLOCK):
            qh = queries[a : a + QUERY_BLOCK]
            q = torch.from_numpy(np.ascontiguousarray(qh, dtype=np.float32)).to(self.device)
            if self.distance == "Cosine":
                q = q / q.norm(dim=1, keepdim=True).clamp_min(1e-30)
            best_s = best_i = None
            for lo in range(0, n, ROW_BLOCK):
                hi = min(n, lo + ROW_BLOCK)
                s = self._key(q, lo, hi, precision)
                ts, ti = torch.topk(s, min(keep, hi - lo), dim=1)
                ti = ti + lo
                if best_s is not None:
                    ts, ti = torch.cat([best_s, ts], 1), torch.cat([best_i, ti], 1)
                    ts, j = torch.topk(ts, min(keep, ts.shape[1]), dim=1)
                    ti = torch.gather(ti, 1, j)
                best_s, best_i = ts, ti
            if precision == "tf32":
                if self.distance == "Euclid":
                    q_sq = (q * q).sum(dim=1, keepdim=True)
                    best_s = torch.sqrt(torch.clamp(q_sq - best_s, min=0.0))
                ids_out[a : a + len(qh)] = best_i[:, :k].cpu().numpy()
                sc_out[a : a + len(qh)] = best_s[:, :k].double().cpu().numpy()
                continue
            cand = best_i.cpu().numpy()
            exact = self.scores(qh, cand)
            order = np.argsort(exact if lower_is_better(self.distance) else -exact,
                               axis=1, kind="stable")[:, :k]
            ids_out[a : a + len(qh)] = np.take_along_axis(cand, order, axis=1)
            sc_out[a : a + len(qh)] = np.take_along_axis(exact, order, axis=1)
        return ids_out, sc_out

    def scores(self, queries: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Exact scores (float64, straight from the rows) of ids [R, m] for
        queries [R, d]; NaN where an id is out of range."""
        n = self.x.shape[0]
        out = np.full(ids.shape, np.nan, dtype=np.float64)
        for a in range(0, len(ids), SCORE_BLOCK):
            idb = torch.from_numpy(np.asarray(ids[a : a + SCORE_BLOCK], dtype=np.int64))
            ok = (idb >= 0) & (idb < n)
            idb = idb.clamp(0, n - 1).to(self.device)
            rows = self.x[idb].double()  # [r, m, d]
            q = torch.from_numpy(np.asarray(queries[a : a + SCORE_BLOCK], dtype=np.float32))
            q = q.to(self.device).double()[:, None, :]
            if self.distance == "Euclid":
                s = torch.sqrt(((rows - q) ** 2).sum(dim=2))
            else:
                s = (rows * q).sum(dim=2)
                if self.distance == "Cosine":
                    s = s / (rows.norm(dim=2) * q.norm(dim=2)).clamp_min(1e-300)
            s = s.cpu().numpy()
            out[a : a + SCORE_BLOCK] = np.where(ok.numpy(), s, np.nan)
        return out
