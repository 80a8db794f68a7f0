"""Sparse vector scoring over a device-resident inverted index (counterpart
of qdrant_tpu/ops/sparse.py).

Reference: lib/sparse/ (inverted index + WAND-style pruned posting merge,
lib/sparse/src/index/search_context.rs:25-80). The per-posting merge loop
becomes fixed-shape gathers and one scatter-add:

  * The sealed inverted index is a flat CSR on the device: `flat_ids [L]`,
    `flat_weights [L]`, with per-dimension (start, len).
  * A query gathers a [T, P] window per term, multiplies by query weights,
    scatter-adds into a dense [N] accumulator, then takes a top-k.

The JAX functions are `jax.jit` programs outside any Pallas kernel; here they
are plain functions on tensors that run on the device their operands lie on.
Where the JAX program drops out-of-range scatter ids (`mode="drop"`), the
accumulator here carries one spare slot that is sliced off. Scatter-adds on
CUDA sum in no fixed order, so SELECTION scores may differ in their last bits
between runs; every score that is returned from `sparse_hybrid_search` and
`rescore_sparse_packed` comes from a gather, a product and an ordered sum.
The hot product must be a true f32 product: `torch.backends.cuda.matmul.
allow_tf32` stays off (device.require_exact_f32_matmul checks it).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import require_exact_f32_matmul
from .scan import block_lane_winners

NEG_INF = float(-np.inf)

HOT_BLOCK = 8192
# elements of the [queries, T, P] window temporaries of score_sparse_batch
_STEP_ELEMS = 1 << 22


def score_sparse_batch(
    flat_ids: torch.Tensor,  # [L] int32 point offsets, concatenated postings
    flat_weights: torch.Tensor,  # [L] f32
    dim_starts: torch.Tensor,  # [B, T] int32 posting start per query term (-1 = absent)
    dim_lens: torch.Tensor,  # [B, T] int32 posting length
    query_weights: torch.Tensor,  # [B, T] f32 (0 = padded term)
    window: int,  # posting window cap P
    n_points: int,  # accumulator size
    valid_mask: Optional[torch.Tensor] = None,  # [n_points] bool
) -> torch.Tensor:
    """→ [B, n_points] scores (0 where no overlap; -inf where masked)."""
    b, t = dim_starts.shape
    dev = flat_ids.device
    pos = torch.arange(window, device=dev)
    acc = torch.zeros((b, n_points + 1), dtype=torch.float32, device=dev)
    last = flat_ids.shape[0] - 1
    rows = max(1, _STEP_ELEMS // max(t * window, 1))  # queries per step
    for i in range(0, b, rows):
        starts = dim_starts[i : i + rows].long()
        lens = dim_lens[i : i + rows].long()
        qw = query_weights[i : i + rows]
        ok = (pos < lens[..., None]) & (starts[..., None] >= 0)  # [r, T, P]
        # window entries past a posting's length are masked, so clamping the
        # gather never changes an entry that counts
        at = (starts.clamp(min=0)[..., None] + pos).clamp(max=last)
        ids = torch.where(ok, flat_ids[at].long(), n_points)
        contrib = torch.where(ok, flat_weights[at] * qw[..., None], 0.0)
        acc[i : i + rows].scatter_add_(
            1, ids.reshape(len(starts), -1), contrib.reshape(len(starts), -1)
        )
    scores = acc[:, :n_points]
    if valid_mask is not None:
        scores = torch.where(valid_mask[None, :], scores, NEG_INF)
    return scores


def sparse_search(
    flat_ids: torch.Tensor,
    flat_weights: torch.Tensor,
    dim_starts: torch.Tensor,
    dim_lens: torch.Tensor,
    query_weights: torch.Tensor,
    window: int,
    n_points: int,
    k: int,
    valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    scores = score_sparse_batch(
        flat_ids, flat_weights, dim_starts, dim_lens, query_weights,
        window, n_points, valid_mask,
    )
    # zero score = no overlap → exclude from results
    scores = torch.where(scores != 0.0, scores, NEG_INF)
    top_s, top_i = torch.topk(scores, k, dim=1)
    return top_s, top_i.to(torch.int32)


def _forward_dot(
    rows: torch.Tensor,  # [B, C, 2J] int32 packed [tids (-1 pad) | f32 bits]
    qvec: torch.Tensor,  # [B, V] f32 dense query over compact term ids
) -> torch.Tensor:
    """Σ_j qvec[tid_j] · w_j over each packed forward row → [B, C], summed in
    row order (no atomics)."""
    b, c, two_j = rows.shape
    j = two_j // 2
    terms = rows[..., :j]
    weights = rows[..., j:].contiguous().view(torch.float32)
    picked = torch.gather(qvec, 1, terms.clamp(min=0).reshape(b, -1).long())
    contrib = torch.where(terms >= 0, picked.reshape(b, c, j), 0.0)
    return (contrib * weights).sum(dim=-1)


def rescore_sparse_packed(
    cand_ids: torch.Tensor,  # [B, C] int32 point offsets (-1 padded)
    fwd_rows: torch.Tensor,  # [N_pad, 2J] int32: [tids (-1 pad) | f32 bits]
    qvec: torch.Tensor,  # [B, V] f32 dense query over compact term ids
) -> torch.Tensor:
    """Exact f32 candidate rescore over the PACKED forward table: term ids
    and f32 weight bit patterns live side by side in one int32 row, so each
    candidate costs one row gather."""
    rows = fwd_rows[cand_ids.clamp(min=0).long()]  # [B, C, 2J]
    scores = _forward_dot(rows, qvec)
    return torch.where(cand_ids >= 0, scores, NEG_INF)


def build_hot_matrix(
    flat_ids: torch.Tensor,  # [L] int32 point offsets (pad tail allowed)
    flat_weights: torch.Tensor,  # [L] f32 (pad tail zero)
    dim_starts: torch.Tensor,  # [U] int32 posting start per sorted dim
    hot_col_of_dim: torch.Tensor,  # [U] int32 hot column per dim (-1 = cold)
    hot_init: torch.Tensor,  # [N_pad, H] f32 zeros, filled in place
    chunk: int = 1 << 23,
) -> torch.Tensor:
    """Seal-time build of the dense hot-term matrix from the device CSR.

    Each posting maps to its dim by a searchsorted over the dim start table,
    then adds its weight into (point_row, hot_column). Cold postings (hot
    column -1), pad-tail postings and rows past N_pad are dropped. Postings
    are walked in chunks so the index temporaries stay small beside the
    matrix."""
    n_pad, h = hot_init.shape
    flat = hot_init.view(-1)
    starts = dim_starts.long()
    for off in range(0, flat_ids.shape[0], chunk):
        ids = flat_ids[off : off + chunk].long()
        pos = torch.arange(off, off + len(ids), device=ids.device)
        dim_idx = torch.searchsorted(starts, pos, right=True) - 1
        col = hot_col_of_dim[dim_idx.clamp(min=0)].long()
        keep = (col >= 0) & (ids < n_pad)
        flat.index_add_(
            0, ids[keep] * h + col[keep], flat_weights[off : off + chunk][keep]
        )
    return hot_init


def sparse_hybrid_search(
    hot: torch.Tensor,  # [N_pad, H] f32 dense hot-term matrix
    qhot: torch.Tensor,  # [B, H] f32 query weights over hot columns (host-built)
    flat_ids: torch.Tensor,  # [Lw] int32 top-W window CSR: point offsets
    flat_weights: torch.Tensor,  # [Lw] f32 window CSR: posting weights
    cold_starts: torch.Tensor,  # [B, Tc] int32 window start per cold term
    cold_lens: torch.Tensor,  # [B, Tc] int32 window length taken per term (0 pad)
    cold_qw: torch.Tensor,  # [B, Tc] f32 query weight per cold term
    fwd_cold: torch.Tensor,  # [N_pad, 2*Jc] int32 packed [cold tids | f32 bits]
    q_tids: torch.Tensor,  # [B, Tq] int32 compact term ids, -1 pad (ALL terms)
    q_w: torch.Tensor,  # [B, Tq] f32 query weights (idf-remapped)
    valid_mask: torch.Tensor,  # [N_pad] bool
    u_pad: int,  # dense query width (compact term space)
    e_pad: int,  # per-query cold window entry budget
    k_fetch: int,  # candidate count
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hot-dense + windowed-cold SELECTION, exact candidate RESCORE.

      * SELECTION: the top-H document-frequency terms live as a dense
        [N, H] f32 matrix scored block-wise in full f32. Cold terms
        contribute through a bounded WINDOW of their heaviest postings:
        per-term (start, len, qw) descriptors expand to entry positions via
        a searchsorted over per-query prefix sums. One winner survives per
        (HOT_BLOCK rows, lane of 128), first index on ties. Window
        truncation and the order of the scatter-add only perturb CANDIDATE
        CHOICE, never reported scores.
      * RESCORE: the top k_fetch candidates get exact f32 scores: s_hot from
        a contiguous hot-row gather and a product, s_cold from the cold-only
        packed forward rows against a dense per-query term vector.

    The padded sizes (u_pad, e_pad, the batch and term paddings of the
    operands) change no result: padding contributes zeros and dropped ids."""
    require_exact_f32_matmul(hot)
    b, h = qhot.shape
    n_pad = hot.shape[0]
    dev = hot.device
    blk = min(HOT_BLOCK, n_pad)

    # ---- dense per-query term vector (compact tid space) ----
    qdense = torch.zeros((b, u_pad + 1), dtype=torch.float32, device=dev)
    safe_t = torch.where(q_tids >= 0, q_tids, u_pad).long()
    qdense.scatter_add_(1, safe_t, torch.where(q_tids >= 0, q_w, 0.0))
    qdense = qdense[:, :u_pad]

    # ---- cold window accumulator: entry expansion + scatter-add ----
    lens = cold_lens.long()
    cum = torch.cumsum(lens, dim=1)  # [B, Tc]
    ent = torch.arange(e_pad, device=dev).expand(b, e_pad).contiguous()
    term = torch.searchsorted(cum, ent, right=True)
    term_c = term.clamp(max=cum.shape[1] - 1)
    base = cum - lens  # entry offset where each term begins
    within = ent - torch.gather(base, 1, term_c)
    pos = (torch.gather(cold_starts.long(), 1, term_c) + within).clamp(
        min=0, max=flat_ids.shape[0] - 1
    )
    ok = ent < cum[:, -1:]
    ids = torch.where(ok, flat_ids[pos].long(), n_pad)
    contrib = torch.where(
        ok, flat_weights[pos] * torch.gather(cold_qw, 1, term_c), 0.0
    )
    acc = torch.zeros((b, n_pad + 1), dtype=torch.float32, device=dev)
    acc.scatter_add_(1, ids, contrib)

    # ---- block walk: hot product + cold accumulator, one winner per
    # (block, lane) ----
    def score_rows(off: int, rows: int) -> torch.Tensor:
        s = qhot @ hot[off : off + rows].T + acc[:, off : off + rows]
        return torch.where(valid_mask[None, off : off + rows] & (s != 0.0), s, NEG_INF)

    flat_s, flat_i = block_lane_winners(n_pad, b, blk, score_rows, dev)
    kf = min(k_fetch, flat_s.shape[1])
    top_s, ti = torch.topk(flat_s, kf, dim=1)
    cand = torch.gather(flat_i, 1, ti)
    cand = torch.where(torch.isfinite(top_s), cand, -1)

    # ---- exact f32 rescore of the candidates ----
    safe = cand.clamp(min=0)
    s_hot = torch.einsum("bkh,bh->bk", hot[safe], qhot)  # contiguous row gather
    s_cold = _forward_dot(fwd_cold[safe], qdense)
    exact = s_hot + s_cold
    exact = torch.where((cand >= 0) & (exact != 0.0), exact, NEG_INF)
    out_s, oi = torch.topk(exact, min(k, kf), dim=1)
    out_i = torch.gather(cand, 1, oi)
    out_i = torch.where(torch.isfinite(out_s), out_i, -1)
    return out_s, out_i.to(torch.int32)
