"""Dense distance scoring as matrix products (counterpart of
qdrant_tpu/ops/distances.py).

Internal score convention: **larger is always better**.
  * dot / cosine: the similarity itself (cosine vectors are normalized at
    insert time).
  * euclid: negative *squared* distance (sqrt applied only at the API
    boundary).
  * manhattan: negative L1 distance.

Low-precision storage (bf16 / f16) scores with f32 accumulation, as the JAX
functions do with `preferred_element_type=float32`: operands are rounded to
the storage type and the product is taken in f32. Everything here is plain
torch; it serves segments below the fused scan's row threshold, and the
multivector max-sim (a jax.jit program in the JAX package, outside any
Pallas kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import require_exact_f32_matmul
from ..types import Distance

NEG_INF = float(-np.inf)


def preprocess_vectors(vectors: np.ndarray, distance: Distance) -> np.ndarray:
    """Host-side insert-time preprocessing (normalize for cosine). The same
    function as qdrant_tpu.ops.distances.preprocess_vectors, kept here
    because that module imports jax."""
    if distance is Distance.COSINE:
        norms = np.linalg.norm(vectors, axis=-1, keepdims=True)
        norms = np.where(norms == 0.0, 1.0, norms)
        return (vectors / norms).astype(np.float32, copy=False)
    return np.asarray(vectors, dtype=np.float32)


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float32 if t.dtype == torch.uint8 else t.dtype


def score_dense(
    queries: torch.Tensor,  # [B, D] float32
    vectors: torch.Tensor,  # [N, D] storage dtype
    distance: str,
    valid_mask: Optional[torch.Tensor] = None,  # [N] bool
) -> torch.Tensor:
    """Score a batch of queries against a full vector block → [B, N]."""
    dist = Distance(distance)
    cd = _compute_dtype(vectors)
    q = queries.to(cd).float()
    v = vectors.to(cd).float()
    if dist in (Distance.DOT, Distance.COSINE):
        scores = q @ v.T
    elif dist is Distance.EUCLID:
        qv = q @ v.T
        q32 = queries.float()
        v32 = vectors.float()
        q_sq = (q32 * q32).sum(dim=-1, keepdim=True)  # [B, 1]
        v_sq = (v32 * v32).sum(dim=-1)  # [N]
        scores = 2.0 * qv - q_sq - v_sq[None, :]  # = -||q - v||^2
    elif dist is Distance.MANHATTAN:
        # no matmul formulation for L1: chunk over N
        q32 = queries.float()
        v32 = vectors.float()
        chunk = 2048
        scores = torch.cat(
            [
                -(q32[:, None, :] - v32[None, i : i + chunk, :]).abs().sum(dim=-1)
                for i in range(0, v32.shape[0], chunk)
            ],
            dim=1,
        )
    else:  # pragma: no cover
        raise ValueError(f"unknown distance {distance}")
    if valid_mask is not None:
        scores = torch.where(valid_mask[None, :], scores, NEG_INF)
    return scores


def topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis → (scores [B, k], indices [B, k])."""
    return torch.topk(scores, k, dim=-1)


def score_and_topk(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    distance: str,
    k: int,
    valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-scan search: scores + top-k, only [B, k] leaves the device."""
    return topk(score_dense(queries, vectors, distance, valid_mask), k)


def score_ids_batch(
    queries: torch.Tensor,  # [B, D] float32
    vectors: torch.Tensor,  # [N, D]
    ids: torch.Tensor,  # [B, K] int, -1 = invalid
    distance: str,
) -> torch.Tensor:
    """Scores of per-query candidate rows → [B, K] (-inf where id < 0)."""
    dist = Distance(distance)
    cand = vectors[torch.clamp(ids, min=0).long()]  # [B, K, D]
    cd = _compute_dtype(cand)
    if dist in (Distance.DOT, Distance.COSINE):
        scores = torch.einsum(
            "bd,bkd->bk", queries.to(cd).float(), cand.to(cd).float()
        )
    elif dist is Distance.EUCLID:
        diff = queries.float()[:, None, :] - cand.float()
        scores = -(diff * diff).sum(dim=-1)
    elif dist is Distance.MANHATTAN:
        diff = queries.float()[:, None, :] - cand.float()
        scores = -diff.abs().sum(dim=-1)
    else:  # pragma: no cover
        raise ValueError(f"unknown distance {distance}")
    return torch.where(ids >= 0, scores, NEG_INF)


def pairwise_scores(
    a: torch.Tensor,  # [B, Ka, D]
    b: torch.Tensor,  # [B, Kb, D]
    distance: str,
) -> torch.Tensor:
    """Batched pairwise scores [B, Ka, Kb] — used by the HNSW build heuristic."""
    dist = Distance(distance)
    a32 = a.float()
    b32 = b.float()
    if dist in (Distance.DOT, Distance.COSINE):
        return torch.bmm(a32, b32.transpose(1, 2))
    if dist is Distance.EUCLID:
        ab = torch.bmm(a32, b32.transpose(1, 2))
        a_sq = (a32 * a32).sum(dim=-1)  # [B, Ka]
        b_sq = (b32 * b32).sum(dim=-1)  # [B, Kb]
        return 2.0 * ab - a_sq[:, :, None] - b_sq[:, None, :]
    if dist is Distance.MANHATTAN:
        diff = a32[:, :, None, :] - b32[:, None, :, :]
        return -diff.abs().sum(dim=-1)
    raise ValueError(f"unknown distance {distance}")  # pragma: no cover


# bytes of the largest temporary one max-sim chunk makes: unchunked, the
# [N, S, T] f32 products of 262,144 points x 64 tokens x 32 query tokens
# would be 2.1 GB
MAXSIM_CHUNK_BYTES = 1 << 28


def score_multivector_maxsim(
    query: torch.Tensor,  # [T, D] query token matrix
    vectors: torch.Tensor,  # [N, S, D] padded per-point token matrices
    token_mask: torch.Tensor,  # [N, S] bool: valid tokens
    distance: str,
    valid_mask: Optional[torch.Tensor] = None,  # [N] bool
) -> torch.Tensor:
    """ColBERT-style late-interaction max-sim scores → [N] (counterpart of
    qdrant_tpu/ops/distances.py::score_multivector_maxsim):

        score(q, v) = sum_t max_s sim(q_t, v_s)

    Padded tokens score -inf, a point with no tokens or an invalid point
    -inf. Dot / cosine / euclid take one f32 product of the flattened
    [n·S, D] block with the query's [D, T] (TF32 refused, as everywhere in
    the port) and reduce it in place; manhattan takes |q_t - v_s| summed
    over D. Chunked over N so that no temporary passes MAXSIM_CHUNK_BYTES.
    """
    dist = Distance(distance)
    require_exact_f32_matmul(vectors)
    q32 = query.float()
    n, s, d = vectors.shape
    t = q32.shape[0]
    # the largest temporary per point: [S, T, D] differences for manhattan,
    # else the [S, T] products or an [S, D] f32 copy / square of the tokens
    per_point = s * 4 * (t * d if dist is Distance.MANHATTAN else max(t, d))
    step = max(1, MAXSIM_CHUNK_BYTES // per_point)
    q_sq = (q32 * q32).sum(dim=-1)  # [T]
    out = torch.empty(n, dtype=torch.float32, device=vectors.device)
    for lo in range(0, n, step):
        v32 = vectors[lo : lo + step].float()  # [m, S, D]
        m = v32.shape[0]
        if dist is Distance.MANHATTAN:
            sims = -(v32[:, :, None, :] - q32[None, None, :, :]).abs().sum(dim=-1)
        else:
            sims = (v32.reshape(m * s, d) @ q32.T).reshape(m, s, t)
            if dist is Distance.EUCLID:  # 2 q·v - |q|^2 - |v|^2
                sims.mul_(2.0).sub_(q_sq).sub_((v32 * v32).sum(dim=-1)[:, :, None])
        tm = token_mask[lo : lo + step]
        sims.masked_fill_(~tm[:, :, None], NEG_INF)
        best = sims.amax(dim=1)  # [m, T]
        scores = torch.where(torch.isfinite(best), best, 0.0).sum(dim=-1)
        out[lo : lo + m] = torch.where(tm.any(dim=-1), scores, NEG_INF)
    if valid_mask is not None:
        out = torch.where(valid_mask, out, NEG_INF)
    return out
