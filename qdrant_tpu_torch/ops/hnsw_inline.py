"""HNSW beam search over link rows with inlined quantized vectors
(counterpart of qdrant_tpu/ops/hnsw_inline.py).

For every graph node the table stores its M neighbour ids AND their int8 SQ
codes + f32 norms in ONE contiguous byte row:

    row = [ids: M x int32 | norms: M x f32 | codes: M x D x int8]

so a neighbour expansion is e_x fat-row gathers per query instead of e_x*M
vector gathers. Traversal scores are integer dots of int8 codes; the final
beam is exactly rescored from the f32 vectors (one [B, ef]-row gather).

The byte layout is the JAX package's (little-endian int32 / f32 viewed as
int8), so a table packed by either package reads the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .hnsw import (
    CHECK_EVERY,
    NEG_INF,
    _has_candidate,
    _merge_beam,
    _pick,
    _seed_beam,
    dup_earlier,
    run_until_idle,
    take_rows,
    topk_first,
)

# rows of the table assembled per step of pack_linkcodes_device: bounds the
# [rows, M, D] gather beside a multi-GB table
PACK_ROWS = 65_536
# widest chunk of D whose int8 dot stays exact in f32: 127 * 127 * 1024 < 2^24
EXACT_F32_DOT_WIDTH = 1024


def pack_linkcodes(
    links: np.ndarray,  # [R, M] int32 global neighbor ids, -1 padded
    codes: np.ndarray,  # [N, D] int8 SQ codes (global row space)
    norms: np.ndarray,  # [N] f32 — ||v||^2 of the original vectors
) -> np.ndarray:
    """Host-side assembly of the fused link+code table -> [R, W] int8.

    W = M*4 (ids) + M*4 (norms) + M*D (codes). Padded (-1) neighbors carry
    zero codes and zero norms; their id slot stays -1 so the search masks
    them out.
    """
    r, m = links.shape
    d = codes.shape[1]
    safe = np.maximum(links, 0)
    ok = links >= 0
    nb_codes = np.where(ok[:, :, None], codes[safe], 0).astype(np.int8)
    nb_norms = np.where(ok, norms[safe], 0.0).astype(np.float32)
    out = np.empty((r, 4 * m + 4 * m + m * d), dtype=np.int8)
    ids32 = np.ascontiguousarray(links, dtype=np.int32)
    out[:, : 4 * m] = ids32.view(np.int8).reshape(r, 4 * m)
    nrm32 = np.ascontiguousarray(nb_norms, dtype=np.float32)
    out[:, 4 * m : 8 * m] = nrm32.view(np.int8).reshape(r, 4 * m)
    out[:, 8 * m :] = nb_codes.reshape(r, m * d)
    return out


def pack_linkcode_rows(
    links_rows: np.ndarray, codes: np.ndarray, norms: np.ndarray
) -> np.ndarray:
    """pack_linkcodes for a subset of rows (incremental table updates)."""
    return pack_linkcodes(links_rows, codes, norms)


def pack_linkcodes_device(
    links: torch.Tensor,  # [R, M] int32 device adjacency
    codes: torch.Tensor,  # [N, D] int8 SQ codes (device)
    norms: torch.Tensor,  # [N] f32 (device)
) -> torch.Tensor:
    """Device-side assembly of the fused table — same layout as
    pack_linkcodes, written PACK_ROWS rows at a time into one allocation, so
    the peak beside the table is one step's gather."""
    r, m = links.shape
    d = codes.shape[1]
    out = torch.empty((r, 8 * m + m * d), dtype=torch.int8, device=links.device)
    for lo in range(0, r, PACK_ROWS):
        part = links[lo : lo + PACK_ROWS].contiguous()
        ok = part >= 0
        rows = part.shape[0]
        nb_codes = torch.where(ok[:, :, None], take_rows(codes, part), 0).to(torch.int8)
        nb_norms = torch.where(ok, take_rows(norms, part), 0.0).to(torch.float32)
        dst = out[lo : lo + rows]
        dst[:, : 4 * m] = part.view(torch.int8).reshape(rows, 4 * m)
        dst[:, 4 * m : 8 * m] = nb_norms.contiguous().view(torch.int8).reshape(rows, 4 * m)
        dst[:, 8 * m :] = nb_codes.reshape(rows, m * d)
    return out


def code_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched products of code rows, a [B, Ka, D] x b [B, Kb, D] → [B, Ka, Kb]
    f32, with the accumulator the JAX programs ask for: int8 codes give the
    int32 sum converted once to f32, float codes (bf16) an f32 sum.

    There is no batched int8 product on CUDA, and a bf16 product would round
    its result to bf16, so both run as f32 products of the upcast operands
    (exact for these operands' products; TF32 would round the operands and is
    refused). int8 sums can pass 2^24 (D = 1536: up to 24.8M), where an f32
    sum starts to round, so D is walked in chunks narrow enough that every
    partial sum is an integer below 2^24, exact in f32 in any order; the
    chunks' sums are added as int32 and converted once."""
    from ..device import require_exact_f32_matmul

    require_exact_f32_matmul(a)
    d = a.shape[-1]
    if a.dtype != torch.int8 or d <= EXACT_F32_DOT_WIDTH:
        return torch.bmm(a.float(), b.float().transpose(1, 2))
    total = None
    for lo in range(0, d, EXACT_F32_DOT_WIDTH):
        part = torch.bmm(
            a[:, :, lo : lo + EXACT_F32_DOT_WIDTH].float(),
            b[:, :, lo : lo + EXACT_F32_DOT_WIDTH].float().transpose(1, 2),
        ).to(torch.int32)
        total = part if total is None else total + part
    return total.float()


def int8_dots(q: torch.Tensor, nb_codes: torch.Tensor) -> torch.Tensor:
    """Per-query dots q[b] . codes[b, k] → [B, K] f32 (see code_products)."""
    return code_products(nb_codes, q[:, None, :])[:, :, 0]


def beam_search_inline(
    q_f32: torch.Tensor,  # [B, D] f32 distance-preprocessed queries
    q_i8: torch.Tensor,  # [B, D] int8 SQ-encoded queries
    table: torch.Tensor,  # [R, W] int8 fused link+code rows
    scale_sq: float,  # scale^2 (x2 when euclid), an f32 value
    compact_of: torch.Tensor,  # [N] int32 global id -> table row
    vectors_f32: torch.Tensor,  # [Nf, D] f32 — exact rescore source
    entry_ids: torch.Tensor,  # [B, E] int32
    filter_bias: Optional[torch.Tensor],  # [N] f32: 0 allowed / NEG_INF excluded
    m: int,
    d: int,
    ef: int,
    iters: int,
    expand: int,
    euclid: bool,
    k: int,
    check_every: Optional[int] = CHECK_EVERY,
    counter: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (exact scores [B, k], global ids [B, k]); -1 padded. `counter` as in
    `run_until_idle`."""
    b = q_f32.shape[0]
    e_x = expand
    kk = e_x * m
    scale_sq = float(np.float32(scale_sq))
    entry_ids = entry_ids.to(torch.int32)

    q_sq = (q_f32 * q_f32).sum(dim=-1, keepdim=True)  # [B, 1]

    def score_entries(ids):
        """Exact f32 scores, same convention as ops/distances.py
        (euclid = -(q-v)^2, not the rank-equivalent 2qv - v^2)."""
        cand = take_rows(vectors_f32, ids).float()
        qv = torch.bmm(cand, q_f32[:, :, None])[:, :, 0]
        if euclid:
            s = 2.0 * qv - (cand * cand).sum(dim=-1) - q_sq
        else:
            s = qv
        return torch.where(ids >= 0, s, NEG_INF)

    entry_scores = score_entries(entry_ids)
    beam_ids, beam_scores, beam_exp = _seed_beam(entry_ids, entry_scores, ef, sort=False)

    # filtered search keeps TWO sets: the beam navigates the full graph;
    # res_* accumulates only filter-passing encounters. Biasing the beam
    # itself would wall off every filtered-out region.
    if filter_bias is not None:
        ent_bias = take_rows(filter_bias, beam_ids)
        res_scores = torch.where(beam_ids >= 0, beam_scores + ent_bias, NEG_INF)
        res_ids = torch.where(torch.isfinite(res_scores), beam_ids, -1)
    else:
        res_scores = res_ids = None

    def step(st, _it):
        beam_ids, beam_scores, beam_exp, res_s, res_i = st
        pick_ids, beam_exp = _pick(beam_ids, beam_scores, beam_exp, e_x)

        rows = torch.where(pick_ids >= 0, take_rows(compact_of, pick_ids), 0)
        fat = take_rows(table, rows)  # [B, e_x, W]
        neigh = fat[:, :, : 4 * m].contiguous().view(torch.int32).reshape(b, kk)
        nb_norms = fat[:, :, 4 * m : 8 * m].contiguous().view(torch.float32).reshape(b, kk)
        nb_codes = fat[:, :, 8 * m :].reshape(b, kk, d)
        # picked slot invalid -> neutralize its neighbors
        valid_pick = (pick_ids >= 0)[:, :, None].expand(b, e_x, m).reshape(b, kk)
        neigh = torch.where(valid_pick, neigh, -1)

        dots = int8_dots(q_i8, nb_codes) * scale_sq
        # same -(q-v)^2 convention as the exact entry scores so beam
        # eviction compares like with like
        n_scores = dots - nb_norms - q_sq if euclid else dots
        n_scores = torch.where(neigh >= 0, n_scores, NEG_INF)

        # dedup against the current beam + within the expansion itself
        dup_beam = (neigh[:, :, None] == beam_ids[:, None, :]).any(dim=2)
        n_scores = torch.where(dup_beam | dup_earlier(neigh), NEG_INF, n_scores)
        neigh = torch.where(torch.isfinite(n_scores), neigh, -1)

        if res_s is not None:
            allowed = n_scores + take_rows(filter_bias, neigh)
            ra_s = torch.cat([res_s, allowed], dim=1)
            ra_i = torch.cat([res_i, neigh], dim=1)
            res_s, ri = topk_first(ra_s, ef)
            res_i = torch.where(torch.isfinite(res_s), ra_i.gather(1, ri), -1)

        new_ids, top_scores, new_exp = _merge_beam(
            beam_ids, beam_scores, beam_exp, neigh, n_scores, ef)
        return new_ids, top_scores, new_exp, res_s, res_i

    st = (beam_ids, beam_scores, beam_exp, res_scores, res_ids)
    beam_ids, beam_scores, _, res_scores, res_ids = run_until_idle(
        step, st, lambda s: _has_candidate(s[0], s[2]), iters, check_every, counter)

    # exact f32 rescore of the final set (one [B, ef]-row gather); filtered
    # searches rank the result accumulator, not the traversal beam
    out_ids = beam_ids if filter_bias is None else res_ids
    re = score_entries(out_ids)
    if filter_bias is not None:
        re = re + take_rows(filter_bias, out_ids)
        # the result set may hold duplicates (a node can re-enter after beam
        # eviction): keep each id's first occurrence only
        re = torch.where(dup_earlier(out_ids), NEG_INF, re)
    top_s, ti = topk_first(re, k)
    top_i = torch.where(torch.isfinite(top_s), out_ids.gather(1, ti), -1)
    return top_s, top_i
