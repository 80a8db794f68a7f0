"""HNSW level-0 batch insertion on the device (counterpart of
qdrant_tpu/ops/hnsw_build.py).

One whole insert round with fixed shapes, as the JAX program runs it:

  1. batched construction beam over the current adjacency, scored on codes
     (int8 SQ, or bf16: encoded once per build — the store is sealed),
  2. heuristic neighbour selection on the codes' pairwise scores,
  3. forward-row scatter,
  4. reverse pass: sort the (neighbour, new-point) pairs by row, rank them
     within the row with searchsorted, and let pair rank w replace the row's
     w-th worst link when the incoming point scores better. Pairs beyond the
     per-row inbox are dropped — the in-degree healer repairs the tail.

The adjacency and counts stay on the device across batches and are updated
IN PLACE (the JAX program donates them); the functions return the same
tensors. The adjacency MUST have at least one spare padding row at the end
(row R-1): it absorbs masked-out scatter writes and is wiped afterwards.

On the card the construction beam (1) is one hand-written kernel,
`csrc/hnsw_beam.cu`, for every shape the builder gives it: it reads the code
rows where they lie, with no [B, expand * width, D] gather. Its torch body,
`_beam_construct_plain`, is the CPU path and the version the tests hold the
kernel to. The rounds whose beam ran in the kernel are counted
as `build.beam_kernel` beside `build.insert_rounds` (utils/tracing.py).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import tracing
from .hnsw import (
    NEG_INF,
    _has_candidate,
    _merge_beam,
    _pick,
    _seed_beam,
    dup_earlier,
    run_until_idle,
    select_by_heuristic,
    take_rows,
    topk_first,
)
from .fused_scan import build_library
from .hnsw_inline import code_products, int8_dots

# bytes of the reverse pass's [K, m0, D] code gather held at once
REVERSE_GATHER_BUDGET = 1.5e9

BEAM_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "csrc", "hnsw_beam.cu")

_BEAM_LIB: Optional[ctypes.CDLL] = None
_BEAM_LOCK = threading.Lock()


def _score_codes(q_i8, codes, norms, ids, scale_sq, euclid):
    """Approximate scores of `ids` for each query; -inf for id < 0.
    euclid: -(q-v)^2 + q^2 = 2qv - v^2 (q^2 constant per query)."""
    cand = take_rows(codes, ids)  # [B, K, D]
    dots = int8_dots(q_i8, cand) * scale_sq
    if euclid:
        s = dots - take_rows(norms, ids)
    else:
        s = dots
    return torch.where(ids >= 0, s, NEG_INF)


def _beam_lib() -> ctypes.CDLL:
    global _BEAM_LIB
    with _BEAM_LOCK:
        if _BEAM_LIB is None:
            lib = ctypes.CDLL(build_library(source=BEAM_SOURCE)[0])
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.hnsw_beam_construct.argtypes = (
                [ptr] * 6 + [ctypes.c_float] + [i32] * 9 + [ptr] * 4)
            lib.hnsw_beam_construct.restype = i32
            _BEAM_LIB = lib
        return _BEAM_LIB


def beam_construct_kernel(q_i8, codes, norms, links, rank, entries, scale_sq,
                          euclid, ef, iters, expand,
                          rows_scored: Optional[torch.Tensor] = None):
    """`_beam_construct` in one launch of csrc/hnsw_beam.cu → (beam_scores
    [B, ef] f32, beam_ids [B, ef] int32), on the current stream, with no
    synchronise. It takes CUDA bf16 or int8 codes of any width D, and any
    link width, ef and expand whose working set fits a CTA's shared memory;
    it raises on anything else. `rows_scored` (int64 [1], optional) gains
    the code rows the kernel read."""
    b, d = q_i8.shape
    if codes.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"the beam kernel takes bf16 or int8 codes, not {codes.dtype}")
    if codes.dim() != 2 or codes.shape[1] != d or q_i8.dtype != codes.dtype:
        raise ValueError(f"codes [N, {d}] of the queries' type expected")
    if ef < 1 or expand < 1 or iters < 0:
        raise ValueError(f"ef {ef}, expand {expand}, iters {iters}")
    for name, t, dtype in (("links", links, torch.int32), ("rank", rank, torch.int32),
                           ("norms", norms, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if codes.device.type != "cuda":
        raise ValueError("the beam kernel runs on CUDA tensors only")
    dev = codes.device
    q = q_i8.contiguous()
    codes, norms, links, rank = (t.contiguous() for t in (codes, norms, links, rank))
    ent = entries.to(torch.int32).contiguous()
    out_s = torch.empty((b, ef), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, ef), dtype=torch.int32, device=dev)
    if rows_scored is not None and (rows_scored.dtype != torch.int64
                                    or rows_scored.device != dev):
        raise TypeError("rows_scored must be an int64 tensor on the codes' device")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _beam_lib().hnsw_beam_construct(
            q.data_ptr(), codes.data_ptr(), norms.data_ptr(), links.data_ptr(),
            rank.data_ptr(), ent.data_ptr(), float(np.float32(scale_sq)), int(euclid),
            int(codes.dtype == torch.int8), b, d, links.shape[1], links.shape[0], ef,
            iters, expand, out_s.data_ptr(), out_i.data_ptr(),
            None if rows_scored is None else rows_scored.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"hnsw_beam_construct launch failed: CUDA error {err} (D {d} {codes.dtype}, "
            f"width {links.shape[1]}, ef {ef}, expand {expand}; cudaErrorInvalidValue = 1 "
            "where a CTA's working set exceeds the card's shared memory)")
    beam_construct_kernel.launches += 1
    return out_s, out_i


beam_construct_kernel.launches = 0


def _beam_construct(q_i8, codes, norms, links, rank, entries, scale_sq,
                    euclid, ef, iters, expand, check_every: Optional[int] = None):
    """Construction beam → (beam_scores [B, ef], beam_ids [B, ef]): the
    kernel on the card (counted as `build.beam_kernel`), the plain version
    on the CPU."""
    if codes.device.type == "cuda":
        out = beam_construct_kernel(q_i8, codes, norms, links, rank, entries, scale_sq,
                                    euclid, ef, iters, expand)
        tracing.count("build.beam_kernel")
        return out
    return _beam_construct_plain(q_i8, codes, norms, links, rank, entries, scale_sq,
                                 euclid, ef, iters, expand, check_every)


def _beam_construct_plain(q_i8, codes, norms, links, rank, entries, scale_sq,
                          euclid, ef, iters, expand, check_every: Optional[int] = None):
    """Construction beam at level 0 — code scoring, beam-only dedup +
    intra-expansion dedup (same structure as ops/hnsw_inline.py). By default
    all `iters` turns run with no read of the stop flag: a build batch almost
    never converges early, and no sync keeps the device queue full."""
    e_x = expand
    entry_ids = entries[:, None].to(torch.int32)
    entry_scores = _score_codes(q_i8, codes, norms, entry_ids, scale_sq, euclid)
    beam_ids, beam_scores, beam_exp = _seed_beam(entry_ids, entry_scores, ef, sort=False)

    def step(st, _it):
        beam_ids, beam_scores, beam_exp = st
        pick_ids, beam_exp = _pick(beam_ids, beam_scores, beam_exp, e_x)
        rows = torch.where(pick_ids >= 0, take_rows(rank, pick_ids), -1)
        neigh = take_rows(links, rows)
        neigh = torch.where(rows[:, :, None] >= 0, neigh, -1).reshape(rows.shape[0], -1)
        n_scores = _score_codes(q_i8, codes, norms, neigh, scale_sq, euclid)
        # all-pairs compare-mask dedup of (beam ∪ expansion)
        dup_beam = (neigh[:, :, None] == beam_ids[:, None, :]).any(dim=2)
        n_scores = torch.where(dup_beam | dup_earlier(neigh), NEG_INF, n_scores)
        neigh = torch.where(torch.isfinite(n_scores), neigh, -1)
        return _merge_beam(beam_ids, beam_scores, beam_exp, neigh, n_scores, ef)

    st = (beam_ids, beam_scores, beam_exp)
    beam_ids, beam_scores, _ = run_until_idle(
        step, st, lambda s: _has_candidate(s[0], s[2]), iters, check_every)
    return beam_scores, beam_ids


def _pairwise_i8(codes_a, norms_a, codes_b, norms_b, scale_sq, euclid):
    """[B, Ka, Kb] approximate pairwise scores from codes."""
    dots = code_products(codes_a, codes_b) * scale_sq
    if euclid:
        return dots - norms_a[:, :, None] - norms_b[:, None, :]
    return dots


def _heuristic_select(cand_ids, cand_scores, pair, m, fill=False):
    """The selection heuristic, batched (ops/hnsw.py::select_by_heuristic).
    cand_* sorted by score desc; pair[b, i, j] = score(c_i, c_j). fill=False
    keeps heuristic winners only, leaving row slots free for reverse links."""
    return select_by_heuristic(cand_ids, cand_scores, pair, m, fill)


def heal_low_indegree_device(
    links: torch.Tensor,  # [R, M0] int32 (updated in place; row R-1 spare)
    counts: torch.Tensor,  # [R] int32
    rank: torch.Tensor,  # [Ncap] int32 global id -> row
    owner_of_row: torch.Tensor,  # [R] int32 row -> global id (-1 spare/unused)
    m0: int,
    min_indegree: int = 8,
    force_links: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The post-build in-degree healer on the device: every node with
    in-degree < min_indegree is force-written into the tail slots of its own
    first `force_links` forward neighbours' rows. Tail slots rotate by
    (row + j) so concurrent heals into one hub spread across the tail window.
    Several weak nodes can still meet in one slot; which of them stays is
    undefined (in the JAX scatter too)."""
    r_total = links.shape[0]
    spare = r_total - 1
    dev = links.device

    valid = links >= 0
    rows_of = torch.where(valid, take_rows(rank, links), spare)
    indeg = torch.bincount(rows_of.reshape(-1).long(), minlength=r_total)
    weak = (indeg < min_indegree) & (owner_of_row >= 0)

    window = max(m0 // 4, force_links)
    fwd = links[:, :force_links]  # [R, F]
    fwd_rows = torch.where((fwd >= 0) & weak[:, None], take_rows(rank, fwd), spare)
    row_iota = torch.arange(r_total, dtype=torch.int32, device=dev)[:, None]
    slot_iota = torch.arange(fwd.shape[1], dtype=torch.int32, device=dev)[None, :]
    slots = m0 - 1 - ((row_iota + slot_iota) % window)
    vals = owner_of_row[:, None].expand_as(fwd)
    do = fwd_rows != spare
    # masked-out writes go to (spare, 0); the spare row is wiped below
    at_rows = torch.where(do, fwd_rows, spare).long()
    at_slots = torch.where(do, slots, 0).long()
    links[at_rows, at_slots] = torch.where(do, vals, -1).to(links.dtype)
    links[spare] = -1
    counts.copy_((links >= 0).sum(dim=1).to(counts.dtype))
    return links, counts


def insert_batch_level0(
    links: torch.Tensor,  # [R, M0] int32 adjacency (updated in place; row R-1 spare)
    counts: torch.Tensor,  # [R] int32 link counts (updated in place)
    batch_ids: torch.Tensor,  # [B] int32 global ids of new points (-1 padded)
    q_i8: torch.Tensor,  # [B, D] codes of the new points
    codes: torch.Tensor,  # [Ncap, D] codes of ALL points (int8 SQ or bf16)
    norms: torch.Tensor,  # [Ncap] f32 ||v||^2
    rank: torch.Tensor,  # [Ncap] int32 global id -> adjacency row
    owner_of_row: torch.Tensor,  # [R] int32 adjacency row -> global id (-1 spare)
    entries: torch.Tensor,  # [B] int32 per-point entry (post upper descent)
    scale_sq: float,  # an f32 value (x2 when euclid)
    ef: int,
    iters: int,
    expand: int,
    m0: int,
    inc_cap: int,
    ov_cap: int,
    euclid: bool,
    sel_c: int,
    merge_forward: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One full level-0 insert round on the device →
    (links, counts, beam_ids [B, ef] for upper-level chaining).

    merge_forward=True is the REFINE mode (points already in the graph are
    re-inserted against the final adjacency): the point's existing row links
    join the candidate set before heuristic selection, so reverse-appended
    links survive the row overwrite when they win on score."""
    tracing.count("build.insert_rounds")
    b = batch_ids.shape[0]
    dev = links.device
    scale_sq = float(np.float32(scale_sq))
    half_scale = float(np.float32(scale_sq) * np.float32(0.5))
    valid_pt = batch_ids >= 0
    r_total = links.shape[0]
    spare = r_total - 1  # guaranteed padding row: absorbs masked writes

    # 1) construction beam
    beam_scores, beam_ids = _beam_construct(
        q_i8, codes, norms, links, rank, entries, scale_sq, euclid, ef,
        iters, expand,
    )
    if merge_forward:
        pre_rows = torch.where(valid_pt, take_rows(rank, batch_ids), spare)
        old_ids = links[pre_rows.long()]  # [B, m0]
        old_ids = torch.where(valid_pt[:, None], old_ids, -1)
        old_ids = torch.where(old_ids == batch_ids[:, None], -1, old_ids)
        old_scores = _score_codes(q_i8, codes, norms, old_ids, scale_sq, euclid)

    # 1b) intra-batch candidates: lockstep insertion means batch-mates are
    # absent from the graph during the beam — mutual nearest batch-mates are
    # merged into the candidate set so close pairs inserted together still link
    kb = min(16, b)
    bb = code_products(q_i8[None], q_i8[None])[0] * scale_sq
    if euclid:
        bb = bb - take_rows(norms, batch_ids)[None, :]
    eye = torch.eye(b, dtype=torch.bool, device=dev)
    bb = torch.where(eye | (batch_ids[None, :] < 0) | (batch_ids[:, None] < 0),
                     NEG_INF, bb)
    mate_scores, mate_idx = topk_first(bb, kb)
    mate_ids = torch.where(torch.isfinite(mate_scores), batch_ids[mate_idx], -1)

    # 2) heuristic selection over the top sel_c of (beam + batch-mates
    #    [+ existing row links in refine mode])
    comb_ids = torch.cat([beam_ids[:, :sel_c], mate_ids], dim=1)
    comb_scores = torch.cat([beam_scores[:, :sel_c], mate_scores], dim=1)
    if merge_forward:
        comb_ids = torch.cat([comb_ids, old_ids], dim=1)
        comb_scores = torch.cat([comb_scores, old_scores], dim=1)
        # the point is already in the graph, so the beam finds IT (maximal
        # self-score): as a candidate it would take slot 0 and then veto
        # every true neighbour in the heuristic
        self_hit = comb_ids == batch_ids[:, None]
        comb_ids = torch.where(self_hit, -1, comb_ids)
        comb_scores = torch.where(self_hit, NEG_INF, comb_scores)
    cand_scores, top_i = topk_first(comb_scores, sel_c)
    cand_ids = comb_ids.gather(1, top_i)
    cand_codes = take_rows(codes, cand_ids)
    cand_norms = take_rows(norms, cand_ids)
    q_f = q_i8.float()
    q_norm_sq = (q_f * q_f).sum(dim=-1)
    if euclid:
        # beam scores are 2qv - v^2; subtract scale^2*||q||^2 so base and
        # pairwise comparisons share the -(x-y)^2 metric
        base_scores = cand_scores - (q_norm_sq * half_scale)[:, None]
    else:
        base_scores = cand_scores
    pair = _pairwise_i8(cand_codes, cand_norms, cand_codes, cand_norms, scale_sq, euclid)
    # heuristic-only selection in BOTH modes (fill=False): diversity beats
    # density; open slots are refilled by later reverse appends and the healer
    sel = _heuristic_select(cand_ids, base_scores, pair, m0, fill=False)  # [B, m0]
    sel = torch.where(valid_pt[:, None], sel, -1)
    del pair, cand_codes

    # 3) forward scatter (invalid batch slots write the spare row)
    fwd_rows = torch.where(valid_pt, take_rows(rank, batch_ids), spare).long()
    links[fwd_rows] = torch.where(valid_pt[:, None], sel, links[fwd_rows])
    counts[fwd_rows] = torch.where(
        valid_pt, (sel >= 0).sum(dim=1).to(counts.dtype), counts[fwd_rows])

    # 4) reverse pass — each (neighbour <- new point) pair replaces its
    # target row's w-th WORST existing link (empty slots score -inf, so
    # appending and replacing unify): pairs are sorted by row, ranked within
    # the row by searchsorted, and pair rank w targets the w-th ascending
    # victim. The victim is replaced only when the incoming point scores
    # better.
    k_pairs = b * m0
    nb = sel.reshape(-1)  # [K] neighbour global ids
    pt = batch_ids.repeat_interleave(m0)  # [K] new-point global ids
    pair_ok = (nb >= 0) & (pt >= 0)
    nb_rows = torch.where(pair_ok, take_rows(rank, nb), r_total)
    rows_s, order = torch.sort(nb_rows, stable=True)
    src = order // m0  # batch slot of each sorted pair
    pt_s = batch_ids[src]
    ptc_s = q_i8[src]  # [K, D]
    ptn_s = (q_norm_sq * half_scale)[src]
    first = torch.searchsorted(rows_s.contiguous(), rows_s.contiguous(), right=False)
    within = (torch.arange(k_pairs, device=dev) - first).to(torch.int32)
    ok = (rows_s < r_total) & (within < inc_cap) & (within < m0)
    rows_c = torch.where(ok, rows_s, spare).long()

    row_links = links[rows_c]  # [K, m0]
    owners = nb[order]  # target row owner = the neighbour itself
    owner_codes = take_rows(codes, owners)  # [K, D]
    # link-code gather + scoring, CHUNKED: the one-shot [K, m0, D] gather is
    # B*m0*m0*D*itemsize bytes — 10.1 GB at B=2048, m0=40, D=1536 bf16
    gather_bytes = k_pairs * m0 * codes.shape[1] * codes.element_size()
    n_chunks = 1
    while gather_bytes / n_chunks > REVERSE_GATHER_BUDGET and n_chunks < b:
        n_chunks *= 2
    step = -(-k_pairs // n_chunks)
    link_scores = torch.cat([
        int8_dots(owner_codes[lo : lo + step],
                  take_rows(codes, row_links[lo : lo + step]))  # [C, m0, D]
        for lo in range(0, k_pairs, step)
    ]) * scale_sq
    if euclid:
        link_scores = link_scores - take_rows(norms, row_links)
    link_scores = torch.where(row_links >= 0, link_scores, NEG_INF)
    # don't evict the point's own duplicate (already linked): an existing
    # copy of pt scores +inf, so it is never the victim and the compare
    # below fails
    dup = row_links == pt_s[:, None]
    link_scores = torch.where(dup, float("inf"), link_scores)
    s_in = (owner_codes.float() * ptc_s.float()).sum(dim=-1) * scale_sq
    if euclid:
        # link_scores are 2*o.l - ||l||^2; match with 2*o.p - ||p||^2
        s_in = s_in - ptn_s

    asc = torch.sort(link_scores, dim=1, stable=True)[1]  # victims worst-first
    w = torch.clamp(within, 0, m0 - 1).long()
    victim_slot = asc.gather(1, w[:, None])[:, 0]
    victim_score = link_scores.gather(1, victim_slot[:, None])[:, 0]
    # a point already present in the row (refine-mode re-insert) must not
    # land a second copy in the victim slot
    do = ok & ~dup.any(dim=1) & (s_in > victim_score)
    scatter_rows = torch.where(do, rows_s, spare).long()
    scatter_slots = torch.where(do, victim_slot, 0)
    links[scatter_rows, scatter_slots] = torch.where(
        do, pt_s, links[scatter_rows, scatter_slots])
    victim_was_empty = row_links.gather(1, victim_slot[:, None])[:, 0] < 0
    counts.index_add_(0, scatter_rows, (do & victim_was_empty).to(counts.dtype))
    links[spare] = -1
    counts[spare] = 0

    return links, counts, beam_ids
