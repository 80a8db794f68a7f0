"""Batched HNSW graph traversal (counterpart of qdrant_tpu/ops/hnsw.py).

The same batched, fixed-shape formulation as the JAX programs, as plain torch
functions on tensors that all lie on one device:

  * B queries advance in lockstep through a loop of at most `iters` turns.
  * Adjacency is a fixed-degree table `links [N, M]` (int32, -1 padded), so a
    neighbour expansion is one gather of shape [B, M].
  * The beam (result set of size ef) is a sorted array, merged each turn with
    the new candidates by a top-k over their concatenation.
  * Visited handling: a per-query ring of expanded ids plus dedup against the
    current beam.

Two things differ from the JAX source, neither in a result:

  * `lax.while_loop` stops on a flag computed on the device. Reading it
    every turn would cost one device→host sync per turn, so the loops here
    (`run_until_idle`) test it every `check_every` turns. Every loop body is
    idempotent once no candidate is left (all picks -1 → all neighbours -1 →
    scores -inf → the state unchanged), so the extra turns change nothing.
  * `lax.top_k` and `jnp.argsort` order equal keys by the lower index;
    `torch.topk` promises no order among equals. Every selection here goes
    through `topk_first` / a stable sort.

Scores follow the engine-wide convention: larger is better.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .distances import pairwise_scores, score_ids_batch

NEG_INF = float(-np.inf)

# turns between two reads of a loop's stop flag (one device→host sync each)
CHECK_EVERY = 4


def topk_first(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, best first, equal scores in index order (the
    order `jax.lax.top_k` gives) → (values [..., k], indices [..., k])."""
    s, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def argsort_desc(scores: torch.Tensor) -> torch.Tensor:
    """Stable descending argsort over the last axis (`jnp.argsort(-x)`)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1]


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[max(ids, 0)] — every gather by an id that may be -1 goes through
    this guard (torch would wrap a negative index silently)."""
    return table[torch.clamp(ids, min=0).long()]


def run_until_idle(
    step: Callable, state, active: Callable, iters: int,
    check_every: Optional[int] = CHECK_EVERY,
):
    """`state = step(state, it)` for it in range(iters), ending early once
    `active(state)` is false. The flag is read every `check_every` turns
    (None: never, all `iters` turns run); `step` must leave an inactive state
    unchanged, so where the loop ends does not show in the result."""
    for it in range(iters):
        if check_every and it % check_every == 0 and not bool(active(state)):
            break
        state = step(state, it)
    return state


def dup_earlier(ids: torch.Tensor) -> torch.Tensor:
    """[B, K] bool: the id also stands at a lower position of its row (the
    JAX programs' `first_pos < pos`)."""
    k = ids.shape[1]
    eq = ids[:, :, None] == ids[:, None, :]
    earlier = torch.ones((k, k), dtype=torch.bool, device=ids.device).tril(-1)
    return (eq & earlier[None]).any(dim=2)


def _descend(queries, vectors, links, compact_of, count, ids, scores, distance,
             max_steps, check_every):
    """One level's greedy best-neighbour walk; `count` (rows valid on this
    level of a stack) may be None."""

    def step(state, _it):
        ids, scores, _ = state
        row = take_rows(compact_of, ids)
        ok = row >= 0 if count is None else (row >= 0) & (row < count)
        neigh = take_rows(links, row)
        neigh = torch.where(ok[:, None], neigh, -1)
        n_scores = score_ids_batch(queries, vectors, neigh, distance)  # [B, M]
        best_score, best = n_scores.max(dim=1)
        best_id = neigh.gather(1, best[:, None])[:, 0]
        improved = best_score > scores
        return (
            torch.where(improved, best_id, ids),
            torch.where(improved, best_score, scores),
            improved,
        )

    init = (ids, scores, torch.ones_like(ids, dtype=torch.bool))
    ids, scores, _ = run_until_idle(
        step, init, lambda st: st[2].any(), max_steps, check_every
    )
    return ids, scores


def greedy_descend_level(
    queries: torch.Tensor,  # [B, D] f32 (preprocessed)
    vectors: torch.Tensor,  # [N, D]
    links: torch.Tensor,  # [Nl, M] int32 level-l adjacency (rows → global ids)
    compact_of: torch.Tensor,  # [N] int32 global id → row on this level (-1 absent)
    cur_ids: torch.Tensor,  # [B] int32 current (global) node per query
    cur_scores: torch.Tensor,  # [B] f32
    distance: str,
    max_steps: int = 128,
    check_every: Optional[int] = CHECK_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy best-neighbour descent on one upper level, batched over queries.
    A strict improvement moves a query; equal best neighbours resolve to the
    lowest slot, as `jnp.argmax` does."""
    return _descend(queries, vectors, links, compact_of, None, cur_ids,
                    cur_scores, distance, max_steps, check_every)


def greedy_descend_stack(
    queries: torch.Tensor,  # [B, D] f32
    vectors: torch.Tensor,  # [N, D]
    links_stack: torch.Tensor,  # [L, R, M] int32 — levels top..1, same row space
    compact_of: torch.Tensor,  # [N] int32 global id → row (level-sort rank)
    level_counts: torch.Tensor,  # [L] int32 — nodes on each stacked level
    cur_ids: torch.Tensor,  # [B] int32
    cur_scores: torch.Tensor,  # [B] f32
    distance: str,
    max_steps: int = 128,
    check_every: Optional[int] = CHECK_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy descent through all upper levels, top first."""
    for i in range(links_stack.shape[0]):
        cur_ids, cur_scores = _descend(
            queries, vectors, links_stack[i], compact_of, level_counts[i],
            cur_ids, cur_scores, distance, max_steps, check_every,
        )
    return cur_ids, cur_scores


def _seed_beam(entry_ids, entry_scores, ef, sort: bool):
    """Entries padded to ef slots with (-1, -inf), optionally sorted best
    first → (beam_ids, beam_scores, beam_exp)."""
    b, e = entry_ids.shape
    beam_ids = torch.full((b, ef), -1, dtype=torch.int32, device=entry_ids.device)
    beam_scores = torch.full((b, ef), NEG_INF, dtype=torch.float32,
                             device=entry_ids.device)
    w = min(e, ef)
    beam_ids[:, :w] = entry_ids[:, :w]
    beam_scores[:, :w] = entry_scores[:, :w]
    if sort:
        order = argsort_desc(beam_scores)
        beam_ids = beam_ids.gather(1, order)
        beam_scores = beam_scores.gather(1, order)
    return beam_ids, beam_scores, beam_ids < 0  # invalid slots count as expanded


def _pick(beam_ids, beam_scores, beam_exp, e_x):
    """The e_x best unexpanded beam entries → (pick_ids [B, e_x] with -1 where
    none is left, beam_exp with the picked slots marked)."""
    cand_ok = ~beam_exp & (beam_ids >= 0)
    pick_scores = torch.where(cand_ok, beam_scores, NEG_INF)
    top_pick, pick_idx = topk_first(pick_scores, e_x)
    live = torch.isfinite(top_pick)
    pick_ids = torch.where(live, beam_ids.gather(1, pick_idx), -1)
    hit = torch.zeros_like(beam_exp).scatter_(1, pick_idx, live)
    return pick_ids, beam_exp | hit


def _expand(links, compact_of, pick_ids):
    """Neighbour ids of the picked nodes → [B, e_x * M], -1 where the pick
    is."""
    b = pick_ids.shape[0]
    if compact_of is not None:
        row = torch.where(pick_ids >= 0, take_rows(compact_of, pick_ids), -1)
    else:
        row = pick_ids
    neigh = take_rows(links, row)  # [B, e_x, M]
    return torch.where(row[:, :, None] >= 0, neigh, -1).reshape(b, -1)


def _merge_beam(beam_ids, beam_scores, beam_exp, neigh, n_scores, ef):
    """Top ef of beam + new candidates → the next (ids, scores, expanded)."""
    all_ids = torch.cat([beam_ids, neigh], dim=1)
    all_scores = torch.cat([beam_scores, n_scores], dim=1)
    all_exp = torch.cat([beam_exp, torch.zeros_like(neigh, dtype=torch.bool)], dim=1)
    top_scores, top_idx = topk_first(all_scores, ef)
    new_ids = all_ids.gather(1, top_idx)
    new_exp = all_exp.gather(1, top_idx) | (new_ids < 0)
    return new_ids, top_scores, new_exp


def _has_candidate(beam_ids, beam_exp):
    return (~beam_exp & (beam_ids >= 0)).any()


def beam_search_acorn(
    queries: torch.Tensor,  # [B, D] f32
    vectors: torch.Tensor,  # [N, D]
    links: torch.Tensor,  # [Nl, M] int32
    entry_ids: torch.Tensor,  # [B, E] int32
    filter_mask: torch.Tensor,  # [N] bool — required
    ef: int,
    max_iters: int,
    distance: str,
    compact_of: Optional[torch.Tensor] = None,
    expand: int = 4,
    check_every: Optional[int] = CHECK_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filtered beam search in the spirit of ACORN: the beam traverses the
    UNFILTERED graph (so low-selectivity filters cannot strand it), while a
    separate result set accumulates only filter-matching candidates."""
    beam_search_acorn.calls += 1
    b = queries.shape[0]
    e_x = expand
    iters = max(max_iters // e_x, 8)
    entry_ids = entry_ids.to(torch.int32)

    entry_scores = score_ids_batch(queries, vectors, entry_ids, distance)
    beam_ids, beam_scores, beam_exp = _seed_beam(entry_ids, entry_scores, ef, sort=True)
    visited = torch.full((b, iters * e_x), -1, dtype=torch.int32, device=queries.device)
    # matching-results accumulator, seeded from matching entries
    ent_ok = take_rows(filter_mask, beam_ids) & (beam_ids >= 0)
    res_ids = torch.where(ent_ok, beam_ids, -1)
    res_scores = torch.where(ent_ok, beam_scores, NEG_INF)

    def step(state, it):
        beam_ids, beam_scores, beam_exp, res_ids, res_scores = state
        pick_ids, beam_exp = _pick(beam_ids, beam_scores, beam_exp, e_x)
        visited[:, it * e_x : (it + 1) * e_x] = pick_ids
        neigh = _expand(links, compact_of, pick_ids)

        dup_beam = (neigh[:, :, None] == beam_ids[:, None, :]).any(dim=2)
        dup_vis = (neigh[:, :, None] == visited[:, None, :]).any(dim=2)
        neigh = torch.where(dup_beam | dup_vis | dup_earlier(neigh), -1, neigh)
        n_scores = score_ids_batch(queries, vectors, neigh, distance)

        # beam merge: UNfiltered traversal
        new_ids, top_scores, new_exp = _merge_beam(
            beam_ids, beam_scores, beam_exp, neigh, n_scores, ef)

        # results merge: matching candidates only (dedup vs current results)
        n_ok = take_rows(filter_mask, neigh) & (neigh >= 0)
        dup_res = (neigh[:, :, None] == res_ids[:, None, :]).any(dim=2)
        cand_res = torch.where(n_ok & ~dup_res, neigh, -1)
        cand_scores = torch.where(cand_res >= 0, n_scores, NEG_INF)
        r_ids = torch.cat([res_ids, cand_res], dim=1)
        r_scores = torch.cat([res_scores, cand_scores], dim=1)
        rtop, ridx = topk_first(r_scores, ef)
        res_ids_new = torch.where(torch.isfinite(rtop), r_ids.gather(1, ridx), -1)
        return new_ids, top_scores, new_exp, res_ids_new, rtop

    state = (beam_ids, beam_scores, beam_exp, res_ids, res_scores)
    _, _, _, res_ids, res_scores = run_until_idle(
        step, state, lambda st: _has_candidate(st[0], st[2]), iters, check_every)
    return res_scores, res_ids


beam_search_acorn.calls = 0


def level_beam_loop(
    queries: torch.Tensor,  # [B, D] f32
    vectors: torch.Tensor,  # [N, D]
    links: torch.Tensor,  # [Nl, M] int32 (-1 padded), rows indexed by compact id
    entry_ids: torch.Tensor,  # [B, E] int32 initial candidates (-1 padded)
    filter_mask: Optional[torch.Tensor],  # [N] bool — nodes allowed in results/expansion
    ef: int,
    max_iters: int,
    distance: str,
    compact_of: Optional[torch.Tensor] = None,  # [N] int32 global→row in `links`
    expand: int = 4,
):
    """The loop of `beam_search_level`, not yet run → (state, step, active,
    iters) for `run_until_idle`, or for `run_all_until_idle` beside other
    beams. The final state is (beam_ids, beam_scores, beam_exp)."""
    beam_search_level.calls += 1
    b = queries.shape[0]
    e_x = expand
    iters = max(max_iters // e_x, 8)
    entry_ids = entry_ids.to(torch.int32)

    entry_scores = score_ids_batch(queries, vectors, entry_ids, distance)  # [B, E]
    beam_ids, beam_scores, beam_exp = _seed_beam(entry_ids, entry_scores, ef, sort=True)
    visited = torch.full((b, iters * e_x), -1, dtype=torch.int32, device=queries.device)

    def step(state, it):
        beam_ids, beam_scores, beam_exp = state
        pick_ids, beam_exp = _pick(beam_ids, beam_scores, beam_exp, e_x)
        visited[:, it * e_x : (it + 1) * e_x] = pick_ids
        neigh = _expand(links, compact_of, pick_ids)

        # drop neighbours failing the filter (not scored, not traversed)
        if filter_mask is not None:
            n_ok = take_rows(filter_mask, neigh)
            neigh = torch.where((neigh >= 0) & n_ok, neigh, -1)

        # dedup against beam, visited set, and within the expansion itself
        dup_beam = (neigh[:, :, None] == beam_ids[:, None, :]).any(dim=2)
        dup_vis = (neigh[:, :, None] == visited[:, None, :]).any(dim=2)
        neigh = torch.where(dup_beam | dup_vis | dup_earlier(neigh), -1, neigh)

        n_scores = score_ids_batch(queries, vectors, neigh, distance)  # [B, e_x*M]
        return _merge_beam(beam_ids, beam_scores, beam_exp, neigh, n_scores, ef)

    state = (beam_ids, beam_scores, beam_exp)
    return state, step, lambda st: _has_candidate(st[0], st[2]), iters


def run_all_until_idle(loops, check_every: Optional[int] = CHECK_EVERY):
    """`run_until_idle` over several (state, step, active, iters) loops in
    lockstep → their final states. Every loop still running takes one turn
    per round; every `check_every` rounds one idle check reads all of their
    flags. Each loop ends where `run_until_idle` would end it alone, so its
    state is the same; when the loops lie on several cards, all of them have
    a stride of turns queued before the host waits on any."""
    states = [lp[0] for lp in loops]
    running = list(range(len(loops)))
    for it in range(max((lp[3] for lp in loops), default=0)):
        if check_every and it % check_every == 0:
            flags = [bool(loops[i][2](states[i])) for i in running]
            running = [i for i, on in zip(running, flags) if on]
        running = [i for i in running if it < loops[i][3]]
        if not running:
            break
        for i in running:
            states[i] = loops[i][1](states[i], it)
    return states


def beam_search_level(
    queries: torch.Tensor,  # [B, D] f32
    vectors: torch.Tensor,  # [N, D]
    links: torch.Tensor,  # [Nl, M] int32 (-1 padded), rows indexed by compact id
    entry_ids: torch.Tensor,  # [B, E] int32 initial candidates (-1 padded)
    filter_mask: Optional[torch.Tensor],  # [N] bool — nodes allowed in results/expansion
    ef: int,
    max_iters: int,
    distance: str,
    compact_of: Optional[torch.Tensor] = None,  # [N] int32 global→row in `links`
    expand: int = 4,
    check_every: Optional[int] = CHECK_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched beam search on one level → (scores [B, ef], ids [B, ef]).

    Each turn expands the `expand` best unexpanded beam entries at once.
    Filtered-out nodes are skipped entirely; entry points are scored even if
    filtered out so traversal can start anywhere — the caller drops
    non-matching entries.
    """
    state, step, active, iters = level_beam_loop(
        queries, vectors, links, entry_ids, filter_mask, ef, max_iters, distance,
        compact_of, expand)
    beam_ids, beam_scores, _ = run_until_idle(step, state, active, iters, check_every)
    return beam_scores, beam_ids


beam_search_level.calls = 0


def select_by_heuristic(
    cand_ids: torch.Tensor,  # [B, C] int32 sorted by score desc, -1 padded
    cand_scores: torch.Tensor,  # [B, C] score(candidate, base point)
    pair: torch.Tensor,  # [B, C, C] score(candidate_i, candidate_j)
    m: int,
    fill: bool,
) -> torch.Tensor:
    """The HNSW neighbour-selection heuristic, batched → selected ids [B, m]:
    iterating candidates nearest-first, keep candidate c iff for every
    already-selected s: score(c, base) > score(c, s). All B rows advance in
    lockstep over the candidate axis. fill=True then fills the remaining
    slots with the best pruned candidates (hnswlib keep_pruned_connections);
    fill=False keeps the heuristic's winners only."""
    b, c = cand_ids.shape
    dev = cand_ids.device
    sel_mask = torch.zeros((b, c), dtype=torch.bool, device=dev)
    count = torch.zeros((b,), dtype=torch.int32, device=dev)
    valid = cand_ids >= 0
    for i in range(c):
        # max score(c_i, s) over selected s
        closest_sel = torch.where(sel_mask, pair[:, i, :], NEG_INF).amax(dim=1)
        keep = valid[:, i] & (count < m) & (cand_scores[:, i] > closest_sel)
        sel_mask[:, i] = keep
        count += keep
    pos = torch.arange(c, dtype=torch.int32, device=dev)[None, :]
    if fill:
        key = torch.where(sel_mask, 2 * c - pos, torch.where(valid, c - pos, -1))
    else:
        key = torch.where(sel_mask & valid, 2 * c - pos, -1)
    m_eff = min(m, c)
    top_key, idx = topk_first(key, m_eff)
    out = torch.where(top_key >= 0, cand_ids.gather(1, idx), -1)
    if m_eff < m:
        out = torch.nn.functional.pad(out, (0, m - m_eff), value=-1)
    return out


def heuristic_select(
    cand_ids: torch.Tensor, cand_scores: torch.Tensor,
    cand_pairwise: torch.Tensor, m: int,
) -> torch.Tensor:
    """Heuristic picks first (by candidate order), then the best pruned
    candidates to fill remaining slots → selected ids [B, m]."""
    return select_by_heuristic(cand_ids, cand_scores, cand_pairwise, m, fill=True)


def simple_select(cand_ids: torch.Tensor, cand_scores: torch.Tensor, m: int) -> torch.Tensor:
    """Keep the m best candidates (no diversity heuristic)."""
    m_eff = min(m, cand_ids.shape[1])
    sc, idx = topk_first(cand_scores, m_eff)
    out = torch.where(torch.isfinite(sc), cand_ids.gather(1, idx), -1)
    if m_eff < m:
        out = torch.nn.functional.pad(out, (0, m - m_eff), value=-1)
    return out


def select_neighbors(
    cand_ids: torch.Tensor,  # [B, C] int32 sorted by score desc (beam output)
    cand_scores: torch.Tensor,  # [B, C] score(candidate, new point)
    vectors: torch.Tensor,  # [N, D]
    m: int,
    distance: str,
) -> torch.Tensor:
    """Forward-link selection for a batch of newly inserted points."""
    cand_vecs = take_rows(vectors, cand_ids)  # [B, C, D]
    pair = pairwise_scores(cand_vecs, cand_vecs, distance)  # [B, C, C]
    return heuristic_select(cand_ids, cand_scores, pair, m)


def reprune_rows(
    nb_ids: torch.Tensor,  # [K] int32 overflowed neighbour nodes
    cand_ids: torch.Tensor,  # [K, C] int32 existing links + incoming points, -1 pad
    vectors: torch.Tensor,  # [N, D]
    m: int,
    distance: str,
) -> torch.Tensor:
    """Re-apply the selection heuristic to overflowed link rows → [K, m]."""
    nb_vecs = vectors[nb_ids.long()].float()  # [K, D]
    scores = score_ids_batch(nb_vecs, vectors, cand_ids, distance)  # [K, C]
    order = argsort_desc(scores)
    sorted_ids = cand_ids.gather(1, order)
    sorted_scores = scores.gather(1, order)
    sorted_vecs = take_rows(vectors, sorted_ids)
    pair = pairwise_scores(sorted_vecs, sorted_vecs, distance)
    return heuristic_select(sorted_ids, sorted_scores, pair, m)


def scatter_link_rows(links: torch.Tensor, ids, rows) -> torch.Tensor:
    """Write whole rows of the device adjacency table, in place."""
    dev = links.device
    ids_t = torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(dev)
    rows_t = torch.from_numpy(np.asarray(rows, dtype=np.int32)).to(dev)
    links[ids_t] = rows_t
    return links
