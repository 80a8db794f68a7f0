"""HNSW index: batched build + batched beam-search queries (counterpart of
qdrant_tpu/index/hnsw.py::HnswIndex).

  * Fixed-degree adjacency tables on the device: level 0 is `[N, M0]` int32
    (-1 padded); all upper levels live in ONE stacked `[L, R, M]` tensor
    sharing the level-sort `rank` permutation as row index.
  * Build: geometric level assignment, a brute-force-linked seed set, then
    fixed-size batches inserted in lockstep. On the card the whole insert
    round runs on the device (ops/hnsw_build.py) and the adjacency never
    leaves it; on the CPU the host-orchestrated builder runs (batched beam +
    heuristic on the device functions, reverse-link bookkeeping in numpy).
    `QDRANT_TPU_DEVICE_BUILD=force` runs the device builder on the CPU too.
  * Queries: one greedy descent through the upper levels + one level-0 beam:
    over the fused link+code table (ops/hnsw_inline.py) on the card,
    `beam_search_level` otherwise, `beam_search_acorn` for selective filters.

The files written by `save` (`hnsw_graph.npz`, `hnsw_meta.json`) are the JAX
package's, so either package loads a graph the other built. On a device mesh
the seal builds a `ShardedHnswIndex` instead: one subgraph per row slice,
searched on every shard (`hnsw_sharded.npz`, also the JAX package's files).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import default_device, storage_bytes, tensor_bytes
from ..ops import hnsw as hnsw_ops
from ..ops.distances import preprocess_vectors
from ..parallel.mesh import (make_mesh, place_rows, placing, shard_slices,
                             sharded_hnsw_search)
from ..storage.vectors import DenseVectorStore
from ..types import Distance, HnswConfig
from ..utils import tracing
from ..utils.budget import BUDGET

INC_CAP = 64  # max reverse-link insertions routed to one node per round


def _pow2_at_least(x: int, minimum: int = 8) -> int:
    p = minimum
    while p < x:
        p *= 2
    return p


def _pad_rows(arr: np.ndarray, rows: int, fill) -> np.ndarray:
    if arr.shape[0] >= rows:
        return arr[:rows]
    pad_shape = (rows - arr.shape[0],) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)


def _on_card() -> bool:
    """Whether the port runs on the GPU: there the device builder and the
    inline table are the product path (the JAX package asks
    `is_tpu_backend()` at the same places)."""
    return default_device().type == "cuda"


def _sync(t: Optional[torch.Tensor]) -> None:
    """Wait for everything queued on `t`'s device (no-op on the CPU)."""
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def _build_sync(t: Optional[torch.Tensor]) -> None:
    """A build's wait for the device: its `build.sync` span is the share of
    the build's wall time in which the host had nothing left to queue."""
    with tracing.span("build.sync"):
        _sync(t)


def _to_host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype, copy=False)


class HnswIndex:
    def __init__(
        self,
        store: DenseVectorStore,
        config: HnswConfig,
        seed: int = 42,
        subset: Optional[np.ndarray] = None,
    ):
        self.store = store
        self.config = config
        self.seed = seed
        # optional subset of global offsets — used for payload-block subgraphs
        self.subset = None if subset is None else np.asarray(subset, dtype=np.int32)
        self.distance: Distance = store.distance
        # graph state (populated by build/load)
        self.levels: Optional[np.ndarray] = None  # [n] int32, -1 = not in graph
        self.rank: Optional[np.ndarray] = None  # [n] level-sort permutation rank
        self.entry: int = -1
        self.max_level: int = -1
        self.level_counts: Dict[int, int] = {}
        # host adjacency mirrors are LAZY: after a device build the device
        # tensors are authoritative and the host copies are stale until some
        # host-path consumer (save, tools) reads them
        self._host_stale = False
        self.links0 = None  # [rows0, M0]
        self.links_upper = None  # [L, R, M] levels max..1
        self.counts0 = None  # link counts per row
        self.counts_upper = None  # [L, R]
        self._links0_dev: Optional[torch.Tensor] = None
        self._upper_dev: Optional[torch.Tensor] = None
        self._rank_dev: Optional[torch.Tensor] = None
        self._stack_counts_dev: Optional[torch.Tensor] = None
        # fused link+code table (ops/hnsw_inline.py): None = undecided,
        # False = disabled for this index, dict = built state
        self._inline = None
        # telemetry: searches served per level-0 program ("inline", "level",
        # "acorn"; a Segment always passes its alive mask, so its inline
        # searches carry a filter bias) and what the last build did
        self.served: collections.Counter = collections.Counter()
        self.build_stats: dict = {}

    # ------------------------------------------------------------------
    # host adjacency mirrors (lazy after device builds)
    # ------------------------------------------------------------------

    def _sync_host(self) -> None:
        """Download the device adjacency into the host mirror if stale."""
        if not self._host_stale:
            return
        self._host_stale = False
        if self._links0_dev is not None:
            self._links0_host = _to_host(self._links0_dev, np.int32)
            self._counts0_host = (self._links0_host >= 0).sum(axis=1).astype(np.int32)
        if self._upper_dev is not None:
            self._links_upper_host = _to_host(self._upper_dev, np.int32)
            self._counts_upper_host = (
                (self._links_upper_host >= 0).sum(axis=2).astype(np.int32)
            )

    @property
    def links0(self) -> Optional[np.ndarray]:
        self._sync_host()
        return self._links0_host

    @links0.setter
    def links0(self, v) -> None:
        self._links0_host = v

    @property
    def counts0(self) -> Optional[np.ndarray]:
        self._sync_host()
        return self._counts0_host

    @counts0.setter
    def counts0(self, v) -> None:
        self._counts0_host = v

    @property
    def links_upper(self) -> Optional[np.ndarray]:
        self._sync_host()
        return self._links_upper_host

    @links_upper.setter
    def links_upper(self, v) -> None:
        self._links_upper_host = v

    @property
    def counts_upper(self) -> Optional[np.ndarray]:
        self._sync_host()
        return self._counts_upper_host

    @counts_upper.setter
    def counts_upper(self, v) -> None:
        self._counts_upper_host = v

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _m_at(self, level: int) -> int:
        return self.config.m0 if level == 0 else self.config.m

    def _stack_index(self, level: int) -> int:
        """Stack rows are ordered top level → level 1."""
        return self.max_level - level

    def _device(self) -> torch.device:
        return self.store.device_block()[0].device

    def _links0_device(self) -> torch.Tensor:
        if self._links0_dev is None:
            self._links0_dev = torch.from_numpy(
                np.ascontiguousarray(self.links0, dtype=np.int32)).to(self._device())
        return self._links0_dev

    def _upper_device(self) -> Optional[torch.Tensor]:
        if self._upper_dev is not None:
            return self._upper_dev
        # check the raw host attr (not the property) — the property getter
        # would force a stale-sync download just to answer "is there one"
        if self._links_upper_host is None or self._links_upper_host.shape[0] == 0:
            return None
        self._upper_dev = torch.from_numpy(
            np.ascontiguousarray(self._links_upper_host, dtype=np.int32)
        ).to(self._device())
        return self._upper_dev

    def _rank_device(self) -> torch.Tensor:
        if self._rank_dev is None:
            vectors = self.store.device_block()[0]
            self._rank_dev = torch.from_numpy(
                _pad_rows(self.rank.astype(np.int32), vectors.shape[0], -1)
            ).to(vectors.device)
        return self._rank_dev

    def _stack_counts(self) -> torch.Tensor:
        if self._stack_counts_dev is None:
            counts = np.asarray(
                [self.level_counts.get(l, 0) for l in range(self.max_level, 0, -1)],
                dtype=np.int32,
            )
            self._stack_counts_dev = torch.from_numpy(counts).to(self._device())
        return self._stack_counts_dev

    def _row_of(self, level: int, ids: np.ndarray) -> np.ndarray:
        """Global ids → link-table rows (all levels are rank-compact)."""
        return self.rank[ids]

    def _scatter(self, level: int, rows: np.ndarray, values: np.ndarray) -> None:
        """Write full link rows (host mirror + device)."""
        if self._inline:
            self._inline = None  # graph mutated: drop the fused table
        counts = (values >= 0).sum(axis=1).astype(np.int32)
        if level == 0:
            self.links0[rows] = values
            self.counts0[rows] = counts
            if self._links0_dev is not None:
                hnsw_ops.scatter_link_rows(self._links0_dev, rows, values)
        else:
            i = self._stack_index(level)
            self.links_upper[i, rows] = values
            self.counts_upper[i, rows] = counts
            if self._upper_dev is not None:
                hnsw_ops.scatter_link_rows(self._upper_dev[i], rows, values)

    def _link_counts(self, level: int, rows: np.ndarray) -> np.ndarray:
        if level == 0:
            return self.counts0[rows]
        return self.counts_upper[self._stack_index(level), rows]

    def _links_host(self, level: int, rows: np.ndarray) -> np.ndarray:
        if level == 0:
            return self.links0[rows]
        return self.links_upper[self._stack_index(level), rows]

    def _add_link_counts(self, level: int, rows: np.ndarray, inc: np.ndarray) -> None:
        if level == 0:
            self.counts0[rows] += inc
        else:
            self.counts_upper[self._stack_index(level), rows] += inc

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------

    @tracing.traced("hnsw.build")
    def build(
        self,
        batch_size: int = 1024,
        ef_construct: Optional[int] = None,
        progress_fn=None,
    ) -> None:
        """Build the graph over all non-deleted points in the store. Returns
        once it is built (every path ends with a device synchronise);
        `build_stats["seconds"]` is the wall time of that."""
        t0 = time.perf_counter()
        self._build(batch_size, ef_construct, progress_fn)
        self.build_stats["seconds"] = time.perf_counter() - t0

    def _build(self, batch_size: int, ef_construct: Optional[int], progress_fn) -> None:
        n = len(self.store)
        efc = ef_construct or self.config.ef_construct
        m = self.config.m
        rng = np.random.default_rng(self.seed)

        alive = ~self.store.deleted_mask
        if self.subset is not None:
            member = np.zeros(n, dtype=bool)
            member[self.subset[self.subset < n]] = True
            alive = alive & member
        alive_ids = np.nonzero(alive)[0].astype(np.int32)
        n_alive = len(alive_ids)

        # geometric level assignment
        ml = 1.0 / np.log(max(m, 2))
        u = rng.random(n_alive)
        levels_alive = np.floor(-np.log(np.clip(u, 1e-12, 1.0)) * ml).astype(np.int32)

        self.levels = np.full(n, -1, dtype=np.int32)
        self.levels[alive_ids] = levels_alive
        self.build_stats = {"points": n_alive, "device_build": False}

        if n_alive == 0:
            self.rank = np.full(n, -1, dtype=np.int32)
            self.entry = -1
            self.max_level = -1
            self.level_counts = {}
            return

        tiebreak = rng.random(n_alive)
        order = alive_ids[np.lexsort((tiebreak, -levels_alive))]
        self.rank = np.full(n, -1, dtype=np.int32)
        self.rank[order] = np.arange(len(order), dtype=np.int32)
        self.entry = int(order[0])
        self.max_level = int(self.levels[self.entry])
        self.level_counts = {
            l: int((levels_alive >= l).sum()) for l in range(self.max_level + 1)
        }

        # +1 guarantees a spare padding row at the end — the device insert
        # round (ops/hnsw_build.py) uses it to absorb masked scatter writes
        rows0 = _pow2_at_least(max(n_alive, 1) + 1)
        self._host_stale = False
        self.links0 = np.full((rows0, self.config.m0), -1, dtype=np.int32)
        self.counts0 = np.zeros(rows0, dtype=np.int32)
        n_upper_levels = self.max_level
        upper_rows = _pow2_at_least(max(self.level_counts.get(1, 1), 1) + 1, 16)
        self.links_upper = np.full(
            (max(n_upper_levels, 0), upper_rows, m), -1, dtype=np.int32
        )
        self.counts_upper = np.zeros((max(n_upper_levels, 0), upper_rows), dtype=np.int32)
        self._links0_dev = None
        self._upper_dev = None
        self._rank_dev = None
        self._stack_counts_dev = None
        self._inline = None

        vectors, _ = self.store.device_block()
        dist = self.distance.value

        # ---- seed graph: brute-force link the first points --------------
        n_seed = min(n_alive, max(2 * efc, 256), 512)
        seed_ids = order[:n_seed]
        self._build_seed_graph(seed_ids, vectors, dist)

        # ---- batched insertion ------------------------------------------
        build_env = os.environ.get("QDRANT_TPU_DEVICE_BUILD", "1")
        device_build = (
            (_on_card() or build_env == "force")
            and build_env != "0"
            and n_alive - n_seed > 0
        )
        if device_build:
            self.build_stats["device_build"] = True
            self._build_device(order, n_seed, n_alive, efc, batch_size,
                               dist, progress_fn)
            return  # device path heals on device; host mirror stays lazy
        # host-orchestrated path (CPU / small builds): geometric batch ramp —
        # a batch is never more than a fraction of the already-inserted
        # graph, so early points link against a graph that already contains
        # most of their neighbourhood
        inserted = n_seed
        cur_batch = 256
        while inserted < n_alive:
            while cur_batch < batch_size and cur_batch * 2 <= inserted:
                cur_batch *= 2
            bsz = min(cur_batch, n_alive - inserted)
            batch = order[inserted : inserted + bsz]
            self._insert_batch(batch, vectors, efc, dist, pad_to=cur_batch)
            tracing.count("build.batches")
            inserted += bsz
            if progress_fn:
                progress_fn(inserted, n_alive)
            BUDGET.yield_to_searches()

        self._heal_low_indegree(order)
        _build_sync(self._links0_dev)

    def _build_device(
        self, order: np.ndarray, n_seed: int, n_alive: int, efc: int,
        batch_size: int, dist: str, progress_fn,
    ) -> None:
        """Device-resident batched insertion (ops/hnsw_build.py): every
        level-0 (and upper-level) insert round runs on the device; the
        adjacency stays there across batches and the host sends only batch
        offsets. Codes are bf16 (default) or SQ int8, derived once."""
        from ..ops import hnsw_build as hb
        from ..ops import quantization as qops

        vectors_f32, _ = self.store.device_block()
        dev = vectors_f32.device
        cap = vectors_f32.shape[0]
        n = len(self.store)
        d = self.store.dim
        euclid = self.distance in (Distance.EUCLID, Distance.MANHATTAN)
        # bf16 codes cost 2x the memory of int8 but carry ~5x less scoring
        # noise (and none of the 0.99-quantile clipping bias that int8 SQ
        # applies to exactly the most discriminative components)
        precision = os.environ.get("QDRANT_TPU_BUILD_PRECISION", "bf16")
        if precision == "int8":
            sq = qops.ScalarQuantized.encode(self.store.get_batch(np.arange(n)))
            codes_np = np.zeros((cap, d), dtype=np.int8)
            codes_np[:n] = sq.codes
            norms_np = np.zeros(cap, dtype=np.float32)
            norms_np[:n] = sq.norms_sq
            scale_sq = float(
                np.float32((2.0 if euclid else 1.0) * sq.scale * sq.scale))
            codes_dev = torch.from_numpy(codes_np).to(dev)
            norms_dev = torch.from_numpy(norms_np).to(dev)
        else:
            # bf16 codes + norms derived ON DEVICE from the resident block
            vf = vectors_f32.float()
            codes_dev = vf.to(torch.bfloat16)
            norms_dev = (vf * vf).sum(dim=1)
            del vf
            scale_sq = 2.0 if euclid else 1.0
        rank_dev = self._rank_device()

        def up(a, dtype=np.int32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

        m0 = self.config.m0
        m = self.config.m
        links0_dev = up(self.links0)
        counts0_dev = up(self.counts0)
        owner0_np = np.full(self.links0.shape[0], -1, np.int32)
        owner0_np[self.rank[order]] = order
        owner0_dev = up(owner0_np)
        n_up = self.links_upper.shape[0]
        # one stacked tensor; each level's insert round updates its slice
        upper_stack = up(self.links_upper) if n_up else None
        upper_counts = [up(self.counts_upper[i]) for i in range(n_up)]
        owner_up_dev = None
        if n_up:
            rows_up = self.links_upper.shape[1]
            owner_up_np = np.full(rows_up, -1, np.int32)
            ranks_o = self.rank[order]
            sel_up = ranks_o < rows_up
            owner_up_np[ranks_o[sel_up]] = order[sel_up]
            owner_up_dev = up(owner_up_np)

        # expand=8 halves the beam's sequential iteration count vs expand=4
        # at equal total expansions
        expand = int(os.environ.get("QDRANT_TPU_BUILD_EXPAND", 8))
        iters = max((int(efc * 1.2) + 16) // expand, 8)
        sel_c = min(max(efc, m0), 128)
        inc_cap = int(os.environ.get("QDRANT_TPU_BUILD_INC_CAP", 16))

        # batch ramp: per-point cost falls with batch, but batches beyond
        # 4096 measurably hurt the graph (lockstep batch-mates do not see
        # each other)
        top_batch = int(os.environ.get("QDRANT_TPU_BUILD_TOP_BATCH", 4096))
        # 1024 is in the ramp so cooperative mode (below) has a mid-size
        # shape to drop to
        ramp = [256, 1024, 2048, _pow2_at_least(max(batch_size, top_batch), 256)]
        ramp = sorted({min(r, ramp[-1]) for r in ramp})

        # order uploaded once; per-batch ids/vectors gathered on device
        order_pad = np.full(n_alive + max(ramp[-1], 8192), -1, np.int32)
        order_pad[:n_alive] = order
        order_dev = up(order_pad)
        lane = torch.arange(ramp[-1], device=dev)

        def _prep(start, remaining, b_pad):
            valid = lane[:b_pad] < remaining
            bi = torch.where(valid, order_dev[start : start + b_pad], -1)
            safe = torch.clamp(bi, min=0).long()
            q = torch.where(valid[:, None], vectors_f32[safe].float(), 0.0)
            qi8 = torch.where(valid[:, None], codes_dev[safe], 0)
            return bi, q, qi8

        # Cooperative mode under concurrent search load: when searches are in
        # flight the builder drops to a smaller ramp shape and syncs after
        # every batch, bounding a search's queue wait to ~one small batch.
        throttle_on = float(os.environ.get("QDRANT_TPU_BUILD_THROTTLE_MS", 5)) > 0
        contended_cap = int(os.environ.get("QDRANT_TPU_BUILD_CONTENDED_BATCH", 1024))
        sync_every = int(os.environ.get("QDRANT_TPU_BUILD_SYNC_EVERY", 4))
        batches = collections.Counter()
        self.build_stats.update(
            precision=precision, expand=expand, iters=iters, ramp=ramp,
            contended_batches=0)

        def descend(q_dev, entries, from_level, to_level):
            """Greedy descent through levels from_level..to_level+1."""
            cur_scores = hnsw_ops.score_ids_batch(
                q_dev, vectors_f32, entries[:, None], dist)[:, 0]
            for lev in range(from_level, to_level, -1):
                entries, cur_scores = hnsw_ops.greedy_descend_level(
                    q_dev, vectors_f32, upper_stack[self._stack_index(lev)],
                    rank_dev, entries, cur_scores, dist,
                )
            return entries

        inserted = n_seed
        batches_since_sync = 0
        while inserted < n_alive:
            b_pad = ramp[0]
            for r in ramp:
                if inserted >= 2 * r:
                    b_pad = r
            contended = (
                throttle_on and contended_cap > 0 and BUDGET.search_pressure()
            )
            if contended:
                # largest ramp shape within the cap
                coop = [r for r in ramp if r <= contended_cap] or [ramp[0]]
                b_pad = min(b_pad, coop[-1])
                self.build_stats["contended_batches"] += 1
            bsz = min(b_pad, n_alive - inserted)
            batches[b_pad] += 1
            batch_levels = self.levels[order[inserted : inserted + bsz]]
            bmax = int(batch_levels[0]) if bsz else 0
            bi_dev, q_dev, qi8_dev = _prep(inserted, bsz, b_pad)

            # greedy descent through levels above the batch's top level
            entries = torch.full((b_pad,), self.entry, dtype=torch.int32, device=dev)
            if self.max_level > bmax and n_up:
                entries = descend(q_dev, entries, self.max_level, bmax)

            # masked insertion at upper levels bmax..1
            for lev in range(min(bmax, self.max_level), 0, -1):
                i = self._stack_index(lev)
                kl = int((batch_levels >= lev).sum())
                bi_l = torch.where(lane[:b_pad] < kl, bi_dev, -1)
                _, _, beam = hb.insert_batch_level0(
                    upper_stack[i], upper_counts[i], bi_l, qi8_dev,
                    codes_dev, norms_dev, rank_dev, owner_up_dev, entries,
                    scale_sq, ef=efc, iters=iters, expand=expand, m0=m,
                    inc_cap=inc_cap, ov_cap=256, euclid=euclid, sel_c=sel_c,
                )
                entries = torch.where(beam[:, 0] >= 0, beam[:, 0], self.entry)

            hb.insert_batch_level0(
                links0_dev, counts0_dev, bi_dev, qi8_dev, codes_dev,
                norms_dev, rank_dev, owner0_dev, entries, scale_sq,
                ef=efc, iters=iters, expand=expand, m0=m0,
                inc_cap=inc_cap, ov_cap=b_pad, euclid=euclid, sel_c=sel_c,
            )
            inserted += bsz
            tracing.count("build.batches")
            if progress_fn:
                progress_fn(inserted, n_alive)
            # Backpressure: launches are asynchronous, so without a periodic
            # sync the loop queues far ahead of the device and the
            # cooperative yield below is meaningless. Draining every few
            # batches (every batch under contention) bounds the queue.
            batches_since_sync += 1
            if sync_every and (contended or batches_since_sync >= sync_every):
                _build_sync(links0_dev)
                batches_since_sync = 0
            # let queued searches run before the next build batch
            BUDGET.yield_to_searches()

        # ---- refine pass(es): re-insert points against the FINAL graph.
        # Scale-dependent, DEFAULT OFF. QDRANT_TPU_BUILD_REFINE takes
        # comma-separated fractions (e.g. "1.0" = one full pass).
        refine_spec = os.environ.get("QDRANT_TPU_BUILD_REFINE", "")
        refine_fracs = [float(f) for f in refine_spec.split(",") if f.strip()]
        for refine_frac in refine_fracs:
            n_refine = min(int(n_alive * refine_frac), n_alive)
            if n_refine <= 0:
                continue
            b_pad = ramp[-1]
            # reverse order: the earliest rows (inserted into the sparsest
            # graph) are refined last
            for start in list(range(0, n_refine, b_pad))[::-1]:
                bsz = min(b_pad, n_refine - start)
                bi_dev, q_dev, qi8_dev = _prep(start, bsz, b_pad)
                entries = torch.full((b_pad,), self.entry, dtype=torch.int32, device=dev)
                if n_up:
                    entries = descend(q_dev, entries, self.max_level, 0)
                hb.insert_batch_level0(
                    links0_dev, counts0_dev, bi_dev, qi8_dev, codes_dev,
                    norms_dev, rank_dev, owner0_dev, entries, scale_sq,
                    ef=efc, iters=iters, expand=expand, m0=m0,
                    inc_cap=inc_cap, ov_cap=b_pad, euclid=euclid,
                    sel_c=sel_c, merge_forward=True,
                )
                batches[f"refine_{b_pad}"] += 1
                BUDGET.yield_to_searches()

        # in-degree healing runs on the device; the host mirror is NOT
        # downloaded here, it syncs lazily via the links0/... properties
        hb.heal_low_indegree_device(
            links0_dev, counts0_dev, rank_dev, owner0_dev, m0=m0)
        self._links0_dev = links0_dev
        self._upper_dev = upper_stack
        self._host_stale = True
        self.build_stats["batches"] = {str(k): v for k, v in batches.items()}
        # build() must mean BUILT: the loop above only queues its work, so
        # without this barrier the first search after the build would wait
        # for it, and a wall-clock "build seconds" would time the queueing
        _build_sync(self._links0_dev)

    def _heal_low_indegree(
        self, order: np.ndarray, min_indegree: int = 8, force_links: int = 6
    ) -> None:
        """Post-build connectivity repair: every point with in-degree <
        min_indegree is force-written into the link rows of its own nearest
        forward neighbours, replacing the tail slots. Tail slots rotate per
        healing write so concurrent heals into one hub don't clobber each
        other."""
        n = len(self.levels)
        m0 = self.config.m0
        links = self.links0
        valid = links >= 0
        indeg = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indeg, np.clip(links[valid], 0, n), 1)

        member = order[: int((self.levels[order] >= 0).sum())] if len(order) else order
        weak = [
            int(p)
            for p in member
            if indeg[p] < min_indegree and self.rank[p] >= 0
        ]
        if not weak:
            return
        pairs_t: list = []
        pairs_p: list = []
        for p in weak:
            row = self.rank[p]
            fwd = links[row]
            fwd = fwd[fwd >= 0][:force_links]
            for t in fwd:
                pairs_t.append(int(t))
                pairs_p.append(p)
        if not pairs_t:
            return
        t_arr = np.asarray(pairs_t, dtype=np.int64)
        p_arr = np.asarray(pairs_p, dtype=np.int32)
        sort_idx = np.argsort(t_arr, kind="stable")
        t_s, p_s = t_arr[sort_idx], p_arr[sort_idx]
        uniq, starts, counts = np.unique(t_s, return_index=True, return_counts=True)
        within = np.arange(len(t_s)) - np.repeat(starts, counts)
        window = max(m0 // 4, force_links)
        slots = m0 - 1 - (within % window)
        rows_t = self.rank[t_s]
        self.links0[rows_t, slots] = p_s
        self.counts0[rows_t] = (self.links0[rows_t] >= 0).sum(axis=1).astype(np.int32)
        if self._inline:
            self._inline = None
        if self._links0_dev is not None:
            upd_rows = self.rank[uniq]
            hnsw_ops.scatter_link_rows(
                self._links0_dev, upd_rows.astype(np.int32), self.links0[upd_rows]
            )

    def _build_seed_graph(self, seed_ids: np.ndarray, vectors, dist: str) -> None:
        """All-pairs heuristic linking of the seed set — on the HOST: the
        seed set is a few hundred points, microseconds of numpy."""
        seed_levels = self.levels[seed_ids]
        vecs = self.store.get_batch(seed_ids).astype(np.float32)
        vecs = preprocess_vectors(vecs, self.distance)
        if self.distance in (Distance.EUCLID, Distance.MANHATTAN):
            n2 = (vecs * vecs).sum(axis=1)
            pair = 2.0 * (vecs @ vecs.T) - n2[None, :] - n2[:, None]
        else:
            pair = vecs @ vecs.T
        for l in range(0, int(seed_levels.max()) + 1):
            members = np.nonzero(seed_levels >= l)[0]
            if len(members) == 0:
                continue
            m_l = self._m_at(l)
            sel_rows = np.full((len(members), m_l), -1, dtype=np.int32)
            for r, i in enumerate(members):
                others = members[members != i]
                order = others[np.argsort(-pair[i, others], kind="stable")]
                kept: list = []
                for c in order:
                    if len(kept) >= m_l:
                        break
                    if all(pair[c, s] <= pair[i, c] for s in kept):
                        kept.append(int(c))
                sel_rows[r, : len(kept)] = seed_ids[kept]
            ids = seed_ids[members]
            self._scatter(l, self._row_of(l, ids), sel_rows)

    def _insert_batch(
        self, batch: np.ndarray, vectors, efc: int, dist: str, pad_to: int
    ) -> None:
        b_pad = _pow2_at_least(pad_to, 8)
        dev = vectors.device
        qs = _pad_rows(self.store.get_batch(batch).astype(np.float32), b_pad, 0.0)
        q_dev = torch.from_numpy(np.ascontiguousarray(qs)).to(dev)
        batch_levels = self.levels[batch]  # desc sorted
        batch_max = int(batch_levels[0])
        rank_dev = self._rank_device()

        cur = torch.full((b_pad,), self.entry, dtype=torch.int32, device=dev)
        cur_scores = hnsw_ops.score_ids_batch(q_dev, vectors, cur[:, None], dist)[:, 0]

        # 1) greedy descent through levels above any insertion
        upper = self._upper_device()
        if upper is not None and self.max_level > batch_max:
            n_desc = self.max_level - batch_max  # stack indices [0, n_desc)
            cur, cur_scores = hnsw_ops.greedy_descend_stack(
                q_dev, vectors, upper[:n_desc], rank_dev,
                self._stack_counts()[:n_desc], cur, cur_scores, dist,
            )

        # 2) per-level insertion from batch_max down to 0
        ent_dev = cur[:, None]
        max_iters = int(efc * 1.2) + 16
        for l in range(batch_max, -1, -1):
            kl = int((batch_levels >= l).sum())
            if l == 0:
                links_l = self._links0_device()
            else:
                links_l = self._upper_device()[self._stack_index(l)]
            beam_scores, beam_ids = hnsw_ops.beam_search_level(
                q_dev, vectors, links_l, ent_dev, None, efc, max_iters, dist,
                compact_of=rank_dev,
            )
            m_l = self._m_at(l)
            sel = hnsw_ops.select_neighbors(beam_ids, beam_scores, vectors, m_l, dist)
            sel_np = _to_host(sel, np.int32)[:kl]

            tracing.count("build.insert_rounds")
            rows = self._row_of(l, batch[:kl])
            self._scatter(l, rows, sel_np)
            self._apply_reverse_links(l, batch[:kl], sel_np, vectors, dist)
            ent_dev = beam_ids

    def _apply_reverse_links(
        self, level: int, points: np.ndarray, sel: np.ndarray, vectors, dist: str
    ) -> None:
        """Add `points` to their selected neighbours' link rows, repruning
        overflowed rows with the device heuristic. Shape-stable: candidate
        arrays are always [k_pow2, cap + INC_CAP]."""
        cap = self._m_at(level)
        dev = vectors.device
        nb_flat = sel.reshape(-1)
        p_flat = np.repeat(points.astype(np.int32), sel.shape[1])
        ok = nb_flat >= 0
        nb_flat, p_flat = nb_flat[ok], p_flat[ok]

        while len(nb_flat) > 0:
            sort_idx = np.argsort(nb_flat, kind="stable")
            nb_s, p_s = nb_flat[sort_idx], p_flat[sort_idx]
            uniq, starts, counts = np.unique(nb_s, return_index=True, return_counts=True)
            within = np.arange(len(nb_s)) - np.repeat(starts, counts)
            defer = within >= INC_CAP
            next_nb, next_p = nb_s[defer], p_s[defer]
            nb_s, p_s, within = nb_s[~defer], p_s[~defer], within[~defer]
            uniq, starts, counts = np.unique(nb_s, return_index=True, return_counts=True)

            rows_u = self._row_of(level, uniq)
            cur_counts = self._link_counts(level, rows_u)
            fits = counts <= (cap - cur_counts)

            # --- direct placement (no overflow) ---
            fit_pairs = np.repeat(fits, counts)
            if fit_pairs.any():
                nb_fit = nb_s[fit_pairs]
                p_fit = p_s[fit_pairs]
                w_fit = within[fit_pairs]
                rows_fit = self._row_of(level, nb_fit)
                slots = self._link_counts(level, rows_fit) + w_fit
                if level == 0:
                    self.links0[rows_fit, slots] = p_fit
                else:
                    self.links_upper[self._stack_index(level), rows_fit, slots] = p_fit
                u_fit_rows = self._row_of(level, uniq[fits])
                self._add_link_counts(level, u_fit_rows, counts[fits].astype(np.int32))
                new_rows = self._links_host(level, u_fit_rows)
                if level == 0:
                    if self._links0_dev is not None:
                        hnsw_ops.scatter_link_rows(self._links0_dev, u_fit_rows, new_rows)
                elif self._upper_dev is not None:
                    hnsw_ops.scatter_link_rows(
                        self._upper_dev[self._stack_index(level)], u_fit_rows, new_rows)

            # --- overflow: device reprune with fixed candidate shape ---
            over = ~fits
            if over.any():
                u_over = uniq[over]
                k = len(u_over)
                rows_over = self._row_of(level, u_over)
                c_total = cap + INC_CAP
                k_pad = _pow2_at_least(k, 8)
                cands = np.full((k_pad, c_total), -1, dtype=np.int32)
                cands[:k, :cap] = self._links_host(level, rows_over)
                over_pairs = np.repeat(over, counts)
                nb_o, p_o, w_o = nb_s[over_pairs], p_s[over_pairs], within[over_pairs]
                k_idx = np.searchsorted(u_over, nb_o)
                cands[k_idx, cap + w_o] = p_o
                nb_p = np.zeros(k_pad, dtype=np.int32)
                nb_p[:k] = u_over
                new_rows = _to_host(
                    hnsw_ops.reprune_rows(
                        torch.from_numpy(nb_p).to(dev), torch.from_numpy(cands).to(dev),
                        vectors, cap, dist,
                    ),
                    np.int32,
                )[:k]
                self._scatter(level, rows_over, new_rows)

            nb_flat, p_flat = next_nb, next_p

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    def memory_usage_bytes(self):
        """Host adjacency + device mirrors + the fused inline link+code table
        (the dominant device entry at rows*(8*m0 + m0*d))."""
        from ..utils.memsize import merge, sizeof_attrs

        tensors = [self._links0_dev, self._upper_dev, self._rank_dev,
                   self._stack_counts_dev]
        if isinstance(self._inline, dict):
            tensors.append(self._inline["table"])
        return merge(
            sizeof_attrs(
                self, "rank", "levels", "_links0_host", "_links_upper_host",
                "_counts0_host", "_counts_upper_host",
            ),
            {"device_bytes": tensor_bytes(*tensors)},
        )

    def _inline_state(self) -> Optional[dict]:
        """Build (lazily) the fused link+code table for level-0 beam search
        (ops/hnsw_inline.py). On the card only (or QDRANT_TPU_INLINE=force);
        invalidated on any link mutation; skipped when the table would not
        fit comfortably in device memory."""
        if self._inline is not None:
            return self._inline or None

        d = self.store.dim
        m0 = self.config.m0
        enable = os.environ.get("QDRANT_TPU_INLINE", "1")
        have_adj = self._links0_dev is not None or self._links0_host is not None
        if (
            enable == "0"
            or (not _on_card() and enable != "force")
            or not have_adj
            or self.distance is Distance.MANHATTAN
        ):
            self._inline = False
            return None
        rows = (
            self._links0_dev.shape[0]
            if self._links0_dev is not None
            else self._links0_host.shape[0]
        )
        table_bytes = rows * (8 * m0 + m0 * d)
        max_bytes = int(
            os.environ.get("QDRANT_TPU_INLINE_MAX_BYTES", 6_000_000_000)
        )
        if table_bytes > max_bytes:
            self._inline = False
            return None
        from ..ops.hnsw_inline import pack_linkcodes_device

        # codes + norms are SQ-encoded ON DEVICE from the resident block and
        # the table is assembled on device from the device-resident
        # adjacency. Only the clip bound comes from a small host value sample
        # (quantile of |v| over <=1M samples, same rule as
        # ScalarQuantized.encode).
        n_live = len(self.store)
        max_rows = max(1, min(n_live, 1_000_000 // max(d, 1) + 1))
        if n_live > max_rows:
            rng = np.random.default_rng(0)
            sample_ids = rng.integers(0, n_live, max_rows)
        else:
            sample_ids = np.arange(n_live)
        flat = np.asarray(
            self.store.get_batch(sample_ids), dtype=np.float32
        ).reshape(-1)
        bound = max(float(np.quantile(np.abs(flat), 0.99)), 1e-12) if flat.size else 1.0
        scale = bound / 127.0
        vecs_dev, _ = self.store.device_block()
        vf = vecs_dev.float()
        codes_dev = torch.clamp(
            torch.round(vf / float(np.float32(scale))), -127, 127).to(torch.int8)
        norms_dev = (vf * vf).sum(dim=1)
        del vf
        if vecs_dev.dtype != torch.float32:
            # reduced-precision scoring dtype (f16/bf16): the device block
            # has already lost bits, so ||v||^2 from it is inexact. Recompute
            # norms from the f32 originals.
            host = np.asarray(self.store.get_batch(np.arange(n_live)), dtype=np.float32)
            norms_host = (host * host).sum(axis=1).astype(np.float32)
            pad = vecs_dev.shape[0] - norms_host.shape[0]
            if pad > 0:
                norms_host = np.pad(norms_host, (0, pad))
            norms_dev = torch.from_numpy(norms_host).to(vecs_dev.device)
        # pad rows beyond the live prefix carry whatever the block holds;
        # the adjacency never points at them, so their codes are never read
        table = pack_linkcodes_device(self._links0_device(), codes_dev, norms_dev)
        self._inline = {"table": table, "scale": scale, "m0": m0, "d": d}
        return self._inline

    @tracing.traced("hnsw.search")
    def search(
        self,
        queries: np.ndarray,  # [B, D] raw queries
        k: int,
        ef: Optional[int] = None,
        filter_mask: Optional[np.ndarray] = None,  # [n] bool
        acorn: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores [B, k], offsets [B, k]), -1 padded."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b = queries.shape[0]
        if self.entry < 0:
            return (
                np.full((b, k), -np.inf, dtype=np.float32),
                np.full((b, k), -1, dtype=np.int32),
            )
        b_pad = _pow2_at_least(b, 8)
        q = _pad_rows(preprocess_vectors(queries, self.distance), b_pad, 0.0)
        vectors, _ = self.store.device_block()
        dev = vectors.device
        q_dev = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
        dist = self.distance.value
        ef_eff = max(ef or self.config.ef_construct, k)

        with tracing.span("hnsw.descend"):
            cur = torch.full((b_pad,), self.entry, dtype=torch.int32, device=dev)
            cur_scores = hnsw_ops.score_ids_batch(q_dev, vectors, cur[:, None], dist)[:, 0]
            upper = self._upper_device()
            if upper is not None:
                cur, cur_scores = hnsw_ops.greedy_descend_stack(
                    q_dev, vectors, upper, self._rank_device(), self._stack_counts(),
                    cur, cur_scores, dist,
                )

        mask_dev = None
        if filter_mask is not None:
            cap = vectors.shape[0]
            fm = np.zeros(cap, dtype=bool)
            fm[: len(filter_mask)] = filter_mask
            mask_dev = torch.from_numpy(fm).to(dev)

        # beam seeds: the greedy-descent winner, plus optionally a fixed
        # seeded spread of extra graph nodes
        entries2d = cur[:, None]
        n_extra = int(os.environ.get("QDRANT_TPU_SEARCH_EXTRA_ENTRIES", "0"))
        if n_extra > 0 and self.levels is not None:
            nodes = np.flatnonzero(self.levels >= 0)
            if len(nodes) > n_extra:
                extra = np.random.default_rng(0x5EED).choice(
                    nodes, size=n_extra, replace=False
                ).astype(np.int32)
                extra_dev = torch.from_numpy(extra).to(dev)[None, :].expand(b_pad, n_extra)
                # a seed equal to the greedy winner would duplicate a beam
                # slot; -1 seeds are inert in every beam program
                extra_dev = torch.where(extra_dev == cur[:, None], -1, extra_dev)
                entries2d = torch.cat([entries2d, extra_dev], dim=1)

        max_iters = int(
            (2 * ef_eff + 16)
            * float(os.environ.get("QDRANT_TPU_SEARCH_ITERS_MULT", "1"))
        )
        inline = None if (acorn and mask_dev is not None) else self._inline_state()
        with tracing.span("hnsw.beam"):
            beam_scores, beam_ids = self._beam(
                q, q_dev, vectors, entries2d, mask_dev, filter_mask, inline, acorn,
                ef_eff, max_iters, dist)
        with tracing.span("device.fetch"):
            scores = _to_host(beam_scores, np.float32)[:b]
            ids = _to_host(beam_ids, np.int32)[:b]
        # entries bypass the filter inside the beam; enforce it here
        if filter_mask is not None:
            ok = (ids >= 0) & filter_mask[np.maximum(ids, 0)]
            scores = np.where(ok, scores, -np.inf)
            ids = np.where(ok, ids, -1)
            order = np.argsort(-scores, axis=1, kind="stable")
            scores = np.take_along_axis(scores, order, axis=1)
            ids = np.take_along_axis(ids, order, axis=1)
        ids = np.where(np.isfinite(scores), ids, -1)
        if k <= scores.shape[1]:
            return scores[:, :k], ids[:, :k]
        pad = k - scores.shape[1]
        return (
            np.pad(scores, ((0, 0), (0, pad)), constant_values=-np.inf),
            np.pad(ids, ((0, 0), (0, pad)), constant_values=-1),
        )

    def _beam(self, q, q_dev, vectors, entries2d, mask_dev, filter_mask, inline, acorn,
              ef_eff, max_iters, dist):
        """The level-0 beam a search takes: ACORN under a selective filter,
        else the inline link + code table where it is built, else the level
        program → device (scores, ids)."""
        dev = vectors.device
        if acorn and mask_dev is not None:
            self.served["acorn"] += 1
            return hnsw_ops.beam_search_acorn(
                q_dev, vectors, self._links0_device(), entries2d, mask_dev,
                ef_eff, max_iters, dist, compact_of=self._rank_device(), counter="beam",
            )
        if inline is not None:
            from ..ops.hnsw_inline import beam_search_inline

            self.served["inline"] += 1
            scale = inline["scale"]
            q_i8 = torch.from_numpy(
                np.clip(np.round(q / scale), -127, 127).astype(np.int8)
            ).to(dev)
            euclid = self.distance is Distance.EUCLID
            fbias = None
            if filter_mask is not None:
                cap = vectors.shape[0]
                fb = np.full(cap, -np.inf, dtype=np.float32)
                fb[: len(filter_mask)] = np.where(filter_mask, 0.0, -np.inf)
                fbias = torch.from_numpy(fb).to(dev)
            expand = 4
            return beam_search_inline(
                q_dev, q_i8, inline["table"],
                float(np.float32((2.0 if euclid else 1.0) * scale * scale)),
                self._rank_device(), vectors, entries2d, fbias,
                m=inline["m0"], d=inline["d"], ef=ef_eff,
                iters=max(max_iters // expand, 8), expand=expand,
                euclid=euclid, k=ef_eff, counter="beam",
            )
        self.served["level"] += 1
        return hnsw_ops.beam_search_level(
            q_dev, vectors, self._links0_device(), entries2d, mask_dev,
            ef_eff, max_iters, dist, compact_of=self._rank_device(), counter="beam",
        )

    # ------------------------------------------------------------------
    # persistence (the JAX package's files)
    # ------------------------------------------------------------------

    @tracing.traced("hnsw.save")
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "hnsw_graph.npz"),
            levels=self.levels,
            rank=self.rank,
            links0=self.links0,
            counts0=self.counts0,
            links_upper=self.links_upper,
            counts_upper=self.counts_upper,
        )
        with open(os.path.join(path, "hnsw_meta.json"), "w") as f:
            json.dump(
                {
                    "entry": self.entry,
                    "max_level": self.max_level,
                    "level_counts": self.level_counts,
                    "m": self.config.m,
                    "ef_construct": self.config.ef_construct,
                },
                f,
            )

    @classmethod
    def load(cls, path: str, store: DenseVectorStore, config: HnswConfig) -> "HnswIndex":
        idx = cls(store, config)
        with open(os.path.join(path, "hnsw_meta.json")) as f:
            meta = json.load(f)
        idx.entry = meta["entry"]
        idx.max_level = meta["max_level"]
        idx.level_counts = {int(k): v for k, v in meta["level_counts"].items()}
        with np.load(os.path.join(path, "hnsw_graph.npz")) as data:
            idx.levels = data["levels"]
            idx.rank = data["rank"]
            idx.links0 = data["links0"]
            idx.counts0 = data["counts0"]
            idx.links_upper = data["links_upper"]
            idx.counts_upper = data["counts_upper"]
        return idx


class ShardedHnswIndex:
    """Multi-device graph serving (counterpart of
    qdrant_tpu/index/hnsw.py::ShardedHnswIndex): S independent per-row-slice
    subgraphs searched on every shard of a mesh
    (parallel/mesh.py::sharded_hnsw_search) and merged.

    Each shard holds one contiguous row slice of np_local rows (rows stay
    shard-major, so a local row plus shard * np_local is the store offset):
    its rows (views of the store's device block where the shard's device is
    the block's), a LOCAL-offset level-0 adjacency [np_local, M0] and an
    entry point (-1: an empty or fully deleted shard, inert). Build: the
    subgraphs are built one after another with the single-device builder
    (`HnswIndex(subset=...)`), then re-based to local offsets on the device
    (a subset build links only slice members). Upper levels are not served:
    each shard's beam starts at its own entry, and np_local = n / S keeps the
    level-0 walk short. Searches run the level beam on every shard (no
    inline table, no ACORN beam, as in the JAX index); the files are the JAX
    package's (`hnsw_sharded.npz`, `hnsw_meta.json` with `sharded` and
    `n_shards`).
    """

    def __init__(self, store: DenseVectorStore, config: HnswConfig, seed: int = 42,
                 mesh=None):
        self.store = store
        self.config = config
        self.seed = seed
        self.distance: Distance = store.distance
        self.mesh = mesh
        self.n_shards = 0
        self.n_per_shard = 0
        self._v = None  # per shard [<= Np, D] rows
        self._links = None  # per shard [Np, M0], local-offset values
        self._entries: Optional[np.ndarray] = None  # [S] int32 local entry, -1 inert
        self._alive: Optional[np.ndarray] = None  # [S*Np] bool host (pad rows False)
        self._mask_cache: Dict[bytes, list] = {}
        self.served: collections.Counter = collections.Counter()
        self.build_stats: dict = {}

    # -- build ----------------------------------------------------------

    @tracing.traced("hnsw.build")
    def build(self, batch_size: int = 1024, ef_construct: Optional[int] = None,
              progress_fn=None) -> None:
        """Build one subgraph per shard; `build_stats` gives the seconds of
        the whole build and of each shard's."""
        t0 = time.perf_counter()
        if self.mesh is None:
            self.mesh = make_mesh()
        s_count = self.mesh.size
        n = len(self.store)
        alive_mask = ~self.store.deleted_mask
        np_local = max((n + s_count - 1) // s_count, 8)
        np_local = (np_local + 127) // 128 * 128
        v, _ = self.store.device_block()
        links = torch.full((s_count * np_local, self.config.m0), -1, dtype=torch.int32,
                           device=v.device)
        entries = np.full(s_count, -1, np.int32)
        shard_stats = []
        for s in range(s_count):
            lo = s * np_local
            hi = min(lo + np_local, n)
            ids = (np.nonzero(alive_mask[lo:hi])[0] + lo).astype(np.int32)
            if len(ids) == 0:
                continue  # inert: no rows, or all deleted
            with tracing.span("mesh.subgraph", shard=s, rows=len(ids), card=str(v.device)):
                sub = HnswIndex(self.store, self.config, seed=self.seed + s, subset=ids)
                sub.build(batch_size=batch_size, ef_construct=ef_construct)
                ids_dev = torch.from_numpy(ids.astype(np.int64)).to(v.device)
                lk = sub._links0_device()[sub._rank_device()[ids_dev].long()]
                links[ids_dev] = torch.where(lk >= 0, lk - lo, -1).to(torch.int32)
                entries[s] = sub.entry - lo
                shard_stats.append(sub.build_stats)
                del sub
            if progress_fn:
                progress_fn(hi, n)
        alive = np.zeros(s_count * np_local, dtype=bool)
        alive[:n] = alive_mask[:n]
        self._install(links, entries, alive, np_local)
        _build_sync(links)
        self.build_stats = {
            "points": int(sum(st["points"] for st in shard_stats)),
            "shards": s_count,
            "device_build": bool(shard_stats) and all(
                st.get("device_build") for st in shard_stats),
            "shard_seconds": [st["seconds"] for st in shard_stats],
            "seconds": time.perf_counter() - t0,
        }

    def _install(self, links: torch.Tensor, entries: np.ndarray, alive: np.ndarray,
                 np_local: int) -> None:
        """Lay a shard-major level-0 table [S*Np, M0] (any device or the
        host), the entries and the alive rows out on the mesh (a `mesh.place`
        span: it returns once every card holds its part)."""
        v, _ = self.store.device_block()
        with placing(self.mesh):
            self._v = shard_slices(v, self.mesh, np_local)
            self._links = place_rows(links if self.mesh.one_device else links.cpu(),
                                     self.mesh)
        self._entries = np.asarray(entries, dtype=np.int32)
        self._alive = np.asarray(alive, dtype=bool)
        self._mask_cache.clear()
        self.n_shards = self.mesh.size
        self.n_per_shard = np_local

    # -- search ---------------------------------------------------------

    def _mask_sharded(self, mask: np.ndarray) -> list:
        """Per-shard device copies of a [S*Np] bool mask, digest-cached (a
        repeated filter reuses them)."""
        import hashlib

        key = hashlib.blake2b(np.ascontiguousarray(mask), digest_size=16).digest()
        hit = self._mask_cache.get(key)
        if hit is None:
            if len(self._mask_cache) >= 16:
                self._mask_cache.pop(next(iter(self._mask_cache)))
            hit = self._mask_cache[key] = place_rows(torch.from_numpy(mask), self.mesh)
        return hit

    @tracing.traced("hnsw.search")
    def search(
        self,
        queries: np.ndarray,
        k: int,
        ef: Optional[int] = None,
        filter_mask: Optional[np.ndarray] = None,
        acorn: bool = False,  # noqa: ARG002 — the sharded beam is mask-biased
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores [B, k], offsets [B, k]), -1 padded. Offsets are global
        store offsets (shard-major rows coincide with store offsets)."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b = queries.shape[0]
        if self._v is None or self.n_shards == 0:
            return (np.full((b, k), -np.inf, dtype=np.float32),
                    np.full((b, k), -1, dtype=np.int32))
        b_pad = _pow2_at_least(b, 8)
        q = _pad_rows(preprocess_vectors(queries, self.distance), b_pad, 0.0)
        mask = self._alive
        if filter_mask is not None:
            fm = np.zeros(mask.shape[0], dtype=bool)
            m = min(len(filter_mask), mask.shape[0])
            fm[:m] = filter_mask[:m]
            mask = mask & fm
        ef_eff = max(ef or self.config.ef_construct, k)
        self.served["level"] += 1
        with tracing.span("hnsw.beam"):
            s, ids = sharded_hnsw_search(
                self.mesh, torch.from_numpy(q).to(self.mesh.devices[0]), self._v,
                self._links, self._entries, self._mask_sharded(mask),
                self.distance.value, ef_eff, k,
            )
        with tracing.span("device.fetch"):
            scores = _to_host(s, np.float32)[:b]
            out_ids = _to_host(ids, np.int32)[:b]
        # per-shard entry points bypass the in-beam filter (traversal must be
        # able to start anywhere): enforce alive and the filter on the merged
        # results, then re-sort (stable)
        ok = (out_ids >= 0) & mask[np.maximum(out_ids, 0)]
        scores = np.where(ok, scores, -np.inf)
        out_ids = np.where(ok, out_ids, -1)
        order = np.argsort(-scores, axis=1, kind="stable")
        scores = np.take_along_axis(scores, order, axis=1)
        out_ids = np.take_along_axis(out_ids, order, axis=1)
        if k > scores.shape[1]:
            pad = k - scores.shape[1]
            scores = np.pad(scores, ((0, 0), (0, pad)), constant_values=-np.inf)
            out_ids = np.pad(out_ids, ((0, 0), (0, pad)), constant_values=-1)
        return scores, out_ids

    def memory_usage_bytes(self):
        """Host alive mask and entries; on the device the adjacency (each
        distinct storage once) and any rows not viewed from the store's
        block."""
        from ..utils.memsize import merge, sizeof_attrs

        rows, block = [], getattr(self.store, "_dev", None)
        if self._v is not None:
            src = None if block is None else block.untyped_storage().data_ptr()
            rows = [r for r in self._v if r.untyped_storage().data_ptr() != src]
        return merge(
            sizeof_attrs(self, "_alive", "_entries"),
            {"device_bytes": storage_bytes(*(self._links or []), *rows)},
        )

    # -- persistence (the JAX package's files) ----------------------------

    @tracing.traced("hnsw.save")
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "hnsw_sharded.npz"),
            links=np.concatenate([_to_host(t, np.int32) for t in self._links]),
            entries=self._entries,
            alive=self._alive,
        )
        with open(os.path.join(path, "hnsw_meta.json"), "w") as f:
            json.dump(
                {
                    "sharded": True,
                    "n_shards": self.n_shards,
                    "n_per_shard": self.n_per_shard,
                    "m": self.config.m,
                    "ef_construct": self.config.ef_construct,
                },
                f,
            )

    @classmethod
    def load(cls, path: str, store: DenseVectorStore, config: HnswConfig,
             mesh=None) -> "ShardedHnswIndex":
        """Load onto `mesh` (default: the process's mesh); a mesh of another
        size than the saved one rebuilds the subgraphs for it."""
        idx = cls(store, config, mesh=mesh or make_mesh())
        with open(os.path.join(path, "hnsw_meta.json")) as f:
            meta = json.load(f)
        if idx.mesh.size != int(meta["n_shards"]):
            idx.build()  # topology changed since the save
            return idx
        with np.load(os.path.join(path, "hnsw_sharded.npz")) as data:
            idx._install(torch.from_numpy(data["links"].astype(np.int32)), data["entries"],
                         data["alive"], int(meta["n_per_shard"]))
        return idx


def load_hnsw_any(path: str, store: DenseVectorStore, config: HnswConfig):
    """Load whichever graph flavour was saved at `path`: the single-device
    HnswIndex, or the mesh-sharded ShardedHnswIndex (`hnsw_sharded.npz`)."""
    if os.path.exists(os.path.join(path, "hnsw_sharded.npz")):
        return ShardedHnswIndex.load(path, store, config)
    return HnswIndex.load(path, store, config)
