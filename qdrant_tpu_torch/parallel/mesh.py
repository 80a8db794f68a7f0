"""Device-mesh parallel search: shard scatter-gather over an ordered list of
torch devices (counterpart of qdrant_tpu/parallel/mesh.py).

Reference equivalence: qdrant fans a query out over segments/shards on
threadpools and merges top-k on the coordinator
(lib/collection/src/collection_manager/segments_searcher.rs:212-306). The
JAX package maps that onto one `shard_map` program over a
`jax.sharding.Mesh`: each device holds one row slice (vectors, HNSW
adjacency), scores a replicated query batch locally, and the local top-k are
all-gathered and merged.

Here one process drives the mesh's devices, as the JAX package's single
controller does. A sharded operand is a list with one tensor per shard, each
on its shard's device; `shard_rows` cuts a row-major tensor into that form
(views where a shard's device is the tensor's own). Every program launches
its local work on every shard before any host sync, offsets the local ids by
`shard * np_local` (-1 stays -1), copies the per-shard [B, k] candidates to
the mesh's first device and merges them with one top-k over the shard-major
concatenation: the layout of JAX's `all_gather`, so equal scores keep JAX's
order. A mesh may repeat a device (`device.set_logical_devices`): its shards
then run one after another on that card, with the same launches and merge.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..device import mesh_devices
from ..ops import hnsw as hnsw_ops
from ..ops.distances import score_dense
from ..ops.fused_scan import fused_scan_rescore, scan_grid

SHARD_AXIS = "shard"
MESH_ENV = "QDRANT_TPU_MESH"  # "0" keeps every index on one device


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices, one per shard (a device may repeat)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def one_device(self) -> bool:
        """Every shard lies on one device: sharded tensors are views of one."""
        return len(set(self.devices)) == 1


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A mesh over `device.mesh_devices(n_devices)`."""
    return Mesh(tuple(mesh_devices(n_devices)))


def mesh_enabled() -> bool:
    """The gate the JAX package puts on its sharded scan and graph: more
    than one mesh device, and QDRANT_TPU_MESH not "0"."""
    return os.environ.get(MESH_ENV, "1") != "0" and len(mesh_devices()) > 1


def shard_rows(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Cut a row-major tensor shard-major into `mesh.size` equal slices, each
    on its shard's device: a view where that is `t`'s device, a copy
    otherwise."""
    rows, rem = divmod(t.shape[0], mesh.size)
    if rem:
        raise ValueError(f"{t.shape[0]} rows do not split into {mesh.size} shards")
    return [t[s * rows : (s + 1) * rows].to(dev) for s, dev in enumerate(mesh.devices)]


def place_rows(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """A host tensor → its shard-major slices on the mesh: views of one
    upload where every shard lies on one device, one upload per shard
    otherwise."""
    return shard_rows(t.to(mesh.devices[0]) if mesh.one_device else t, mesh)


def shard_slices(t: torch.Tensor, mesh: Mesh, np_local: int) -> List[torch.Tensor]:
    """Per-shard row slices [s * np_local, (s + 1) * np_local) of a table
    that may hold fewer rows than the mesh (a store's rows): each slice is
    cut short at the table's end, and a shard past it gets one zero row (its
    candidates are all -1, whose guarded gathers read row 0). Views where a
    shard's device is `t`'s, copies otherwise."""
    out = []
    for s, dev in enumerate(mesh.devices):
        piece = t[s * np_local : (s + 1) * np_local]
        if piece.shape[0] == 0:
            piece = torch.zeros((1,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
        out.append(piece.to(dev))
    return out


def _offset_ids(ids: torch.Tensor, shard: int, np_local: int) -> torch.Tensor:
    return torch.where(ids >= 0, ids + shard * np_local, -1)


def _merge(mesh: Mesh, scores: Sequence[torch.Tensor], gids: Sequence[torch.Tensor],
           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-shard [B, k_s] candidates → the best k on the first device, over
    their shard-major concatenation (JAX's all_gather layout; equal scores
    keep the lower position)."""
    dev0 = mesh.devices[0]
    flat_s = torch.cat([s.to(dev0) for s in scores], dim=1)
    flat_g = torch.cat([g.to(dev0) for g in gids], dim=1)
    ms, mi = hnsw_ops.topk_first(flat_s, min(k, flat_s.shape[1]))
    return ms, flat_g.gather(1, mi)


# ---------------------------------------------------------------------------
# sharded exact search
# ---------------------------------------------------------------------------


def sharded_exact_search(
    mesh: Mesh,
    queries: torch.Tensor,  # [B, D] (replicated)
    vectors: Sequence[torch.Tensor],  # per shard [Np, D]
    valid: Sequence[torch.Tensor],  # per shard [Np] bool
    distance: str,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data-parallel full scan: local scoring + local top-k on every shard,
    then a merge of the [B, k] candidates → (scores [B, k], global ids
    [B, k]) on the first device."""
    scores, gids = [], []
    for s, (dev, v, m) in enumerate(zip(mesh.devices, vectors, valid)):
        local = score_dense(queries.to(dev), v, distance, m)
        ls, li = hnsw_ops.topk_first(local, min(k, v.shape[0]))
        scores.append(ls)
        gids.append(li.to(torch.int32) + s * v.shape[0])
    return _merge(mesh, scores, gids, k)


# ---------------------------------------------------------------------------
# sharded HNSW search
# ---------------------------------------------------------------------------


def _beam_loops(mesh, queries, vectors, links, entries, filter_mask, distance, ef,
                max_iters):
    """One level-0 beam loop per shard, each seeded at its shard's entry
    (-1: an inert shard whose beam finds nothing)."""
    loops = []
    for s, dev in enumerate(mesh.devices):
        q = queries[s] if isinstance(queries, (list, tuple)) else queries.to(dev)
        entry = torch.full((q.shape[0], 1), int(entries[s]), dtype=torch.int32, device=dev)
        fm = None if filter_mask is None else filter_mask[s]
        loops.append(hnsw_ops.level_beam_loop(
            q, vectors[s], links[s], entry, fm, ef, max_iters, distance))
    return loops


def sharded_hnsw_search(
    mesh: Mesh,
    queries: torch.Tensor,  # [B, D] replicated
    vectors: Sequence[torch.Tensor],  # per shard [<= Np, D] (shard_slices)
    links: Sequence[torch.Tensor],  # per shard [Np, M0] (local-offset adjacency)
    entries: Sequence[int],  # per shard entry point (local offset, -1 = inert)
    filter_mask: Optional[Sequence[torch.Tensor]],  # per shard [Np] bool
    distance: str,
    ef: int,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every shard runs the batched level beam over its local graph; the
    beams advance in lockstep (`hnsw_ops.run_all_until_idle`: one stride of
    turns on each shard, then one idle check over all of them), and the
    per-shard top-k are merged → (scores [B, k], global ids [B, k])."""
    loops = _beam_loops(mesh, queries, vectors, links, entries, filter_mask, distance,
                        ef, 2 * ef + 16)
    scores, gids = [], []
    states = hnsw_ops.run_all_until_idle(loops, counter="beam")
    for s, (beam_ids, beam_scores, _) in enumerate(states):
        ls, idx = hnsw_ops.topk_first(beam_scores, min(k, beam_scores.shape[1]))
        scores.append(ls)
        gids.append(_offset_ids(beam_ids.gather(1, idx), s, links[s].shape[0]))
    return _merge(mesh, scores, gids, k)


# ---------------------------------------------------------------------------
# sharded build step (one batched-insert search round on every shard)
# ---------------------------------------------------------------------------


def sharded_build_step(
    mesh: Mesh,
    batch_queries: Sequence[torch.Tensor],  # per shard [Bb, D]: each shard its own batch
    vectors: Sequence[torch.Tensor],  # per shard [Np, D]
    links: Sequence[torch.Tensor],  # per shard [Np, M0]
    entries: Sequence[int],  # per shard entry (local offset)
    distance: str,
    ef_construct: int,
    m: int,
) -> List[torch.Tensor]:
    """One device-parallel graph-build round: per-shard candidate beam
    search + heuristic neighbour selection for a batch of new points →
    per shard the selected local rows [Bb, m], on the shard's device (the
    caller applies them to each shard's adjacency)."""
    loops = _beam_loops(mesh, list(batch_queries), vectors, links, entries, None,
                        distance, ef_construct, int(ef_construct * 1.2) + 16)
    return [
        hnsw_ops.select_neighbors(beam_ids, beam_scores, vectors[s], m, distance)
        for s, (beam_ids, beam_scores, _) in enumerate(hnsw_ops.run_all_until_idle(loops))
    ]


# ---------------------------------------------------------------------------
# sharded fused scan + rescore (the ScanIndex hot path over a mesh)
# ---------------------------------------------------------------------------


def sharded_scan_rescore(
    mesh: Mesh,
    queries: torch.Tensor,  # [B, Dp] f32 (replicated)
    v_bf16: Sequence[torch.Tensor],  # per shard [Np, Dp] bf16 (x2 for euclid)
    bias: Sequence[torch.Tensor],  # per shard [Np] f32 (-||v||^2 / NEG_INF)
    v_f32: Sequence[torch.Tensor],  # per shard rescore rows [<= Np, D], local offsets
    blk: int,
    k_fetch: int,
    k: int,
    euclid: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every shard runs the fused scan kernel (ops/fused_scan.py: the kernel
    on the card, its plain version on the CPU) and the exact f32 rescore of
    its k_fetch survivors over ITS rows, then the per-shard top-k are merged
    → (scores [B, k'], global ids [B, k'], -1 where no finite score), k' =
    min(k, size * min(k, k_fetch)). Euclid scores are -(q-v)^2."""
    k_loc = min(k, k_fetch)
    scores, gids = [], []
    for s, dev in enumerate(mesh.devices):
        np_local = v_bf16[s].shape[0]
        sblk, slots = scan_grid(np_local, k_fetch, blk)
        q = queries.to(dev)
        ls, li = fused_scan_rescore(q, q, v_bf16[s], bias[s], v_f32[s], k_fetch, k_loc,
                                    blk=sblk, slots=slots, euclid=euclid)
        scores.append(ls)
        gids.append(_offset_ids(li, s, np_local))
    ms, mg = _merge(mesh, scores, gids, k)
    return ms, torch.where(torch.isfinite(ms), mg, -1)
