"""Carrying state from the JAX package to the port.

The main route needs no conversion: a storage directory written by
`qdrant_tpu` (collection.json, WAL, segment.json, numpy `.npy` vector files,
msgpack payloads) opens unchanged in `qdrant_tpu_torch.api.toc.TableOfContent`,
whose stores read and write the same files.

`scan_index_from_jax` moves a built JAX `ScanIndex` block onto the device
without re-deriving it from the f32 rows; `quantized_from_jax` carries a JAX
quantized encoding (SQ, BQ, PQ or TQ) across in memory, where the main route
is the `quant_*/` directory a JAX-written segment already holds: the tier's
device layouts (`scan_device`, `flat_device`) are derived from the carried
codes on first use. `sparse_index_from_jax` carries a JAX sparse store's rows
across as flat numpy arrays, where the main route is the `sparse_*/`
directory. `hnsw_index_from_jax` carries a built JAX graph (levels, rank,
entry and both link tables) across as numpy arrays, where the main route is
the `hnsw_*/` directory, so both packages can search the same graph;
`sharded_hnsw_index_from_jax` does the same for a mesh-sharded graph.
`multivector_from_jax` carries a JAX multivector store's token rows and
ranges across, where the main route is the `multi_*/` directory; a JAX
pooled-proxy graph then comes across through `hnsw_index_from_jax` over the
port's `PooledMultiVectorStore` of that store.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .device import default_device
from .index.hnsw import HnswIndex, ShardedHnswIndex
from .index.sparse import SparseIndex, SparseVectorStore
from .ops import quantization as qops
from .ops.fused_scan import DEFAULT_BLK, NEG_INF
from .ops.scan import ScanIndex
from .parallel.mesh import Mesh
from .storage.vectors import DenseVectorStore, MultiVectorStore
from .types import Datatype, Distance, HnswConfig


def scan_index_from_jax(
    arrays: Dict[str, np.ndarray],
    *,
    n: Optional[int] = None,
    euclid: Optional[bool] = None,
    block: int = DEFAULT_BLK,
    device: Optional[torch.device] = None,
    mesh: Optional[Mesh] = None,
) -> ScanIndex:
    """Rebuild a port ScanIndex, bit for bit, from the arrays of a JAX
    ScanIndex, as numpy.

    Without `mesh`: a single-device JAX index in its TPU layout, `_v` (bf16,
    pre-scaled by 2 for euclid), `_vsq_host` (f32 ||v||^2) and `_mask` (the
    f32 bias table) — the port's own layout. With `mesh`: a JAX mesh index,
    `_v` (bf16 rows, unscaled), `_vsq`, `_mask` (int8 validity) and `_v_f32`
    (the f32 rows it rescores from), sharded over `mesh` (its rows must be
    whole `block`-row blocks on every shard); the bf16 rows are doubled for
    euclid (exact) and the bias built from `_vsq` and `_mask`.

    `np.asarray` of a jax bf16 array has the ml_dtypes bfloat16 type, which
    torch.from_numpy refuses, so the block crosses as raw 16-bit patterns.
    `n` is the number of real rows (default: every row, padding included;
    pass it so later mask updates keep pad rows invalid); `euclid` defaults
    to whether the ||v||^2 table is non-zero.
    """
    device = mesh.devices[0] if mesh is not None else device or default_device()
    bits = np.asarray(arrays["_v"]).view(np.int16)
    v = torch.tensor(bits, device=device).view(torch.bfloat16)  # copies
    vsq = np.asarray(arrays["_vsq_host" if mesh is None else "_vsq"], dtype=np.float32)
    if euclid is None:
        euclid = bool(np.any(vsq != 0))
    n = v.shape[0] if n is None else n
    if mesh is None:
        bias = torch.tensor(np.asarray(arrays["_mask"], dtype=np.float32), device=device)
        return ScanIndex.from_arrays(v, vsq, bias, n=n, euclid=euclid, block=block)
    live = np.asarray(arrays["_mask"]) != 0
    bias = torch.tensor(np.where(live, -vsq, NEG_INF).astype(np.float32), device=device)
    rows = torch.tensor(np.asarray(arrays["_v_f32"], dtype=np.float32), device=device)
    return ScanIndex.from_arrays(2.0 * v if euclid else v, vsq, bias, n=n, euclid=euclid,
                                 block=block, mesh=mesh, rows=rows)


def quantized_from_jax(q):
    """The port's quantized encoding of the same type as a JAX
    `qdrant_tpu.ops.quantization` object, built from its numpy fields (the
    class is matched by name: the port imports nothing of the JAX package)."""
    kind = type(q).__name__
    if kind == "ScalarQuantized":
        return qops.ScalarQuantized(np.asarray(q.codes), q.scale, np.asarray(q.norms_sq))
    if kind == "BinaryQuantized":
        return qops.BinaryQuantized(np.asarray(q.signs))
    if kind == "ProductQuantized":
        return qops.ProductQuantized(np.asarray(q.codes), np.asarray(q.codebooks))
    if kind == "TurboQuantized":
        return qops.TurboQuantized(
            np.asarray(q.codes), np.asarray(q.scales), q.rotation_seed, q.bits,
            np.asarray(q.norms_sq), q.dim,
        )
    raise TypeError(f"not a JAX quantized encoding: {kind}")


def sparse_index_from_jax(index) -> SparseIndex:
    """The port's SparseIndex over a copy of a JAX `SparseIndex`'s store: the
    live rows cross as the store's flat numpy arrays (dims, weights, row
    lengths, row offsets), deleted rows stay deleted placeholders at their
    offsets, and the modifier is kept."""
    src = index.store
    dims, weights, lens, offs = (np.asarray(a) for a in src.flat_arrays())
    n = len(src)
    row_lens = np.zeros(n, dtype=np.int64)
    row_lens[offs] = lens
    store = SparseVectorStore()
    store.add_flat(row_lens, dims.copy(), weights.copy())
    live = np.zeros(n, dtype=bool)
    live[offs] = True
    for off in np.flatnonzero(~live):
        store.delete(int(off))
    return SparseIndex(store, index.modifier)


def hnsw_index_from_jax(index, store: DenseVectorStore) -> HnswIndex:
    """The port's HnswIndex over `store` (the port's store of the same rows)
    holding the graph of a built JAX `HnswIndex`: levels, rank, entry,
    max_level, level_counts and both link tables cross as numpy arrays
    (reading `links0` / `links_upper` downloads a device-built adjacency)."""
    out = HnswIndex(
        store, HnswConfig.from_dict(index.config.to_dict()), seed=index.seed,
        subset=None if index.subset is None else np.asarray(index.subset),
    )
    out.levels = np.array(index.levels, dtype=np.int32)
    out.rank = np.array(index.rank, dtype=np.int32)
    out.entry = int(index.entry)
    out.max_level = int(index.max_level)
    out.level_counts = {int(k): int(v) for k, v in index.level_counts.items()}
    out.links0 = np.array(index.links0, dtype=np.int32)
    out.counts0 = np.array(index.counts0, dtype=np.int32)
    out.links_upper = np.array(index.links_upper, dtype=np.int32)
    out.counts_upper = np.array(index.counts_upper, dtype=np.int32)
    return out


def sharded_hnsw_index_from_jax(index, store: DenseVectorStore, mesh: Mesh
                                ) -> ShardedHnswIndex:
    """The port's ShardedHnswIndex over `store` holding the subgraphs of a
    built JAX `ShardedHnswIndex`: its shard-major local-offset links, the
    per-shard entries and the alive rows cross as numpy arrays and are laid
    out on `mesh`, which must have as many shards."""
    if mesh.size != int(index.n_shards):
        raise ValueError(f"a {index.n_shards}-shard graph on a mesh of {mesh.size}")
    out = ShardedHnswIndex(store, HnswConfig.from_dict(index.config.to_dict()),
                           seed=index.seed, mesh=mesh)
    out._install(torch.from_numpy(np.array(index._links, dtype=np.int32)),
                 np.array(index._entries, dtype=np.int32),
                 np.array(index._alive, dtype=bool), int(index.n_per_shard))
    return out


def multivector_from_jax(store) -> MultiVectorStore:
    """The port's MultiVectorStore holding a copy of a JAX
    `MultiVectorStore`: the flat (already preprocessed) token rows, the
    (start, len) ranges and the deleted flags cross as numpy arrays."""
    n = len(store)
    out = MultiVectorStore(
        store.dim, Distance(store.distance.value), Datatype(store.datatype.value)
    )
    out._flat = np.array(store._flat[: store._flat_count], dtype=np.float32)
    out._flat_count = int(store._flat_count)
    out._ranges = np.array(store._ranges[:n], dtype=np.int64)
    out._deleted = np.array(store._deleted[:n], dtype=bool)
    out._count = n
    out._deleted_count = int(out._deleted.sum())
    return out
