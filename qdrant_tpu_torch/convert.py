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
the `hnsw_*/` directory, so both packages can search the same graph.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .device import default_device
from .index.hnsw import HnswIndex
from .index.sparse import SparseIndex, SparseVectorStore
from .ops import quantization as qops
from .ops.fused_scan import DEFAULT_BLK
from .ops.scan import ScanIndex
from .storage.vectors import DenseVectorStore
from .types import HnswConfig


def scan_index_from_jax(
    arrays: Dict[str, np.ndarray],
    *,
    n: Optional[int] = None,
    euclid: Optional[bool] = None,
    block: int = DEFAULT_BLK,
    device: Optional[torch.device] = None,
) -> ScanIndex:
    """Rebuild a port ScanIndex, bit for bit, from the arrays of a
    single-device JAX ScanIndex in its TPU layout, as numpy: `_v` (bf16,
    pre-scaled by 2 for euclid), `_vsq_host` (f32 ||v||^2) and `_mask` (the
    f32 bias table) — the port's own layout.

    `np.asarray` of a jax bf16 array has the ml_dtypes bfloat16 type, which
    torch.from_numpy refuses, so the block crosses as raw 16-bit patterns.
    `n` is the number of real rows (default: every row, padding included;
    pass it so later mask updates keep pad rows invalid); `euclid` defaults
    to whether the ||v||^2 table is non-zero.
    """
    device = device or default_device()
    bits = np.asarray(arrays["_v"]).view(np.int16)
    v = torch.tensor(bits, device=device).view(torch.bfloat16)  # copies
    vsq = np.asarray(arrays["_vsq_host"], dtype=np.float32)
    bias = torch.tensor(np.asarray(arrays["_mask"], dtype=np.float32), device=device)
    if euclid is None:
        euclid = bool(np.any(vsq != 0))
    return ScanIndex.from_arrays(
        v, vsq, bias, n=v.shape[0] if n is None else n, euclid=euclid, block=block
    )


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
