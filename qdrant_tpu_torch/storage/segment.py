"""Segment: the per-shard storage + index unit (counterpart of
qdrant_tpu/storage/segment.py).

Id tracker + named dense, multi and sparse vector stores + payload storage /
index, with versioned idempotent ops keyed by op_num. A dense search answers
exactly through PlainIndex (the fused scan kernel's bf16 mode at 65,536 rows
or more), unless the vector is quantized: sealing (`build_indexes`) encodes a
vector with a quantization config as the JAX seal does, and its searches
score the codes, oversample and rescore in f32 — through the fused scan
kernel's int8 mode for SQ at 65,536 rows or more. A quantized `on_disk`
vector is the quantized-primary tier: only its codes live on the device
(scanned by the torch scans of ops/scan.py, as the JAX engine keeps this tier
off its Pallas kernel) and the candidates are rescored on the host from the
f32 memmap, whose rows are never uploaded. Sparse vectors are served by
index/sparse.py. Sealing a resident dense vector builds its HNSW graph
(index/hnsw.py) and one subgraph per payload block, as the JAX seal does; a
search takes the graph when `params.hnsw_ef` asks for it (or past the
crossover row count), a block's subgraph under a matching `must match`
filter, and the ACORN beam under a selective filter. A multivector (ColBERT
token matrices) is scored by exact max-sim over its padded token block below
`full_scan_threshold` points; above it the seal's graph over mean-pooled
proxy rows proposes candidates and max-sim rescores them, as in the JAX
segment.

With more than one mesh device (parallel/mesh.py::mesh_enabled, the JAX
seal's gate), a dense vector's scan is sharded over the mesh (its store's
ScanIndex) and the seal builds a ShardedHnswIndex: per-shard subgraphs whose
level beams run on every shard and merge; payload-block subgraphs stay on
one device. The on-disk format is the JAX package's, a sharded graph
directory included.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import default_device
from ..index.payload_index import StructPayloadIndex
from ..ops import quantization as qops
from ..ops.distances import (
    preprocess_vectors,
    score_ids_batch,
    score_multivector_maxsim,
)
from ..ops.hnsw import topk_first
from ..storage.id_tracker import IdTracker
from ..storage.payload import PayloadStorage
from ..types import (
    BinaryQuantizationConfig,
    CollectionParams,
    Distance,
    Filter,
    HnswConfig,
    PayloadIndexParams,
    PointId,
    ProductQuantizationConfig,
    SparseVector,
    ScalarQuantizationConfig,
    TurboQuantizationConfig,
    VectorParams,
)
from ..utils import hw_counter, tracing
from ..utils.budget import BUDGET

from ..index.hnsw import HnswIndex, ShardedHnswIndex, load_hnsw_any
from ..index.plain import PlainIndex, fetch_to_host, finalize_device_result
from ..index.sparse import SparseIndex, SparseVectorStore
from .vectors import DenseVectorStore, MultiVectorStore, PooledMultiVectorStore


def _with_search_budget(fn):
    """Register the call as an in-flight search so optimizer builds yield
    the device between batches (utils/budget.py)."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with BUDGET.search():
            return fn(*a, **kw)

    return wrapper


DEFAULT_FULL_SCAN_THRESHOLD = 10_000

# Row count above which a search without `params.hnsw_ef` takes the HNSW
# graph instead of the exact scan. The value is the JAX engine's
# (qdrant_tpu/storage/segment.py GRAPH_CROSSOVER_ROWS), an extrapolation from
# its TPU measurements kept as the dispatch rule; it has not been measured on
# this port's device.
GRAPH_CROSSOVER_ROWS = int(
    os.environ.get("QDRANT_TPU_GRAPH_CROSSOVER_ROWS", 258_000_000)
)

LOW_MEMORY_MODES = ("disabled", "no_resident", "no_populate")
_LOW_MEMORY_MODE = "disabled"


def set_low_memory_mode(mode: str) -> None:
    global _LOW_MEMORY_MODE
    mode = (mode or "disabled").lower()
    if mode not in LOW_MEMORY_MODES:
        raise ValueError(
            f"unknown low_memory_mode {mode!r}; expected one of {LOW_MEMORY_MODES}"
        )
    _LOW_MEMORY_MODE = mode


def low_memory_mode() -> str:
    return _LOW_MEMORY_MODE


# On-disk segment format version, shared with the JAX package.
SEGMENT_FORMAT_VERSION = 2

DEFAULT_OVERSAMPLING = 3.0
# store size from which an SQ search takes the fused scan's int8 mode (below
# it one [B, N] scoring product and a top-k win)
FLAT_SCAN_MIN_N = 65536


class SegmentFormatError(Exception):
    pass


def _migrate_segment_meta(meta: dict, path: str) -> dict:
    fv = int(meta.get("format_version", 1))
    if fv > SEGMENT_FORMAT_VERSION:
        raise SegmentFormatError(
            f"segment at {path} has format v{fv}, newer than this build's "
            f"v{SEGMENT_FORMAT_VERSION} — upgrade qdrant-tpu to read it"
        )
    if fv < 2:
        meta["format_version"] = 2
    return meta


class SearchParams:
    def __init__(
        self,
        hnsw_ef: Optional[int] = None,
        exact: bool = False,
        quantization_ignore: bool = False,
        quantization_rescore: bool = True,
        quantization_oversampling: Optional[float] = None,
        acorn_enable: Optional[bool] = None,
        acorn_max_selectivity: float = 0.4,
    ):
        self.hnsw_ef = hnsw_ef
        self.exact = exact
        self.quantization_ignore = quantization_ignore
        self.quantization_rescore = quantization_rescore
        self.quantization_oversampling = quantization_oversampling
        self.acorn_enable = acorn_enable
        self.acorn_max_selectivity = acorn_max_selectivity

    @staticmethod
    def from_dict(d: Optional[dict]) -> "SearchParams":
        d = d or {}
        q = d.get("quantization") or {}
        a = d.get("acorn") or {}
        return SearchParams(
            hnsw_ef=d.get("hnsw_ef"),
            exact=bool(d.get("exact", False)),
            quantization_ignore=bool(q.get("ignore", False)),
            quantization_rescore=bool(q.get("rescore", True)),
            quantization_oversampling=q.get("oversampling"),
            acorn_enable=a.get("enable"),
            acorn_max_selectivity=float(a.get("max_selectivity", 0.4)),
        )


class Segment:
    def __init__(
        self, params: CollectionParams, appendable: bool = True,
        storage_dir: Optional[str] = None,
    ):
        self.params = params
        self.appendable = appendable
        # the directory the segment is saved to: an on_disk vector keeps its
        # working memmap there (without one, under the system temp directory)
        self.storage_dir = storage_dir
        self.version = 0  # max applied op_num
        self.id_tracker = IdTracker()
        self.payload_storage = PayloadStorage()
        # deferred write-visibility: offsets written but invisible to reads
        # until confirmed
        self.deferred: set = set()
        self.dense: Dict[str, DenseVectorStore] = {}
        self.multi: Dict[str, MultiVectorStore] = {}
        self.sparse: Dict[str, SparseVectorStore] = {}
        self.sparse_index: Dict[str, SparseIndex] = {}
        self.hnsw: Dict[str, HnswIndex | ShardedHnswIndex] = {}
        # multivector name → HnswIndex over its PooledMultiVectorStore
        self.hnsw_multi: Dict[str, HnswIndex] = {}
        # filterable-HNSW payload-block subgraphs:
        # vector name → {(field, value_repr): HnswIndex over that block}
        self.hnsw_blocks: Dict[str, Dict[Tuple[str, str], HnswIndex]] = {}
        self.quantized: Dict[str, Any] = {}  # name → qops.*Quantized (sealed)
        for name, vp in params.vectors.items():
            if vp.multivector_config is not None:
                self.multi[name] = MultiVectorStore(vp.size, vp.distance, vp.datatype)
            else:
                self.dense[name] = self._dense_store(name, vp)
        for name, sp in params.sparse_vectors.items():
            self.sparse[name] = SparseVectorStore()
            self.sparse_index[name] = SparseIndex(self.sparse[name], sp.modifier)
        self.payload_index = StructPayloadIndex(
            self.payload_storage, self.id_tracker, self._has_vector
        )

    # ------------------------------------------------------------------
    # live vector-name management
    # ------------------------------------------------------------------

    def add_vector_name(self, name: str, vp: VectorParams) -> None:
        """Add a named dense or multi vector to a live segment: existing
        points get deleted placeholder rows (the lockstep-offset scheme)."""
        if name in self.dense or name in self.multi or name in self.sparse:
            return  # idempotent: WAL replay re-applies the op after load
        self.params.vectors[name] = vp
        n = self.total_offsets
        if vp.multivector_config is not None:
            store = MultiVectorStore(vp.size, vp.distance, vp.datatype)
            _add_deleted_multi(store, n)
            self.multi[name] = store
            return
        store = self._dense_store(name, vp)
        if n:
            offs = store.add(np.zeros((n, vp.size), dtype=np.float32))
            for off in offs:
                store.delete(int(off))
        self.dense[name] = store

    def _dense_store(self, name: str, vp: VectorParams) -> DenseVectorStore:
        sub = None
        if vp.on_disk and self.storage_dir is not None:
            sub = os.path.join(self.storage_dir, f"dense_{_safe(name)}")
        return DenseVectorStore(vp.size, vp.distance, vp.datatype, on_disk=vp.on_disk,
                                storage_dir=sub)

    def drop_vector_name(self, name: str) -> None:
        if name not in self.dense and name not in self.multi:
            return  # idempotent under WAL replay
        self.params.vectors.pop(name, None)
        self.dense.pop(name, None)
        self.multi.pop(name, None)
        self.hnsw.pop(name, None)
        self.hnsw_multi.pop(name, None)
        self.hnsw_blocks.pop(name, None)
        self.quantized.pop(name, None)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.id_tracker)

    def memory_usage_bytes(self) -> Dict[str, Any]:
        from ..utils.memsize import merge, sizeof, total

        parts = {
            "dense": merge(*(sizeof(s) for s in self.dense.values())),
            "multi": merge(*(sizeof(s) for s in self.multi.values())),
            "sparse_index": merge(
                *(sizeof(i) for i in self.sparse_index.values())
            ),
            "quantized": merge(*(sizeof(q) for q in self.quantized.values())),
            "hnsw": merge(
                *(sizeof(h) for h in self.hnsw.values()),
                *(sizeof(h) for h in self.hnsw_multi.values()),
                *(
                    sizeof(h)
                    for blocks in self.hnsw_blocks.values()
                    for h in blocks.values()
                ),
            ),
            "payload_index": sizeof(self.payload_index),
            "payload_storage": sizeof(self.payload_storage),
        }
        out: Dict[str, Any] = merge(*parts.values())
        out["total_bytes"] = total(out)
        out["breakdown"] = {k: v for k, v in parts.items() if total(v) > 0}
        return out

    @property
    def total_offsets(self) -> int:
        """Upper bound on internal offsets (including deleted slots)."""
        counts = (
            [len(s) for s in self.dense.values()]
            + [len(s) for s in self.multi.values()]
            + [len(s) for s in self.sparse.values()]
        )
        return max(counts, default=0)

    def _has_vector(self, name: str, offset: int) -> bool:
        store = self.dense.get(name, self.multi.get(name))
        if store is not None:
            return offset < len(store) and not store.is_deleted(offset)
        if name in self.sparse:
            return not self.sparse[name].is_deleted(offset)
        return False

    def available_point_count(self) -> int:
        return len(self.id_tracker)

    # ------------------------------------------------------------------
    # write ops (idempotent by op_num)
    # ------------------------------------------------------------------

    def point_version(self, external_id: PointId) -> Optional[int]:
        internal = self.id_tracker.internal_id(external_id)
        if internal is None:
            return None
        return self.id_tracker.version(internal)

    def _stale(self, external_id: PointId, op_num: int) -> bool:
        internal = self.id_tracker.internal_id(external_id)
        if internal is None:
            return False
        return self.id_tracker.version(internal) > op_num

    def upsert_point(
        self,
        op_num: int,
        external_id: PointId,
        vectors: Dict[str, Any],
        payload: Optional[Dict[str, Any]] = None,
        deferred: bool = False,
    ) -> bool:
        if self._stale(external_id, op_num):
            return False
        internal = self.id_tracker.internal_id(external_id)
        new_offset = self._next_offset() if internal is None else internal
        for name, store in self.dense.items():
            vec = vectors.get(name)
            if vec is not None:
                arr = np.asarray(vec, dtype=np.float32)
                if internal is None:
                    off = store.add(arr[None, :])[0]
                    assert off == new_offset, (off, new_offset)
                else:
                    store.set(internal, arr)
            elif internal is None:
                # keep offsets aligned across stores: a deleted placeholder
                off = store.add(np.zeros((1, store.dim), dtype=np.float32))[0]
                store.delete(off)
        for name, store in self.multi.items():
            vec = vectors.get(name)
            if vec is not None:
                if internal is None:
                    store.add([np.asarray(vec, dtype=np.float32)])
                else:
                    store.set(internal, np.asarray(vec, dtype=np.float32))
            elif internal is None:
                _add_deleted_multi(store, 1)
        for name, store in self.sparse.items():
            vec = vectors.get(name)
            if vec is not None:
                sv = vec if isinstance(vec, SparseVector) else SparseVector.from_dict(vec)
                if internal is None:
                    store.add([sv])
                else:
                    store.set(internal, sv)
                self.sparse_index[name].invalidate()
            elif internal is None:
                store.add([SparseVector([], [])])
                store.delete(len(store) - 1)
        self.id_tracker.link(external_id, new_offset, op_num)
        if deferred:
            self.deferred.add(new_offset)
        else:
            self.deferred.discard(new_offset)
        if payload is not None:
            self.payload_storage.overwrite(new_offset, payload)
            self.payload_index.update_point(new_offset, payload)
        elif internal is None:
            self.payload_storage.overwrite(new_offset, None)
        self.version = max(self.version, op_num)
        return True

    def bulk_ingest(
        self,
        op_num: int,
        ids: List[PointId],
        dense: Dict[str, np.ndarray],  # name → [N, D] f32
        payloads: Optional[List[Optional[dict]]] = None,
    ) -> int:
        """Array-native bulk load of FRESH points into an appendable segment:
        one numpy append per dense store + one bulk id-tracker link."""
        if not self.appendable:
            raise ValueError("bulk_ingest requires an appendable segment")
        n = len(ids)
        if n == 0:
            return 0
        start = self._next_offset()
        for name, store in self.dense.items():
            vecs = dense.get(name)
            if vecs is not None:
                if len(vecs) != n:
                    raise ValueError(f"bulk_ingest: {len(vecs)} vectors for {n} ids")
                offs = store.add(np.asarray(vecs, dtype=np.float32))
                assert offs[0] == start, (offs[0], start)
            else:
                offs = store.add(np.zeros((n, store.dim), dtype=np.float32))
                for off in offs:
                    store.delete(int(off))
        for store in self.multi.values():  # bulk loads carry dense rows only
            _add_deleted_multi(store, n)
        for name, store in self.sparse.items():
            store.add_flat(
                np.zeros(n, dtype=np.int64),
                np.zeros(0, dtype=np.int64),
                np.zeros(0, dtype=np.float32),
            )
            self.sparse_index[name].invalidate()
        self.id_tracker.bulk_link_fresh(list(ids), start, op_num)
        if payloads is not None:
            for i, payload in enumerate(payloads):
                if payload:
                    self.payload_storage.overwrite(start + i, payload)
                    self.payload_index.update_point(start + i, payload)
        self.version = max(self.version, op_num)
        return n

    def _next_offset(self) -> int:
        return self.total_offsets

    def delete_point(self, op_num: int, external_id: PointId) -> bool:
        if self._stale(external_id, op_num):
            return False
        internal = self.id_tracker.drop(external_id)
        if internal is None:
            return False
        for store in self.dense.values():
            store.delete(internal)
        for store in self.multi.values():
            store.delete(internal)
        for name, store in self.sparse.items():
            if store.delete(internal):
                self.sparse_index[name].invalidate()
        self.payload_index.remove_point(internal)
        self.payload_storage.clear(internal)
        self.version = max(self.version, op_num)
        return True

    def update_vectors(
        self, op_num: int, external_id: PointId, vectors: Dict[str, Any]
    ) -> bool:
        if self._stale(external_id, op_num):
            return False
        internal = self.id_tracker.internal_id(external_id)
        if internal is None:
            return False
        for name, vec in vectors.items():
            if name in self.dense:
                self.dense[name].set(internal, np.asarray(vec, dtype=np.float32))
            elif name in self.multi:
                self.multi[name].set(internal, np.asarray(vec, dtype=np.float32))
            elif name in self.sparse:
                sv = vec if isinstance(vec, SparseVector) else SparseVector.from_dict(vec)
                self.sparse[name].set(internal, sv)
                self.sparse_index[name].invalidate()
        self.id_tracker.set_version(internal, op_num)
        self.version = max(self.version, op_num)
        return True

    def delete_vectors(
        self, op_num: int, external_id: PointId, names: List[str]
    ) -> bool:
        if self._stale(external_id, op_num):
            return False
        internal = self.id_tracker.internal_id(external_id)
        if internal is None:
            return False
        for name in names:
            if name in self.dense:
                self.dense[name].delete(internal)
            elif name in self.multi:
                self.multi[name].delete(internal)
            elif name in self.sparse:
                if self.sparse[name].delete(internal):
                    self.sparse_index[name].invalidate()
        self.id_tracker.set_version(internal, op_num)
        self.version = max(self.version, op_num)
        return True

    def set_payload(
        self,
        op_num: int,
        external_id: PointId,
        payload: Dict[str, Any],
        key: Optional[str] = None,
    ) -> bool:
        if self._stale(external_id, op_num):
            return False
        internal = self.id_tracker.internal_id(external_id)
        if internal is None:
            return False
        if key:
            self.payload_storage.set_by_key(internal, payload, key)
        else:
            self.payload_storage.set(internal, payload)
        self.payload_index.update_point(internal, self.payload_storage.get(internal))
        self.id_tracker.set_version(internal, op_num)
        self.version = max(self.version, op_num)
        return True

    def overwrite_payload(
        self, op_num: int, external_id: PointId, payload: Optional[Dict[str, Any]]
    ) -> bool:
        if self._stale(external_id, op_num):
            return False
        internal = self.id_tracker.internal_id(external_id)
        if internal is None:
            return False
        self.payload_storage.overwrite(internal, payload)
        self.payload_index.update_point(internal, self.payload_storage.get(internal))
        self.id_tracker.set_version(internal, op_num)
        self.version = max(self.version, op_num)
        return True

    def delete_payload_key(self, op_num: int, external_id: PointId, key: str) -> bool:
        if self._stale(external_id, op_num):
            return False
        internal = self.id_tracker.internal_id(external_id)
        if internal is None:
            return False
        self.payload_storage.delete_key(internal, key)
        self.payload_index.update_point(internal, self.payload_storage.get(internal))
        self.id_tracker.set_version(internal, op_num)
        self.version = max(self.version, op_num)
        return True

    def clear_payload(self, op_num: int, external_id: PointId) -> bool:
        if self._stale(external_id, op_num):
            return False
        internal = self.id_tracker.internal_id(external_id)
        if internal is None:
            return False
        self.payload_storage.clear(internal)
        self.payload_index.remove_point(internal)
        self.id_tracker.set_version(internal, op_num)
        self.version = max(self.version, op_num)
        return True

    def create_field_index(self, field: str, params: PayloadIndexParams) -> None:
        self.payload_index.set_indexed(field, params)

    def delete_field_index(self, field: str) -> None:
        self.payload_index.drop_index(field)

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------

    def get_payload(self, external_id: PointId) -> Optional[Dict[str, Any]]:
        internal = self.id_tracker.internal_id(external_id)
        if internal is None:
            return None
        return self.payload_storage.get(internal)

    def get_vectors(self, external_id: PointId) -> Optional[Dict[str, Any]]:
        internal = self.id_tracker.internal_id(external_id)
        if internal is None:
            return None
        out: Dict[str, Any] = {
            name: store.get(internal).tolist()
            for stores in (self.dense, self.multi)
            for name, store in stores.items()
            if internal < len(store) and not store.is_deleted(internal)
        }
        for name, store in self.sparse.items():
            sv = store.get(internal)
            if sv is not None:
                out[name] = sv.to_dict()
        return out

    def filter_mask(self, flt: Optional[Filter]) -> Optional[np.ndarray]:
        return self.payload_index.filter_mask(flt, self.total_offsets)

    def facet_counts(
        self, key: str, flt: Optional[Filter] = None
    ) -> Optional[Dict[Any, int]]:
        """Index-backed facet counts; None when the field has no map index."""
        fi = self.payload_index.field_indexes.get(key)
        if fi is None or fi.map_index is None:
            return None
        mask = self.filter_mask(flt)
        alive = self.alive_mask()
        if mask is None:
            mask = alive
        else:
            mask = mask[: len(alive)] & alive[: len(mask)]
        counts: Dict[Any, int] = {}
        for value, offs in fi.map_index.postings.items():
            arr = np.fromiter(offs, dtype=np.int64, count=len(offs))
            arr = arr[arr < len(mask)]
            c = int(mask[arr].sum())
            if c:
                counts[value] = c
        return counts

    @tracing.traced("segment.alive_mask")
    def alive_mask(self) -> np.ndarray:
        """Mask of offsets currently linked to an external id and visible
        (deferred heads excluded until confirmed)."""
        n = self.total_offsets
        mask = np.zeros(n, dtype=bool)
        ids = self.id_tracker.internal_ids_array()
        if len(ids):
            mask[ids[ids < n]] = True
        for off in self.deferred:
            if off < n:
                mask[off] = False
        return mask

    def confirm_deferred(self, op_num: int, external_id: PointId) -> bool:
        internal = self.id_tracker.internal_id(external_id)
        if internal is None or internal not in self.deferred:
            return False
        self.deferred.discard(internal)
        self.id_tracker.set_version(internal, op_num)
        self.version = max(self.version, op_num)
        return True

    @property
    def num_deferred_points(self) -> int:
        return len(self.deferred)

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------

    @_with_search_budget
    def search_dense(
        self,
        name: str,
        queries: np.ndarray,  # [B, D] raw
        k: int,
        flt: Optional[Filter] = None,
        params: Optional[SearchParams] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (scores [B, k] internal convention, offsets [B, k])."""
        return self.finish_dispatch(
            self._search_dense_dispatch(name, queries, k, flt, params)
        )

    @_with_search_budget
    def search_dense_dispatch(
        self,
        name: str,
        queries: np.ndarray,
        k: int,
        flt: Optional[Filter] = None,
        params: Optional[SearchParams] = None,
    ):
        """Async dispatch: launches the device work and returns an opaque
        handle WITHOUT waiting for the result. Callers keep several batches
        in flight and bring them back with ONE device→host copy via
        `sync_dispatches`."""
        return self._search_dense_dispatch(name, queries, k, flt, params)

    @staticmethod
    def finish_dispatch(handle, fetched=None) -> Tuple[np.ndarray, np.ndarray]:
        """Resolve a search_dense_dispatch handle to host (scores, ids)."""
        if handle[0] == "host":
            return handle[1]
        _, (s_dev, i_dev, b, k_eff), k = handle
        s_host, i_host = fetched if fetched is not None else fetch_to_host(
            [(s_dev, i_dev)]
        )[0]
        return finalize_device_result(s_host, i_host, b, k_eff, k)

    @staticmethod
    def sync_dispatches(handles) -> list:
        """Fetch every device-resident handle with ONE device→host copy and
        finish all handles in order → [(scores, ids)]."""
        dev_pos = [i for i, h in enumerate(handles) if h[0] == "dev"]
        fetched = fetch_to_host(
            [(handles[i][1][0], handles[i][1][1]) for i in dev_pos]
        )
        by_pos = dict(zip(dev_pos, fetched))
        return [
            Segment.finish_dispatch(h, by_pos.get(i))
            for i, h in enumerate(handles)
        ]

    def _search_dense_dispatch(
        self,
        name: str,
        queries: np.ndarray,
        k: int,
        flt: Optional[Filter] = None,
        params: Optional[SearchParams] = None,
    ):
        params = params or SearchParams()
        store = self.dense.get(name)
        if store is None:
            raise ValueError(f"vector {name!r} does not exist in this collection")
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        if queries.shape[1] != store.dim:
            raise ValueError(
                f"Wrong input: vector dimension {queries.shape[1]} does not "
                f"match the collection dimensionality {store.dim}"
            )
        n = self.total_offsets
        if n == 0:
            b = len(queries)
            return (
                "host",
                (
                    np.full((b, k), -np.inf, dtype=np.float32),
                    np.full((b, k), -1, dtype=np.int32),
                ),
            )
        fmask = self.filter_mask(flt)
        alive = self.alive_mask()
        combined = alive if fmask is None else (alive & fmask)
        hw_counter.add(
            vectors_scored=int(combined.sum()),
            dims=store.dim,
            filter_evals=1 if fmask is not None else 0,
        )
        with tracing.span("segment.dispatch"):
            return self._dispatch_masked(name, store, queries, k, flt, params,
                                         fmask, combined)

    def _dispatch_masked(self, name, store, queries, k, flt, params, fmask, combined):
        """`_search_dense_dispatch` once the masks are made: the payload-block
        subgraph, the graph, the quantized scan or the exact scan."""
        vp = self.params.vectors[name]
        hnsw = self.hnsw.get(name)
        ef = params.hnsw_ef or max(k, 64)

        # filterable HNSW: a match-value filter covered by a payload-block
        # subgraph searches that block's graph directly (same crossover gate
        # as the main graph: below it the masked scan is exact and faster)
        if (
            hnsw is not None
            and not params.exact
            and flt is not None
            and (
                params.hnsw_ef is not None
                or len(combined) >= GRAPH_CROSSOVER_ROWS
            )
        ):
            for field, vkey in _block_conditions(flt):
                sub = self.hnsw_blocks.get(name, {}).get((field, vkey))
                if sub is not None:
                    return (
                        "host",
                        sub.search(queries, k, ef=ef, filter_mask=combined),
                    )

        use_graph = (
            hnsw is not None
            and not params.exact
            and self._should_use_graph(
                vp, combined, fmask is not None,
                explicit_ef=params.hnsw_ef is not None,
            )
        )
        if use_graph:
            # ACORN dispatch: low-selectivity filters traverse the unfiltered
            # graph
            acorn = False
            if fmask is not None and params.acorn_enable is not False:
                selectivity = combined.sum() / max(len(combined), 1)
                acorn = bool(
                    params.acorn_enable
                    or selectivity <= params.acorn_max_selectivity
                )
            return (
                "host",
                hnsw.search(queries, k, ef=ef, filter_mask=combined, acorn=acorn),
            )
        quant = None if params.quantization_ignore else self.quantized.get(name)
        if quant is not None and not params.exact:
            return self._search_quantized(name, quant, queries, k, combined, params)
        with tracing.span("scan.step"):
            return ("dev", PlainIndex(store).search_device(queries, k, combined), k)

    def _should_use_graph(
        self,
        vp: VectorParams,
        combined_mask: np.ndarray,
        filtered: bool,
        explicit_ef: bool = False,
    ) -> bool:
        """Cost-model dispatch. Two gates, both scan-favouring:

        * filtered: small filtered cardinality → exact scan of matching
          points.
        * unfiltered: below GRAPH_CROSSOVER_ROWS the exact scan serves, so
          the graph only takes over above it — unless the caller asked for
          the graph explicitly by setting params.hnsw_ef.
        """
        threshold = (
            vp.hnsw_config.full_scan_threshold
            if vp.hnsw_config
            else DEFAULT_FULL_SCAN_THRESHOLD
        )
        cardinality = int(combined_mask.sum())
        if filtered and cardinality < threshold:
            return False
        if explicit_ef:
            return True
        # the masked scan scores every row whatever the filter matches, so
        # the crossover gate is on total rows for both cases
        return len(combined_mask) >= GRAPH_CROSSOVER_ROWS

    def _search_quantized(
        self,
        name: str,
        quant: Any,
        queries: np.ndarray,
        k: int,
        mask: np.ndarray,
        params: SearchParams,
    ):
        """Quantized full scan + oversampled f32 rescore → a dispatch handle:
        device-resident like PlainIndex's where the rescore runs on the
        device, resolved on the host where the vector is `on_disk` (the JAX
        engine resolves every such search synchronously; the answers are the
        same)."""
        store = self.dense[name]
        q = preprocess_vectors(queries, store.distance)
        oversampling = params.quantization_oversampling or DEFAULT_OVERSAMPLING
        k_over = min(max(int(k * oversampling), k), max(int(mask.sum()), 1))
        if len(store) >= FLAT_SCAN_MIN_N:
            if isinstance(quant, qops.ScalarQuantized):
                if not store.on_disk:
                    return self._search_sq_kernel(quant, store, q, k, k_over, mask, params)
                return ("host", self._search_sq_tier(quant, store, q, k, k_over, mask, params))
            if isinstance(quant, qops.TurboQuantized) and store.on_disk:
                return ("host", self._search_tq_tier(quant, store, q, k, k_over, mask, params))
        dev = default_device()
        distance = store.distance.value

        def valid(rows: int) -> torch.Tensor:
            m = np.zeros(rows, dtype=bool)
            m[: len(mask)] = mask[:rows]
            return torch.from_numpy(m).to(dev)

        if isinstance(quant, qops.ScalarQuantized):
            codes, norms = quant.device()
            scores = qops.score_sq(
                torch.from_numpy(quant.encode_queries(q)).to(dev),
                torch.from_numpy((q * q).sum(axis=1).astype(np.float32)).to(dev),
                codes, norms, quant.scale, distance, valid(codes.shape[0]),
            )
        elif isinstance(quant, qops.BinaryQuantized):
            signs = quant.device()
            scores = qops.score_bq(
                torch.from_numpy(q).to(dev), signs, distance, valid(signs.shape[0])
            )
        elif isinstance(quant, qops.TurboQuantized):
            recon, scales, norms = quant.device()
            scores = qops.score_tq(
                torch.from_numpy(quant.rotate_queries(q)).to(dev),
                recon, scales, norms, distance, valid(recon.shape[0]),
            )
        elif isinstance(quant, qops.ProductQuantized):
            codes = quant.device()
            lut = quant.query_lut(q, store.distance)
            scores = qops.score_pq(
                torch.from_numpy(lut).to(dev), codes, valid(codes.shape[0])
            )
        else:  # pragma: no cover
            raise ValueError(f"unknown quantization {type(quant)}")

        b, kk = len(q), min(k, k_over)
        top_scores, top_ids = torch.topk(scores, k_over, dim=1)
        if not params.quantization_rescore:
            return ("dev", (top_scores[:, :kk], top_ids[:, :kk], b, kk), k)
        if store.on_disk:
            # quantized-primary tier: the exact rescore gathers candidate
            # rows from the host memmap — the f32 block never enters the card
            return ("host", self._host_rescore(store, q, _candidates(top_scores, top_ids), k))
        vectors, _ = store.device_block()
        cand = torch.where(torch.isfinite(top_scores), top_ids, -1)
        re_scores = score_ids_batch(torch.from_numpy(q).to(dev), vectors, cand, distance)
        re_top, re_idx = torch.topk(re_scores, kk, dim=1)
        return ("dev", (re_top, torch.gather(cand, 1, re_idx), b, kk), k)

    def _host_rescore(
        self, store, q: np.ndarray, cand: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact f32 rescore of per-query candidates by gathering their rows
        from the HOST tier (disk memmap) — the quantized-primary path's
        second stage (reference: on-disk original vectors + always_ram
        quantized codes, vector_storage/quantized/quantized_vectors.rs:52).
        Scores use the engine's exact conventions (-(q-v)^2 / dot; Manhattan
        is true L1 here, while the scan ranked by squared L2)."""
        b = q.shape[0]
        cand = np.asarray(cand, dtype=np.int32)
        n = len(store)
        dist = store.distance
        # one stacked gather + one BLAS pass for the whole batch
        c = cand.shape[1]
        valid = (cand >= 0) & (cand < n)
        safe = np.where(valid, cand, 0)
        rows = np.asarray(
            store.get_batch(safe.ravel()), dtype=np.float32
        ).reshape(b, c, -1)
        if dist is Distance.EUCLID:
            d = rows - q[:, None, :]
            sc = -np.einsum("bcd,bcd->bc", d, d)
        elif dist is Distance.MANHATTAN:
            sc = -np.abs(rows - q[:, None, :]).sum(axis=2)
        else:
            sc = np.einsum("bcd,bd->bc", rows, q)
        sc = np.where(valid, sc, -np.inf)
        kk = min(k, c)
        part = np.argpartition(-sc, kk - 1, axis=1)[:, :kk]
        psc = np.take_along_axis(sc, part, axis=1)
        order = np.argsort(-psc, axis=1, kind="stable")
        top = np.take_along_axis(part, order, axis=1)
        s_out = np.full((b, k), -np.inf, dtype=np.float32)
        i_out = np.full((b, k), -1, dtype=np.int32)
        s_out[:, :kk] = np.take_along_axis(sc, top, axis=1)
        i_out[:, :kk] = np.take_along_axis(cand, top, axis=1)
        i_out[:, :kk] = np.where(
            np.isfinite(s_out[:, :kk]), i_out[:, :kk], -1
        )
        return s_out, i_out

    def _search_sq_tier(
        self, quant, store, q: np.ndarray, k: int, k_over: int,
        mask: np.ndarray, params: SearchParams,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """SQ over an `on_disk` vector at FLAT_SCAN_MIN_N rows or more: the
        torch int8 block scan over the codes (the only device residency of
        the vector; the JAX engine keeps this tier off its Pallas kernel),
        then an exact rescore from the host memmap, or codes-only scores
        when `rescore` is off."""
        from ..ops.scan import DEFAULT_BLOCK, scan_search_sq_flat

        codes_dev, norms_dev, n_pad = quant.scan_device(DEFAULT_BLOCK)
        dev = codes_dev.device
        mask_pad = np.zeros(n_pad, dtype=bool)
        mask_pad[: len(mask)] = mask[:n_pad]
        # group reduction keeps one winner per 128 rows — widen the
        # candidate set so the f32 rescore recovers full recall
        k_over = min(max(k_over, 128), max(int(mask.sum()), 1))
        top_s, top_i = scan_search_sq_flat(
            torch.from_numpy(quant.encode_queries(q)).to(dev),
            torch.from_numpy((q * q).sum(axis=1).astype(np.float32)).to(dev),
            codes_dev, norms_dev, quant.scale,
            torch.from_numpy(mask_pad).to(dev),
            DEFAULT_BLOCK, k_over,
            euclid=store.distance in (Distance.EUCLID, Distance.MANHATTAN),
        )
        if params.quantization_rescore:
            return self._host_rescore(store, q, _candidates(top_s, top_i), k)
        [(s, i)] = fetch_to_host([(top_s[:, :k], top_i[:, :k])])
        return s, np.where(np.isfinite(s), i, -1)

    def _search_tq_tier(
        self, quant, store, q: np.ndarray, k: int, k_over: int,
        mask: np.ndarray, params: SearchParams,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """TQ-as-primary tier (reference: vector_storage/turbo/mod.rs:1-29):
        packed low-bit codes are the ONLY device residency (bits/8 bytes per
        rotated dim); candidates rescore exactly from the host f32 memmap,
        or keep their codes-only scores when `rescore` is off."""
        from ..ops.scan import DEFAULT_BLOCK, scan_search_tq_flat

        packed, scales_d, norms_d, levels_d, n_pad = quant.flat_device(DEFAULT_BLOCK)
        dev = packed.device
        mask_pad = np.zeros(n_pad, dtype=bool)
        mask_pad[: len(mask)] = mask[:n_pad]
        k_over = min(max(k_over, 128), max(int(mask.sum()), 1))
        top_s, top_i = scan_search_tq_flat(
            torch.from_numpy(quant.rotate_queries(q)).to(dev),
            torch.from_numpy((q * q).sum(axis=1).astype(np.float32)).to(dev),
            packed, scales_d, norms_d, levels_d,
            torch.from_numpy(mask_pad).to(dev),
            DEFAULT_BLOCK, k_over,
            euclid=store.distance in (Distance.EUCLID, Distance.MANHATTAN),
            pack=quant.pack_factor,
            bits_w={4: 4, 2: 2, 1.5: 2, 1: 1}[quant.bits],
        )
        [(s, i)] = fetch_to_host([(top_s, top_i)])
        cand = np.where(np.isfinite(s), i, -1)
        if not params.quantization_rescore:
            return s[:, :k], cand[:, :k]
        return self._host_rescore(store, q, cand, k)

    @tracing.traced("sq.step")
    def _search_sq_kernel(
        self, quant, store, q: np.ndarray, k: int, k_over: int,
        mask: np.ndarray, params: SearchParams,
    ):
        """SQ at FLAT_SCAN_MIN_N rows or more (the JAX engine's
        `_search_sq_pallas`): the fused scan's int8 mode over the codes, then
        an exact f32 rescore of the oversampled winners, or codes-only scores
        when `rescore` is off."""
        from ..ops import fused_scan as fs

        k_over = min(max(k_over, 128), 1024)
        codes_dev, norms_host, n_pad = quant.kernel_device(fs.DEFAULT_BLK)
        # The JAX engine sizes blk to the TPU's 16 MB VMEM window
        # (pallas_block_for / pallas_qt_slots). At D <= 512 and batches under
        # 512 rows it also scans 4,096-row blocks with 16 slots, so the
        # survivors are the same; at D = 1536 it takes blk 2,048, which bins
        # rows differently into the same 2,048 survivors.
        blk, slots = fs.scan_grid(n_pad, k_over)
        euclid = store.distance in (Distance.EUCLID, Distance.MANHATTAN)
        dev = codes_dev.device
        with tracing.span("sq.bias_upload"):
            mask_pad = np.zeros(n_pad, dtype=bool)
            mask_pad[: len(mask)] = mask[:n_pad]
            bias = np.where(
                mask_pad, -norms_host if euclid else 0.0, fs.NEG_INF
            ).astype(np.float32)
            bias_dev = torch.from_numpy(bias).to(dev)
        scale_sq = (2.0 if euclid else 1.0) * quant.scale * quant.scale
        b = q.shape[0]
        b_pad = max(8, (b + 7) // 8 * 8)
        q_codes = np.zeros((b_pad, codes_dev.shape[1]), dtype=np.int8)
        q_codes[:b, : q.shape[1]] = quant.encode_queries(q)
        q_codes_dev = torch.from_numpy(q_codes).to(dev)
        kk = min(k, k_over)
        if params.quantization_rescore:
            vectors_f32, _ = store.device_block()
            q_f32 = np.zeros((b_pad, vectors_f32.shape[1]), dtype=np.float32)
            q_f32[:b, : q.shape[1]] = q
            s, i = fs.fused_scan_rescore(
                torch.from_numpy(q_f32).to(dev), q_codes_dev, codes_dev, bias_dev,
                vectors_f32, k_over, kk, blk=blk, slots=slots, euclid=euclid,
                scale_sq=scale_sq,
            )
        else:
            s, i = fs.fused_scan_topk(
                q_codes_dev, codes_dev, bias_dev, kk, blk=blk, slots=slots,
                scale_sq=scale_sq,
            )
            if euclid:
                q_sq = np.zeros((b_pad, 1), dtype=np.float32)
                q_sq[:b] = (q * q).sum(axis=1, keepdims=True)
                s = torch.where(i >= 0, s - torch.from_numpy(q_sq).to(dev), -np.inf)
        return ("dev", (s, i, b, kk), k)

    @_with_search_budget
    def search_multi(
        self,
        name: str,
        query: np.ndarray,  # [T, D] query token matrix
        k: int,
        flt: Optional[Filter] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Max-sim search of one token matrix → (scores [1, k], offsets
        [1, k]). Below `full_scan_threshold` points (or without a graph)
        every point is scored; above it the pooled-proxy graph proposes
        max(4k, 64) candidates and max-sim rescores them, as the JAX
        segment does."""
        store = self.multi[name]
        if len(store) == 0:
            return (
                np.full((1, k), -np.inf, dtype=np.float32),
                np.full((1, k), -1, dtype=np.int32),
            )
        fmask = self.filter_mask(flt)
        alive = self.alive_mask()
        combined = alive if fmask is None else (alive & fmask)
        tokens, token_mask, valid = store.padded_block()
        n = tokens.shape[0]
        dev = tokens.device
        comb_pad = np.zeros(n, dtype=bool)
        comb_pad[: len(combined)] = combined[:n]
        valid = valid & torch.from_numpy(comb_pad).to(dev)
        raw = np.atleast_2d(np.asarray(query, dtype=np.float32))
        q = torch.from_numpy(preprocess_vectors(raw, store.distance)).to(dev)
        distance = store.distance.value
        idx = self.hnsw_multi.get(name)
        vp = self.params.vectors[name]
        threshold = (
            vp.hnsw_config.full_scan_threshold
            if vp.hnsw_config
            else DEFAULT_FULL_SCAN_THRESHOLD
        )
        s_out = np.full((1, k), -np.inf, dtype=np.float32)
        i_out = np.full((1, k), -1, dtype=np.int32)
        if idx is not None and len(store) >= threshold:
            # pooled graph walk → exact max-sim rescore of the oversampled
            # winners
            pooled_q = preprocess_vectors(raw.mean(axis=0, keepdims=True), store.distance)
            k_over = min(max(4 * k, 64), max(int(combined.sum()), 1))
            _, cand = idx.search(pooled_q, k_over, filter_mask=combined)
            cand_ids = cand[0][cand[0] >= 0]
            if cand_ids.size:
                sel = torch.from_numpy(cand_ids.astype(np.int64)).to(dev)
                sub_scores = score_multivector_maxsim(
                    q, tokens[sel], token_mask[sel], distance, valid[sel]
                )
                kk = min(k, int(cand_ids.size))
                [(top_s, ti)] = fetch_to_host([topk_first(sub_scores, kk)])
                s_out[0, :kk] = top_s
                i_out[0, :kk] = cand_ids[ti]
                i_out[0] = np.where(np.isfinite(s_out[0]), i_out[0], -1)
                return s_out, i_out
        scores = score_multivector_maxsim(q, tokens, token_mask, distance, valid)
        k_eff = min(k, n)
        [(top_s, top_i)] = fetch_to_host([topk_first(scores, k_eff)])
        s_out[0, :k_eff] = top_s
        i_out[0, :k_eff] = np.where(np.isfinite(top_s), top_i, -1)
        return s_out, i_out

    @_with_search_budget
    def search_sparse(
        self,
        name: str,
        queries: List[SparseVector],
        k: int,
        flt: Optional[Filter] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        fmask = self.filter_mask(flt)
        alive = self.alive_mask()
        combined = alive if fmask is None else (alive & fmask)
        return self.sparse_index[name].search(queries, k, filter_mask=combined)

    def search_sparse_many(
        self,
        name: str,
        batches: List[List[SparseVector]],
        k: int,
        flt: Optional[Filter] = None,
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Pipelined multi-batch sparse search (one device sync per window;
        index/sparse.py::SparseIndex.search_many)."""
        fmask = self.filter_mask(flt)
        alive = self.alive_mask()
        combined = alive if fmask is None else (alive & fmask)
        return self.sparse_index[name].search_many(
            batches, k, filter_mask=combined
        )

    # ------------------------------------------------------------------
    # seal
    # ------------------------------------------------------------------

    @tracing.traced("segment.build_indexes")
    def build_indexes(self, default_hnsw: Optional[HnswConfig] = None) -> None:
        """Seal the segment. Every multivector with live points gets an HNSW
        graph over its mean-pooled proxy rows. Every resident dense vector
        with live rows gets its HNSW graph (a ShardedHnswIndex on a mesh)
        and one subgraph per payload block of at least
        `full_scan_threshold` points (an `on_disk` vector skips the graph:
        it would force the f32 block onto the device). A vector with a
        quantization config is encoded as the JAX seal encodes it, and its
        codes are uploaded (SQ at FLAT_SCAN_MIN_N rows or more in the fused
        scan's int8 layout; of an `on_disk` vector in the torch scans'
        layout, its f32 rows staying in the memmap); any other vector uploads
        its bf16 scan block. Either way the first search after sealing pays
        no upload of what it scans."""
        from ..index.plain import SCAN_THRESHOLD
        from ..ops.fused_scan import DEFAULT_BLK
        from ..parallel.mesh import mesh_enabled

        for name, vp in self.params.vectors.items():
            mstore = self.multi.get(name)
            if mstore is None or mstore.available_count == 0:
                continue
            idx = HnswIndex(
                PooledMultiVectorStore(mstore), vp.hnsw_config or default_hnsw or HnswConfig()
            )
            idx.build()
            self.hnsw_multi[name] = idx
        for name, vp in self.params.vectors.items():
            store = self.dense.get(name)
            if store is None:
                continue
            cfg = vp.hnsw_config or default_hnsw or HnswConfig()
            if store.available_count > 0 and not store.on_disk:
                # multi-device: per-shard subgraphs searched over the mesh;
                # the payload-block subgraphs below stay on one device (they
                # are small by construction)
                idx = (ShardedHnswIndex(store, cfg) if mesh_enabled()
                       else HnswIndex(store, cfg))
                idx.build()
                self.hnsw[name] = idx
                # payload-block subgraphs for filterable search
                blocks = self.payload_index.payload_blocks(cfg.full_scan_threshold)
                if blocks:
                    sub_cfg = HnswConfig(
                        m=cfg.payload_m or cfg.m,
                        ef_construct=cfg.ef_construct,
                        full_scan_threshold=cfg.full_scan_threshold,
                    )
                    for field, value, offsets in blocks:
                        sub = HnswIndex(store, sub_cfg, subset=offsets)
                        sub.build()
                        self.hnsw_blocks.setdefault(name, {})[
                            (field, repr(value))
                        ] = sub
            qc = vp.quantization_config
            if qc is None:
                if len(store) >= SCAN_THRESHOLD:  # PlainIndex's own gate
                    with tracing.span("segment.scan_block"):
                        store.scan_index()
                continue
            if len(store) == 0:
                continue
            with tracing.span("segment.quantize"):
                quant = _encode(qc, store.host_array)
                self.quantized[name] = quant
                _upload_codes(quant, store, DEFAULT_BLK)
        self.appendable = False

    # ------------------------------------------------------------------
    # persistence (the JAX package's format)
    # ------------------------------------------------------------------

    def save(self, path: str) -> None:
        written = _thread_bytes_written()
        os.makedirs(path, exist_ok=True)
        meta = {
            "format_version": SEGMENT_FORMAT_VERSION,
            "version": self.version,
            "appendable": self.appendable,
            "params": self.params.to_dict(),
            "payload_indexes": {
                k: v.to_dict() for k, v in self.payload_index.indexed_fields().items()
            },
            "deferred": sorted(self.deferred),
            "hnsw": list(self.hnsw.keys()),
            "hnsw_multi": list(self.hnsw_multi.keys()),
            "hnsw_blocks": {
                name: [
                    [field, vkey, f"hnsw_block_{_safe(name)}_{i}"]
                    for i, (field, vkey) in enumerate(blocks.keys())
                ]
                for name, blocks in self.hnsw_blocks.items()
            },
            "quantized": {
                name: type(q).__name__ for name, q in self.quantized.items()
            },
            "payload_backend": (
                "memory"
                if isinstance(self.payload_storage, PayloadStorage)
                else "gridstore"
            ),
        }
        with open(os.path.join(path, "segment.json"), "w") as f:
            json.dump(meta, f)
        self.id_tracker.save(path)
        self.payload_storage.save(path)
        for name, store in self.dense.items():
            store.save(os.path.join(path, f"dense_{_safe(name)}"))
        for name, store in self.multi.items():
            store.save(os.path.join(path, f"multi_{_safe(name)}"))
        for name, store in self.sparse.items():
            store.save(os.path.join(path, f"sparse_{_safe(name)}"))
        for name, idx in self.hnsw.items():
            idx.save(os.path.join(path, f"hnsw_{_safe(name)}"))
        for name, idx in self.hnsw_multi.items():
            idx.save(os.path.join(path, f"hnsw_multi_{_safe(name)}"))
        for name, blocks in self.hnsw_blocks.items():
            for i, sub in enumerate(blocks.values()):
                sub.save(os.path.join(path, f"hnsw_block_{_safe(name)}_{i}"))
        for name, q in self.quantized.items():
            q.save(os.path.join(path, f"quant_{_safe(name)}"))
        if written is not None:
            tracing.count("flush.bytes", _thread_bytes_written() - written)

    @classmethod
    def load(cls, path: str) -> "Segment":
        with open(os.path.join(path, "segment.json")) as f:
            meta = json.load(f)
        meta = _migrate_segment_meta(meta, path)
        params = CollectionParams.from_dict(meta["params"])
        seg = cls(params, appendable=meta["appendable"], storage_dir=path)
        seg.version = meta["version"]
        seg.deferred = set(meta.get("deferred", []))
        seg.id_tracker = IdTracker.load(path)
        if meta.get("payload_backend") == "gridstore":
            from ..storage.payload import GridPayloadStorage

            seg.payload_storage = GridPayloadStorage.load(path)
        else:
            seg.payload_storage = PayloadStorage.load(path)
        for name, vp in params.vectors.items():
            sub = os.path.join(path, f"dense_{_safe(name)}")
            if vp.multivector_config is not None:
                msub = os.path.join(path, f"multi_{_safe(name)}")
                if os.path.exists(msub):
                    seg.multi[name] = MultiVectorStore.load(
                        msub, vp.size, vp.distance, vp.datatype
                    )
            elif os.path.exists(sub):
                seg.dense[name] = DenseVectorStore.load(
                    sub, vp.size, vp.distance, vp.datatype,
                    on_disk=vp.on_disk or _LOW_MEMORY_MODE != "disabled",
                )
        for name, sp in params.sparse_vectors.items():
            sub = os.path.join(path, f"sparse_{_safe(name)}")
            seg.sparse[name] = SparseVectorStore.load(sub)
            seg.sparse_index[name] = SparseIndex(seg.sparse[name], sp.modifier)
        seg.payload_index = StructPayloadIndex(
            seg.payload_storage, seg.id_tracker, seg._has_vector
        )
        for field, pdict in meta.get("payload_indexes", {}).items():
            seg.payload_index.set_indexed(field, PayloadIndexParams.from_dict(pdict))
        for name in meta.get("hnsw", []):
            cfg = params.vectors[name].hnsw_config or HnswConfig()
            seg.hnsw[name] = load_hnsw_any(
                os.path.join(path, f"hnsw_{_safe(name)}"), seg.dense[name], cfg
            )
        for name in meta.get("hnsw_multi", []):
            mstore = seg.multi.get(name)
            if mstore is None:
                continue
            seg.hnsw_multi[name] = HnswIndex.load(
                os.path.join(path, f"hnsw_multi_{_safe(name)}"),
                PooledMultiVectorStore(mstore),
                params.vectors[name].hnsw_config or HnswConfig(),
            )
        for name, blocks in meta.get("hnsw_blocks", {}).items():
            cfg = params.vectors[name].hnsw_config or HnswConfig()
            sub_cfg = HnswConfig(
                m=cfg.payload_m or cfg.m,
                ef_construct=cfg.ef_construct,
                full_scan_threshold=cfg.full_scan_threshold,
            )
            for field, vkey, dirname in blocks:
                seg.hnsw_blocks.setdefault(name, {})[(field, vkey)] = HnswIndex.load(
                    os.path.join(path, dirname), seg.dense[name], sub_cfg
                )
        for name, qtype in meta.get("quantized", {}).items():
            cls_ = _QUANTIZED_TYPES.get(qtype)
            if cls_ is not None:
                seg.quantized[name] = cls_.load(os.path.join(path, f"quant_{_safe(name)}"))
        if _LOW_MEMORY_MODE == "no_populate":
            for store in seg.dense.values():
                store.drop_device()
        return seg


def _thread_bytes_written() -> Optional[int]:
    """Bytes this thread has passed to write calls (`wchar` of
    /proc/thread-self/io) → None where the kernel does not say. Writes
    through a memory map are not among them."""
    try:
        with open("/proc/thread-self/io") as f:
            for line in f:
                if line.startswith("wchar:"):
                    return int(line.split(":", 1)[1])
    except OSError:
        pass
    return None


def _candidates(top_scores: torch.Tensor, top_ids: torch.Tensor) -> np.ndarray:
    """Device (scores, ids) of a quantized scan → host candidate ids [B, C]
    int32, -1 where the score is not finite."""
    [(s, i)] = fetch_to_host([(top_scores, top_ids)])
    return np.where(np.isfinite(s), i, -1)


def _upload_codes(quant, store: DenseVectorStore, kernel_block: int) -> None:
    """Put a sealed vector's codes on the device in the layout its searches
    scan (Segment._search_quantized picks by the same conditions)."""
    from ..ops.scan import DEFAULT_BLOCK

    big = len(store) >= FLAT_SCAN_MIN_N
    if big and isinstance(quant, qops.ScalarQuantized):
        if store.on_disk:
            quant.scan_device(DEFAULT_BLOCK)
        else:
            quant.kernel_device(kernel_block)
    elif big and store.on_disk and isinstance(quant, qops.TurboQuantized):
        quant.flat_device(DEFAULT_BLOCK)
    else:
        quant.device()


def _add_deleted_multi(store: MultiVectorStore, n: int) -> None:
    """Append `n` deleted one-token placeholders (keeps offsets aligned
    across a segment's stores)."""
    zero = np.zeros((1, store.dim), dtype=np.float32)
    for off in store.add([zero] * n):
        store.delete(int(off))


def _safe(name: str) -> str:
    return name if name else "_default"


def _block_conditions(flt: Optional[Filter]):
    """Yield (field, value_repr) for plain match-value must conditions —
    candidates for payload-block subgraph dispatch."""
    if flt is None:
        return
    from ..types import FieldCondition, MatchValue

    for cond in flt.must:
        if (
            isinstance(cond, FieldCondition)
            and isinstance(cond.match, MatchValue)
            and cond.range is None
            and cond.geo_bounding_box is None
            and cond.geo_radius is None
            and cond.geo_polygon is None
            and cond.values_count is None
        ):
            yield cond.key, repr(cond.match.value)


_QUANTIZED_TYPES = {
    cls.__name__: cls
    for cls in (
        qops.ScalarQuantized,
        qops.BinaryQuantized,
        qops.ProductQuantized,
        qops.TurboQuantized,
    )
}


def _encode(qc, data: np.ndarray):
    """Quantize a sealed vector's rows as the JAX seal does."""
    if isinstance(qc, ScalarQuantizationConfig):
        return qops.ScalarQuantized.encode(data, qc.quantile or 0.99)
    if isinstance(qc, BinaryQuantizationConfig):
        return qops.BinaryQuantized.encode(data)
    if isinstance(qc, ProductQuantizationConfig):
        return qops.ProductQuantized.encode(data, qc.compression)
    if isinstance(qc, TurboQuantizationConfig):
        bits = {"bits1": 1, "bits1_5": 1.5, "bits2": 2, "bits4": 4}[qc.bits]
        return qops.TurboQuantized.encode(data, bits=bits)
    raise ValueError(f"unknown quantization config {qc!r}")
