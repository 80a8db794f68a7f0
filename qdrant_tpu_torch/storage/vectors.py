"""Dense vector storage: host-resident numpy truth with a device mirror
(counterpart of qdrant_tpu/storage/vectors.py::DenseVectorStore).

The source of truth is a float32 numpy array on the host (appendable,
memmap-able for persistence); searches run against a lazily synchronized
device tensor in the configured scoring dtype, padded to a power-of-two
capacity. The on-disk format is the JAX package's, so a storage directory
written by either package opens in the other.

An `on_disk` store given a `storage_dir` (its segment's `dense_<name>`
directory) works in that directory's `vectors.f32`, the file it is saved as:
growth writes the larger file beside it and renames it over, and a save to
the same directory flushes the map instead of rewriting the file under it
(the JAX store rewrites it, which zeroes a store loaded from that file).
Without a directory the working file goes under the system temp directory.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..types import Datatype, Distance

from ..device import default_device, tensor_bytes
from ..ops.distances import preprocess_vectors

_MIN_CAP = 1024


def _round_capacity(n: int) -> int:
    """Next power-of-two capacity ≥ _MIN_CAP (bounded shape classes)."""
    cap = _MIN_CAP
    while cap < n:
        cap *= 2
    return cap


_DTYPE_MAP = {
    Datatype.FLOAT32: torch.float32,
    Datatype.BFLOAT16: torch.bfloat16,
    Datatype.FLOAT16: torch.float16,
    Datatype.UINT8: torch.uint8,
}


class DenseVectorStore:
    """Appendable dense vector storage with a device mirror.

    Host truth: float32 [cap, D] + deleted bitmap. Device mirror: [cap, D] in
    `datatype` + validity mask, rebuilt on demand after mutations.
    """

    def __init__(
        self,
        dim: int,
        distance: Distance,
        datatype: Datatype = Datatype.FLOAT32,
        on_disk: bool = False,
        storage_dir: Optional[str] = None,
    ):
        self.dim = dim
        self.distance = distance
        self.datatype = datatype
        # on_disk: the f32 truth lives in a disk-backed memmap
        self.on_disk = on_disk
        self._disk_dir = storage_dir
        self._disk_path: Optional[str] = None
        self._data = np.zeros((0, dim), dtype=np.float32)
        self._deleted = np.zeros((0,), dtype=bool)
        self._count = 0
        self._deleted_count = 0
        self._dev: Optional[torch.Tensor] = None
        self._dev_mask: Optional[torch.Tensor] = None
        self._scan = None
        self._scan_version = None
        self._dirty = True

    # -- host mutation ------------------------------------------------------

    def __len__(self) -> int:
        return self._count

    @property
    def deleted_count(self) -> int:
        return self._deleted_count

    @property
    def available_count(self) -> int:
        return self._count - self._deleted_count

    def _alloc(self, cap: int) -> np.ndarray:
        """A [cap, D] array holding the current rows."""
        if not self.on_disk:
            data = np.zeros((cap, self.dim), dtype=np.float32)
            data[: self._count] = self._data[: self._count]
            return data
        if self._disk_dir is None:
            import tempfile

            self._disk_dir = tempfile.mkdtemp(prefix="qtpu_vecs_")
        os.makedirs(self._disk_dir, exist_ok=True)
        path = os.path.join(self._disk_dir, "vectors.f32")
        grow = path + ".grow"
        mm = np.memmap(grow, dtype=np.float32, mode="w+", shape=(cap, self.dim))
        for i in range(0, self._count, 1 << 16):
            end = min(i + (1 << 16), self._count)
            mm[i:end] = self._data[i:end]
        mm.flush()
        del mm
        os.replace(grow, path)  # the old map keeps the old file until dropped
        self._disk_path = path
        return np.memmap(path, dtype=np.float32, mode="r+", shape=(cap, self.dim))

    def reserve(self, n: int) -> None:
        """Room for `n` rows in all, so that appends up to it copy nothing
        (an on_disk store rewrites its file at each growth)."""
        if n <= self._data.shape[0]:
            return
        cap = _round_capacity(n)
        data = self._alloc(cap)
        self._data = data
        deleted = np.zeros((cap,), dtype=bool)
        deleted[: self._count] = self._deleted[: self._count]
        self._deleted = deleted

    def add(self, vectors: np.ndarray) -> np.ndarray:
        """Append preprocessed vectors; returns assigned offsets (int32)."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        if vectors.shape[1] != self.dim:
            raise ValueError(
                f"vector dim {vectors.shape[1]} != storage dim {self.dim}"
            )
        vectors = preprocess_vectors(vectors, self.distance)
        n = vectors.shape[0]
        self.reserve(self._count + n)
        offsets = np.arange(self._count, self._count + n, dtype=np.int32)
        self._data[self._count : self._count + n] = vectors
        self._count += n
        self._dirty = True
        return offsets

    def set(self, offset: int, vector: np.ndarray) -> None:
        v = preprocess_vectors(
            np.asarray(vector, dtype=np.float32)[None, :], self.distance
        )[0]
        self._data[offset] = v
        if self._deleted[offset]:
            self._deleted[offset] = False
            self._deleted_count -= 1
        self._dirty = True

    def delete(self, offset: int) -> bool:
        if offset >= self._count or self._deleted[offset]:
            return False
        self._deleted[offset] = True
        self._deleted_count += 1
        self._dirty = True
        return True

    def delete_many(self, offsets: np.ndarray) -> None:
        """`delete` of each of `offsets` (distinct, below the count) at once."""
        offsets = np.asarray(offsets, dtype=np.int64)
        fresh = offsets[~self._deleted[offsets]]
        if len(fresh):
            self._deleted[fresh] = True
            self._deleted_count += len(fresh)
            self._dirty = True

    def is_deleted(self, offset: int) -> bool:
        return bool(self._deleted[offset])

    def get(self, offset: int) -> np.ndarray:
        return self._data[offset]

    def get_batch(self, offsets: np.ndarray) -> np.ndarray:
        return self._data[np.asarray(offsets, dtype=np.int64)]

    @property
    def host_array(self) -> np.ndarray:
        """Valid rows [count, D] (includes deleted rows; mask separately)."""
        return self._data[: self._count]

    @property
    def deleted_mask(self) -> np.ndarray:
        return self._deleted[: self._count]

    # -- device mirror ------------------------------------------------------

    def device_block(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (vectors [cap, D] in scoring dtype, valid_mask [cap] bool)."""
        if self._dirty or self._dev is None:
            cap = max(_MIN_CAP, self._data.shape[0])
            data = self._data
            if data.shape[0] < cap:
                data = np.zeros((cap, self.dim), dtype=np.float32)
                data[: self._count] = self._data[: self._count]
            mask = np.zeros((cap,), dtype=bool)
            mask[: self._count] = ~self._deleted[: self._count]
            dev = default_device()
            self._dev = torch.from_numpy(np.ascontiguousarray(data)).to(
                dev, _DTYPE_MAP[self.datatype]
            )
            self._dev_mask = torch.from_numpy(mask).to(dev)
            self._dirty = False
        return self._dev, self._dev_mask

    def drop_device(self) -> None:
        self._dev = None
        self._dev_mask = None
        self._scan = None
        self._dirty = True

    def memory_usage_bytes(self):
        """Host/device/disk bytes for this store incl. its device mirror
        and cached scan searcher."""
        from ..utils.memsize import merge, sizeof, sizeof_attrs

        return merge(
            sizeof_attrs(self, "_data", "_deleted"),
            {"device_bytes": tensor_bytes(self._dev, self._dev_mask)},
            sizeof(getattr(self, "_scan", None)),
        )

    def scan_index(self):
        """Cached blocked-scan searcher (ops/scan.py) over this store's
        current contents — rebuilt lazily after mutations. With a mesh
        (parallel/mesh.py::mesh_enabled) it is sharded, and its f32 rescore
        reads this store's device block through per-shard views."""
        from ..ops.scan import ScanIndex
        from ..parallel.mesh import mesh_enabled

        if self._scan is None or self._scan_version != (
            self._count,
            self._deleted_count,
        ):
            self._scan = None  # free the old block before uploading the new
            valid = ~self._deleted[: self._count]
            self._scan = ScanIndex(
                self.host_array,
                valid_mask=valid,
                euclid=self.distance in (Distance.EUCLID, Distance.MANHATTAN),
                rows=self.device_block()[0] if mesh_enabled() else None,
            )
            self._scan_version = (self._count, self._deleted_count)
        return self._scan

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        if self.on_disk:
            # stream the memmap straight to the segment dir + a tiny meta
            # record; load() memmaps it back in place
            if isinstance(self._data, np.memmap):
                self._data.flush()
            dst = os.path.join(path, "vectors.f32")
            if self._disk_path is not None and os.path.exists(dst) and os.path.samefile(
                dst, self._disk_path
            ):
                self._save_meta(path)  # the working file is the saved one
                return
            out = np.memmap(
                dst, dtype=np.float32, mode="w+",
                shape=(max(self._count, 1), self.dim),
            )
            step = 1 << 16
            for i in range(0, self._count, step):
                end = min(i + step, self._count)
                out[i:end] = self._data[i:end]
            out.flush()
            self._save_meta(path)
            return
        np.save(os.path.join(path, "vectors.npy"), self._data[: self._count])
        np.save(os.path.join(path, "deleted.npy"), self._deleted[: self._count])

    def _save_meta(self, path: str) -> None:
        """The on-disk form's row count and deleted flags beside vectors.f32,
        which holds at least that many rows."""
        with open(os.path.join(path, "vectors.meta"), "w") as f:
            f.write(f"{self._count} {self.dim} on_disk")
        np.save(os.path.join(path, "deleted.npy"), self._deleted[: self._count])

    @classmethod
    def load(
        cls, path: str, dim: int, distance: Distance, datatype: Datatype,
        on_disk: bool = False,
    ) -> "DenseVectorStore":
        meta = os.path.join(path, "vectors.meta")
        if os.path.exists(meta):
            with open(meta) as f:
                n = int(f.read().split()[0])
            store = cls(dim, distance, datatype, on_disk=True, storage_dir=path)
            deleted = np.load(os.path.join(path, "deleted.npy"))
            if n:
                store._disk_path = os.path.join(path, "vectors.f32")
                store._data = np.memmap(
                    store._disk_path, dtype=np.float32, mode="r+", shape=(n, dim),
                )
            store._deleted = deleted.copy()
            store._count = n
            store._deleted_count = int(deleted.sum())
            return store
        store = cls(dim, distance, datatype, on_disk=on_disk,
                    storage_dir=path if on_disk else None)
        data = np.load(
            os.path.join(path, "vectors.npy"),
            mmap_mode="r" if on_disk else None,
        )
        deleted = np.load(os.path.join(path, "deleted.npy"))
        n = data.shape[0]
        store.reserve(n)
        store._data[:n] = data
        store._deleted[:n] = deleted
        store._count = n
        store._deleted_count = int(deleted.sum())
        return store


class DeviceVectorStore(DenseVectorStore):
    """Sealed dense store whose truth is a tensor on the device (counterpart
    of qdrant_tpu/storage/vectors.py::DeviceVectorStore).

    For vectors produced on the device (an embedding model on the same
    card, a device-side generator): the [N, D] block never round-trips the
    host. The few host-row reads (HNSW seed graph, exact candidate rescore)
    go through an optional `host_fetch(offsets) -> [k, D] f32` callable, or
    else a device gather and a download of just those rows. Sealed: `add` /
    `set` raise; build a new store to change membership.
    """

    def __init__(
        self,
        dev_vectors: torch.Tensor,  # [cap, D] (distance-preprocessed) on the device
        distance: Distance,
        count: Optional[int] = None,
        host_fetch=None,
        datatype: Datatype = Datatype.FLOAT32,
    ):
        super().__init__(int(dev_vectors.shape[1]), distance, datatype)
        cap = int(dev_vectors.shape[0])
        n = int(count if count is not None else cap)
        if not (0 <= n <= cap):
            raise ValueError(f"count {n} outside device block rows {cap}")
        self._count = n
        self._deleted = np.zeros(n, dtype=bool)
        self._host_fetch = host_fetch
        self._dev = dev_vectors.to(_DTYPE_MAP[datatype])
        self._dev_mask = self._mask_tensor()

    def _mask_tensor(self) -> torch.Tensor:
        mask = torch.zeros(self._dev.shape[0], dtype=torch.bool)
        mask[: self._count] = torch.from_numpy(~self._deleted[: self._count])
        return mask.to(self._dev.device)

    def add(self, vectors):
        raise NotImplementedError("DeviceVectorStore is sealed (device-native)")

    def set(self, offset, vector):
        raise NotImplementedError("DeviceVectorStore is sealed (device-native)")

    def delete(self, offset: int) -> bool:
        # a deletion must reach the device mask, or device_block() keeps
        # scoring the row for every caller that relies on the store's own
        # validity (small-store PlainIndex path, HNSW alive defaults)
        ok = super().delete(offset)
        if ok:
            self._dev_mask = self._mask_tensor()
        return ok

    def delete_many(self, offsets: np.ndarray) -> None:
        super().delete_many(offsets)
        self._dev_mask = self._mask_tensor()

    def device_block(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._dev, self._dev_mask

    def get(self, offset: int) -> np.ndarray:
        return self.get_batch(np.asarray([offset]))[0]

    def get_batch(self, offsets: np.ndarray) -> np.ndarray:
        offsets = np.asarray(offsets, dtype=np.int64)
        if self._host_fetch is not None:
            return np.asarray(self._host_fetch(offsets), dtype=np.float32)
        idx = torch.from_numpy(offsets).to(self._dev.device)
        return self._dev[idx].float().cpu().numpy()

    @property
    def host_array(self) -> np.ndarray:
        # O(count) download: debug and persistence readers only
        return self.get_batch(np.arange(self._count))

    def scan_index(self):
        from ..ops.scan import DEFAULT_BLK, ScanIndex, pad_rows
        from ..parallel.mesh import make_mesh, mesh_enabled

        if self._scan is None or self._scan_version != (
            self._count,
            self._deleted_count,
        ):
            self._scan = None
            # the kernel's layout built on the device from the FULL block (a
            # [:count] slice would be a copy); pad rows past count stay
            # invalid through the short mask. On a mesh the rows pad to whole
            # blocks on every shard and the rescore reads this block's rows
            mesh = make_mesh() if mesh_enabled() else None
            cap, d = self._dev.shape
            euclid = self.distance in (Distance.EUCLID, Distance.MANHATTAN)
            rows = self._dev.to(torch.float32)
            n_pad = pad_rows(cap, DEFAULT_BLK * (mesh.size if mesh else 1))
            v = torch.zeros((n_pad, max((d + 127) // 128 * 128, 128)),
                            dtype=torch.bfloat16, device=self._dev.device)
            v[:cap, :d] = (2.0 * rows if euclid else rows).to(torch.bfloat16)
            vsq = np.zeros(v.shape[0], dtype=np.float32)
            if euclid:
                vsq[:cap] = (rows * rows).sum(dim=1).cpu().numpy()
            del rows
            self._scan = ScanIndex.from_arrays(v, vsq, None, cap, euclid, mesh=mesh,
                                               rows=self._dev)
            self._scan.update_mask(~self._deleted[: self._count])
            self._scan_version = (self._count, self._deleted_count)
        return self._scan

    def memory_usage_bytes(self):
        from ..utils.memsize import merge, sizeof, sizeof_attrs

        return merge(
            sizeof_attrs(self, "_deleted"),
            {"device_bytes": tensor_bytes(self._dev, self._dev_mask)},
            sizeof(self._scan),
        )


# points whose tokens go to the device in one scatter while the padded block
# is built (bounds the host gather and the upload at a few hundred MB)
_PAD_CHUNK_POINTS = 16384


def _token_rows(ranges: np.ndarray, lo: int, hi: int, s: int):
    """Rows of the flat token array of points lo..hi-1 and their rows in a
    padded [N·S, D] block → (src, dst) int64, in point then token order."""
    starts, lens = ranges[lo:hi, 0], ranges[lo:hi, 1]
    within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    src = np.repeat(starts, lens) + within
    dst = np.repeat(np.arange(lo, hi, dtype=np.int64) * s, lens) + within
    return src, dst


class MultiVectorStore:
    """Storage for multivectors (token matrices, ColBERT-style; counterpart
    of qdrant_tpu/storage/vectors.py::MultiVectorStore).

    Flat layout: one [total_tokens, D] f32 host array plus per-point
    (start, len) ranges. Searches score a padded [N, S, D] device block
    (`padded_block`), rebuilt after mutations. The on-disk files are the JAX
    package's (mv_flat.npy, mv_ranges.npy, mv_deleted.npy).
    """

    def __init__(self, dim: int, distance: Distance, datatype: Datatype = Datatype.FLOAT32):
        self.dim = dim
        self.distance = distance
        self.datatype = datatype
        self._flat = np.zeros((0, dim), dtype=np.float32)
        self._flat_count = 0
        self._ranges = np.zeros((0, 2), dtype=np.int64)  # (start, len)
        self._count = 0
        self._deleted = np.zeros((0,), dtype=bool)
        self._deleted_count = 0
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
        self._dirty = True

    def __len__(self) -> int:
        return self._count

    @property
    def deleted_count(self) -> int:
        return self._deleted_count

    @property
    def available_count(self) -> int:
        return self._count - self._deleted_count

    def memory_usage_bytes(self):
        from ..utils.memsize import merge, sizeof_attrs

        return merge(
            sizeof_attrs(self, "_flat", "_ranges", "_deleted"),
            {"device_bytes": tensor_bytes(*(self._dev or ()))},
        )

    def add(self, matrices) -> np.ndarray:
        """Append token matrices ([T_i, D] each, preprocessed per token) →
        their offsets (int32)."""
        mats = [np.atleast_2d(np.asarray(m, dtype=np.float32)) for m in matrices]
        for mat in mats:
            if mat.shape[1] != self.dim:
                raise ValueError(f"multivector dim {mat.shape[1]} != {self.dim}")
        if not mats:
            return np.zeros(0, dtype=np.int32)
        lens = np.asarray([m.shape[0] for m in mats], dtype=np.int64)
        tokens = preprocess_vectors(np.concatenate(mats), self.distance)
        t, k = int(lens.sum()), len(mats)
        if self._flat_count + t > self._flat.shape[0]:
            flat = np.zeros((_round_capacity(self._flat_count + t), self.dim), np.float32)
            flat[: self._flat_count] = self._flat[: self._flat_count]
            self._flat = flat
        self._flat[self._flat_count : self._flat_count + t] = tokens
        if self._count + k > self._ranges.shape[0]:
            cap = _round_capacity(self._count + k)
            ranges = np.zeros((cap, 2), dtype=np.int64)
            ranges[: self._count] = self._ranges[: self._count]
            self._ranges = ranges
            deleted = np.zeros((cap,), dtype=bool)
            deleted[: self._count] = self._deleted[: self._count]
            self._deleted = deleted
        self._ranges[self._count : self._count + k, 0] = (
            self._flat_count + np.cumsum(lens) - lens
        )
        self._ranges[self._count : self._count + k, 1] = lens
        offsets = np.arange(self._count, self._count + k, dtype=np.int32)
        self._flat_count += t
        self._count += k
        self._dirty = True
        return offsets

    def set(self, offset: int, matrix) -> None:
        # append the new token block; the old one stays as garbage until the
        # segment is rebuilt
        new_off = self.add([matrix])[0]
        self._ranges[offset] = self._ranges[new_off]
        self._count -= 1  # drop the temporary tail point
        if self._deleted[offset]:
            self._deleted[offset] = False
            self._deleted_count -= 1
        self._dirty = True

    def delete(self, offset: int) -> bool:
        if offset >= self._count or self._deleted[offset]:
            return False
        self._deleted[offset] = True
        self._deleted_count += 1
        self._dirty = True
        return True

    def is_deleted(self, offset: int) -> bool:
        return bool(self._deleted[offset])

    def get(self, offset: int) -> np.ndarray:
        start, ln = self._ranges[offset]
        return self._flat[start : start + ln]

    @property
    def deleted_mask(self) -> np.ndarray:
        return self._deleted[: self._count]

    @property
    def max_tokens(self) -> int:
        if self._count == 0:
            return 0
        return int(self._ranges[: self._count, 1].max())

    def padded_block(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """→ (tokens [N, S, D] in the scoring dtype, token_mask [N, S],
        valid [N]) on the device; S is the longest point's token count
        rounded up to a multiple of 8. Built by one scatter per chunk of
        points from the flat array, not a loop over points."""
        if self._dirty or self._dev is None:
            self._dev = None  # free the old block before building the new
            dev = default_device()
            n_pts = self._count
            n = max(1, n_pts)
            s = (max(1, self.max_tokens) + 7) // 8 * 8
            tokens = torch.zeros((n, s, self.dim), dtype=_DTYPE_MAP[self.datatype], device=dev)
            rows = tokens.view(n * s, self.dim)
            for lo in range(0, n_pts, _PAD_CHUNK_POINTS):
                src, dst = _token_rows(self._ranges, lo, min(lo + _PAD_CHUNK_POINTS, n_pts), s)
                if len(src):
                    rows[torch.from_numpy(dst).to(dev)] = torch.from_numpy(
                        self._flat[src]).to(dev, rows.dtype)
            lens = np.zeros(n, dtype=np.int64)
            lens[:n_pts] = self._ranges[:n_pts, 1]
            token_mask = torch.arange(s, device=dev)[None, :] < torch.from_numpy(lens).to(dev)[:, None]
            valid = np.zeros(n, dtype=bool)
            valid[:n_pts] = ~self._deleted[:n_pts]
            self._dev = (tokens, token_mask, torch.from_numpy(valid).to(dev))
            self._dirty = False
        return self._dev

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "mv_flat.npy"), self._flat[: self._flat_count])
        np.save(os.path.join(path, "mv_ranges.npy"), self._ranges[: self._count])
        np.save(os.path.join(path, "mv_deleted.npy"), self._deleted[: self._count])

    @classmethod
    def load(cls, path: str, dim: int, distance: Distance, datatype: Datatype) -> "MultiVectorStore":
        store = cls(dim, distance, datatype)
        flat = np.load(os.path.join(path, "mv_flat.npy"))
        ranges = np.load(os.path.join(path, "mv_ranges.npy"))
        deleted = np.load(os.path.join(path, "mv_deleted.npy"))
        store._flat = flat.copy()
        store._flat_count = flat.shape[0]
        store._ranges = ranges.astype(np.int64)
        store._deleted = deleted.copy()
        store._count = ranges.shape[0]
        store._deleted_count = int(deleted.sum())
        return store


class PooledMultiVectorStore:
    """Dense single-vector view of a MultiVectorStore: each point's tokens
    mean-pooled, then distance-preprocessed (counterpart of
    qdrant_tpu/storage/vectors.py::PooledMultiVectorStore). It is the HNSW
    proxy store for multivectors: the graph walks one pooled row per point
    and the exact max-sim rescores the oversampled winners, where a graph
    over tokens would multiply every gather by the tokens per point. It has
    the store interface HnswIndex reads."""

    def __init__(self, multi: MultiVectorStore):
        self.multi = multi
        self.dim = multi.dim
        self.distance = multi.distance
        self.datatype = Datatype.FLOAT32
        n = len(multi)
        pooled = np.zeros((n, multi.dim), dtype=np.float32)
        starts, lens = multi._ranges[:n, 0], multi._ranges[:n, 1]
        # each point's tokens summed in order, one token position at a time
        # for all points, then / len: numpy's mean over axis 0 of its rows
        for j in range(int(lens.max(initial=0))):
            rows = np.flatnonzero(lens > j)
            pooled[rows] += multi._flat[starts[rows] + j]
        full = lens > 0
        pooled[full] /= lens[full, None].astype(np.float32)
        self._host = preprocess_vectors(pooled, multi.distance) if n else pooled
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def __len__(self) -> int:
        return len(self.multi)

    @property
    def available_count(self) -> int:
        return self.multi.available_count

    @property
    def deleted_mask(self) -> np.ndarray:
        return self.multi.deleted_mask

    @property
    def host_array(self) -> np.ndarray:
        return self._host

    def get_batch(self, ids: np.ndarray) -> np.ndarray:
        return self._host[np.asarray(ids, dtype=np.int64)]

    def device_block(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (pooled rows [cap, D] f32, valid [cap]); cap is a power of two
        of at least 8 rows."""
        if self._dev is None:
            n = max(1, len(self._host))
            cap = max(1 << (n - 1).bit_length() if n > 1 else 1, 8)
            buf = np.zeros((cap, self.dim), dtype=np.float32)
            buf[: len(self._host)] = self._host
            mask = np.zeros(cap, dtype=bool)
            mask[: len(self.multi)] = ~self.deleted_mask
            dev = default_device()
            self._dev = (torch.from_numpy(buf).to(dev), torch.from_numpy(mask).to(dev))
        return self._dev

    def memory_usage_bytes(self):
        from ..utils.memsize import merge, sizeof_attrs

        return merge(
            sizeof_attrs(self, "_host"),
            {"device_bytes": tensor_bytes(*(self._dev or ()))},
        )
