"""Dense vector storage: host-resident numpy truth with a device mirror
(counterpart of qdrant_tpu/storage/vectors.py::DenseVectorStore).

The source of truth is a float32 numpy array on the host (appendable,
memmap-able for persistence); searches run against a lazily synchronized
device tensor in the configured scoring dtype, padded to a power-of-two
capacity. The on-disk format is the JAX package's, so a storage directory
written by either package opens in the other.
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
        if not self.on_disk:
            return np.zeros((cap, self.dim), dtype=np.float32)
        if self._disk_dir is None:
            import tempfile

            self._disk_dir = tempfile.mkdtemp(prefix="qtpu_vecs_")
        os.makedirs(self._disk_dir, exist_ok=True)
        path = os.path.join(self._disk_dir, f"vectors_{cap}.f32")
        mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(cap, self.dim))
        old = self._disk_path
        self._disk_path = path
        if old is not None and old != path:
            try:
                os.unlink(old)
            except OSError:
                pass
        return mm

    def _ensure_capacity(self, n: int) -> None:
        if n <= self._data.shape[0]:
            return
        cap = _round_capacity(n)
        data = self._alloc(cap)
        data[: self._count] = self._data[: self._count]
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
        self._ensure_capacity(self._count + n)
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
        current contents — rebuilt lazily after mutations."""
        from ..ops.scan import ScanIndex

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
                device=default_device(),
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
            out = np.memmap(
                dst, dtype=np.float32, mode="w+",
                shape=(max(self._count, 1), self.dim),
            )
            step = 1 << 16
            for i in range(0, self._count, step):
                end = min(i + step, self._count)
                out[i:end] = self._data[i:end]
            out.flush()
            with open(os.path.join(path, "vectors.meta"), "w") as f:
                f.write(f"{self._count} {self.dim} on_disk")
            np.save(os.path.join(path, "deleted.npy"), self._deleted[: self._count])
            return
        np.save(os.path.join(path, "vectors.npy"), self._data[: self._count])
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
                store._data = np.memmap(
                    os.path.join(path, "vectors.f32"), dtype=np.float32,
                    mode="r+", shape=(n, dim),
                )
                store._disk_path = None  # segment-owned file: never unlink
            store._deleted = deleted.copy()
            store._count = n
            store._deleted_count = int(deleted.sum())
            return store
        store = cls(dim, distance, datatype, on_disk=on_disk)
        data = np.load(
            os.path.join(path, "vectors.npy"),
            mmap_mode="r" if on_disk else None,
        )
        deleted = np.load(os.path.join(path, "deleted.npy"))
        n = data.shape[0]
        store._ensure_capacity(n)
        store._data[:n] = data
        store._deleted[:n] = deleted
        store._count = n
        store._deleted_count = int(deleted.sum())
        return store
