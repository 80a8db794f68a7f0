"""Payload (JSON document) storage per segment.

Reference: lib/segment/src/payload_storage/ (in-memory / Gridstore / mmap
variants). Host-side list-of-dicts keyed by internal offset, persisted as
msgpack. Payload JSON never touches the device — filters compile to offset
bitmasks that are shipped to HBM (see index/payload_index.py).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import msgpack

from ..utils import json_path


class PayloadStorage:
    def __init__(self):
        self._payloads: List[Optional[Dict[str, Any]]] = []

    def __len__(self) -> int:
        return len(self._payloads)

    def _ensure(self, offset: int) -> None:
        while len(self._payloads) <= offset:
            self._payloads.append(None)

    def set(self, offset: int, payload: Dict[str, Any]) -> None:
        """Merge payload keys (top-level merge, as the reference set_payload)."""
        self._ensure(offset)
        cur = self._payloads[offset]
        if cur is None:
            cur = {}
            self._payloads[offset] = cur
        cur.update(payload)

    def set_by_key(self, offset: int, payload: Dict[str, Any], key: str) -> None:
        """Merge `payload` at nested `key` (reference set_payload with key)."""
        self._ensure(offset)
        cur = self._payloads[offset]
        if cur is None:
            cur = {}
            self._payloads[offset] = cur
        existing = json_path.get_values(cur, key)
        if existing and isinstance(existing[0], dict):
            existing[0].update(payload)
        else:
            json_path.set_value(cur, key, dict(payload))

    def overwrite(self, offset: int, payload: Optional[Dict[str, Any]]) -> None:
        self._ensure(offset)
        self._payloads[offset] = dict(payload) if payload else None

    def get(self, offset: int) -> Dict[str, Any]:
        if offset < len(self._payloads) and self._payloads[offset] is not None:
            return self._payloads[offset]
        return {}

    def has_payload(self, offset: int) -> bool:
        return offset < len(self._payloads) and bool(self._payloads[offset])

    def delete_key(self, offset: int, key: str) -> bool:
        if offset >= len(self._payloads) or self._payloads[offset] is None:
            return False
        return json_path.delete_path(self._payloads[offset], key)

    def clear(self, offset: int) -> None:
        if offset < len(self._payloads):
            self._payloads[offset] = None

    def iter_items(self):
        for off, p in enumerate(self._payloads):
            if p is not None:
                yield off, p

    def memory_usage_bytes(self):
        """Sampled estimate: mean msgpack size of <=256 payloads x count,
        x3 for dict/str interpreter overhead. Exact deep-getsizeof over
        millions of dicts is O(total keys) — too slow for a telemetry
        endpoint; serialized size tracks actual content within ~2x."""
        non_null = [p for p in self._payloads[:4096] if p is not None]
        count = sum(1 for p in self._payloads if p is not None)
        if not non_null or not count:
            return {"host_bytes": 0, "device_bytes": 0, "disk_bytes": 0}
        sample = non_null[:256]
        avg = sum(len(msgpack.packb(p, use_bin_type=True)) for p in sample) / len(sample)
        return {
            "host_bytes": int(avg * 3 * count),
            "device_bytes": 0,
            "disk_bytes": 0,
        }

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "payload.msgpack"), "wb") as f:
            f.write(msgpack.packb(self._payloads, use_bin_type=True))

    @classmethod
    def load(cls, path: str) -> "PayloadStorage":
        storage = cls()
        file = os.path.join(path, "payload.msgpack")
        if os.path.exists(file):
            with open(file, "rb") as f:
                storage._payloads = msgpack.unpackb(f.read(), raw=False, strict_map_key=False)
        return storage


class GridPayloadStorage:
    """On-disk payload storage over the native page-based blob store
    (reference: payload_storage/on_disk via lib/blobstore Gridstore).
    Payloads live on disk as per-offset msgpack blobs; reads go straight to
    the store (OS page cache absorbs hot offsets), so sealed segments with
    `on_disk_payload: true` hold no payload JSON in RAM."""

    def __init__(self, directory: str):
        from ..native import GridStore

        self.directory = directory
        self._store = GridStore(directory)

    def __len__(self) -> int:
        return self._store.capacity()

    def _read(self, offset: int) -> Optional[Dict[str, Any]]:
        raw = self._store.get(offset)
        if raw is None:
            return None
        return msgpack.unpackb(raw, raw=False, strict_map_key=False)

    def _write(self, offset: int, payload: Optional[Dict[str, Any]]) -> None:
        if payload:
            self._store.put(offset, msgpack.packb(payload, use_bin_type=True))
        else:
            self._store.delete(offset)

    def set(self, offset: int, payload: Dict[str, Any]) -> None:
        cur = self._read(offset) or {}
        cur.update(payload)
        self._write(offset, cur)

    def set_by_key(self, offset: int, payload: Dict[str, Any], key: str) -> None:
        cur = self._read(offset) or {}
        existing = json_path.get_values(cur, key)
        if existing and isinstance(existing[0], dict):
            existing[0].update(payload)
        else:
            json_path.set_value(cur, key, dict(payload))
        self._write(offset, cur)

    def overwrite(self, offset: int, payload: Optional[Dict[str, Any]]) -> None:
        self._write(offset, dict(payload) if payload else None)

    def get(self, offset: int) -> Dict[str, Any]:
        return self._read(offset) or {}

    def has_payload(self, offset: int) -> bool:
        return self._store.get(offset) is not None

    def delete_key(self, offset: int, key: str) -> bool:
        cur = self._read(offset)
        if cur is None:
            return False
        ok = json_path.delete_path(cur, key)
        if ok:
            self._write(offset, cur)
        return ok

    def clear(self, offset: int) -> None:
        self._store.delete(offset)

    def iter_items(self):
        for off in range(self._store.capacity()):
            p = self._read(off)
            if p is not None:
                yield off, p

    def flush(self) -> None:
        self._store.flush()

    # -- persistence: the store IS the on-disk representation ----------------

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        self._store.flush()
        target = os.path.join(path, "payload_grid")
        if os.path.abspath(target) != os.path.abspath(self.directory):
            import shutil

            os.makedirs(target, exist_ok=True)
            for fname in ("gridstore.bin", "gridstore.tracker"):
                srcf = os.path.join(self.directory, fname)
                if os.path.exists(srcf):
                    shutil.copy2(srcf, os.path.join(target, fname))

    @classmethod
    def load(cls, path: str) -> "GridPayloadStorage":
        return cls(os.path.join(path, "payload_grid"))

    @classmethod
    def from_memory(cls, directory: str, mem: PayloadStorage) -> "GridPayloadStorage":
        out = cls(directory)
        for off, p in mem.iter_items():
            out._write(off, p)
        out.flush()
        return out
