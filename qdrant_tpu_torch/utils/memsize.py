"""Byte-level memory accounting: host RAM vs device HBM vs disk memmap.

Reference behavior: qdrant sizes every index/storage for telemetry and
optimizer decisions (lib/segment VectorStorage::size_of, sparse posting
lists count their storage, `MemoryTelemetry` via jemalloc). Here one
recursive walker classifies the concrete buffer kinds this codebase uses:

* ``np.memmap``           → disk  (resident only through the page cache)
* ``np.ndarray``          → host
* ``jax.Array``           → device (HBM on TPU, RAM on the CPU backend)
* containers / objects exposing ``memory_usage_bytes()`` → recurse

The walker is deliberately explicit about types — a generic
``sys.getsizeof`` walk misattributes numpy views and counts interpreter
overhead, which is noise next to multi-GB tensors.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _empty() -> Dict[str, int]:
    return {"host_bytes": 0, "device_bytes": 0, "disk_bytes": 0}


def _add(acc: Dict[str, int], other: Dict[str, int]) -> Dict[str, int]:
    for k in acc:
        acc[k] += int(other.get(k, 0))
    return acc


def sizeof(obj: Any) -> Dict[str, int]:
    """→ {host_bytes, device_bytes, disk_bytes} for `obj` (recursive)."""
    acc = _empty()
    if obj is None:
        return acc
    if isinstance(obj, np.memmap):
        acc["disk_bytes"] = int(obj.nbytes)
        return acc
    if isinstance(obj, np.ndarray):
        # a view shares its base's buffer; charge the base once at the
        # owner — charging views double-counts multi-GB blocks
        if obj.base is None:
            acc["host_bytes"] = int(obj.nbytes)
        return acc
    # jax arrays: avoid importing jax at module scope (CPU-only paths)
    tname = type(obj).__module__
    if tname.startswith("jax") or type(obj).__name__ == "ArrayImpl":
        try:
            acc["device_bytes"] = int(obj.size * obj.dtype.itemsize)
        except Exception:
            pass
        return acc
    if isinstance(obj, dict):
        for v in obj.values():
            _add(acc, sizeof(v))
        return acc
    if isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            _add(acc, sizeof(v))
        return acc
    if hasattr(obj, "memory_usage_bytes"):
        try:
            return _add(acc, obj.memory_usage_bytes())
        except Exception:
            return acc
    return acc


def sizeof_shallow(obj: Any) -> Dict[str, int]:
    """Walk ``obj.__dict__`` for array buffers one object deep: ndarray /
    jax arrays directly, plus containers OF arrays. Arbitrary nested
    objects are NOT followed (cycle-safe — index objects back-reference
    their stores). Intended for index structures whose buffers live in
    heterogeneous dicts (payload field indexes)."""
    acc = _empty()
    d = getattr(obj, "__dict__", None)
    if not isinstance(d, dict):
        return acc

    def walk(v, depth=0):
        if isinstance(v, np.ndarray) or (
            type(v).__module__.startswith("jax")
            or type(v).__name__ == "ArrayImpl"
        ):
            _add(acc, sizeof(v))
        elif isinstance(v, (int, float, bool)):
            # postings live in dicts of sets of Python ints (MapIndex);
            # ~28 B per boxed int + ~30 B hash-slot overhead is the real
            # cost that a numbers-only walker would otherwise report as 0
            acc["host_bytes"] += 58
        elif isinstance(v, str):
            acc["host_bytes"] += 49 + len(v)
        elif isinstance(v, dict) and depth < 4:
            for k, x in v.items():
                walk(k, depth + 1)
                walk(x, depth + 1)
        elif isinstance(v, (list, tuple, set, frozenset)) and depth < 4:
            for x in v:
                walk(x, depth + 1)

    for v in d.values():
        walk(v)
    return acc


def sizeof_attrs(obj: Any, *attrs: str) -> Dict[str, int]:
    """Sum sizeof() over the named attributes (missing attrs are 0)."""
    acc = _empty()
    for a in attrs:
        _add(acc, sizeof(getattr(obj, a, None)))
    return acc


def merge(*parts: Dict[str, int]) -> Dict[str, int]:
    acc = _empty()
    for p in parts:
        _add(acc, p)
    return acc


def total(d: Dict[str, int]) -> int:
    return sum(int(v) for v in d.values())
