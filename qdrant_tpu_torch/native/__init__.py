"""Native (C++) runtime components, loaded via ctypes.

Built on demand with g++ into a shared object cached next to the sources.
Every native component has a pure-Python fallback (the engine works without
a toolchain); formats are binary-identical so the two interoperate on the
same files.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LOAD_FAILED = False


def _build(so_path: str) -> bool:
    srcs = [os.path.join(_HERE, "wal.cpp"), os.path.join(_HERE, "gridstore.cpp")]
    cmd = [
        "g++",
        "-O2",
        "-shared",
        "-fPIC",
        "-std=c++17",
        *srcs,
        "-o",
        so_path,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library; None if unavailable."""
    global _LIB, _LOAD_FAILED
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _LOAD_FAILED:
            return None
        so_path = os.path.join(_HERE, "_qdrant_native.so")
        srcs = [os.path.join(_HERE, "wal.cpp"), os.path.join(_HERE, "gridstore.cpp")]
        if not os.path.exists(so_path) or any(
            os.path.exists(s) and os.path.getmtime(s) > os.path.getmtime(so_path)
            for s in srcs
        ):
            if not _build(so_path):
                _LOAD_FAILED = True
                return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError:
            _LOAD_FAILED = True
            return None
        # WAL API
        lib.wal_open.restype = ctypes.c_void_p
        lib.wal_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.wal_next_op.restype = ctypes.c_uint64
        lib.wal_next_op.argtypes = [ctypes.c_void_p]
        lib.wal_append.restype = ctypes.c_uint64
        lib.wal_append.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.wal_sync.argtypes = [ctypes.c_void_p]
        lib.wal_ack.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.wal_close.argtypes = [ctypes.c_void_p]
        lib.wal_read_from.restype = ctypes.c_void_p
        lib.wal_read_from.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.wal_cursor_next.restype = ctypes.c_int64
        lib.wal_cursor_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.wal_cursor_payload.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.wal_cursor_payload.argtypes = [ctypes.c_void_p]
        lib.wal_cursor_close.argtypes = [ctypes.c_void_p]
        # Gridstore (page-based payload blob storage) API
        lib.gs_open.restype = ctypes.c_void_p
        lib.gs_open.argtypes = [ctypes.c_char_p]
        lib.gs_put.restype = ctypes.c_int
        lib.gs_put.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_char_p,
            ctypes.c_uint32,
        ]
        lib.gs_get_len.restype = ctypes.c_int64
        lib.gs_get_len.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.gs_get.restype = ctypes.c_int
        lib.gs_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_uint32,
        ]
        lib.gs_delete.restype = ctypes.c_int
        lib.gs_delete.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.gs_count.restype = ctypes.c_uint64
        lib.gs_count.argtypes = [ctypes.c_void_p]
        lib.gs_capacity.restype = ctypes.c_uint64
        lib.gs_capacity.argtypes = [ctypes.c_void_p]
        lib.gs_flush.restype = ctypes.c_int
        lib.gs_flush.argtypes = [ctypes.c_void_p]
        lib.gs_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


class GridStore:
    """ctypes wrapper over the native page-based blob store
    (reference: lib/blobstore Gridstore)."""

    def __init__(self, directory: str):
        lib = load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        os.makedirs(directory, exist_ok=True)
        self._h = lib.gs_open(directory.encode())
        if not self._h:
            raise RuntimeError(f"gridstore open failed: {directory}")

    def put(self, offset: int, data: bytes) -> None:
        if self._lib.gs_put(self._h, offset, data, len(data)) != 0:
            raise RuntimeError("gridstore put failed")

    def get(self, offset: int) -> Optional[bytes]:
        n = self._lib.gs_get_len(self._h, offset)
        if n < 0:
            return None
        buf = (ctypes.c_uint8 * n)()
        got = self._lib.gs_get(self._h, offset, buf, n)
        if got < 0:
            raise RuntimeError("gridstore get failed")
        return bytes(buf[:got])

    def delete(self, offset: int) -> None:
        self._lib.gs_delete(self._h, offset)

    def count(self) -> int:
        return int(self._lib.gs_count(self._h))

    def capacity(self) -> int:
        return int(self._lib.gs_capacity(self._h))

    def flush(self) -> None:
        if self._lib.gs_flush(self._h) != 0:
            raise RuntimeError("gridstore flush failed")

    def close(self) -> None:
        if self._h:
            self._lib.gs_close(self._h)
            self._h = None
