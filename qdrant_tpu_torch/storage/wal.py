"""Write-ahead log: segmented, length-prefixed msgpack records with CRC.

Reference: lib/wal/ (segmented mmap WAL) + lib/shard/src/wal.rs (SerdeWal of
CBOR operations). Each record: [u32 len][u32 crc32][msgpack bytes]. Segments
roll over at `segment_capacity` bytes; acked prefixes are dropped whole-
segment, mirroring the reference's first_index/truncation semantics.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Iterator, List, Tuple

import msgpack

_HEADER = struct.Struct("<II")


class Wal:
    def __init__(self, path: str, segment_capacity: int = 32 * 1024 * 1024):
        self.path = path
        self.segment_capacity = segment_capacity
        os.makedirs(path, exist_ok=True)
        self._segments: List[Tuple[int, str]] = []  # (first_op_num, filename)
        self._next_op = 1
        self._open_file = None
        self._open_size = 0
        self._recover()

    # -- recovery -----------------------------------------------------------

    def _recover(self) -> None:
        files = sorted(
            f for f in os.listdir(self.path) if f.startswith("wal_") and f.endswith(".log")
        )
        for fname in files:
            first = int(fname[4:-4])
            self._segments.append((first, fname))
        last_op = 0
        if self._segments:
            first, fname = self._segments[-1]
            count, valid_size = self._scan(os.path.join(self.path, fname))
            last_op = first + count - 1
            # truncate torn tail writes
            full = os.path.join(self.path, fname)
            if valid_size < os.path.getsize(full):
                with open(full, "r+b") as f:
                    f.truncate(valid_size)
        self._next_op = last_op + 1

    def _scan(self, filepath: str) -> Tuple[int, int]:
        """→ (record_count, valid_byte_size) stopping at corruption."""
        count = 0
        pos = 0
        size = os.path.getsize(filepath)
        with open(filepath, "rb") as f:
            while pos + _HEADER.size <= size:
                header = f.read(_HEADER.size)
                if len(header) < _HEADER.size:
                    break
                ln, crc = _HEADER.unpack(header)
                payload = f.read(ln)
                if len(payload) < ln or zlib.crc32(payload) != crc:
                    break
                count += 1
                pos += _HEADER.size + ln
        return count, pos

    # -- append -------------------------------------------------------------

    @property
    def next_op_num(self) -> int:
        return self._next_op

    def append(self, operation: Any) -> int:
        """Append an operation; returns its op_num."""
        op_num = self._next_op
        payload = msgpack.packb(operation, use_bin_type=True)
        record = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        f = self._file_for_append(op_num)
        f.write(record)
        f.flush()
        self._open_size += len(record)
        self._next_op += 1
        return op_num

    def _file_for_append(self, op_num: int):
        if self._open_file is not None and self._open_size < self.segment_capacity:
            return self._open_file
        if self._open_file is not None:
            self._open_file.close()
        fname = f"wal_{op_num:016d}.log"
        self._segments.append((op_num, fname))
        self._open_file = open(os.path.join(self.path, fname), "ab")
        self._open_size = os.path.getsize(os.path.join(self.path, fname))
        return self._open_file

    def sync(self) -> None:
        if self._open_file is not None:
            self._open_file.flush()
            os.fsync(self._open_file.fileno())

    # -- read ---------------------------------------------------------------

    def read_from(self, from_op_num: int = 1) -> Iterator[Tuple[int, Any]]:
        """Iterate (op_num, operation) for all records ≥ from_op_num."""
        if self._open_file is not None:
            self._open_file.flush()
        for i, (first, fname) in enumerate(self._segments):
            next_first = (
                self._segments[i + 1][0] if i + 1 < len(self._segments) else self._next_op
            )
            if next_first <= from_op_num:
                continue
            op_num = first
            filepath = os.path.join(self.path, fname)
            with open(filepath, "rb") as f:
                while True:
                    header = f.read(_HEADER.size)
                    if len(header) < _HEADER.size:
                        break
                    ln, crc = _HEADER.unpack(header)
                    payload = f.read(ln)
                    if len(payload) < ln or zlib.crc32(payload) != crc:
                        break
                    if op_num >= from_op_num:
                        yield op_num, msgpack.unpackb(payload, raw=False, strict_map_key=False)
                    op_num += 1

    # -- truncation ---------------------------------------------------------

    def ack(self, op_num: int) -> None:
        """All ops ≤ op_num are persisted in segments; drop full WAL segments
        entirely below the ack point (reference: max_persisted_segment_version
        handling in segment_holder)."""
        keep: List[Tuple[int, str]] = []
        for i, (first, fname) in enumerate(self._segments):
            next_first = (
                self._segments[i + 1][0] if i + 1 < len(self._segments) else self._next_op
            )
            if next_first - 1 <= op_num and i + 1 < len(self._segments):
                try:
                    os.remove(os.path.join(self.path, fname))
                except OSError:
                    pass
            else:
                keep.append((first, fname))
        self._segments = keep

    def pop_last(self):
        """Drop the LAST record — the repair for a poisoned tail operation
        (reference: src/wal_pop.rs truncates the consensus WAL's last
        index). → the popped op_num, or None when the WAL is empty."""
        self.close()
        while self._segments:
            first, fname = self._segments[-1]
            full = os.path.join(self.path, fname)
            count, _valid = self._scan(full)
            if count == 0:
                try:
                    os.remove(full)
                except OSError:
                    pass
                self._segments.pop()
                continue
            pos = 0
            with open(full, "rb") as f:
                for _ in range(count - 1):
                    ln, _crc = _HEADER.unpack(f.read(_HEADER.size))
                    f.seek(ln, 1)
                    pos += _HEADER.size + ln
            if pos == 0:
                os.remove(full)
                self._segments.pop()
            else:
                with open(full, "r+b") as f:
                    f.truncate(pos)
            popped = first + count - 1
            self._next_op = popped
            return popped
        self._next_op = 1
        return None

    def close(self) -> None:
        if self._open_file is not None:
            self._open_file.close()
            self._open_file = None


class NativeWal:
    """ctypes wrapper over the C++ WAL engine (native/wal.cpp) — same
    interface and on-disk format as `Wal`."""

    def __init__(self, path: str, segment_capacity: int = 32 * 1024 * 1024):
        from ..native import load

        self._lib = load()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._h = self._lib.wal_open(path.encode(), segment_capacity)
        if not self._h:
            raise RuntimeError("wal_open failed")

    @property
    def next_op_num(self) -> int:
        return int(self._lib.wal_next_op(self._h))

    def append(self, operation: Any) -> int:
        if not self._h:
            raise IOError("wal is closed")
        payload = msgpack.packb(operation, use_bin_type=True)
        op = int(self._lib.wal_append(self._h, payload, len(payload)))
        if op == 0:
            raise IOError("wal_append failed")
        return op

    def sync(self) -> None:
        if self._h:
            self._lib.wal_sync(self._h)

    def read_from(self, from_op_num: int = 1) -> Iterator[Tuple[int, Any]]:
        import ctypes

        cursor = self._lib.wal_read_from(self._h, from_op_num)
        try:
            op = ctypes.c_uint64()
            while True:
                ln = self._lib.wal_cursor_next(cursor, ctypes.byref(op))
                if ln < 0:
                    break
                buf = ctypes.string_at(self._lib.wal_cursor_payload(cursor), ln)
                yield int(op.value), msgpack.unpackb(
                    buf, raw=False, strict_map_key=False
                )
        finally:
            self._lib.wal_cursor_close(cursor)

    def ack(self, op_num: int) -> None:
        if not self._h:
            return  # closed handle: acking into freed native state segfaults
        self._lib.wal_ack(self._h, op_num)

    def close(self) -> None:
        if self._h:
            self._lib.wal_close(self._h)
            self._h = None


def open_wal(path: str, segment_capacity: int = 32 * 1024 * 1024):
    """WAL factory: native C++ engine when the toolchain is available,
    pure-Python otherwise (identical format — interchangeable on disk)."""
    if os.environ.get("QDRANT_TPU_NO_NATIVE") != "1":
        try:
            return NativeWal(path, segment_capacity)
        except (RuntimeError, OSError):
            pass
    return Wal(path, segment_capacity)
