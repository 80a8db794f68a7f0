"""Universal read tier: one ranged-read interface over local files, S3
objects, and remote peers' storage.

Reference behavior: `lib/common/common/src/universal_io` abstracts reads
over mmap/io_uring/disk-cache/object-store backends, and the `StorageRead`
gRPC service (`storage_read_service.proto:17-21`, client
`lib/uio-grpc-client`) lets one node read byte ranges of another node's
storage for disaggregated deployments. Here the same capability rides the
existing HTTP internal plane (`POST /internal/storage/read`) — a
deliberate divergence: this codebase's inter-peer transport is HTTP
throughout (cluster/remote.py), not tonic gRPC.

URI forms accepted by :class:`UniversalReader.read`:

* ``file://<path>`` or a bare path — local file relative to the storage
  root (escapes rejected), ranged via seek+read.
* ``s3://<key>`` — ranged GET against the configured S3 client.
* ``peer://<host:port>/<relpath>`` — ranged read of another peer's
  storage through its internal storage-read endpoint.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.request
from collections import OrderedDict
from typing import Optional, Tuple


class IoTierError(Exception):
    pass


class S3FifoCache:
    """S3-FIFO byte cache fronting cold (peer/S3) reads.

    Reference behavior: the disk caches front cold reads with an
    S3-FIFO-style cache (`lib/trififo`). Algorithm (Yang et al., SOSP'23):

    * a *small* FIFO (~10% of capacity) admits new keys — one-hit wonders
      wash straight through it without polluting the main cache,
    * on eviction from small, keys that were re-read (freq > 0) promote to
      the *main* FIFO; the rest leave only a key in the *ghost* FIFO,
    * a ghost hit on insert re-admits straight into main (the key proved
      it has reuse), and main evicts with a capped-frequency second-chance
      scan (freq capped at 3, decremented per lap).

    Thread-safe via one mutex — the read path it fronts is network-bound,
    so lock-free reads (the reference's seqlock) buy nothing here.
    """

    SMALL_FRACTION = 0.1
    FREQ_CAP = 3

    def __init__(self, capacity_bytes: int, ghost_entries: int = 4096):
        self.capacity = int(capacity_bytes)
        self.small_capacity = max(1, int(self.capacity * self.SMALL_FRACTION))
        self.ghost_capacity = ghost_entries
        self._small: "OrderedDict[Tuple, bytes]" = OrderedDict()
        self._main: "OrderedDict[Tuple, bytes]" = OrderedDict()
        self._ghost: "OrderedDict[Tuple, None]" = OrderedDict()
        self._freq: dict = {}
        self._small_bytes = 0
        self._main_bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._small) + len(self._main)

    @property
    def size_bytes(self) -> int:
        return self._small_bytes + self._main_bytes

    def get(self, key) -> Optional[bytes]:
        with self._lock:
            val = self._small.get(key)
            if val is None:
                val = self._main.get(key)
            if val is None:
                self.misses += 1
                return None
            self.hits += 1
            self._freq[key] = min(self._freq.get(key, 0) + 1, self.FREQ_CAP)
            return val

    def put(self, key, value: bytes) -> None:
        nbytes = len(value)
        if nbytes > self.capacity:
            return  # larger than the whole cache: never admit
        with self._lock:
            if key in self._small or key in self._main:
                return
            if key in self._ghost:
                del self._ghost[key]
                self._main[key] = value
                self._main_bytes += nbytes
            else:
                self._small[key] = value
                self._small_bytes += nbytes
            self._freq[key] = 0
            self._evict_locked()

    def _evict_locked(self) -> None:
        while self.size_bytes > self.capacity:
            if self._small_bytes > self.small_capacity or not self._main:
                self._evict_small_locked()
            else:
                self._evict_main_locked()

    def _evict_small_locked(self) -> None:
        key, val = self._small.popitem(last=False)
        self._small_bytes -= len(val)
        if self._freq.get(key, 0) > 0:
            # re-read while in small -> has reuse: promote to main
            self._main[key] = val
            self._main_bytes += len(val)
            self._freq[key] = 0
        else:
            self._freq.pop(key, None)
            self._ghost[key] = None
            while len(self._ghost) > self.ghost_capacity:
                self._ghost.popitem(last=False)

    def _evict_main_locked(self) -> None:
        # second-chance scan: decrement capped freq, reinsert until a
        # zero-freq head is found (bounded by queue length per eviction)
        for _ in range(len(self._main)):
            key, val = self._main.popitem(last=False)
            freq = self._freq.get(key, 0)
            if freq > 0:
                self._freq[key] = freq - 1
                self._main[key] = val  # reinsert at tail
            else:
                self._main_bytes -= len(val)
                self._freq.pop(key, None)
                return
        # every entry had freq > 0 — drop the (now zero-freq) head
        if self._main:
            key, val = self._main.popitem(last=False)
            self._main_bytes -= len(val)
            self._freq.pop(key, None)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self),
                "bytes": self.size_bytes,
                "capacity_bytes": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "ghost_entries": len(self._ghost),
            }


def resolve_in_root(root: str, rel: str) -> str:
    """Absolute path of `rel` inside `root`; raises on escape attempts."""
    base = os.path.realpath(root)
    full = os.path.realpath(os.path.join(base, rel.lstrip("/")))
    if not (full == base or full.startswith(base + os.sep)):
        raise IoTierError(f"path escapes storage root: {rel!r}")
    return full


def read_local(root: str, rel: str, offset: int = 0, length: int = -1) -> bytes:
    full = resolve_in_root(root, rel)
    if not os.path.isfile(full):
        raise IoTierError(f"no such file: {rel!r}")
    with open(full, "rb") as f:
        if offset:
            f.seek(offset)
        return f.read(None if length < 0 else length)


def read_peer(
    peer_url: str,
    rel: str,
    offset: int = 0,
    length: int = -1,
    api_key: Optional[str] = None,
    timeout: float = 30.0,
) -> bytes:
    """Ranged read of another peer's storage file over the internal plane."""
    body = json.dumps({"path": rel, "offset": offset, "length": length}).encode()
    req = urllib.request.Request(
        peer_url.rstrip("/") + "/internal/storage/read",
        data=body,
        method="POST",
        headers={"Content-Type": "application/json"},
    )
    if api_key:
        req.add_header("api-key", api_key)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        raise IoTierError(
            f"peer storage read {rel!r} failed: {e.code} "
            f"{e.read().decode(errors='replace')[:200]}"
        )
    except OSError as e:
        raise IoTierError(f"peer {peer_url} unreachable: {e}")


class UniversalReader:
    """Scheme-dispatching ranged reader (see module docstring)."""

    def __init__(
        self,
        storage_root: str,
        s3_client=None,
        api_key: Optional[str] = None,
        cache_bytes: int = 0,
    ):
        self.storage_root = storage_root
        self.s3_client = s3_client
        self.api_key = api_key
        # cold reads (peer/S3) are fronted by an S3-FIFO cache when sized;
        # local files stay uncached (they are cheap and may be mutated)
        self.cache = S3FifoCache(cache_bytes) if cache_bytes > 0 else None

    def read(self, uri: str, offset: int = 0, length: int = -1) -> bytes:
        remote = uri.startswith("s3://") or uri.startswith("peer://")
        if remote and self.cache is not None:
            key = (uri, offset, length)
            cached = self.cache.get(key)
            if cached is not None:
                return cached
        data = self._read_uncached(uri, offset, length)
        if remote and self.cache is not None:
            self.cache.put((uri, offset, length), data)
        return data

    def _read_uncached(self, uri: str, offset: int, length: int) -> bytes:
        if uri.startswith("s3://"):
            if self.s3_client is None:
                raise IoTierError("no S3 client configured")
            return self.s3_client.get_object_range(uri[5:], offset, length)
        if uri.startswith("peer://"):
            rest = uri[7:]
            host, _, rel = rest.partition("/")
            scheme = "https" if host.endswith(":443") else "http"
            return read_peer(
                f"{scheme}://{host}", rel, offset, length, self.api_key
            )
        if uri.startswith("file://"):
            uri = uri[7:]
        return read_local(self.storage_root, uri, offset, length)
