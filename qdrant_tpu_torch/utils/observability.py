"""Slow-request profiling + audit logging.

Reference: lib/collection/src/profiling/slow_requests_log.rs (per-request
bounded priority queues of the slowest requests, content-hash dedup keeping
the longer duplicate, approximate repeat counters) and
lib/storage/src/audit.rs (structured JSONL audit events with daily file
rotation and a bounded file count).
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import heapq
import itertools
import json
import os
import threading
from typing import Any, Dict, List, Optional


class SlowRequestsLog:
    """Keeps the `max_entries` slowest requests per request name.

    Entries with identical content hashes dedup to the slower occurrence and
    carry an approximate repeat count (a plain counter dict here — the
    reference's count-min sketch guards unbounded cardinality; our hash
    space is bounded by the queue size x names, so exact counts are fine).
    """

    def __init__(self, max_entries: int = 16, threshold_s: float = 1.0):
        self.max_entries = max_entries
        self.threshold_s = threshold_s
        self._lock = threading.Lock()
        self._tie = itertools.count()
        # name → heap of (duration, tie, entry-dict)
        self._queues: Dict[str, list] = {}
        self._counts: Dict[int, int] = {}

    @staticmethod
    def _content_hash(collection: str, body: Any) -> int:
        try:
            blob = json.dumps(body, sort_keys=True, default=str)
        except Exception:
            blob = repr(body)
        h = hashlib.blake2b(
            f"{collection}:{blob}".encode(), digest_size=8
        ).digest()
        return int.from_bytes(h, "little")

    def observe(
        self,
        request_name: str,
        collection: str,
        duration_s: float,
        body: Any,
    ) -> None:
        if duration_s < self.threshold_s:
            return
        chash = self._content_hash(collection, body)
        with self._lock:
            self._counts[chash] = self._counts.get(chash, 0) + 1
            q = self._queues.setdefault(request_name, [])
            for i, (dur, tie, e) in enumerate(q):
                if e["content_hash"] == chash:
                    if dur >= duration_s:
                        e["approx_count"] = self._counts[chash]
                        return
                    q.pop(i)
                    heapq.heapify(q)
                    break
            entry = {
                "collection_name": collection,
                "duration": round(duration_s, 4),
                "datetime": _dt.datetime.now(_dt.timezone.utc).isoformat(),
                "request_name": request_name,
                "approx_count": self._counts[chash],
                "request_body": body,
                "content_hash": chash,
            }
            heapq.heappush(q, (duration_s, next(self._tie), entry))
            while len(q) > self.max_entries:
                heapq.heappop(q)

    def entries(self) -> List[dict]:
        with self._lock:
            out = []
            for q in self._queues.values():
                for _dur, _tie, e in q:
                    e = dict(e)
                    e.pop("content_hash", None)
                    out.append(e)
        out.sort(key=lambda e: -e["duration"])
        return out

    def clear(self) -> None:
        with self._lock:
            self._queues.clear()
            self._counts.clear()


class AuditLog:
    """Structured JSONL audit trail with daily rotation.

    Every entry mirrors the reference's AuditEvent fields (audit.rs:110):
    timestamp, method (internal op name), api (HTTP path), auth_type,
    subject (JWT sub), remote, collection, result (ok|denied), error.
    """

    def __init__(
        self,
        directory: str,
        enabled: bool = True,
        max_log_files: int = 7,
    ):
        self.dir = directory
        self.enabled = enabled
        self.max_log_files = max(1, max_log_files)
        self._lock = threading.Lock()
        self._current_day: Optional[str] = None
        self._fh = None

    def _rotate(self) -> None:
        day = _dt.datetime.now(_dt.timezone.utc).strftime("%Y-%m-%d")
        if day == self._current_day and self._fh is not None:
            return
        os.makedirs(self.dir, exist_ok=True)
        if self._fh is not None:
            self._fh.close()
        self._fh = open(os.path.join(self.dir, f"audit-{day}.log"), "a")
        self._current_day = day
        logs = sorted(
            f for f in os.listdir(self.dir)
            if f.startswith("audit-") and f.endswith(".log")
        )
        for stale in logs[: -self.max_log_files]:
            try:
                os.unlink(os.path.join(self.dir, stale))
            except OSError:
                pass

    def record(
        self,
        api: str,
        result: str,
        method: Optional[str] = None,
        auth_type: str = "none",
        subject: Optional[str] = None,
        remote: Optional[str] = None,
        collection: Optional[str] = None,
        error: Optional[str] = None,
    ) -> None:
        if not self.enabled:
            return
        event = {
            "timestamp": _dt.datetime.now(_dt.timezone.utc).isoformat(),
            "api": api,
            "result": result,
            "auth_type": auth_type,
        }
        if method:
            event["method"] = method
        if subject:
            event["subject"] = subject
        if remote:
            event["remote"] = remote
        if collection:
            event["collection"] = collection
        if error:
            event["error"] = error
        line = json.dumps(event)
        with self._lock:
            self._rotate()
            self._fh.write(line + "\n")
            self._fh.flush()

    def read(self, limit: int = 100) -> List[dict]:
        """Newest-first entries across rotated files."""
        out: List[dict] = []
        if not os.path.isdir(self.dir):
            return out
        for fname in sorted(os.listdir(self.dir), reverse=True):
            if not (fname.startswith("audit-") and fname.endswith(".log")):
                continue
            try:
                with open(os.path.join(self.dir, fname)) as f:
                    lines = f.readlines()
            except OSError:
                continue
            for line in reversed(lines):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
                if len(out) >= limit:
                    return out
        return out
