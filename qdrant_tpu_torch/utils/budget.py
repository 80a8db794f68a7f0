"""Optimizer/serving resource budget.

Reference: lib/common/common/src/budget.rs (ResourceBudget CPU/IO permits
gating optimizer runs, wired in src/main.rs:509-511). On TPU the contended
resource is not a thread pool but the single device command queue: a 1M-
point HNSW build issues a long train of jitted programs, and any search
dispatched behind them waits. The budget therefore has two parts:

* a build-permit semaphore (default 1) so at most N optimizers touch the
  device at once (`acquire_build`), and
* a cooperative yield point between build batches: when searches are
  in flight (or recently arrived), the builder sleeps a configurable slice
  so the queued search programs run first. Build batches are ~10-40 ms of
  device time each, which bounds search p99 at roughly one batch plus the
  throttle window instead of the whole multi-second build.

Knobs: `QDRANT_TPU_BUILD_PERMITS` (concurrent builds),
`QDRANT_TPU_BUILD_THROTTLE_MS` (sleep per yield while searches wait; 0
disables yielding entirely).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager


class ResourceBudget:
    def __init__(self, build_permits: int | None = None):
        if build_permits is None:
            build_permits = int(os.environ.get("QDRANT_TPU_BUILD_PERMITS", 1))
        self._build_sem = threading.BoundedSemaphore(max(build_permits, 1))
        self._lock = threading.Lock()
        self._searches_inflight = 0
        self._last_search = 0.0
        # telemetry: how long builds spent yielding to searches
        self.yielded_s = 0.0

    # -- search side ---------------------------------------------------

    @contextmanager
    def search(self):
        """Wrap a device search dispatch; builders yield while any search
        is between enter and exit (plus a short recency window)."""
        with self._lock:
            self._searches_inflight += 1
        try:
            yield
        finally:
            with self._lock:
                self._searches_inflight -= 1
                self._last_search = time.monotonic()

    @property
    def searches_inflight(self) -> int:
        return self._searches_inflight

    def search_pressure(self, window_s: float = 0.5) -> bool:
        """True when a search is in flight or finished within `window_s`.
        Builders use this to switch into cooperative mode (small batches +
        per-batch sync) so a concurrent search never waits behind more
        than ~one small batch of queued device work."""
        with self._lock:
            if self._searches_inflight > 0:
                return True
            return (time.monotonic() - self._last_search) < window_s

    # -- build side ----------------------------------------------------

    @contextmanager
    def acquire_build(self):
        """Permit-gated optimizer/index-build section (reference:
        budget.rs acquire)."""
        self._build_sem.acquire()
        try:
            yield
        finally:
            self._build_sem.release()

    def yield_to_searches(self) -> float:
        """Called between build batches. Sleeps while searches are in
        flight (bounded), giving their queued device programs priority.
        Returns the seconds yielded."""
        throttle_ms = float(os.environ.get("QDRANT_TPU_BUILD_THROTTLE_MS", 5))
        if throttle_ms <= 0:
            return 0.0
        # also yield briefly if a search finished within the last slice —
        # an interactive client is likely to send the next one
        recency_s = throttle_ms / 1000.0
        start = time.monotonic()
        deadline = start + 50 * recency_s  # hard cap per yield point
        yielded = 0.0
        while time.monotonic() < deadline:
            with self._lock:
                active = self._searches_inflight > 0
                recent = (time.monotonic() - self._last_search) < recency_s
            if not active and not recent:
                break
            time.sleep(recency_s)
            yielded = time.monotonic() - start
        if yielded:
            with self._lock:
                self.yielded_s += yielded
        return yielded


BUDGET = ResourceBudget()
