"""Service-debug tooling: stall watchdog + data-consistency check.

Reference: the `service_debug` deadlock checker thread
(/root/reference/src/main.rs:331-366, parking_lot::deadlock every 10 s)
and the `data-consistency-check` feature (local_shard read-back verify).

Python can't introspect lock wait-graphs the way parking_lot does, so the
TPU-repo rendering is a STALL watchdog: long-lived sections register with
the watchdog (shard optimizer cycles, consensus appliers); if a section
stays open past its threshold the watchdog logs every thread's stack once
per period — the actionable equivalent of a deadlock backtrace dump. It is
config-gated via the /debugger endpoint or QDRANT__SERVICE__SERVICE_DEBUG.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class StallWatchdog:
    DEFAULT_PERIOD_S = 10.0
    DEFAULT_THRESHOLD_S = 60.0

    def __init__(self):
        self._lock = threading.Lock()
        self._sections: Dict[int, tuple] = {}  # token → (name, started, tid)
        self._next_token = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.enabled = False
        self.period_s = self.DEFAULT_PERIOD_S
        self.threshold_s = self.DEFAULT_THRESHOLD_S
        self.stalls_detected = 0

    @contextmanager
    def section(self, name: str):
        """Mark a long-lived critical section; the watchdog flags it if it
        stays open past the threshold."""
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._sections[token] = (name, time.monotonic(), threading.get_ident())
        try:
            yield
        finally:
            with self._lock:
                self._sections.pop(token, None)

    def _dump_stacks(self, stalled) -> str:
        lines = [f"{len(stalled)} stalled section(s) detected"]
        for name, started, tid in stalled:
            lines.append(
                f"  section {name!r} held {time.monotonic() - started:.0f}s by thread {tid}"
            )
        frames = sys._current_frames()
        for tid, frame in frames.items():
            lines.append(f"Thread {tid}:")
            lines.extend(
                "  " + l for l in traceback.format_stack(frame) for l in l.splitlines()
            )
        return "\n".join(lines)

    def check_once(self) -> int:
        """→ number of stalled sections (logs stacks if any)."""
        now = time.monotonic()
        with self._lock:
            stalled = [
                s for s in self._sections.values() if now - s[1] > self.threshold_s
            ]
        if stalled:
            self.stalls_detected += len(stalled)
            logger.error("%s", self._dump_stacks(stalled))
        return len(stalled)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            if self.enabled:
                try:
                    self.check_once()
                except Exception:  # watchdog must never die
                    logger.exception("stall watchdog error")

    def configure(self, patch: Dict[str, Any]) -> Dict[str, Any]:
        if "enabled" in patch:
            self.enabled = bool(patch["enabled"])
            if self.enabled and self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="stall-watchdog"
                )
                self._thread.start()
        if patch.get("period_s"):
            self.period_s = float(patch["period_s"])
        if patch.get("threshold_s"):
            self.threshold_s = float(patch["threshold_s"])
        return self.config()

    def config(self) -> Dict[str, Any]:
        with self._lock:
            open_sections = [
                {"name": n, "held_s": round(time.monotonic() - s, 1)}
                for n, s, _ in self._sections.values()
            ]
        return {
            "enabled": self.enabled,
            "period_s": self.period_s,
            "threshold_s": self.threshold_s,
            "stalls_detected": self.stalls_detected,
            "open_sections": open_sections,
        }


WATCHDOG = StallWatchdog()


def check_segment_consistency(segment) -> list:
    """Read-back data-consistency check for one segment (reference: the
    `data-consistency-check` cargo feature). → list of problem strings."""
    problems = []
    tracker = segment.id_tracker
    for external in tracker.external_ids():
        internal = tracker.internal_id(external)
        if internal is None:
            problems.append(f"{external}: tracked but no internal offset")
            continue
        back = tracker.external_id(internal)
        if back != external:
            problems.append(
                f"{external}: id mapping asymmetric (offset {internal} → {back})"
            )
        has_vec = False
        for name, store in segment.dense.items():
            vec = store.get(internal)
            if vec is not None:
                has_vec = True
                if not bool((vec == vec).all()):
                    problems.append(f"{external}: NaN in dense vector {name!r}")
        for store in segment.multi.values():
            if store.get(internal) is not None:
                has_vec = True
        for store in segment.sparse.values():
            if not store.is_deleted(internal):
                has_vec = True
        # deferred holds INTERNAL offsets (and external may be a UUID str)
        if not has_vec and internal not in getattr(segment, "deferred", ()):
            problems.append(f"{external}: tracked but no vector in any store")
    return problems


def check_shard_consistency(shard) -> Dict[str, Any]:
    problems = []
    for i, seg in enumerate(shard.segments):
        for p in check_segment_consistency(seg):
            problems.append(f"segment[{i}] {p}")
    return {
        "consistent": not problems,
        "checked_points": shard.point_count(),
        "problems": problems[:100],
    }
