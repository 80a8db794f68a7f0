"""Spans and counters inside the port, on the host's monotonic clock.

`span(name, **attrs)` times a phase, a batch or a call; `count(name, n)`
adds to a counter. Both are always on and cheap: a span reads the monotonic
clock and the thread's CPU clock at its start and at its end, and updates
one aggregate under a lock. Spans sit at phase, batch or call granularity;
per-point quantities are counters.

Aggregates are kept per span *path*: the names of the enclosing spans on the
same thread and the span's own, joined by "/" (for example
`shard.bulk_ingest/shard.flush`). Each path keeps its count, wall seconds,
self seconds (wall less the part its child spans cover) and thread-CPU
seconds (`time.thread_time`). Wall minus CPU is the time the thread waited:
for the interpreter lock, the device or the disk.

The timeline is off by default. Between `timeline_start()` and
`timeline_stop()` every span that ends is also kept as a record
`(t0, t1, info, thread_id)` under its name, the shape of the benchmark's
own span records (`portbench/trace.py`), whose device trace is tied to
`time.monotonic()`. `info` holds the span's path, parent path, CPU and self
seconds, its attributes and, while a coalesced batch is served on the
thread, the batch's id (`serving_batch`). The timeline keeps at most
`max_records` records and counts the rest as dropped.

Operators read the aggregates and counters through `GET /telemetry`
(utils/telemetry.py, detail level 1 or higher).
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Dict, List, Optional

TIMELINE_RECORDS = 200_000


class Tracer:
    """One registry of aggregates, counters and the timeline. The port uses
    the process-wide `TRACER` through the module functions below."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._aggregates: Dict[str, List[float]] = {}  # path → [n, wall, self, cpu]
        self._counters: Dict[str, int] = {}
        self._batch_ids = itertools.count(1)
        self._timeline: Optional[Dict[str, List[tuple]]] = None  # while it runs
        self._kept: Optional[Dict[str, List[tuple]]] = None  # the last one's
        self._timeline_users = 0
        self._timeline_room = 0
        self._dropped = 0

    # -- spans ---------------------------------------------------------------

    def span(self, name: str, **attrs) -> "_Span":
        return _Span(self, name, attrs)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _finish(self, name: str, path: str, parent: Optional[str], t0: float,
                t1: float, cpu: float, self_s: float, attrs: dict,
                thread: int, batch: Optional[int]) -> None:
        with self._lock:
            agg = self._aggregates.get(path)
            if agg is None:
                agg = self._aggregates[path] = [0, 0.0, 0.0, 0.0]
            agg[0] += 1
            agg[1] += t1 - t0
            agg[2] += self_s
            agg[3] += cpu
            if self._timeline is None:
                return
            if self._timeline_room <= 0:
                self._dropped += 1
                return
            self._timeline_room -= 1
            info = {"path": path, "parent": parent, "cpu": cpu, "self": self_s, **attrs}
            if batch is not None:
                info["batch"] = batch
            self._timeline.setdefault(name, []).append((t0, t1, info, thread))

    def record(self, name: str, t0: float, t1: float, thread: Optional[int] = None,
               **attrs) -> None:
        """A root span whose ends the caller measured on `time.monotonic()`,
        on `thread` (default: this one). It has no CPU reading: it stands for
        a wait, such as a queued request's, that no code ran through."""
        self._finish(name, name, None, t0, t1, 0.0, t1 - t0, attrs,
                     threading.get_ident() if thread is None else thread,
                     getattr(self._local, "batch", None))

    # -- the coalesced batch being served ------------------------------------

    def serving_batch(self) -> "_Batch":
        """Context manager: a new batch id, carried by every span that this
        thread ends inside it → the id."""
        return _Batch(self, next(self._batch_ids))

    # -- counters ------------------------------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    # -- reading -------------------------------------------------------------

    def aggregates(self) -> Dict[str, Dict[str, float]]:
        """{path: {count, wall_s, self_s, cpu_s}}."""
        with self._lock:
            return {path: {"count": int(n), "wall_s": wall, "self_s": self_s, "cpu_s": cpu}
                    for path, (n, wall, self_s, cpu) in self._aggregates.items()}

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def total(self, suffix: str, field: str = "wall_s") -> Optional[float]:
        """`field` summed over the paths that are `suffix` or end in
        "/" + `suffix` → None where no such path has ended yet."""
        found = [agg[field] for path, agg in self.aggregates().items()
                 if path == suffix or path.endswith("/" + suffix)]
        return sum(found) if found else None

    # -- the timeline --------------------------------------------------------

    def timeline_start(self, max_records: int = TIMELINE_RECORDS) -> None:
        """Start keeping records. Starts nest: the timeline runs until as
        many `timeline_stop` calls; the first start clears the old records."""
        with self._lock:
            if self._timeline_users == 0:
                self._timeline = {}
                self._timeline_room = int(max_records)
                self._dropped = 0
            self._timeline_users += 1

    def timeline_stop(self) -> None:
        """End one start; the records stay readable until the next start."""
        with self._lock:
            if self._timeline_users == 0:
                return
            self._timeline_users -= 1
            if self._timeline_users == 0:
                self._kept = self._timeline
                self._timeline = None

    def timeline(self) -> Dict[str, List[tuple]]:
        """The records of the running or the last timeline, by span name."""
        with self._lock:
            recs = self._timeline if self._timeline is not None else self._kept
            return {name: list(r) for name, r in (recs or {}).items()}

    def timeline_dropped(self) -> int:
        with self._lock:
            return self._dropped

    def reset(self) -> None:
        """Forget every aggregate, counter and record."""
        with self._lock:
            self._aggregates.clear()
            self._counters.clear()
            self._timeline = None
            self._kept = None
            self._timeline_users = 0
            self._dropped = 0


class _Span:
    __slots__ = ("tracer", "name", "attrs", "path", "parent", "child_s", "t0", "c0")

    def __init__(self, tracer: Tracer, name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        stack = self.tracer._stack()
        self.parent = stack[-1].path if stack else None
        self.path = self.name if self.parent is None else f"{self.parent}/{self.name}"
        self.child_s = 0.0
        stack.append(self)
        self.c0 = time.thread_time()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.monotonic()
        c1 = time.thread_time()
        tracer = self.tracer
        stack = tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        wall = t1 - self.t0
        if stack:
            stack[-1].child_s += wall
        tracer._finish(self.name, self.path, self.parent, self.t0, t1, c1 - self.c0,
                       wall - self.child_s, self.attrs, threading.get_ident(),
                       getattr(tracer._local, "batch", None))
        return False


class _Batch:
    __slots__ = ("tracer", "id", "outer")

    def __init__(self, tracer: Tracer, batch_id: int):
        self.tracer = tracer
        self.id = batch_id

    def __enter__(self) -> int:
        self.outer = getattr(self.tracer._local, "batch", None)
        self.tracer._local.batch = self.id
        return self.id

    def __exit__(self, *exc) -> bool:
        self.tracer._local.batch = self.outer
        return False


def traced(name: str):
    """Decorator: every call of the function is a span `name` of `TRACER`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with TRACER.span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


TRACER = Tracer()
span = TRACER.span
record = TRACER.record
serving_batch = TRACER.serving_batch
count = TRACER.count
aggregates = TRACER.aggregates
counters = TRACER.counters
total = TRACER.total
timeline_start = TRACER.timeline_start
timeline_stop = TRACER.timeline_stop
timeline = TRACER.timeline
timeline_dropped = TRACER.timeline_dropped
reset = TRACER.reset
