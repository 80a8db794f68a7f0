"""Spans around the port's calls, and the device trace of a sub-window.

Only a traced run (`--trace 1`) uses this. A metric reader declares the
spans it needs as `SPANS = {span: ["module:Class.method", ...]}` (and may
give `DESCRIBE = {span: fn}`, called with the wrapped call's arguments to
record what the call was asked to do). Each wrapper records (start, end,
description, thread id) on the host clock. A target that no longer exists
is skipped: the metric that reads it then finds nothing and is left out of
the result.

`profile_window` traces CUDA activity only (kernels, copies, memsets and the
CUDA runtime calls that launched them; no host op is recorded, so the host
runs at its own pace) between two marker kernels that the main thread
launches at known host times on an idle device. The markers map the trace's
clock onto the host's, so every device op is matched, through the time of
the runtime call that launched it, to the deepest span then open, and every
idle gap of the device is named by the deepest span open in its middle.
"""

from __future__ import annotations

import functools
import importlib
import inspect
import json
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
NAME_CHARS = 120  # device op names are long template instantiations


def _resolve(target: str):
    """'pkg.module:Class.attr' → (owner object, attribute name), or None."""
    mod_name, _, path = target.partition(":")
    try:
        owner = importlib.import_module(mod_name)
    except ImportError:
        return None
    *parents, attr = path.split(".")
    for p in parents:
        owner = getattr(owner, p, None)
        if owner is None:
            return None
    if not hasattr(owner, attr):
        return None
    return owner, attr


class Spans:
    def __init__(self):
        self.records: Dict[str, List[tuple]] = defaultdict(list)
        self._undo: List[tuple] = []

    def install(self, readers) -> None:
        done = set()
        for mod in readers:
            describe = getattr(mod, "DESCRIBE", {})
            for span, targets in getattr(mod, "SPANS", {}).items():
                for target in targets:
                    if (span, target) in done:
                        continue
                    done.add((span, target))
                    found = _resolve(target)
                    if found is not None:
                        self._wrap(*found, span, describe.get(span))

    def _wrap(self, owner, attr: str, span: str, describe: Optional[Callable]) -> None:
        static = inspect.getattr_static(owner, attr)
        orig = getattr(owner, attr)
        sink = self.records[span]

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            info = describe(*args, **kwargs) if describe is not None else None
            t0 = time.monotonic()
            try:
                return orig(*args, **kwargs)
            finally:
                sink.append((t0, time.monotonic(), info, threading.get_ident()))

        new = staticmethod(wrapper) if isinstance(static, staticmethod) else wrapper
        setattr(owner, attr, new)
        self._undo.append((owner, attr, static))

    def remove(self) -> None:
        for owner, attr, static in reversed(self._undo):
            setattr(owner, attr, static)
        self._undo.clear()


def _marker() -> float:
    """Wait for the device, then launch one marker kernel (a spin of 100
    cycles), which therefore runs as soon as it is launched → the host time
    just before its launch."""
    import torch

    torch.cuda.synchronize()
    t = time.monotonic()
    torch.cuda._sleep(100)
    return t


def profile_window(length: float, settle: float, drain: float, hold, work_dir: str,
                   snapshot: Callable[[], object], spans: Dict[str, List[tuple]]):
    """Trace CUDA activity over `length` seconds of serving. The caller has
    set `hold` (the clients send nothing) and let the server drain: the
    profiler starts and stops only while the server is quiet, since a busy
    interpreter can stall it for minutes. Inside: release the clients, let
    the load settle, take a snapshot, launch a marker kernel, serve for
    `length` seconds, launch a second marker, take a snapshot, hold the
    clients again and let the server drain → (summary with `spans` matched,
    (first snapshot, second snapshot)). `hold` is left set."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():  # a CPU rehearsal: nothing to trace
        hold.clear()
        time.sleep(settle)
        first = snapshot()
        time.sleep(length)
        return {}, (first, snapshot())
    t_enter = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_started = time.monotonic()
        hold.clear()
        time.sleep(settle)
        first = snapshot()
        m0 = _marker()
        time.sleep(length)
        m1 = _marker()
        second = snapshot()
        hold.set()
        time.sleep(drain)
        torch.cuda.synchronize()
        t_stop = time.monotonic()
    value = (first, second)
    path = os.path.join(work_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    os.remove(path)
    t_parsed = time.monotonic()
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    summary = summarise(events, (m0, m1), spans)
    summary["host_window"] = (m0, m1)
    summary["profiler_s"] = {"start": t_started - t_enter, "stop": t_parsed - t_stop,
                             "events": len(events)}
    return summary, value


def _set_depth(ranges) -> None:
    """Give each range its depth among the ranges of its own thread (ranges
    on one thread nest)."""
    by_thread = defaultdict(list)
    for r in ranges:
        by_thread[r["thread"]].append(r)
    for rs in by_thread.values():
        rs.sort(key=lambda r: (r["start"], -r["end"]))
        stack = []
        for r in rs:
            while stack and stack[-1]["end"] < r["start"]:
                stack.pop()
            r["depth"] = len(stack)
            stack.append(r)


def _deepest_open(points, ranges) -> Dict[object, dict]:
    """For each (time, key), the deepest range open at that time on any
    thread (the latest-starting of that depth) → {key: range}. Batches run
    one at a time under the micro-batcher's lock, so the deepest open span
    is the one on the launching thread."""
    order = sorted(ranges, key=lambda r: r["start"])
    levels: Dict[int, List[dict]] = defaultdict(list)
    out, j = {}, 0
    for ts, key in sorted(points, key=lambda p: p[0]):
        while j < len(order) and order[j]["start"] <= ts:
            levels[order[j]["depth"]].append(order[j])
            j += 1
        for depth in sorted(levels, reverse=True):
            levels[depth] = [r for r in levels[depth] if r["end"] >= ts]
            if levels[depth]:
                out[key] = levels[depth][-1]
                break
    return out


def summarise(events: List[dict], markers, spans: Dict[str, List[tuple]]) -> dict:
    """A Chrome trace (µs timestamps) with its two marker kernels launched at
    host times `markers` → busy seconds, per-span device seconds and calls,
    top device ops and named idle gaps, all between the markers."""
    device, launches = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, e.get("name", "?"), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
    # a marker runs as soon as it is launched (the device was idle): its
    # runtime call's time, or else its own start, is its launch time
    marks = sorted(launches.get(corr, a) for a, _, name, corr in device if MARKER in name)
    if len(marks) < 2:
        return {}
    l0, l1 = marks[0], marks[-1]
    offset = 0.5 * ((l0 - markers[0] * 1e6) + (l1 - markers[1] * 1e6))
    w0, w1 = l0, l1
    device = [d for d in device if MARKER not in d[2]]
    ranges = [{"name": name, "start": a * 1e6 + offset, "end": b * 1e6 + offset,
               "thread": tid}
              for name, recs in spans.items() for a, b, _, tid in recs]
    _set_depth(ranges)
    launched = _deepest_open(
        [(launches[corr], i) for i, (_, _, _, corr) in enumerate(device) if corr in launches],
        ranges)

    range_s = defaultdict(float)
    op_s = defaultdict(float)
    busy = []
    for i, (a, b, name, _) in enumerate(device):
        r = launched.get(i)
        if r is not None and w0 <= r["start"] and r["end"] <= w1:
            range_s[r["name"]] += (b - a) * 1e-6  # whole op: it may end past the range
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        busy.append((a, b))
        op_s[name[:NAME_CHARS]] += (b - a) * 1e-6
    busy.sort()
    merged = []
    for a, b in busy:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps, cur = [], w0
    for a, b in merged:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    gap_sum, gap_one = _name_gaps(gaps, ranges)
    calls = defaultdict(int)  # ranges wholly inside the window
    for r in ranges:
        if w0 <= r["start"] and r["end"] <= w1:
            calls[r["name"]] += 1
    top_ops = sorted(op_s.items(), key=lambda kv: -kv[1])[:10]
    idle = ([[f"all_gaps:{n}", s] for n, s in sorted(gap_sum.items(), key=lambda kv: -kv[1])[:5]]
            + [[f"one_gap:{n}", s] for n, s in gap_one[:5]])
    return {"busy_s": busy_s, "trace_window_s": (w1 - w0) * 1e-6,
            "range_device_s": dict(range_s), "range_calls": dict(calls),
            "device_ops": [[n, s] for n, s in top_ops], "idle_gaps": idle[:10]}


def _name_gaps(gaps, ranges):
    """Each idle gap is named by the deepest span open at its middle ("none"
    where none is) → (seconds per name, largest gaps)."""
    named = _deepest_open([(0.5 * (a + b), i) for i, (a, b) in enumerate(gaps)], ranges)
    total = defaultdict(float)
    singles = []
    for i, (a, b) in enumerate(gaps):
        name = named[i]["name"] if i in named else "none"
        total[name] += (b - a) * 1e-6
        singles.append((name, (b - a) * 1e-6))
    singles.sort(key=lambda t: -t[1])
    return total, singles
