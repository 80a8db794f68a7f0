"""The port's own spans and counters (qdrant_tpu_torch/utils/tracing.py),
for the metric readers that read them.

The aggregates are always on: a reader takes the total of a span path over
the run. The timeline is off unless a reader turns it on: each timeline
reader's `snapshot()` starts it at the traced window's start and stops it at
the window's end (starts nest), and its `read(ctx)` takes the records that
end inside the traced sub-window. A port without the facility gives
nothing: every reader then returns None.
"""

from __future__ import annotations

from typing import List, Optional


def facility():
    try:
        from qdrant_tpu_torch.utils import tracing
    except ImportError:  # a port that has no spans of its own
        return None
    return tracing


def total(*suffixes: str) -> Optional[float]:
    """Wall seconds summed over the span paths that end in any of
    `suffixes` → None where none has ended (or there is no facility)."""
    tr = facility()
    if tr is None:
        return None
    found = [t for t in (tr.total(s) for s in suffixes) if t is not None]
    return sum(found) if found else None


class Timeline:
    """One reader's hold on the timeline; `toggle()` is its snapshot."""

    def __init__(self):
        self.on = False

    def toggle(self):
        """Start the timeline (first call) or stop it (second) → the port's
        counters at that moment, or None without the facility."""
        tr = facility()
        if tr is None:
            return None
        if self.on:
            tr.timeline_stop()
        else:
            tr.timeline_start()
        self.on = not self.on
        return tr.counters()


def records(name: str) -> List[tuple]:
    """Every record of span `name` in the last timeline."""
    tr = facility()
    return [] if tr is None else tr.timeline().get(name, [])


def window_records(ctx, name: str) -> List[tuple]:
    """The records of span `name` that end inside the traced sub-window."""
    t0, t1 = ctx.profile_window
    return [r for r in records(name) if t0 < r[1] <= t1]
