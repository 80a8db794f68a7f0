"""Causal clocks for replicated writes.

Reference: lib/collection/src/shards/replica_set/clock_set.rs (per-peer clock
allocation) and local_shard/clock_map.rs (per-shard tick tracking with
stale-tick rejection + RecoveryPoint for WAL-delta transfers).

Semantics: every update carries a ClockTag{peer_id, clock_id, clock_tick}.
A shard's ClockMap advances to the max seen tick per (peer, clock); an
incoming tag with tick ≤ current is STALE and must be rejected (the sender
retries with a newer tick) unless force is set. The set of (peer, clock) →
tick pairs is the shard's RecoveryPoint: the cut from which a WAL-delta
transfer can resume a stale replica.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class ClockTag:
    peer_id: int
    clock_id: int
    clock_tick: int
    force: bool = False

    def to_dict(self) -> dict:
        return {
            "peer_id": self.peer_id,
            "clock_id": self.clock_id,
            "clock_tick": self.clock_tick,
            "force": self.force,
        }

    @staticmethod
    def from_dict(d: Optional[dict]) -> Optional["ClockTag"]:
        if not d:
            return None
        return ClockTag(
            peer_id=int(d["peer_id"]),
            clock_id=int(d["clock_id"]),
            clock_tick=int(d["clock_tick"]),
            force=bool(d.get("force", False)),
        )


class Clock:
    """One logical clock owned by a peer; ticks monotonically."""

    def __init__(self, start: int = 0):
        self._tick = start
        self._lock = threading.Lock()

    def tick_once(self) -> int:
        with self._lock:
            self._tick += 1
            return self._tick

    def advance_to(self, tick: int) -> None:
        with self._lock:
            self._tick = max(self._tick, tick)

    @property
    def current(self) -> int:
        return self._tick


class ClockSet:
    """Per-peer pool of clocks; each in-flight operation leases one clock so
    concurrent updates get independent tick sequences (reference clock_set.rs)."""

    def __init__(self, peer_id: int):
        self.peer_id = peer_id
        self._clocks: Dict[int, Clock] = {}
        self._free: list = []
        self._next_id = 0
        self._lock = threading.Lock()

    def lease(self) -> Tuple[int, Clock]:
        with self._lock:
            if self._free:
                cid = self._free.pop()
            else:
                cid = self._next_id
                self._next_id += 1
                self._clocks[cid] = Clock()
            return cid, self._clocks[cid]

    def release(self, clock_id: int) -> None:
        with self._lock:
            self._free.append(clock_id)

    def tag_for(self, clock_id: int) -> ClockTag:
        return ClockTag(self.peer_id, clock_id, self._clocks[clock_id].tick_once())


class ClockMap:
    """Shard-side clock tracking with stale rejection (clock_map.rs)."""

    def __init__(self):
        self._ticks: Dict[Tuple[int, int], int] = {}
        self._lock = threading.Lock()

    def advance(self, tag: Optional[ClockTag]) -> bool:
        """→ True if the operation must be applied; False if stale-rejected."""
        return self.advance_result(tag)[0]

    def advance_result(self, tag: Optional[ClockTag]) -> Tuple[bool, int]:
        """→ (accepted, current tick for the tag's clock). The tick is echoed
        back to the sender on stale rejection so a restarted peer (whose
        ClockSet restarted at 0) can advance its clock past this shard's
        high-water mark and retry — reference: replica_set/update.rs's
        rejected-tick retry loop + clock_set.rs advance semantics."""
        if tag is None:
            return True, 0
        key = (tag.peer_id, tag.clock_id)
        with self._lock:
            current = self._ticks.get(key, 0)
            if tag.clock_tick <= current and not tag.force:
                return False, current
            self._ticks[key] = max(current, tag.clock_tick)
            return True, self._ticks[key]

    def recovery_point(self) -> Dict[Tuple[int, int], int]:
        with self._lock:
            return dict(self._ticks)

    def to_dict(self) -> dict:
        with self._lock:
            return {f"{p}:{c}": t for (p, c), t in self._ticks.items()}

    @classmethod
    def from_dict(cls, d: dict) -> "ClockMap":
        cm = cls()
        for key, tick in (d or {}).items():
            p, c = key.split(":")
            cm._ticks[(int(p), int(c))] = int(tick)
        return cm


def missing_clocks(
    source: Dict[Tuple[int, int], int], target: Dict[Tuple[int, int], int]
) -> Dict[Tuple[int, int], int]:
    """Clocks where `target` lags `source` — drives WAL-delta transfer
    decisions (reference: wal_delta.rs resolve)."""
    out = {}
    for key, tick in source.items():
        if target.get(key, 0) < tick:
            out[key] = target.get(key, 0)
    return out
