"""Fair hash-ring point→shard routing.

Reference: lib/collection/src/hash_ring.rs:15-60 — a fair ring with scale 100
virtual nodes per shard; points map to the first virtual node clockwise of
their hash. A Resharding variant holds (old, new) rings during resharding,
routing to both for writes.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Any, List, Optional, Tuple

HASH_RING_SCALE = 100


def _hash(value: Any) -> int:
    data = repr(value).encode()
    return int.from_bytes(hashlib.md5(data).digest()[:8], "little")


class HashRing:
    def __init__(self, scale: int = HASH_RING_SCALE):
        self.scale = scale
        self._nodes: List[Tuple[int, int]] = []  # (hash, shard_id) sorted
        self._shards: set = set()

    def add(self, shard_id: int) -> None:
        if shard_id in self._shards:
            return
        self._shards.add(shard_id)
        for i in range(self.scale):
            self._nodes.append((_hash(("shard", shard_id, i)), shard_id))
        self._nodes.sort()

    def remove(self, shard_id: int) -> None:
        if shard_id not in self._shards:
            return
        self._shards.discard(shard_id)
        self._nodes = [(h, s) for h, s in self._nodes if s != shard_id]

    def get(self, point_id: Any) -> Optional[int]:
        if not self._nodes:
            return None
        h = _hash(("point", point_id))
        idx = bisect.bisect_right([n[0] for n in self._nodes], h)
        if idx == len(self._nodes):
            idx = 0
        return self._nodes[idx][1]

    def shard_ids(self) -> List[int]:
        return sorted(self._shards)

    def __len__(self) -> int:
        return len(self._shards)


class ReshardingRing:
    """Dual ring used mid-resharding: reads/writes go to both mappings."""

    def __init__(self, old: HashRing, new: HashRing):
        self.old = old
        self.new = new

    def get_all(self, point_id: Any) -> List[int]:
        out = []
        for ring in (self.old, self.new):
            s = ring.get(point_id)
            if s is not None and s not in out:
                out.append(s)
        return out
