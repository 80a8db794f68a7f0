"""Shard replica set: replicated writes with clock tags + consistent reads.

Reference: lib/collection/src/shards/replica_set/ — ShardReplicaSet
(mod.rs:97-132), the ReplicaState machine (replica_set_state.rs:100-133),
parallel write fan-out with clock tags and failure-driven deactivation
(update.rs:254-430, locally_disabled_peers.rs), and read fallback across
replicas (execute_read_operation.rs).

Transport abstraction: a replica is anything implementing ShardOperations —
a LocalShard (in-process) or a RemoteReplica stub (HTTP to a peer's internal
API). Location transparency mirrors the reference's RemoteShard design
(shards/remote_shard.rs).
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..types import PointId
from .clock import ClockSet, ClockTag


class ReplicaState(str, enum.Enum):
    # reference: replica_set_state.rs:100-133
    ACTIVE = "Active"
    DEAD = "Dead"
    PARTIAL = "Partial"
    INITIALIZING = "Initializing"
    LISTENER = "Listener"
    RECOVERY = "Recovery"
    RESHARDING = "Resharding"
    RESHARDING_SCALE_DOWN = "ReshardingScaleDown"
    ACTIVE_READ = "ActiveRead"

    @property
    def is_updatable(self) -> bool:
        """States that must receive writes (even if not readable)."""
        return self in (
            ReplicaState.ACTIVE,
            ReplicaState.PARTIAL,
            ReplicaState.INITIALIZING,
            ReplicaState.LISTENER,
            ReplicaState.RESHARDING,
            ReplicaState.RESHARDING_SCALE_DOWN,
        )

    @property
    def is_readable(self) -> bool:
        return self in (ReplicaState.ACTIVE, ReplicaState.ACTIVE_READ, ReplicaState.LISTENER)


class ReplicaError(Exception):
    pass


class WriteOrdering(str, enum.Enum):
    WEAK = "weak"
    MEDIUM = "medium"
    STRONG = "strong"


class ShardOperations:
    """Interface every replica implements (local or remote)."""

    def update_with_clock(self, op: dict, clock_tag: Optional[dict]) -> dict:
        raise NotImplementedError

    def search_dense(self, name, queries, k, flt=None, params=None):
        raise NotImplementedError

    def search_sparse(self, name, queries, k, flt=None):
        raise NotImplementedError

    def count(self, flt):
        raise NotImplementedError

    def scroll_ids(self, limit, offset_id=None, flt=None):
        raise NotImplementedError

    def recover_from_snapshot(self, data: bytes) -> None:
        raise NotImplementedError


class LocalReplica(ShardOperations):
    """In-process replica wrapping a LocalShard (clock map lives with the
    shard and persists across restarts)."""

    def __init__(self, shard):
        self.shard = shard

    @property
    def clock_map(self):
        return self.shard.clock_map

    def update_with_clock(self, op: dict, clock_tag: Optional[dict]) -> dict:
        return self.shard.update(op, clock_tag=clock_tag)

    def search_dense(self, name, queries, k, flt=None, params=None):
        return self.shard.search_dense(name, queries, k, flt, params)

    def search_sparse(self, name, queries, k, flt=None):
        return self.shard.search_sparse(name, queries, k, flt)

    def count(self, flt):
        return self.shard.count(flt)

    def scroll_ids(self, limit, offset_id=None, flt=None):
        return self.shard.scroll_ids(limit, offset_id, flt)

    def recover_from_snapshot(self, data: bytes) -> None:
        self.shard.restore_snapshot_bytes(data)


class ShardReplicaSet:
    """One shard's replicas across peers, with this peer's view of states.

    Writes: lease a clock, tag the op, fan out to every updatable replica;
    a replica failure marks it locally disabled (→ Dead) and the write
    succeeds if ≥ write_consistency_factor replicas applied it.
    Reads: first readable replica in preference order (local first), with
    fallback on failure.
    """

    def __init__(
        self,
        shard_id: int,
        this_peer_id: int,
        local: Optional[ShardOperations] = None,
        write_consistency_factor: int = 1,
        on_replica_failure: Optional[Callable[[int, int], None]] = None,
    ):
        self.shard_id = shard_id
        self.this_peer_id = this_peer_id
        self.replicas: Dict[int, ShardOperations] = {}
        self.states: Dict[int, ReplicaState] = {}
        if local is not None:
            self.replicas[this_peer_id] = local
            self.states[this_peer_id] = ReplicaState.ACTIVE
        self.write_consistency_factor = write_consistency_factor
        self.clock_set = ClockSet(this_peer_id)
        self.locally_disabled: set = set()
        self.on_replica_failure = on_replica_failure
        self._lock = threading.RLock()

    # -- membership -----------------------------------------------------

    def add_replica(
        self,
        peer_id: int,
        replica: ShardOperations,
        state: ReplicaState = ReplicaState.INITIALIZING,
    ) -> None:
        with self._lock:
            self.replicas[peer_id] = replica
            self.states[peer_id] = state

    def remove_replica(self, peer_id: int) -> None:
        with self._lock:
            self.replicas.pop(peer_id, None)
            self.states.pop(peer_id, None)
            self.locally_disabled.discard(peer_id)

    def set_replica_state(self, peer_id: int, state: ReplicaState) -> None:
        with self._lock:
            if peer_id in self.states:
                self.states[peer_id] = state
                if state is ReplicaState.ACTIVE:
                    self.locally_disabled.discard(peer_id)

    def active_replicas(self) -> List[int]:
        with self._lock:
            return [
                p
                for p, s in self.states.items()
                if s.is_readable and p not in self.locally_disabled
            ]

    # -- writes ----------------------------------------------------------

    def leader_for(self, ordering: str) -> Optional[int]:
        """Peer that must drive this write (reference: update.rs:218-238
        leader_peer_for_update): weak → this peer; medium → highest ALIVE
        replica; strong → highest replica, alive or not."""
        with self._lock:
            if ordering == "medium":
                alive = [
                    p
                    for p, s in self.states.items()
                    if s.is_readable and p not in self.locally_disabled
                ]
                return max(alive) if alive else None
            if ordering == "strong":
                return max(self.states) if self.states else None
            return self.this_peer_id

    def update(self, op: dict, max_retries: int = 3, ordering: str = "weak") -> dict:
        """Clock-tagged fan-out write (reference: update.rs:254-430,
        including the stale-tick retry loop). Medium/strong ordering routes
        the write through the designated leader replica first."""
        if ordering in ("medium", "strong"):
            leader = self.leader_for(ordering)
            if leader is None:
                raise ReplicaError(f"no leader available for {ordering} ordering")
            if leader != self.this_peer_id:
                replica = self.replicas.get(leader)
                forward = getattr(replica, "forward_update", None)
                if forward is None:
                    raise ReplicaError(
                        f"peer {leader} cannot accept forwarded writes"
                    )
                return forward(op)
        clock_id, clock = self.clock_set.lease()
        try:
            for attempt in range(max_retries):
                tag = self.clock_set.tag_for(clock_id)
                if attempt == max_retries - 1:
                    tag.force = True
                results, stale, stale_tick = self._fan_out(op, tag)
                if not stale:
                    successes = [r for r in results.values() if r is not None]
                    if len(successes) < self.write_consistency_factor:
                        raise ReplicaError(
                            f"write applied on {len(successes)} replicas, "
                            f"need {self.write_consistency_factor}"
                        )
                    return successes[0] if successes else {"status": "completed"}
                # a replica saw a newer tick (e.g. this peer restarted and its
                # clocks reset): adopt the echoed high-water mark so the next
                # tag_for() ticks PAST it — reference update.rs retry loop
                if stale_tick is not None:
                    clock.advance_to(stale_tick)
            raise ReplicaError("write kept being rejected as stale")
        finally:
            self.clock_set.release(clock_id)

    def _fan_out(
        self, op: dict, tag: ClockTag
    ) -> Tuple[Dict[int, Optional[dict]], bool, Optional[int]]:
        with self._lock:
            targets = [
                (p, r)
                for p, r in self.replicas.items()
                if self.states[p].is_updatable and p not in self.locally_disabled
            ]
        if not targets:
            raise ReplicaError(f"no updatable replicas for shard {self.shard_id}")
        results: Dict[int, Optional[dict]] = {}
        stale = False
        stale_tick: Optional[int] = None
        lock = threading.Lock()

        def one(peer_id: int, replica: ShardOperations) -> None:
            nonlocal stale, stale_tick
            try:
                res = replica.update_with_clock(op, tag.to_dict())
                with lock:
                    if res.get("status") == "stale":
                        stale = True
                        results[peer_id] = None
                        echoed = res.get("current_tick")
                        if echoed is not None:
                            stale_tick = max(stale_tick or 0, int(echoed))
                    else:
                        results[peer_id] = res
            except Exception:
                with lock:
                    results[peer_id] = None
                self._handle_failure(peer_id)

        if len(targets) == 1:
            one(*targets[0])
        else:
            # parallel fan-out (reference: update.rs joins the per-replica
            # futures) — a dead peer's timeout must not serialize after the
            # healthy replicas' writes
            threads = [
                threading.Thread(target=one, args=(p, r), daemon=True)
                for p, r in targets
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        return results, stale, stale_tick

    def _handle_failure(self, peer_id: int) -> None:
        """Failed write → locally disable; consensus later confirms Dead
        (reference: locally_disabled_peers.rs)."""
        if peer_id == self.this_peer_id:
            return  # local failures are fatal, not a replica-health issue
        with self._lock:
            self.locally_disabled.add(peer_id)
        if self.on_replica_failure:
            self.on_replica_failure(self.shard_id, peer_id)

    # -- reads -----------------------------------------------------------

    def _read_order(self) -> List[Tuple[int, ShardOperations]]:
        with self._lock:
            order = []
            if self.this_peer_id in self.replicas and self.states.get(
                self.this_peer_id, ReplicaState.DEAD
            ).is_readable:
                order.append((self.this_peer_id, self.replicas[self.this_peer_id]))
            for p, r in self.replicas.items():
                if p == self.this_peer_id:
                    continue
                if self.states[p].is_readable and p not in self.locally_disabled:
                    order.append((p, r))
            return order

    def execute_read(self, fn: Callable[[ShardOperations], Any]) -> Any:
        last_err: Optional[Exception] = None
        for peer_id, replica in self._read_order():
            try:
                return fn(replica)
            except Exception as e:  # fall back to the next replica
                last_err = e
                self._handle_failure(peer_id)
        raise ReplicaError(
            f"no readable replica for shard {self.shard_id}: {last_err}"
        )

    def execute_read_consistent(
        self,
        fn: Callable[[ShardOperations], Any],
        factor: int,
        resolve: Callable[[List[Any]], Any],
    ) -> Any:
        """Read from up to `factor` replicas and resolve divergence
        (reference: shards/resolve.rs + ReadConsistency factor)."""
        results = []
        errors = []
        for peer_id, replica in self._read_order():
            if len(results) >= factor:
                break
            try:
                results.append(fn(replica))
            except Exception as e:
                errors.append(e)
                self._handle_failure(peer_id)
        if not results:
            raise ReplicaError(
                f"no readable replica for shard {self.shard_id}: {errors}"
            )
        if len(results) == 1:
            return results[0]
        return resolve(results)

    @staticmethod
    def resolve_search_results(
        results: List[List[List[tuple]]],
    ) -> List[List[tuple]]:
        """Merge per-replica search outputs [(score, id, version)]: keep the
        highest-version record per point, re-rank by score."""
        n_queries = max(len(r) for r in results)
        out = []
        for qi in range(n_queries):
            best = {}
            for rep in results:
                if qi >= len(rep):
                    continue
                for score, pid, ver in rep[qi]:
                    prev = best.get(pid)
                    if prev is None or ver > prev[1]:
                        best[pid] = (score, ver)
            items = [(s, pid, v) for pid, (s, v) in best.items()]
            items.sort(key=lambda t: -t[0])
            k = max((len(rep[qi]) for rep in results if qi < len(rep)), default=0)
            out.append(items[:k])
        return out

    def search_dense(
        self, name, queries, k, flt=None, params=None, consistency: int = 1
    ):
        return self.execute_read_consistent(
            lambda r: r.search_dense(name, queries, k, flt, params),
            max(consistency, 1),
            self.resolve_search_results,
        )

    def search_sparse(self, name, queries, k, flt=None):
        return self.execute_read(lambda r: r.search_sparse(name, queries, k, flt))

    def count(self, flt=None, consistency: int = 1):
        return self.execute_read_consistent(
            lambda r: r.count(flt), max(consistency, 1), max
        )

    def scroll_ids(self, limit, offset_id=None, flt=None):
        return self.execute_read(lambda r: r.scroll_ids(limit, offset_id, flt))
