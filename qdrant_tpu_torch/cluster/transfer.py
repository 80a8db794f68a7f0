"""Shard transfer: populate a new replica while serving writes.

Reference: lib/collection/src/shards/transfer/ (ShardTransferMethod
StreamRecords, transfer/driver.rs) + the proxy shards that capture
concurrent writes (shards/forward_proxy_shard.rs).

StreamRecords flow implemented here:
  1. target replica enters PARTIAL (receives live writes but serves no reads),
  2. the local replica is wrapped in a ForwardProxyReplica so every update
     applies locally AND forwards to the target,
  3. existing points stream to the target in scroll-ordered batches,
  4. target is promoted ACTIVE, the proxy unwraps.
Idempotent per-point versions make the overlap between streamed batches and
forwarded live writes safe (same guarantee the reference relies on).
"""

from __future__ import annotations

from typing import Optional

from .replica_set import (
    LocalReplica,
    ReplicaState,
    ShardOperations,
    ShardReplicaSet,
)


class TransferError(Exception):
    pass


class ForwardProxyReplica(ShardOperations):
    """Applies updates locally, then forwards them to the transfer target
    (reference: ForwardProxyShard)."""

    def __init__(self, inner: ShardOperations, target: ShardOperations):
        self.inner = inner
        self.target = target

    def update_with_clock(self, op: dict, clock_tag: Optional[dict]) -> dict:
        res = self.inner.update_with_clock(op, clock_tag)
        # forward even stale-rejected ops — target keeps its own clock map
        self.target.update_with_clock(op, clock_tag)
        return res

    def search_dense(self, *a, **k):
        return self.inner.search_dense(*a, **k)

    def search_sparse(self, *a, **k):
        return self.inner.search_sparse(*a, **k)

    def count(self, flt):
        return self.inner.count(flt)

    def scroll_ids(self, *a, **k):
        return self.inner.scroll_ids(*a, **k)


def stream_records(
    source_shard,
    target: ShardOperations,
    batch_size: int = 100,
    cancel=None,
) -> int:
    """Scroll the source shard and upsert every live point into the target.
    `cancel` (zero-arg callable) is checked between batches — an abort takes
    effect within one batch instead of after the whole shard streamed.
    → number of transferred points."""
    transferred = 0
    offset = None
    while True:
        if cancel is not None and cancel():
            raise TransferError("transfer aborted")
        ids = source_shard.scroll_ids(batch_size + 1, offset)
        if not ids:
            break
        page = ids[:batch_size]
        offset = ids[batch_size] if len(ids) > batch_size else None
        points = []
        for pid in page:
            seg = source_shard._find_point(pid)
            if seg is None:
                continue
            internal = seg.id_tracker.internal_id(pid)
            version = seg.id_tracker.version(internal)
            points.append(
                {
                    "id": pid,
                    "vectors": seg.get_vectors(pid) or {},
                    "payload": seg.get_payload(pid),
                    "_version": version,
                }
            )
        if points:
            target.update_with_clock({"type": "upsert", "points": points}, None)
            transferred += len(points)
        if offset is None:
            break
    return transferred


class QueueProxyReplica(ShardOperations):
    """Applies updates locally while queueing them for later replay to the
    transfer target (reference: QueueProxyShard — used by the snapshot
    transfer method so writes during the copy are not lost)."""

    def __init__(self, inner: ShardOperations):
        self.inner = inner
        self.queue = []

    def update_with_clock(self, op: dict, clock_tag):
        res = self.inner.update_with_clock(op, clock_tag)
        self.queue.append((op, clock_tag))
        return res

    def search_dense(self, *a, **k):
        return self.inner.search_dense(*a, **k)

    def search_sparse(self, *a, **k):
        return self.inner.search_sparse(*a, **k)

    def count(self, flt):
        return self.inner.count(flt)

    def scroll_ids(self, *a, **k):
        return self.inner.scroll_ids(*a, **k)


def transfer_shard_snapshot(
    replica_set: ShardReplicaSet,
    target_peer: int,
    target: ShardOperations,
) -> int:
    """Snapshot transfer (reference: ShardTransferMethod::Snapshot):
    1. wrap the local replica in a QueueProxy (live writes queue),
    2. tar the local shard and recover it on the target,
    3. replay the queued writes, 4. promote the target ACTIVE.
    → number of points in the snapshot."""
    local_peer = replica_set.this_peer_id
    local = replica_set.replicas.get(local_peer)
    if not isinstance(local, LocalReplica):
        raise TransferError("snapshot transfer source must hold a local replica")

    proxy = QueueProxyReplica(local)
    replica_set.replicas[local_peer] = proxy
    try:
        data = local.shard.create_snapshot_bytes()
        target.recover_from_snapshot(data)
        n = local.shard.point_count()
        # replay writes captured during the copy (idempotent by op version)
        for op, tag in proxy.queue:
            target.update_with_clock(op, tag)
    finally:
        replica_set.replicas[local_peer] = local
    replica_set.add_replica(target_peer, target, ReplicaState.PARTIAL)
    replica_set.set_replica_state(target_peer, ReplicaState.ACTIVE)
    return n


def transfer_wal_delta(
    replica_set: ShardReplicaSet,
    target_peer: int,
    target: ShardOperations,
    target_recovery: dict,
) -> int:
    """WAL-delta transfer (reference: ShardTransferMethod::WalDelta +
    wal_delta.rs): replay only the WAL records whose causal clocks are newer
    than the target's recovery point — the cheap catch-up path for a replica
    that was briefly down. → number of replayed operations."""
    local_peer = replica_set.this_peer_id
    local = replica_set.replicas.get(local_peer)
    if not isinstance(local, LocalReplica):
        raise TransferError("wal-delta source must hold a local replica")
    replica_set.add_replica(target_peer, target, ReplicaState.PARTIAL)
    replayed = 0
    for op, tag in local.shard.wal_ops_since(target_recovery):
        clean = {k: v for k, v in op.items() if k != "clock_tag"}
        target.update_with_clock(clean, tag)
        replayed += 1
    replica_set.set_replica_state(target_peer, ReplicaState.ACTIVE)
    return replayed


def transfer_shard_stream_records(
    replica_set: ShardReplicaSet,
    target_peer: int,
    target: ShardOperations,
    batch_size: int = 100,
    cancel=None,
) -> int:
    """Full StreamRecords transfer into `target`, registered as a replica of
    `replica_set`. Live writes during the copy reach the target both via the
    PARTIAL replica state (normal fan-out) and the forward proxy. A `cancel`
    that fires mid-stream raises TransferError after deregistering the
    PARTIAL replica (the caller drops the half-copied data)."""
    local_peer = replica_set.this_peer_id
    local = replica_set.replicas.get(local_peer)
    if local is None:
        raise TransferError("transfer source must hold a local replica")

    replica_set.add_replica(target_peer, target, ReplicaState.PARTIAL)
    proxy = ForwardProxyReplica(local, target)
    replica_set.replicas[local_peer] = proxy
    try:
        n = stream_records(
            proxy.inner.shard if isinstance(proxy.inner, LocalReplica) else None,
            target,
            batch_size,
            cancel=cancel,
        )
    except TransferError:
        replica_set.remove_replica(target_peer)
        raise
    finally:
        replica_set.replicas[local_peer] = local
    replica_set.set_replica_state(target_peer, ReplicaState.ACTIVE)
    return n
