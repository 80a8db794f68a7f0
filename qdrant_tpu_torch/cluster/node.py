"""ClusterNode: the composition root for a clustered peer.

Reference: src/main.rs cluster bootstrap + src/consensus.rs (the consensus
thread pumping raft ticks/messages). A ClusterNode owns this peer's
TableOfContent, its RaftNode (metadata consensus), a ConsensusManager
applying committed ops, and an HTTP transport that posts Raft messages to
peer REST servers (/cluster/raft/message). A background thread drives
ticks, like the reference's dedicated consensus OS thread.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Dict, Optional

from ..api.toc import TableOfContent
from .consensus import ConsensusManager, Dispatcher
from .raft import RaftNode


class HttpRaftTransport:
    """Posts raft messages to peers' REST endpoints from a dedicated sender
    thread. Sends MUST be async: RaftNode invokes the transport while holding
    its state lock, and a synchronous send to a peer that is itself sending
    back deadlocks the cluster. Unreachable peers are dropped silently (raft
    tolerates message loss)."""

    def __init__(
        self,
        peer_urls: Dict[int, str],
        timeout: float = 2.0,
        api_key: Optional[str] = None,
    ):
        import queue

        self.peer_urls = dict(peer_urls)
        self.timeout = timeout
        self.api_key = api_key
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def __call__(self, peer_id: int, message: dict) -> None:
        self._q.put((peer_id, message))

    def _pump(self) -> None:
        while True:
            peer_id, message = self._q.get()
            url = self.peer_urls.get(peer_id)
            if url is None:
                continue
            req = urllib.request.Request(
                f"{url.rstrip('/')}/cluster/raft/message",
                data=json.dumps(message).encode(),
                method="POST",
            )
            req.add_header("Content-Type", "application/json")
            if self.api_key:
                req.add_header("api-key", self.api_key)
            try:
                urllib.request.urlopen(req, timeout=self.timeout).read()
            except OSError:
                pass  # peer down — raft retries via heartbeats


class ClusterNode:
    def __init__(
        self,
        peer_id: int,
        toc: TableOfContent,
        peer_urls: Dict[int, str],
        tick_period: float = 0.05,
        raft_storage: Optional[str] = None,
        api_key: Optional[str] = None,
    ):
        self.peer_id = peer_id
        self.toc = toc
        self.api_key = api_key
        self.manager = ConsensusManager(toc)
        self.transport = HttpRaftTransport(peer_urls, api_key=api_key)
        self.raft = RaftNode(
            peer_id,
            sorted(set(peer_urls.keys()) | {peer_id}),
            self.transport,
            apply_fn=self.manager.apply,
            storage_path=raft_storage,
            snapshot_fn=self.manager.snapshot_state,
            restore_fn=self.manager.restore_state,
        )
        self.dispatcher = Dispatcher(toc, raft=self.raft, manager=self.manager)
        self.tick_period = tick_period
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the REST server discovers the node through the toc
        toc.cluster_node = self
        for name in toc.list_collections():
            self.attach_replication(name)
        self.manager.on_collection_created = self.attach_replication
        self.manager.on_peer_added = self.add_peer
        self.manager.on_replica_down = self._on_replica_down
        self.manager.on_replica_move = self._on_replica_move
        self.manager.on_replica_add = self._on_replica_add
        self.manager.on_replica_drop = self._on_replica_drop
        self.manager.on_replica_activate = self._on_replica_activate
        # live shard transfers driven by this peer, keyed
        # (collection, shard_id, to_peer) → status record (reference:
        # transfer tracking in shard_transfer/mod.rs + /cluster listing)
        self.active_transfers: Dict[tuple, dict] = {}

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        threading.Thread(
            target=self._migrate_existing_collections, daemon=True
        ).start()

    def _migrate_existing_collections(self) -> None:
        """Single→cluster migration (reference:
        src/migrations/single_to_cluster.rs handle_existing_collections):
        collections that exist locally but were created OUTSIDE consensus
        (single-node era, or restored from a backup) are proposed into the
        consensus log with every shard pinned to this peer. Idempotent:
        peers that already know a collection skip the committed op."""
        import time as _time

        deadline = _time.time() + 30
        while _time.time() < deadline and self.raft.leader_id is None:
            _time.sleep(0.1)
        if self.raft.leader_id is None:
            return
        for name in list(self.toc.list_collections()):
            try:
                coll = self.toc.get_collection(name)
            except Exception:
                continue
            if coll.placement:
                continue  # already consensus-placed
            spec = {
                "vectors": {
                    n: vp.to_dict() for n, vp in coll.params.vectors.items()
                },
                "sparse_vectors": {
                    n: sp.to_dict()
                    for n, sp in (coll.params.sparse_vectors or {}).items()
                },
                "shard_number": coll.params.shard_number,
                "replication_factor": coll.params.replication_factor,
            }
            placement = {
                str(sid): [self.peer_id] for sid in coll.shards
            }
            self.propose_anywhere(
                {
                    "type": "create_collection",
                    "name": name,
                    "spec": spec,
                    "placement": placement,
                }
            )

    def _run(self) -> None:
        while not self._stop.wait(self.tick_period):
            self.raft.tick()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def receive(self, message: dict) -> None:
        self.raft.receive(message)

    def all_peer_ids(self) -> list:
        return sorted(set(self.transport.peer_urls.keys()) | {self.peer_id})

    def propose_placement(
        self, shard_number: int, replication_factor: int
    ) -> Dict[str, list]:
        """Round-robin shard→peers proposal embedded into the
        create_collection consensus op (reference: the
        ShardDistributionProposal in collection_meta_ops.rs:488-511).
        Every shard gets min(replication_factor, n_peers) distinct peers."""
        peers = self.all_peer_ids()
        rf = max(1, min(replication_factor, len(peers)))
        return {
            str(sid): [peers[(sid + j) % len(peers)] for j in range(rf)]
            for sid in range(shard_number)
        }

    def attach_replication(self, collection_name: str) -> None:
        """Wire the collection's shards for cluster operation according to
        its consensus-decided placement (reference: ShardReplicaSet
        mod.rs:97-132). For each shard:
          - placed here + replicated → ShardReplicaSet(local, placed peers)
          - placed here, rf=1       → plain local shard (no fan-out)
          - placed elsewhere        → RemoteShardHandle (reads fan out with
                                      failover; writes forward)
        Legacy collections without a placement map replicate everywhere."""
        from .remote import RemoteReplica, RemoteShardHandle
        from .replica_set import LocalReplica, ReplicaState, ShardReplicaSet

        try:
            coll = self.toc.get_collection(collection_name)
        except Exception:
            return
        all_peers = self.all_peer_ids()
        for sid in coll.all_shard_ids():
            placed = coll.placement.get(sid) or all_peers
            others = [p for p in placed if p != self.peer_id]
            if self.peer_id in placed:
                shard = coll.shards.get(sid)
                if shard is None:
                    continue  # placed here but not materialized yet
                if coll.params.replication_factor < 2 and not coll.placement:
                    continue  # legacy standalone behavior
                if not others and coll.params.replication_factor < 2:
                    continue  # sole replica, rf=1: plain local path
                rs = ShardReplicaSet(
                    sid,
                    this_peer_id=self.peer_id,
                    local=LocalReplica(shard),
                    write_consistency_factor=coll.params.write_consistency_factor,
                    on_replica_failure=(
                        lambda s, p, name=collection_name:
                        self.report_replica_failure(name, s, p)
                    ),
                )
                for peer_id in others:
                    url = self.transport.peer_urls.get(peer_id)
                    if url is None:
                        continue
                    rs.add_replica(
                        peer_id,
                        RemoteReplica(
                            url, collection_name, sid, api_key=self.api_key
                        ),
                        ReplicaState.ACTIVE,
                    )
                coll.replica_sets[sid] = rs
            else:
                replicas = []
                for peer_id in placed:
                    url = self.transport.peer_urls.get(peer_id)
                    if url is None:
                        continue
                    replicas.append(
                        (
                            peer_id,
                            RemoteReplica(
                                url, collection_name, sid, api_key=self.api_key
                            ),
                        )
                    )
                coll.remote_shards[sid] = RemoteShardHandle(replicas)

    # ------------------------------------------------------------------
    # replica failure → consensus-driven re-replication
    # (reference: the SetShardReplicaState → Dead meta op followed by a
    # shard transfer to a freshly chosen peer, transfer/driver.rs)
    # ------------------------------------------------------------------

    def propose_anywhere(self, op: dict) -> None:
        """Propose a consensus op from any peer: direct when leader, else
        forwarded to the current leader's /cluster/raft/propose."""
        from .raft import NotLeader

        try:
            self.dispatcher.submit(op)
            return
        except NotLeader as e:
            leader = e.leader_id
        url = self.transport.peer_urls.get(leader)
        if url is None:
            return
        req = urllib.request.Request(
            f"{url.rstrip('/')}/cluster/raft/propose",
            data=json.dumps(op).encode(),
            method="POST",
        )
        req.add_header("Content-Type", "application/json")
        if self.api_key:
            req.add_header("api-key", self.api_key)
        try:
            urllib.request.urlopen(req, timeout=5).read()
        except OSError:
            pass  # leader churn — the next failure re-reports

    def report_replica_failure(self, collection: str, sid: int, peer: int) -> None:
        """Write-failure hook from a ShardReplicaSet: confirm the dead
        replica through consensus (off-thread; the caller holds shard
        locks)."""
        op = {
            "type": "replica_down",
            "name": collection,
            "shard_id": sid,
            "peer_id": peer,
        }
        threading.Thread(
            target=self.propose_anywhere, args=(op,), daemon=True
        ).start()

    def _on_replica_down(self, collection: str, sid: int, peer: int) -> None:
        """Committed dead replica: the raft leader picks a replacement peer
        and proposes the move (deterministic, so duplicate reports no-op)."""
        if self.raft.role != "leader":
            return
        try:
            coll = self.toc.get_collection(collection)
        except Exception:
            return
        placed = coll.placement.get(sid)
        if not placed or peer not in placed:
            return  # already repaired (or not a placed shard)
        candidates = [
            p for p in self.all_peer_ids() if p not in placed and p != peer
        ]
        if not candidates:
            return  # replication_factor == live peers: nowhere to move
        op = {
            "type": "move_replica",
            "name": collection,
            "shard_id": sid,
            "from_peer": peer,
            "to_peer": min(candidates),
        }
        threading.Thread(
            target=self.propose_anywhere, args=(op,), daemon=True
        ).start()

    def _on_replica_move(
        self, collection: str, sid: int, frm: int, to: int
    ) -> None:
        """Committed replica move: update placement everywhere, materialize
        the (empty) shard on the target, re-wire, and let the lowest alive
        holder stream the data over."""
        try:
            coll = self.toc.get_collection(collection)
        except Exception:
            return
        placed = coll.placement.get(sid)
        if not placed or frm not in placed:
            return
        coll.placement[sid] = [to if p == frm else p for p in placed]
        coll.save_config()
        self._materialize_replica_target(coll, collection, sid, to, source=frm)
        self.attach_replication(collection)
        self._start_stream_transfer(coll, collection, sid, to, source=frm)

    def _materialize_replica_target(
        self, coll, collection: str, sid: int, to: int, source: int = None
    ) -> None:
        """Create the (empty) shard on `to` when that's this peer; serve
        reads for it remotely until the transfer lands. `source` — a peer
        that still holds the data but left the placement (rf=1 move) — is
        included as a read route for the transfer window."""
        if to != self.peer_id or sid in coll.shards:
            return
        coll._create_shard(sid)
        coll.partial_local.add(sid)
        from .remote import RemoteReplica, RemoteShardHandle

        readers = []
        route_peers = list(coll.placement[sid])
        if source is not None and source not in route_peers:
            route_peers.append(source)
        for p in route_peers:
            if p == self.peer_id:
                continue
            url = self.transport.peer_urls.get(p)
            if url is not None:
                readers.append(
                    (p, RemoteReplica(url, collection, sid,
                                      api_key=self.api_key))
                )
        coll.remote_shards[sid] = RemoteShardHandle(readers)

    def _start_stream_transfer(
        self, coll, collection: str, sid: int, to: int, source: int = None
    ) -> None:
        """Lowest alive holder streams the shard to `to`, then proposes
        activation. Tracked in active_transfers; abortable between retries
        (reference: shard_transfer driver + abort, transfer/driver.rs).

        `source` covers the rf=1 move: placement already points at `to`
        only, but `source` still physically holds the data and must drive
        the copy (a dead `source` — rf=1 repair — simply never drives; the
        shard starts empty on the target)."""
        others = [p for p in coll.placement[sid] if p != to]
        if not others and source is not None:
            others = [source]
        if not others:
            return
        driver = min(others)
        if driver != self.peer_id:
            return
        key = (collection, sid, to)
        rec = {
            "shard_id": sid,
            "from": driver,
            "to": to,
            "method": "stream_records",
            "aborted": False,
        }
        self.active_transfers[key] = rec

        def _transfer():
            from .remote import RemoteReplica
            from .transfer import transfer_shard_stream_records

            try:
                rs = coll.replica_sets.get(sid)
                if rs is None and sid in coll.shards:
                    # rf=1 local shard (or source already out of placement):
                    # build a transfer-only replica set over the local copy
                    from .replica_set import LocalReplica, ShardReplicaSet

                    rs = ShardReplicaSet(
                        sid,
                        this_peer_id=self.peer_id,
                        local=LocalReplica(coll.shards[sid]),
                        write_consistency_factor=1,
                    )
                url = self.transport.peer_urls.get(to)
                if rs is None or url is None:
                    return
                target = RemoteReplica(
                    url, collection, sid, api_key=self.api_key
                )
                for attempt in range(40):
                    if rec["aborted"]:
                        return
                    try:
                        transfer_shard_stream_records(
                            rs, to, target, cancel=lambda: rec["aborted"]
                        )
                        break
                    except Exception:
                        if attempt == 39:
                            return
                        import time as _time

                        _time.sleep(0.25)
                if rec["aborted"]:
                    return
                self.propose_anywhere(
                    {
                        "type": "activate_replica",
                        "name": collection,
                        "shard_id": sid,
                        "peer_id": to,
                    }
                )
            finally:
                # guarded: a fresh transfer for the same (coll, sid, to) may
                # have re-registered the key after this one aborted
                if self.active_transfers.get(key) is rec:
                    self.active_transfers.pop(key, None)

        threading.Thread(target=_transfer, daemon=True).start()

    def abort_transfer(self, collection: str, sid: int, to: int) -> bool:
        """Cancel a transfer this peer is driving (between retry attempts;
        an in-flight stream batch completes first), then clean up: the
        half-copied target replica is dropped through consensus so
        placement never routes reads at partial data (reference: transfer
        abort removes the PARTIAL replica, transfer/mod.rs). The sole
        remaining holder of an rf=1 move cannot be aborted — the source
        already left the placement. → True if a transfer matched."""
        rec = self.active_transfers.get((collection, sid, to))
        if rec is None:
            return False
        try:
            coll = self.toc.get_collection(collection)
            others = [p for p in coll.placement.get(sid, []) if p != to]
        except Exception:
            others = []
        if not others:
            # rf=1 move: the target is the ONLY placement holder — aborting
            # would strand the shard on a never-activated partial replica
            # (no holder left to stream from). Refuse; the transfer either
            # completes or is repaired by the dead-replica path.
            return False
        rec["aborted"] = True
        if others:
            # inline (not a thread): by the time the abort call returns, the
            # drop is committed (or at least handed to the leader), so a
            # follow-up replicate cannot race a late drop of its fresh copy
            self.propose_anywhere(
                {
                    "type": "drop_replica",
                    "name": collection,
                    "shard_id": sid,
                    "peer_id": to,
                }
            )
        return True

    def _on_replica_add(self, collection: str, sid: int, to: int) -> None:
        """Committed replicate_shard: ADD a replica on `to` (the source
        set keeps serving); lowest holder streams the data over and then
        proposes activation (reference: ReplicateShard, cluster_ops.rs)."""
        try:
            coll = self.toc.get_collection(collection)
        except Exception:
            return
        placed = coll.placement.get(sid)
        if placed is None or to in placed:
            return
        coll.placement[sid] = list(placed) + [to]
        coll.save_config()
        self._materialize_replica_target(coll, collection, sid, to)
        self.attach_replication(collection)
        self._start_stream_transfer(coll, collection, sid, to)

    def _on_replica_drop(self, collection: str, sid: int, peer: int) -> None:
        """Committed drop_replica: remove `peer`'s copy of the shard. The
        last remaining replica is never dropped (validated at the API, and
        re-checked here since ops replay on every peer)."""
        try:
            coll = self.toc.get_collection(collection)
        except Exception:
            return
        placed = coll.placement.get(sid)
        if not placed or peer not in placed or len(placed) <= 1:
            return
        coll.placement[sid] = [p for p in placed if p != peer]
        coll.save_config()
        if peer == self.peer_id and sid in coll.shards:
            import shutil

            shard = coll.shards.pop(sid)
            shard.close()
            coll.replica_sets.pop(sid, None)
            coll.partial_local.discard(sid)
            shutil.rmtree(coll._shard_path(sid), ignore_errors=True)
        self.attach_replication(collection)

    def _on_replica_activate(self, collection: str, sid: int, peer: int) -> None:
        try:
            coll = self.toc.get_collection(collection)
        except Exception:
            return
        rs = coll.replica_sets.get(sid)
        if rs is not None:
            from .replica_set import ReplicaState

            rs.set_replica_state(peer, ReplicaState.ACTIVE)
        if peer == self.peer_id:
            coll.partial_local.discard(sid)
            coll.remote_shards.pop(sid, None)
        elif (
            coll.placement.get(sid)
            and self.peer_id not in coll.placement[sid]
            and sid in coll.shards
        ):
            # move handoff complete: this peer was the source and is no
            # longer in the placement — drop its local copy (reference:
            # move_shard finalize drops the source replica)
            import shutil

            shard = coll.shards.pop(sid)
            shard.close()
            coll.replica_sets.pop(sid, None)
            coll.partial_local.discard(sid)
            shutil.rmtree(coll._shard_path(sid), ignore_errors=True)
            self.attach_replication(collection)

    def add_peer(self, peer_id: int, url: str) -> None:
        """Committed add_peer op: extend transport + raft membership and
        wire the new peer into every replicated collection."""
        if peer_id == self.peer_id:
            return
        self.transport.peer_urls[peer_id] = url
        self.raft.add_peer(peer_id)
        for name in self.toc.list_collections():
            self.attach_replication(name)

    def cluster_info(self) -> dict:
        return {
            "status": "enabled",
            "peer_id": self.peer_id,
            "peers": {
                str(p): {"uri": u} for p, u in self.transport.peer_urls.items()
            },
            "raft_info": {
                "term": self.raft.term,
                "commit": self.raft.commit_index,
                "pending_operations": len(self.raft.log) - self.raft.commit_index,
                "leader": self.raft.leader_id,
                "role": self.raft.role,
                "is_voter": True,
            },
        }
