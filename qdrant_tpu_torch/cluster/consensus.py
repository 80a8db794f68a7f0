"""Consensus manager: committed Raft entries → collection meta operations.

Reference: lib/storage/src/content_manager/consensus_manager.rs
(apply_entries → CollectionMetaOperations, collection_meta_ops.rs:488-511)
and the Dispatcher (dispatcher.rs:25) that routes meta ops through consensus
when a cluster is configured, or straight to the ToC otherwise.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

from ..api.toc import TableOfContent
from .raft import NotLeader, RaftNode


class ConsensusManager:
    """Applies committed metadata operations onto this peer's ToC."""

    def __init__(self, toc: TableOfContent):
        self.toc = toc
        self.applied_ops: List[dict] = []
        self.failed_ops: List[dict] = []  # async op failures (e.g. reshard)
        self.on_collection_created = None  # hook: ClusterNode replication
        self.on_peer_added = None  # hook: ClusterNode membership
        self.on_replica_down = None  # hook: ClusterNode repair driver
        self.on_replica_move = None  # hook: ClusterNode placement move
        self.on_replica_add = None  # hook: ClusterNode replicate (copy)
        self.on_replica_drop = None  # hook: ClusterNode replica removal
        self.on_replica_activate = None  # hook: transfer completion

    def apply(self, op: dict) -> None:
        t = op.get("type")
        try:
            if t == "create_collection":
                placement = {
                    int(k): list(v)
                    for k, v in (op.get("placement") or {}).items()
                } or None
                if not self.toc.has_collection(op["name"]):
                    self.toc.create_collection(
                        op["name"], op.get("spec") or {}, placement=placement
                    )
                    if self.on_collection_created is not None:
                        self.on_collection_created(op["name"])
                elif placement:
                    # single→cluster migration: the originating peer already
                    # holds the collection — it adopts the committed
                    # placement so future moves/repairs see the same map
                    coll = self.toc.get_collection(op["name"])
                    if not coll.placement:
                        coll.placement = placement
                        coll.this_peer_id = getattr(
                            getattr(self.toc, "cluster_node", None),
                            "peer_id",
                            None,
                        )
                        coll.save_config()
                        if self.on_collection_created is not None:
                            self.on_collection_created(op["name"])
            elif t == "update_collection":
                self.toc.update_collection(op["name"], op.get("spec") or {})
            elif t == "delete_collection":
                self.toc.delete_collection(op["name"])
            elif t == "update_aliases":
                self.toc.update_aliases(op.get("actions") or [])
            elif t == "set_quota":
                # cluster-wide resource-limit config (reference: quota
                # config replicated through consensus, lib/storage/quota.rs)
                self.toc.quota.update_config(op.get("config") or {})
            elif t == "create_payload_index":
                from ..types import PayloadIndexParams

                coll = self.toc.get_collection(op["name"])
                coll.create_payload_index(
                    op["field"], PayloadIndexParams.from_dict(op.get("params") or {})
                )
            elif t == "delete_payload_index":
                coll = self.toc.get_collection(op["name"])
                coll.delete_payload_index(op["field"])
            elif t == "set_shard_replica_state":
                # recorded for the replica-set layer to pick up
                pass
            elif t == "replica_down":
                # consensus-confirmed dead replica (reference:
                # collection_meta_ops.rs SetShardReplicaState → Dead):
                # every peer marks it; the leader starts the repair driver
                from .replica_set import ReplicaState

                coll = self.toc.get_collection(op["name"])
                sid, peer = int(op["shard_id"]), int(op["peer_id"])
                rs = coll.replica_sets.get(sid)
                if rs is not None:
                    rs.set_replica_state(peer, ReplicaState.DEAD)
                    rs.locally_disabled.add(peer)
                if self.on_replica_down is not None:
                    self.on_replica_down(op["name"], sid, peer)
            elif t == "move_replica":
                if self.on_replica_move is not None:
                    self.on_replica_move(
                        op["name"],
                        int(op["shard_id"]),
                        int(op["from_peer"]),
                        int(op["to_peer"]),
                    )
            elif t == "replicate_replica":
                # add a replica WITHOUT removing the source (reference:
                # ReplicateShard in collection_meta_ops.rs / cluster_ops.rs)
                if self.on_replica_add is not None:
                    self.on_replica_add(
                        op["name"], int(op["shard_id"]), int(op["to_peer"])
                    )
            elif t == "drop_replica":
                # remove one peer's replica of a shard (reference:
                # DropReplica in cluster_ops.rs)
                if self.on_replica_drop is not None:
                    self.on_replica_drop(
                        op["name"], int(op["shard_id"]), int(op["peer_id"])
                    )
            elif t == "activate_replica":
                if self.on_replica_activate is not None:
                    self.on_replica_activate(
                        op["name"], int(op["shard_id"]), int(op["peer_id"])
                    )
            elif t == "add_peer":
                if self.on_peer_added is not None:
                    self.on_peer_added(int(op["peer_id"]), op["url"])
            elif t == "reshard_collection":
                coll = self.toc.get_collection(op["name"])
                n_new = int(op["new_shard_number"])
                coll.reshard_prepare(n_new)
                if self.on_collection_created is not None:
                    # wire replica sets / remote handles over the new layout
                    # BEFORE moving points, so forwarded moves have routes
                    self.on_collection_created(op["name"])

                # the move waits (with retries) for OTHER peers to apply
                # reshard_prepare — it must not block the raft tick thread
                # (stalled heartbeats would trigger elections mid-reshard)
                def _move(coll=coll, n_new=n_new, name=op["name"]):
                    try:
                        coll.reshard_move(n_new)
                    except Exception as exc:
                        # A silently-dead mover would leave THIS peer on the
                        # old ring while peers that succeeded commit the new
                        # one — routing then diverges cluster-wide. Surface
                        # the failure loudly (reference: resharding driver
                        # aborts + reverts through consensus on error).
                        import logging

                        logging.getLogger(__name__).error(
                            "reshard_move(%s -> %d shards) FAILED on this "
                            "peer; ring state may diverge: %s",
                            name, n_new, exc,
                        )
                        self.failed_ops.append(
                            {"op": "reshard_collection", "name": name,
                             "new_shard_number": n_new, "error": str(exc)}
                        )
                    finally:
                        if self.on_collection_created is not None:
                            self.on_collection_created(name)

                threading.Thread(target=_move, daemon=True).start()
            self.applied_ops.append(op)
        except Exception:
            # a malformed/duplicate committed op must not wedge the state
            # machine — reference behavior: log and continue applying
            self.applied_ops.append({"failed": op})


    # -- state snapshot for raft log compaction --------------------------

    def snapshot_state(self) -> dict:
        """Cluster-metadata snapshot: everything `apply` can affect
        (reference: consensus_manager.rs SnapshotData)."""
        collections = {}
        for name in self.toc.list_collections():
            coll = self.toc.get_collection(name)
            collections[name] = {
                "spec": {
                    "vectors": {
                        n: vp.to_dict() for n, vp in coll.params.vectors.items()
                    },
                    "sparse_vectors": {
                        n: sp.to_dict()
                        for n, sp in (coll.params.sparse_vectors or {}).items()
                    },
                    "shard_number": coll.params.shard_number,
                    "replication_factor": coll.params.replication_factor,
                },
                "placement": {str(k): v for k, v in coll.placement.items()},
            }
        return {"collections": collections, "aliases": dict(self.toc.aliases)}

    def restore_state(self, state: dict) -> None:
        for name, meta in (state.get("collections") or {}).items():
            placement = {
                int(k): list(v)
                for k, v in (meta.get("placement") or {}).items()
            } or None
            if not self.toc.has_collection(name):
                self.toc.create_collection(
                    name, meta.get("spec") or {}, placement=placement
                )
                if self.on_collection_created is not None:
                    self.on_collection_created(name)
            elif placement:
                # a restarted peer catches up via snapshot: its on-disk
                # placement may predate moves committed while it was down —
                # the snapshot's map is the consensus truth, adopt it
                coll = self.toc.get_collection(name)
                if coll.placement != placement:
                    coll.placement = placement
                    coll.save_config()
                    if self.on_collection_created is not None:
                        self.on_collection_created(name)
        for alias, target in (state.get("aliases") or {}).items():
            self.toc.aliases[alias] = target


class Dispatcher:
    """Routes metadata ops: through Raft when clustered, direct otherwise
    (reference: lib/storage/src/dispatcher.rs)."""

    def __init__(
        self,
        toc: TableOfContent,
        raft: Optional[RaftNode] = None,
        manager: Optional[ConsensusManager] = None,
    ):
        self.toc = toc
        self.raft = raft
        self.manager = manager

    def submit(self, op: dict) -> Any:
        if self.raft is None:
            manager = self.manager or ConsensusManager(self.toc)
            manager.apply(op)
            return True
        return self.raft.propose(op)  # NotLeader propagates with leader hint
