"""Raft consensus for cluster METADATA (not point data).

Reference: src/consensus.rs (Consensus thread over raft-rs) +
lib/storage/src/content_manager/consensus_manager.rs and
consensus/persistent.rs. As in the reference, only collection-meta
operations (create/drop collection, shard moves, replica-state changes)
go through consensus — point upserts take the WAL + replica fan-out path.

This is a compact, tick-driven Raft: leader election with randomized
timeouts, log replication with commit on majority match, persistent
(term, voted_for, log) state, and a pluggable transport (in-process queues
for tests — the pattern the reference's consensus tests use with real
processes; an HTTP transport slots in for multi-node deployments).
Single-node clusters bypass elections and commit immediately (reference:
src/main.rs:672-683 single-node mode).

Two raft-rs behaviors the reference relies on are implemented here too:

* **Pre-vote** (raft-rs `pre_vote: true`, enabled by the reference's
  consensus config): before bumping its term, a timed-out node runs a
  non-binding poll at term+1. Only a majority of "would vote for you"
  answers starts a real election — a partitioned node rejoining cannot
  disrupt a stable leader by inflating terms. Pre-vote messages never
  mutate any node's persistent state.
* **Learner state** (raft-rs learners; the reference adds new peers as
  learners until they catch up): a learner receives append_entries and
  snapshots but holds no vote, counts toward no quorum, and never starts
  elections. `promote_learner` flips it to a full voter once caught up.
"""

from __future__ import annotations

import json
import os
import random
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import msgpack

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

ELECTION_TIMEOUT_TICKS = (10, 20)  # randomized range
HEARTBEAT_TICKS = 3


@dataclass
class LogEntry:
    term: int
    index: int
    operation: Any  # metadata operation (dict)

    def to_wire(self) -> dict:
        return {"term": self.term, "index": self.index, "operation": self.operation}

    @staticmethod
    def from_wire(d: dict) -> "LogEntry":
        return LogEntry(d["term"], d["index"], d["operation"])


class RaftNode:
    """One consensus participant.

    transport: send(peer_id, message_dict) — fire and forget.
    apply_fn: called with each committed operation, in log order.
    """

    def __init__(
        self,
        node_id: int,
        peers: List[int],
        transport: Callable[[int, dict], None],
        apply_fn: Callable[[Any], None],
        storage_path: Optional[str] = None,
        seed: Optional[int] = None,
        snapshot_fn: Optional[Callable[[], Any]] = None,
        restore_fn: Optional[Callable[[Any], None]] = None,
        compact_threshold: int = 256,
        learners: Optional[List[int]] = None,
        is_learner: bool = False,
        pre_vote: bool = True,
    ):
        self.node_id = node_id
        self.peers = [p for p in peers if p != node_id]
        # non-voting replication targets (raft-rs learners)
        self.learners = [p for p in (learners or []) if p != node_id]
        self.is_learner = is_learner
        self.pre_vote = pre_vote
        self.transport = transport
        self.apply_fn = apply_fn
        self.storage_path = storage_path
        self._rng = random.Random(seed if seed is not None else node_id * 7919)
        # log compaction (reference: consensus snapshotting via
        # raft-rs Storage::snapshot + src/consensus.rs InstallSnapshot)
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.compact_threshold = compact_threshold

        # persistent state
        self.term = 0
        self.voted_for: Optional[int] = None
        self.log: List[LogEntry] = []
        self.snapshot_index = 0  # last log index folded into the snapshot
        self.snapshot_term = 0

        # volatile
        self.role = FOLLOWER
        self.leader_id: Optional[int] = None
        self.commit_index = 0
        self.last_applied = 0
        self.next_index: Dict[int, int] = {}
        self.match_index: Dict[int, int] = {}
        self.votes: set = set()
        self.prevotes: set = set()
        self._prevote_term = 0  # term the in-flight pre-vote poll targets
        self._ticks_since_heard = 0
        self._ticks_since_heartbeat = 0
        self._election_timeout = self._rng.randint(*ELECTION_TIMEOUT_TICKS)
        self._lock = threading.RLock()

        if storage_path:
            self._load()
        if not self.peers and not self.is_learner:
            self.role = LEADER
            self.leader_id = node_id

    # ------------------------------------------------------------------
    # persistence (reference: consensus/persistent.rs + consensus_wal.rs)
    # ------------------------------------------------------------------

    def _state_file(self) -> str:
        return os.path.join(self.storage_path, "raft_state.json")

    def _log_file(self) -> str:
        return os.path.join(self.storage_path, "raft_log.msgpack")

    def _snapshot_file(self) -> str:
        return os.path.join(self.storage_path, "raft_snapshot.msgpack")

    def _persist(self) -> None:
        if not self.storage_path:
            return
        os.makedirs(self.storage_path, exist_ok=True)
        with open(self._state_file(), "w") as f:
            json.dump(
                {
                    "term": self.term,
                    "voted_for": self.voted_for,
                    "commit_index": self.commit_index,
                    "snapshot_index": self.snapshot_index,
                    "snapshot_term": self.snapshot_term,
                },
                f,
            )
        with open(self._log_file(), "wb") as f:
            f.write(
                msgpack.packb([e.to_wire() for e in self.log], use_bin_type=True)
            )

    def _load(self) -> None:
        try:
            with open(self._state_file()) as f:
                st = json.load(f)
            self.term = st["term"]
            self.voted_for = st.get("voted_for")
            self.commit_index = st.get("commit_index", 0)
            self.snapshot_index = st.get("snapshot_index", 0)
            self.snapshot_term = st.get("snapshot_term", 0)
        except (OSError, json.JSONDecodeError, KeyError):
            return
        if self.snapshot_index and self.restore_fn is not None:
            try:
                with open(self._snapshot_file(), "rb") as f:
                    self.restore_fn(msgpack.unpackb(f.read(), raw=False))
            except OSError:
                pass
        self.last_applied = self.snapshot_index
        try:
            with open(self._log_file(), "rb") as f:
                self.log = [
                    LogEntry.from_wire(e)
                    for e in msgpack.unpackb(f.read(), raw=False)
                ]
        except OSError:
            self.log = []
        # re-apply committed entries on restart
        for entry in self.log:
            if self.last_applied < entry.index <= self.commit_index:
                self.apply_fn(entry.operation)
                self.last_applied = entry.index

    # ------------------------------------------------------------------
    # log helpers
    # ------------------------------------------------------------------

    def _last_log_index(self) -> int:
        return self.log[-1].index if self.log else self.snapshot_index

    def _last_log_term(self) -> int:
        return self.log[-1].term if self.log else self.snapshot_term

    def _entry_at(self, index: int) -> Optional[LogEntry]:
        pos = index - self.snapshot_index - 1
        if 0 <= pos < len(self.log):
            return self.log[pos]
        return None

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def propose(self, operation: Any) -> int:
        """Propose a metadata op; → assigned log index. Must be the leader
        (callers route to leader_id otherwise)."""
        with self._lock:
            if self.role != LEADER:
                raise NotLeader(self.leader_id)
            entry = LogEntry(self.term, self._last_log_index() + 1, operation)
            self.log.append(entry)
            self._persist()
            if not self.peers:  # sole voter: commit immediately
                self._advance_commit(entry.index)
                if self.learners:
                    self._broadcast_append()
            else:
                self._broadcast_append()
            return entry.index

    def tick(self) -> None:
        """Advance timers: candidates/followers count toward election
        timeout; leaders emit heartbeats."""
        with self._lock:
            if self.role == LEADER:
                self._ticks_since_heartbeat += 1
                if self._ticks_since_heartbeat >= HEARTBEAT_TICKS:
                    self._broadcast_append()
            else:
                self._ticks_since_heard += 1
                if self._ticks_since_heard >= self._election_timeout:
                    if self.is_learner:
                        # learners never campaign; just rearm the timer
                        self._ticks_since_heard = 0
                    elif self.pre_vote and self.peers:
                        self._start_prevote()
                    else:
                        self._start_election()

    def receive(self, message: dict) -> None:
        with self._lock:
            t = message["type"]
            # pre-vote traffic is non-binding: it carries term+1 but must
            # never bump any node's real term (the whole point of pre-vote)
            if t not in ("pre_vote", "pre_vote_response") and message["term"] > self.term:
                self.term = message["term"]
                self.voted_for = None
                self.role = FOLLOWER
                self._persist()
            handler = {
                "pre_vote": self._on_pre_vote,
                "pre_vote_response": self._on_prevote_response,
                "request_vote": self._on_request_vote,
                "request_vote_response": self._on_vote_response,
                "append_entries": self._on_append_entries,
                "append_entries_response": self._on_append_response,
                "install_snapshot": self._on_install_snapshot,
            }.get(t)
            if handler:
                handler(message)

    # ------------------------------------------------------------------
    # election
    # ------------------------------------------------------------------

    def _start_prevote(self) -> None:
        """Non-binding poll at term+1; a real election starts only if a
        majority would grant the vote. No persistent state changes."""
        self._prevote_term = self.term + 1
        self.prevotes = {self.node_id}
        self._ticks_since_heard = 0
        self._election_timeout = self._rng.randint(*ELECTION_TIMEOUT_TICKS)
        for peer in self.peers:
            self.transport(
                peer,
                {
                    "type": "pre_vote",
                    "term": self._prevote_term,
                    "candidate": self.node_id,
                    "last_log_index": self._last_log_index(),
                    "last_log_term": self._last_log_term(),
                },
            )
        if len(self.prevotes) >= self._majority():
            self._start_election()

    def _on_pre_vote(self, msg: dict) -> None:
        # grant iff we have no live leader (our own timer has at least
        # reached the minimum election timeout) and the candidate's log is
        # at least as complete as ours; grant changes NO local state
        quiet = (
            self.leader_id is None
            or self._ticks_since_heard >= ELECTION_TIMEOUT_TICKS[0]
        )
        up_to_date = (msg["last_log_term"], msg["last_log_index"]) >= (
            self._last_log_term(),
            self._last_log_index(),
        )
        grant = (
            not self.is_learner
            and msg["term"] > self.term
            and quiet
            and up_to_date
        )
        self.transport(
            msg["candidate"],
            {
                "type": "pre_vote_response",
                "term": msg["term"],
                "voter": self.node_id,
                "granted": grant,
            },
        )

    def _on_prevote_response(self, msg: dict) -> None:
        if (
            self.role == LEADER
            or msg["term"] != self._prevote_term
            or self._prevote_term <= self.term
        ):
            return
        if msg["granted"]:
            self.prevotes.add(msg["voter"])
            if len(self.prevotes) >= self._majority():
                self._prevote_term = 0
                self._start_election()

    def _start_election(self) -> None:
        self.role = CANDIDATE
        self.term += 1
        self.voted_for = self.node_id
        self.votes = {self.node_id}
        self._ticks_since_heard = 0
        self._election_timeout = self._rng.randint(*ELECTION_TIMEOUT_TICKS)
        self._persist()
        for peer in self.peers:
            self.transport(
                peer,
                {
                    "type": "request_vote",
                    "term": self.term,
                    "candidate": self.node_id,
                    "last_log_index": self._last_log_index(),
                    "last_log_term": self._last_log_term(),
                },
            )
        if len(self.votes) >= self._majority():
            self._become_leader()

    def _majority(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    def _on_request_vote(self, msg: dict) -> None:
        grant = False
        if (
            not self.is_learner
            and msg["term"] >= self.term
            and self.voted_for in (None, msg["candidate"])
        ):
            up_to_date = (msg["last_log_term"], msg["last_log_index"]) >= (
                self._last_log_term(),
                self._last_log_index(),
            )
            if up_to_date:
                grant = True
                self.voted_for = msg["candidate"]
                self._ticks_since_heard = 0
                self._persist()
        self.transport(
            msg["candidate"],
            {
                "type": "request_vote_response",
                "term": self.term,
                "voter": self.node_id,
                "granted": grant,
            },
        )

    def _on_vote_response(self, msg: dict) -> None:
        if self.role != CANDIDATE or msg["term"] != self.term:
            return
        if msg["granted"]:
            self.votes.add(msg["voter"])
            if len(self.votes) >= self._majority():
                self._become_leader()

    def _become_leader(self) -> None:
        self.role = LEADER
        self.leader_id = self.node_id
        targets = self.peers + self.learners
        self.next_index = {p: self._last_log_index() + 1 for p in targets}
        self.match_index = {p: 0 for p in targets}
        self._ticks_since_heartbeat = 0
        self._broadcast_append()

    # ------------------------------------------------------------------
    # replication
    # ------------------------------------------------------------------

    def _broadcast_append(self) -> None:
        self._ticks_since_heartbeat = 0
        for peer in self.peers + self.learners:
            self._send_append(peer)

    def _send_append(self, peer: int) -> None:
        nxt = self.next_index.get(peer, self._last_log_index() + 1)
        if nxt <= self.snapshot_index:
            # follower is behind the compacted log — ship the snapshot
            # (reference: raft InstallSnapshot RPC)
            data = self.snapshot_fn() if self.snapshot_fn is not None else None
            self.transport(
                peer,
                {
                    "type": "install_snapshot",
                    "term": self.term,
                    "leader": self.node_id,
                    "snapshot_index": self.snapshot_index,
                    "snapshot_term": self.snapshot_term,
                    "data": data,
                },
            )
            return
        prev_index = nxt - 1
        prev_entry = self._entry_at(prev_index)
        if prev_entry is not None:
            prev_term = prev_entry.term
        elif prev_index == self.snapshot_index:
            prev_term = self.snapshot_term
        else:
            prev_term = 0
        entries = [e.to_wire() for e in self.log[prev_index - self.snapshot_index :]]
        self.transport(
            peer,
            {
                "type": "append_entries",
                "term": self.term,
                "leader": self.node_id,
                "prev_log_index": prev_index,
                "prev_log_term": prev_term,
                "entries": entries,
                "leader_commit": self.commit_index,
            },
        )

    def _on_append_entries(self, msg: dict) -> None:
        if msg["term"] < self.term:
            self.transport(
                msg["leader"],
                {
                    "type": "append_entries_response",
                    "term": self.term,
                    "follower": self.node_id,
                    "success": False,
                    "match_index": 0,
                },
            )
            return
        self.role = FOLLOWER
        self.leader_id = msg["leader"]
        self._ticks_since_heard = 0

        prev_index = msg["prev_log_index"]
        if prev_index > 0 and prev_index != self.snapshot_index:
            prev = self._entry_at(prev_index)
            if prev is None or prev.term != msg["prev_log_term"]:
                self.transport(
                    msg["leader"],
                    {
                        "type": "append_entries_response",
                        "term": self.term,
                        "follower": self.node_id,
                        "success": False,
                        "match_index": 0,
                    },
                )
                return
        # append / overwrite conflicting suffix
        for wire in msg["entries"]:
            entry = LogEntry.from_wire(wire)
            if entry.index <= self.snapshot_index:
                continue  # already folded into our snapshot
            existing = self._entry_at(entry.index)
            if existing is not None and existing.term != entry.term:
                del self.log[entry.index - self.snapshot_index - 1 :]
                existing = None
            if existing is None:
                self.log.append(entry)
        if msg["entries"]:
            self._persist()
        if msg["leader_commit"] > self.commit_index:
            self._apply_up_to(min(msg["leader_commit"], self._last_log_index()))
        self.transport(
            msg["leader"],
            {
                "type": "append_entries_response",
                "term": self.term,
                "follower": self.node_id,
                "success": True,
                "match_index": self._last_log_index(),
            },
        )

    def _on_install_snapshot(self, msg: dict) -> None:
        if msg["term"] < self.term:
            return
        self.role = FOLLOWER
        self.leader_id = msg["leader"]
        self._ticks_since_heard = 0
        if msg["snapshot_index"] <= self.snapshot_index:
            return
        if self.restore_fn is not None and msg.get("data") is not None:
            self.restore_fn(msg["data"])
        self.log = []
        self.snapshot_index = msg["snapshot_index"]
        self.snapshot_term = msg["snapshot_term"]
        self.commit_index = max(self.commit_index, self.snapshot_index)
        self.last_applied = self.snapshot_index
        self._persist()
        if self.storage_path and msg.get("data") is not None:
            with open(self._snapshot_file(), "wb") as f:
                f.write(msgpack.packb(msg["data"], use_bin_type=True))
        self.transport(
            msg["leader"],
            {
                "type": "append_entries_response",
                "term": self.term,
                "follower": self.node_id,
                "success": True,
                "match_index": self.snapshot_index,
            },
        )

    def _on_append_response(self, msg: dict) -> None:
        if self.role != LEADER or msg["term"] != self.term:
            return
        peer = msg["follower"]
        if msg["success"]:
            self.match_index[peer] = max(self.match_index.get(peer, 0), msg["match_index"])
            self.next_index[peer] = self.match_index[peer] + 1
            # commit the highest index replicated on a majority within this term
            for idx in range(self._last_log_index(), self.commit_index, -1):
                entry = self._entry_at(idx)
                if entry is None or entry.term != self.term:
                    continue
                replicated = 1 + sum(
                    1 for p in self.peers if self.match_index.get(p, 0) >= idx
                )
                if replicated >= self._majority():
                    self._advance_commit(idx)
                    break
        else:
            self.next_index[peer] = max(1, self.next_index.get(peer, 1) - 1)
            self._send_append(peer)

    def _advance_commit(self, index: int) -> None:
        self.commit_index = max(self.commit_index, index)
        self._apply_up_to(self.commit_index)
        self._persist()

    def _apply_up_to(self, index: int) -> None:
        self.commit_index = max(self.commit_index, min(index, self._last_log_index()))
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self._entry_at(self.last_applied)
            if entry is not None:
                self.apply_fn(entry.operation)
        self._maybe_compact()
        if self.storage_path:
            self._persist()

    def _maybe_compact(self) -> None:
        """Fold applied entries into a state snapshot once the retained log
        exceeds compact_threshold (reference: consensus log compaction via
        ConsensusManager::snapshot)."""
        if self.snapshot_fn is None:
            return
        if self.last_applied - self.snapshot_index < self.compact_threshold:
            return
        data = self.snapshot_fn()
        boundary = self._entry_at(self.last_applied)
        self.snapshot_term = boundary.term if boundary else self.term
        del self.log[: self.last_applied - self.snapshot_index]
        self.snapshot_index = self.last_applied
        if self.storage_path:
            os.makedirs(self.storage_path, exist_ok=True)
            with open(self._snapshot_file(), "wb") as f:
                f.write(msgpack.packb(data, use_bin_type=True))

    # ------------------------------------------------------------------
    # membership (single-server changes; reference: consensus.rs AddPeer)
    # ------------------------------------------------------------------

    def add_peer(self, peer_id: int) -> None:
        with self._lock:
            if peer_id == self.node_id or peer_id in self.peers:
                return
            self.peers.append(peer_id)
            if self.role == LEADER:
                self.next_index[peer_id] = self._last_log_index() + 1
                self.match_index[peer_id] = 0
                self._send_append(peer_id)

    def remove_peer(self, peer_id: int) -> None:
        with self._lock:
            if peer_id in self.peers:
                self.peers.remove(peer_id)
            if peer_id in self.learners:
                self.learners.remove(peer_id)
            self.next_index.pop(peer_id, None)
            self.match_index.pop(peer_id, None)

    def add_learner(self, peer_id: int) -> None:
        """Register a non-voting replication target (raft-rs learner). The
        reference adds joining peers this way until they replicate the log,
        then promotes them to voters."""
        with self._lock:
            if (
                peer_id == self.node_id
                or peer_id in self.peers
                or peer_id in self.learners
            ):
                return
            self.learners.append(peer_id)
            if self.role == LEADER:
                self.next_index[peer_id] = self._last_log_index() + 1
                self.match_index[peer_id] = 0
                self._send_append(peer_id)

    def promote_learner(self, peer_id: int) -> None:
        """Promote a caught-up learner to a full voter. Promoting self
        (peer_id == node_id) clears the local learner flag so the node can
        campaign and grant votes."""
        with self._lock:
            if peer_id == self.node_id:
                self.is_learner = False
                return
            if peer_id in self.learners:
                self.learners.remove(peer_id)
            if peer_id not in self.peers:
                self.peers.append(peer_id)
                if self.role == LEADER:
                    self.next_index.setdefault(
                        peer_id, self._last_log_index() + 1
                    )
                    self.match_index.setdefault(peer_id, 0)


class NotLeader(Exception):
    def __init__(self, leader_id: Optional[int]):
        super().__init__(f"not the leader; leader is {leader_id}")
        self.leader_id = leader_id
