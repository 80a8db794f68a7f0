"""Faults of a 3-peer cluster of the port, over HTTP on loopback, on the CPU
(after tests/test_cluster_http.py and tests/test_cluster_faults.py of the
JAX package):

* a peer stopped and restarted from its storage rejoins and serves every
  acknowledged write, and the cluster's replicas hold equal counts;
* replicate_shard and move_shard while writers keep writing end with the new
  replica ACTIVE and every replica of the shard at the same count;
* an aborted transfer drops the half-copied replica, and a later one
  completes;
* start_resharding moves points onto the new shard (`reshard_move`) and every
  point stays readable from every peer.
"""

import threading
import time

import numpy as np
import torch

from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.cluster.node import ClusterNode
from qdrant_tpu_torch.collection.hash_ring import HashRing
from test_torch_cluster import Cluster, call, wait_for

torch.set_num_threads(1)


def _vec(i):
    return [float(i % 97), float(i // 97), 1.0, 0.5]


def _upsert(port, name, ids):
    call(port, "PUT", f"/collections/{name}/points?wait=true",
         {"points": [{"id": i, "vector": _vec(i), "payload": {"i": i}} for i in ids]})


def _counts(c, name, sid):
    """{peer: points} of every peer placed to hold shard `sid`."""
    out = {}
    for peer, t in enumerate(c.tocs, 1):
        if t is None:
            continue
        coll = t.get_collection(name)
        if peer in coll.placement.get(sid, []) and sid in coll.shards:
            out[peer] = coll.shards[sid].point_count()
    return out


def _replicas_agree(c, name):
    """Every shard: the same placement on every live peer, each placed peer
    holds the shard, and all its replicas hold the same count."""
    live = [t for t in c.tocs if t is not None]
    placements = [t.get_collection(name).placement for t in live]
    if any(p != placements[0] for p in placements):
        return False
    for sid, peers in placements[0].items():
        counts = _counts(c, name, sid)
        if sorted(counts) != sorted(p for p in peers if c.tocs[p - 1] is not None):
            return False
        if len(set(counts.values())) != 1:
            return False
    return True


def _writers(c, name, start, n_threads=2):
    """Writers that keep upserting fresh ids through every live peer until
    stopped → (stop event, threads, acknowledged ids)."""
    stop, acked = threading.Event(), []

    def run(w):
        i = 0
        while not stop.is_set():
            pid = start + w * 100_000 + i
            port = c.servers[(w + i) % len(c.servers)].port
            try:
                _upsert(port, name, [pid])
                acked.append(pid)
            except Exception:
                pass  # refused while a route changes: not acknowledged
            i += 1
            time.sleep(0.01)

    threads = [threading.Thread(target=run, args=(w,)) for w in range(n_threads)]
    for t in threads:
        t.start()
    return stop, threads, acked


def test_peer_restart_from_storage_catches_up(tmp_path):
    c = Cluster(tmp_path)
    try:
        leader = c.leader.peer_id
        c.create("rj", {"vectors": {"size": 4, "distance": "Euclid"}, "shard_number": 3,
                        "replication_factor": 2})
        _upsert(c.port(leader), "rj", range(300))
        victim = next(p for p in (1, 2, 3) if p != leader)
        v_port, v_storage = c.port(victim), c.tocs[victim - 1].storage_path
        held = {sid for sid, peers in c.tocs[0].get_collection("rj").placement.items()
                if victim in peers}
        assert held
        c.nodes[victim - 1].stop()
        c.servers[victim - 1].shutdown()
        c.tocs[victim - 1].close()
        c.nodes[victim - 1] = c.servers[victim - 1] = c.tocs[victim - 1] = None

        _upsert(c.port(leader), "rj", range(1000, 1300))  # acknowledged while it is down
        # the failed fan-out confirms the victim's replicas dead, and the leader
        # moves each to the live peer that lacked it (a stream transfer)
        assert wait_for(lambda: all(victim not in peers for peers in
                                    c.tocs[leader - 1].get_collection("rj").placement.values())
                        and _replicas_agree(c, "rj"))

        toc = TableOfContent(v_storage)
        assert sum(s.point_count() for s in toc.get_collection("rj").shards.values()) > 0
        srv = RestServer(toc, port=v_port)
        srv.start_background()
        node = ClusterNode(victim, toc, c.urls, tick_period=c.tick)
        node.start()
        c.tocs[victim - 1], c.servers[victim - 1], c.nodes[victim - 1] = toc, srv, node
        assert wait_for(lambda: node.raft.leader_id is not None
                        and node.raft.commit_index == c.nodes[leader - 1].raft.commit_index
                        and _replicas_agree(c, "rj"))
        for p in (1, 2, 3):
            assert wait_for(lambda p=p: call(c.port(p), "POST", "/collections/rj/points/count",
                                             {})["count"] == 600)
        got = call(v_port, "POST", "/collections/rj/points",
                   {"ids": list(range(1000, 1300)), "with_vector": True})
        assert sorted(r["id"] for r in got) == list(range(1000, 1300))
        assert all(r["vector"] == _vec(r["id"]) for r in got)
    finally:
        c.close()


def _transfer_under_writes(c, name, body, sid, target, start):
    """Run one replicate / move with writers going through every peer while
    the stream is mid-way (held before its second page until 10 writes are
    acknowledged) → the acknowledged ids. The writers begin once the target
    holds the (empty) shard: a write that reaches the target before it has
    applied the op fails there and marks the new replica dead (ROADMAP.md
    queue 3)."""
    from qdrant_tpu_torch.cluster import transfer

    real, mid = transfer.stream_records, threading.Event()

    def held(source, target_replica, batch_size=100, cancel=None):
        pages = [0]

        def gate():
            pages[0] += 1
            if pages[0] == 2:
                mid.wait(30)
            return cancel is not None and cancel()

        return real(source, target_replica, batch_size, cancel=gate)

    transfer.stream_records = held
    stop = None
    try:
        call(c.port(c.leader.peer_id), "POST", f"/collections/{name}/cluster", body)
        assert wait_for(lambda: sid in c.tocs[target - 1].get_collection(name).shards)
        stop, threads, acked = _writers(c, name, start)
        assert wait_for(lambda: len(acked) >= 10)
        mid.set()
        assert wait_for(lambda: target in _counts(c, name, sid)
                        and not any(n.active_transfers for n in c.nodes))
        time.sleep(0.3)  # writes after the transfer
    finally:
        mid.set()
        transfer.stream_records = real
        if stop is not None:
            stop.set()
            for t in threads:
                t.join(timeout=30)
    return acked


def test_replicate_and_move_under_concurrent_writes(tmp_path):
    c = Cluster(tmp_path)
    try:
        leader = c.leader.peer_id
        c.create("tw", {"vectors": {"size": 4, "distance": "Euclid"}, "shard_number": 2})
        _upsert(c.port(leader), "tw", range(2000))
        placement = c.tocs[leader - 1].get_collection("tw").placement
        # replicate shard 0 onto a peer that lacks it
        holder = placement[0][0]
        target = next(p for p in (1, 2, 3) if p not in placement[0])
        acked = _transfer_under_writes(
            c, "tw", {"replicate_shard": {"shard_id": 0, "from_peer_id": holder,
                                          "to_peer_id": target}}, 0, target, 10_000)
        assert sorted(_counts(c, "tw", 0)) == sorted([holder, target])
        # move shard 1 to a peer that lacks it
        src = placement[1][0]
        dst = next(p for p in (1, 2, 3) if p not in placement[1])
        acked += _transfer_under_writes(
            c, "tw", {"move_shard": {"shard_id": 1, "from_peer_id": src, "to_peer_id": dst}},
            1, dst, 500_000)
        assert wait_for(lambda: list(_counts(c, "tw", 1)) == [dst])
        total = 2000 + len(set(acked))
        assert wait_for(lambda: _replicas_agree(c, "tw"))
        rs = c.tocs[holder - 1].get_collection("tw").replica_sets[0]
        assert rs.states[target].value == "Active" and rs.states[holder].value == "Active"
        assert 1 not in c.tocs[src - 1].get_collection("tw").shards
        for p in (1, 2, 3):
            assert wait_for(lambda p=p: call(c.port(p), "POST", "/collections/tw/points/count",
                                             {})["count"] == total)
        for pid in list(set(acked))[:20]:
            assert call(c.port(dst), "GET", f"/collections/tw/points/{pid}")["id"] == pid
    finally:
        c.close()


def test_aborted_transfer_cleans_up(tmp_path):
    c = Cluster(tmp_path)
    try:
        leader = c.leader.peer_id
        c.create("ab", {"vectors": {"size": 4, "distance": "Euclid"}, "shard_number": 2})
        for s in range(0, 12_000, 2000):
            _upsert(c.port(leader), "ab", range(s, s + 2000))
        placement = c.tocs[leader - 1].get_collection("ab").placement
        holder = placement[0][0]
        target = next(p for p in (1, 2, 3) if p not in placement[0])
        n0 = c.tocs[holder - 1].get_collection("ab").shards[0].point_count()
        driver = c.nodes[holder - 1]
        # hold the stream between batches until the abort has been made, so
        # the abort always lands mid-stream
        from qdrant_tpu_torch.cluster import transfer

        gate, real = threading.Event(), transfer.stream_records

        def gated(source, target_replica, batch_size=100, cancel=None):
            def held():
                gate.wait(30)
                return cancel is not None and cancel()
            return real(source, target_replica, batch_size, cancel=held)

        transfer.stream_records = gated
        try:
            call(c.port(leader), "POST", "/collections/ab/cluster",
                 {"replicate_shard": {"shard_id": 0, "from_peer_id": holder,
                                      "to_peer_id": target}})
            assert wait_for(lambda: ("ab", 0, target) in driver.active_transfers)
            out = call(c.port(holder), "POST", "/collections/ab/cluster",
                       {"abort_transfer": {"shard_id": 0, "from_peer_id": holder,
                                           "to_peer_id": target}})
            assert out is True
        finally:
            gate.set()
            transfer.stream_records = real
        assert wait_for(lambda: all(t.get_collection("ab").placement.get(0) == [holder]
                                    for t in c.tocs)
                        and 0 not in c.tocs[target - 1].get_collection("ab").shards
                        and not any(n.active_transfers for n in c.nodes))
        for p in (1, 2, 3):
            assert call(c.port(p), "POST", "/collections/ab/points/count", {})["count"] == 12_000
        call(c.port(leader), "POST", "/collections/ab/cluster",
             {"replicate_shard": {"shard_id": 0, "from_peer_id": holder, "to_peer_id": target}})
        assert wait_for(lambda: _counts(c, "ab", 0) == {holder: n0, target: n0})
    finally:
        c.close()


def test_resharding_moves_points_to_the_new_shard(tmp_path):
    c = Cluster(tmp_path)
    try:
        leader = c.leader.peer_id
        c.create("rs", {"vectors": {"size": 4, "distance": "Euclid"}, "shard_number": 2})
        _upsert(c.port(leader), "rs", range(600))
        before = {sid: sum(_counts(c, "rs", sid).values()) for sid in (0, 1)}
        assert sum(before.values()) == 600
        call(c.port(leader), "POST", "/collections/rs/cluster",
             {"start_resharding": {"direction": "up"}})
        assert wait_for(lambda: all(len(t.get_collection("rs").placement) == 3 for t in c.tocs)
                        and sum(len(t.get_collection("rs").shards) for t in c.tocs) == 3)
        # done when every shard holds exactly the points the new ring routes to it
        ring = HashRing()
        for sid in range(3):
            ring.add(sid)
        routed = np.bincount([ring.get(pid) for pid in range(600)], minlength=3)
        assert 0 < routed[2] < 600
        assert wait_for(lambda: [sum(_counts(c, "rs", s).values()) for s in (0, 1, 2)]
                        == routed.tolist())
        assert not any(n.manager.failed_ops for n in c.nodes)
        rng = np.random.default_rng(0)
        for p in (1, 2, 3):
            assert wait_for(lambda p=p: call(c.port(p), "POST", "/collections/rs/points/count",
                                             {})["count"] == 600)
            for pid in rng.choice(600, 10, replace=False).tolist():
                got = call(c.port(p), "GET", f"/collections/rs/points/{pid}")
                assert got["id"] == pid and got["payload"] == {"i": pid}
    finally:
        c.close()
