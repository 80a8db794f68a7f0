"""Cluster mode of the port (qdrant_tpu_torch/cluster/): peers with Raft
metadata consensus, replicated shards and remote search, over real HTTP on
loopback, on the CPU (the kernels' plain versions).

* Parity: a 3-peer cluster of the JAX package and one of the port, each
  with shard_number 3 and replication_factor 2, take the same seeded upserts
  of 16-d Euclid points with payloads; 16 plain and 16 filtered searches
  through a non-leader peer give equal ids (modulo exact ties) and scores
  within 1e-5 relative.
* The scan branch through a remote shard: a peer's shard of 70,000 x 8 rows
  (over SCAN_THRESHOLD, so it takes ScanIndex) searched through the other
  peer, against a numpy brute force.

The entry point is in test_torch_cluster_entry.py, faults (restart, transfers
under writes, abort, resharding) in test_torch_cluster_faults.py. Every file
of these tests runs on one torch thread and waits on generous
deadlines: the peers' Raft ticks, HTTP threads and searches share one
interpreter with other test workers.
"""

import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch

from qdrant_tpu.api.rest import RestServer as JaxRestServer
from qdrant_tpu.api.toc import TableOfContent as JaxToc
from qdrant_tpu.cluster.node import ClusterNode as JaxClusterNode
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.cluster.node import ClusterNode
from qdrant_tpu_torch.device import force_cpu

force_cpu()
torch.set_num_threads(1)

DEADLINE_S = 60.0  # every wait below; a healthy run takes a few seconds


def call(port, method, path, body=None, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.loads(resp.read())
    assert out["status"] == "ok", out
    return out["result"]


def wait_for(pred, seconds=DEADLINE_S, step=0.05):
    deadline = time.time() + seconds
    while time.time() < deadline:
        try:
            if pred():
                return True
        except Exception:
            pass
        time.sleep(step)
    return pred()


class Cluster:
    """Peers 1..n in this process: a TableOfContent, a REST server on an
    ephemeral loopback port and a ClusterNode each."""

    def __init__(self, root, n=3, package="port", tick=0.02):
        toc_cls, srv_cls, node_cls = {
            "port": (TableOfContent, RestServer, ClusterNode),
            "jax": (JaxToc, JaxRestServer, JaxClusterNode),
        }[package]
        self.node_cls, self.tick = node_cls, tick
        self.tocs, self.servers, self.nodes = [], [], []
        for i in range(1, n + 1):
            toc = toc_cls(os.path.join(str(root), f"{package}{i}"))
            srv = srv_cls(toc, port=0)
            srv.start_background()
            self.tocs.append(toc)
            self.servers.append(srv)
        self.urls = {i + 1: f"http://127.0.0.1:{s.port}" for i, s in enumerate(self.servers)}
        for i in range(1, n + 1):
            node = node_cls(i, self.tocs[i - 1], self.urls, tick_period=tick)
            node.start()
            self.nodes.append(node)
        assert wait_for(lambda: len([n for n in self.nodes if n.raft.role == "leader"]) == 1
                        and all(n.raft.leader_id is not None for n in self.nodes)), \
            "no leader elected over HTTP"

    @property
    def leader(self):
        return next(n for n in self.nodes if n.raft.role == "leader")

    def port(self, peer_id):
        return self.servers[peer_id - 1].port

    def create(self, name, spec):
        call(self.port(self.leader.peer_id), "PUT", f"/collections/{name}", spec)
        assert wait_for(lambda: all(t.has_collection(name) for t in self.tocs
                                    if t is not None))

    def close(self):
        for n in self.nodes:
            if n is not None:
                n.stop()
        for s in self.servers:
            if s is not None:
                s.shutdown()
        for t in self.tocs:
            if t is not None:
                t.close()


def _points(x):
    return [{"id": i, "vector": x[i].tolist(), "payload": {"n": i, "group": "a" if i % 10 == 0 else "b"}}
            for i in range(len(x))]


def _same_ids(hits_a, hits_b, rtol):
    """Equal ids where the scores are not tied, scores within rtol."""
    sa = np.array([h["score"] for h in hits_a])
    sb = np.array([h["score"] for h in hits_b])
    assert len(sa) == len(sb)
    np.testing.assert_allclose(sa, sb, rtol=rtol)
    ia = [h["id"] for h in hits_a]
    ib = [h["id"] for h in hits_b]
    for j, (a, b) in enumerate(zip(ia, ib)):
        if a != b:  # only a tie may swap two ids
            assert any(abs(sa[j] - sa[m]) <= rtol * abs(sa[j]) for m in range(len(sa)) if m != j), \
                (j, ia, ib)


def test_three_peer_parity_with_jax(tmp_path):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    q = rng.standard_normal((16, 16)).astype(np.float32)
    spec = {"vectors": {"size": 16, "distance": "Euclid"}, "shard_number": 3,
            "replication_factor": 2, "write_consistency_factor": 1}
    answers = {}
    for package in ("jax", "port"):
        c = Cluster(tmp_path, package=package)
        try:
            c.create("par", spec)
            leader = c.leader.peer_id
            other = next(p for p in (1, 2, 3) if p != leader)
            pts = _points(x)
            for s in range(0, len(pts), 500):
                call(c.port(other), "PUT", "/collections/par/points?wait=true",
                     {"points": pts[s: s + 500]})
            placement = c.tocs[0].get_collection("par").placement
            assert sorted(len(set(p)) for p in placement.values()) == [2, 2, 2]
            held = sum(s.point_count() for t in c.tocs
                       for s in t.get_collection("par").shards.values())
            assert held == 2 * len(x)  # every point on both of its replicas
            flt = {"must": [{"key": "group", "match": {"value": "a"}}]}
            answers[package] = [
                [call(c.port(other), "POST", "/collections/par/points/search",
                      {"vector": qi.tolist(), "limit": 10, "with_payload": True,
                       **({"filter": flt} if f else {})}) for qi in q]
                for f in (False, True)
            ]
        finally:
            c.close()
    for plain_or_filtered in (0, 1):
        for ha, hb in zip(answers["jax"][plain_or_filtered], answers["port"][plain_or_filtered]):
            assert len(hb) == 10
            _same_ids(ha, hb, 1e-5)
    assert all(h["payload"]["group"] == "a" for hits in answers["port"][1] for h in hits)
    # the port's answers are the exact neighbours
    for qi, hits in zip(q, answers["port"][0]):
        d = np.sqrt(((x - qi) ** 2).sum(1))
        np.testing.assert_allclose([h["score"] for h in hits], np.sort(d)[:10], rtol=1e-5)


def test_remote_shard_takes_the_scan_branch(tmp_path):
    """Two peers, two shards of one replica each (a single replicated shard
    would be read locally by both): peer 2's shard holds 70,000 x 8 rows and
    peer 1 reaches it only through its RemoteShardHandle; the remote search
    runs ScanIndex (its plain version here) and matches a numpy brute force."""
    from qdrant_tpu_torch.cluster.remote import RemoteReplica
    from qdrant_tpu_torch.index.plain import SCAN_THRESHOLD

    c = Cluster(tmp_path, n=2)
    try:
        c.create("scan", {"vectors": {"size": 8, "distance": "Euclid"}, "shard_number": 2,
                          "optimizers_config": {"indexing_threshold": 10**9}})
        coll2 = c.tocs[1].get_collection("scan")
        assert wait_for(lambda: coll2.placement == {0: [1], 1: [2]})
        # each peer applies the placement from the consensus log on its own
        assert wait_for(lambda: 1 in c.tocs[0].get_collection("scan").remote_shards)
        ids = [i for i in range(160_000) if coll2._route_sid(i) == 1][:70_000]
        assert len(ids) == 70_000 >= SCAN_THRESHOLD
        rng = np.random.default_rng(3)
        x = rng.standard_normal((len(ids), 8)).astype(np.float32)
        coll2.shards[1].bulk_ingest(ids, {"": x}, None)
        q = rng.standard_normal((4, 8)).astype(np.float32)
        calls = []
        real = RemoteReplica.search_dense

        def counted(self, *a, **k):
            calls.append(self.base_url)
            return real(self, *a, **k)

        RemoteReplica.search_dense = counted
        try:
            got = [call(c.port(1), "POST", "/collections/scan/points/search",
                        {"vector": qi.tolist(), "limit": 10}) for qi in q]
        finally:
            RemoteReplica.search_dense = real
        assert calls and set(calls) == {c.urls[2]}
        store = coll2.shards[1].segments[0].dense[""]
        assert len(store) == 70_000 and store._scan is not None  # ScanIndex built
        ids_arr = np.asarray(ids)
        for qi, hits in zip(q, got):
            d = np.sqrt(((x - qi) ** 2).sum(1))
            order = np.argsort(d)[:10]
            assert [h["id"] for h in hits] == ids_arr[order].tolist()
            np.testing.assert_allclose([h["score"] for h in hits], d[order], rtol=1e-5)
    finally:
        c.close()
