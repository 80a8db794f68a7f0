"""Port parity through REST: the port's server (qdrant_tpu_torch) and the JAX
one (qdrant_tpu), both on the CPU on ephemeral ports, receive the same
creates, upserts, deletes and a bulk_ingest of 65,536 x 32 (the scan
threshold), then answer the same filtered and unfiltered searches.

The JAX side runs its TPU path with the Pallas kernel in interpret mode (its
TPU probe and `pallas_scan_rescore` are patched for that, single-device), so
both packages keep the same survivors: 4,096-row blocks, 16 slots.
Tolerance: ids are equal, and scores agree within 1e-4 relative (the f32
rescore sums in a different order).
"""

import functools
import json
import urllib.request

import numpy as np
import pytest

import qdrant_tpu.ops.pallas_scan as pallas_scan
from qdrant_tpu.api.rest import RestServer as JaxRestServer
from qdrant_tpu.api.toc import TableOfContent as JaxToc
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.device import force_cpu

force_cpu()  # the port on the CPU, with the kernels' plain versions

N, D = 65536, 32
NEVER = {"indexing_threshold": 10**9}  # keep both engines on the exact path


def call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=300) as resp:
        out = json.loads(resp.read())
    assert out["status"] == "ok", out
    return out["result"]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("QDRANT_TPU_MESH", "0")
    mp.setattr(pallas_scan, "is_tpu_backend", lambda: True)
    mp.setattr(pallas_scan, "pallas_scan_rescore",
               functools.partial(pallas_scan.pallas_scan_rescore, interpret=True))
    out = []
    for toc_cls, srv_cls, name in ((JaxToc, JaxRestServer, "jax"),
                                   (TableOfContent, RestServer, "port")):
        toc = toc_cls(str(tmp_path_factory.mktemp(name)))
        srv = srv_cls(toc, port=0)
        srv.start_background()
        out.append((toc, srv))
    rng = np.random.default_rng(21)
    x = rng.standard_normal((N, D)).astype(np.float32)
    small = rng.standard_normal((300, 16)).astype(np.float32)
    for toc, srv in out:
        p = srv.port
        call(p, "PUT", "/collections/big",
             {"vectors": {"size": D, "distance": "Euclid"}, "optimizers_config": NEVER})
        call(p, "PUT", "/collections/big/index", {"field_name": "g", "field_schema": "keyword"})
        call(p, "PUT", "/collections/big/points?wait=true", {"points": [
            {"id": 10**6 + i, "vector": x[i].tolist(), "payload": {"g": "up"}}
            for i in range(40)
        ]})
        toc.get_collection("big").bulk_ingest(
            list(range(N)), {"": x}, [{"g": str(i % 10)} for i in range(N)])
        call(p, "POST", "/collections/big/points/delete?wait=true",
             {"points": list(range(0, 400, 3))})
        call(p, "PUT", "/collections/small",
             {"vectors": {"size": 16, "distance": "Dot"}, "optimizers_config": NEVER})
        call(p, "PUT", "/collections/small/points?wait=true", {"points": [
            {"id": i, "vector": small[i].tolist(), "payload": {"odd": i % 2 == 1}}
            for i in range(300)
        ]})
    yield [srv.port for _, srv in out], x, [toc for toc, _ in out]
    for toc, srv in out:
        srv.shutdown()
        toc.close()
    mp.undo()


def _same_hits(a, b):
    assert [h["id"] for h in a] == [h["id"] for h in b]
    for ha, hb in zip(a, b):
        assert abs(ha["score"] - hb["score"]) <= 1e-4 * max(1.0, abs(hb["score"]))
        assert ha.get("payload") == hb.get("payload")


QUERIES = np.random.default_rng(22).standard_normal((6, D)).astype(np.float32)


@pytest.mark.parametrize(
    "body",
    [
        {"limit": 10},
        {"limit": 5, "with_payload": True,
         "filter": {"must": [{"key": "g", "match": {"value": "3"}}]}},
        {"limit": 7, "filter": {"must_not": [{"key": "g", "match": {"value": "up"}}]}},
    ],
    ids=["unfiltered", "filtered", "must_not"],
)
def test_big_collection_search_matches_jax(servers, body):
    (jax_port, port), x, _ = servers
    for q in QUERIES:
        req = {"vector": q.tolist(), **body}
        a = call(port, "POST", "/collections/big/points/search", req)
        b = call(jax_port, "POST", "/collections/big/points/search", req)
        assert len(a) == body["limit"]
        _same_hits(a, b)
        assert not {h["id"] for h in a} & set(range(0, 400, 3))  # deleted


def test_big_collection_query_and_batch_match_jax(servers):
    (jax_port, port), _, _ = servers
    q = QUERIES[0].tolist()
    a = call(port, "POST", "/collections/big/points/query", {"query": q, "limit": 4})
    b = call(jax_port, "POST", "/collections/big/points/query", {"query": q, "limit": 4})
    _same_hits(a["points"], b["points"])
    batch = {"searches": [{"vector": v.tolist(), "limit": 3} for v in QUERIES[:4]]}
    ra = call(port, "POST", "/collections/big/points/search/batch", batch)
    rb = call(jax_port, "POST", "/collections/big/points/search/batch", batch)
    for a, b in zip(ra, rb):
        _same_hits(a, b)


@pytest.mark.parametrize("flt", [None, {"must": [{"key": "odd", "match": {"value": True}}]}],
                         ids=["unfiltered", "filtered"])
def test_small_collection_search_matches_jax(servers, flt):
    (jax_port, port), _, _ = servers
    rng = np.random.default_rng(23)
    for q in rng.standard_normal((4, 16)):
        req = {"vector": q.tolist(), "limit": 8, "filter": flt, "with_payload": True}
        a = call(port, "POST", "/collections/small/points/search", req)
        b = call(jax_port, "POST", "/collections/small/points/search", req)
        _same_hits(a, b)


def test_counts_and_info_match_jax(servers):
    (jax_port, port), _, _ = servers
    for coll in ("big", "small"):
        a = call(port, "POST", f"/collections/{coll}/points/count", {"exact": True})
        b = call(jax_port, "POST", f"/collections/{coll}/points/count", {"exact": True})
        assert a == b
        ia = call(port, "GET", f"/collections/{coll}")
        ib = call(jax_port, "GET", f"/collections/{coll}")
        assert ia["points_count"] == ib["points_count"]
        assert ia["config"]["params"] == ib["config"]["params"]


def test_both_engines_took_the_fused_scan(servers):
    ports, _, (jax_toc, toc) = servers
    for p in ports:  # one search of its own, so the test needs no other
        call(p, "POST", "/collections/big/points/search",
             {"vector": QUERIES[0].tolist(), "limit": 3})
    for t in (jax_toc, toc):
        seg = t.get_collection("big").shards[0].segments[0]
        assert seg.dense[""]._scan is not None
    assert jax_toc.get_collection("big").shards[0].segments[0].dense[""]._scan.use_pallas
