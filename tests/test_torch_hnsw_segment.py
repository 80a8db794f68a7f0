"""The graph branches of the port's Segment against the JAX Segment (CPU).

Both packages seal the same points (single-device JAX, `QDRANT_TPU_MESH=0`):
the port's seal builds the main graph and one subgraph per payload block; an
`hnsw_ef` search, a search under a block's `must match` filter and the ACORN
gate take the programs the JAX dispatch takes. Graphs built by different
packages are compared by recall@10 against exact (port >= JAX - 0.03); a
segment directory written by the JAX package (`hnsw_*`, `hnsw_block_*`) is
loaded by the port and returns the JAX ids, and the other way round. One REST
search with `params.hnsw_ef` on the CPU server returns 200.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from qdrant_tpu.storage.segment import SearchParams as JaxSearchParams
from qdrant_tpu.storage.segment import Segment as JaxSegment
from qdrant_tpu import types as jt
from qdrant_tpu_torch import types as pt
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.storage import segment as port_segment
from qdrant_tpu_torch.storage.segment import SearchParams, Segment

force_cpu()  # the port on the CPU
# the graph programs are thousands of tiny ops: torch's worker threads only
# contend with the other test workers
torch.set_num_threads(1)

N, D, GROUPS = 1200, 16, 3
FLT = {"must": [{"key": "tenant", "match": {"value": "t2"}}]}
RANGE = {"must": [{"key": "n", "range": {"lt": 360}}]}


def _segment(types, seg_cls, x):
    params = types.CollectionParams(vectors={"": types.VectorParams(
        size=D, distance=types.Distance.EUCLID,
        hnsw_config=types.HnswConfig(m=8, ef_construct=32, full_scan_threshold=100,
                                     payload_m=8))})
    seg = seg_cls(params)
    for i in range(len(x)):
        seg.upsert_point(i + 1, i, {"": x[i]}, {"tenant": f"t{i % GROUPS}", "n": i})
    seg.create_field_index("tenant", types.PayloadIndexParams(
        type=types.PayloadSchemaType.KEYWORD))
    seg.create_field_index("n", types.PayloadIndexParams(type=types.PayloadSchemaType.INTEGER))
    seg.build_indexes()
    return seg


@pytest.fixture(scope="module")
def sealed():
    mp = pytest.MonkeyPatch()
    mp.setenv("QDRANT_TPU_MESH", "0")  # one HnswIndex, not the mesh-sharded flavour
    rng = np.random.default_rng(41)
    centers = rng.uniform(0, 8, size=(32, D)).astype(np.float32)
    x = (centers[rng.integers(0, 32, N)] + rng.standard_normal((N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 32, 24)] + rng.standard_normal((24, D))).astype(np.float32)
    out = {"x": x, "q": q, "jax": _segment(jt, JaxSegment, x), "port": _segment(pt, Segment, x)}
    yield out
    mp.undo()


def _recall(ids, x, q, allowed=None):
    s = -((q[:, None, :] - x[None]) ** 2).sum(-1)
    if allowed is not None:
        s[:, ~allowed] = -np.inf
    truth = np.argsort(-s, axis=1)[:, :10]
    return float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids.tolist(), truth.tolist())]))


def test_seal_builds_graph_and_block_subgraphs(sealed):
    jseg, seg = sealed["jax"], sealed["port"]
    assert set(seg.hnsw) == set(jseg.hnsw) == {""}
    assert set(seg.hnsw_blocks[""]) == set(jseg.hnsw_blocks[""])
    assert len(seg.hnsw_blocks[""]) == GROUPS  # keyword blocks only: `n` yields none
    np.testing.assert_array_equal(seg.hnsw[""].levels, jseg.hnsw[""].levels)
    for key, sub in seg.hnsw_blocks[""].items():
        np.testing.assert_array_equal(sub.levels, jseg.hnsw_blocks[""][key].levels)
        assert sub.build_stats["points"] == N // GROUPS
    usage = seg.memory_usage_bytes()
    assert usage["breakdown"]["hnsw"]["host_bytes"] > 0


def test_hnsw_ef_search_takes_the_graph(sealed):
    jseg, seg, x, q = sealed["jax"], sealed["port"], sealed["x"], sealed["q"]
    main = seg.hnsw[""]
    main.served.clear()
    ref = seg.search_dense("", q, 10)  # default params: the exact scan
    assert not main.served
    np.testing.assert_array_equal(ref[1], np.argsort(
        ((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1)[:, :10])
    s, i = seg.search_dense("", q, 10, params=SearchParams(hnsw_ef=64))
    assert main.served["level"] == 1
    _, ji = jseg.search_dense("", q, 10, params=JaxSearchParams(hnsw_ef=64))
    assert _recall(i, x, q) >= _recall(ji, x, q) - 0.03
    assert _recall(i, x, q) >= 0.9
    exact = -((q[:, None, :] - x[None]) ** 2).sum(-1)
    np.testing.assert_allclose(s, np.take_along_axis(exact, i, 1), rtol=1e-4, atol=1e-4)
    # exact=True beats hnsw_ef, as in the JAX dispatch
    again = seg.search_dense("", q, 10, params=SearchParams(hnsw_ef=64, exact=True))
    np.testing.assert_array_equal(again[1], ref[1])


def test_block_filter_takes_the_subgraph(sealed):
    jseg, seg, x, q = sealed["jax"], sealed["port"], sealed["x"], sealed["q"]
    sub = seg.hnsw_blocks[""][("tenant", repr("t2"))]
    main = seg.hnsw[""]
    sub.served.clear()
    main.served.clear()
    _, i = seg.search_dense("", q, 10, flt=pt.parse_filter(FLT),
                            params=SearchParams(hnsw_ef=64))
    assert sub.served["level"] == 1 and not main.served
    assert (i >= 0).all() and (i % GROUPS == 2).all()
    _, ji = jseg.search_dense("", q, 10, flt=jt.parse_filter(FLT),
                              params=JaxSearchParams(hnsw_ef=64))
    allowed = np.arange(N) % GROUPS == 2
    assert _recall(i, x, q, allowed) >= _recall(ji, x, q, allowed) - 0.03
    assert _recall(i, x, q, allowed) >= 0.9
    # without hnsw_ef (below the crossover) the masked scan answers, exactly
    sub.served.clear()
    _, i = seg.search_dense("", q, 10, flt=pt.parse_filter(FLT))
    assert not sub.served and _recall(i, x, q, allowed) == 1.0


@pytest.mark.parametrize("acorn", [None, False, True], ids=["gate", "disabled", "forced"])
def test_acorn_gate(sealed, acorn):
    """A range filter (no block) matching 30% <= max_selectivity 0.4 fires
    ACORN unless disabled; both packages take the same program."""
    jseg, seg, x, q = sealed["jax"], sealed["port"], sealed["x"], sealed["q"]
    main = seg.hnsw[""]
    main.served.clear()
    _, i = seg.search_dense("", q, 10, flt=pt.parse_filter(RANGE),
                            params=SearchParams(hnsw_ef=64, acorn_enable=acorn))
    assert dict(main.served) == ({"level": 1} if acorn is False else {"acorn": 1})
    got = i[i >= 0]
    assert (got < 360).all()
    _, ji = jseg.search_dense("", q, 10, flt=jt.parse_filter(RANGE),
                              params=JaxSearchParams(hnsw_ef=64, acorn_enable=acorn))
    allowed = np.arange(N) < 360
    assert _recall(i, x, q, allowed) >= _recall(ji, x, q, allowed) - 0.03


def test_cost_model_gates(sealed, monkeypatch):
    seg, q = sealed["port"], sealed["q"]
    main = seg.hnsw[""]
    # a filter matching fewer points than full_scan_threshold: the exact scan
    main.served.clear()
    tiny = pt.parse_filter({"must": [{"key": "n", "range": {"lt": 50}}]})
    _, i = seg.search_dense("", q, 10, flt=tiny, params=SearchParams(hnsw_ef=64))
    assert not main.served and (i[i >= 0] < 50).all()
    # past the crossover row count the graph serves without hnsw_ef
    monkeypatch.setattr(port_segment, "GRAPH_CROSSOVER_ROWS", 1000)  # < N
    seg.search_dense("", q, 10)
    assert main.served["level"] == 1
    

def test_segment_directories_cross_both_ways(sealed, tmp_path):
    jseg, seg, q = sealed["jax"], sealed["port"], sealed["q"]
    params, jparams = SearchParams(hnsw_ef=64), JaxSearchParams(hnsw_ef=64)
    jseg.save(str(tmp_path / "jax"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert "hnsw__default" in names and "hnsw_block__default_0" in names
    loaded = Segment.load(str(tmp_path / "jax"))
    assert set(loaded.hnsw_blocks[""]) == set(jseg.hnsw_blocks[""])
    for flt_spec in (None, FLT, RANGE):
        js, ji = jseg.search_dense(
            "", q, 10, flt=jt.parse_filter(flt_spec) if flt_spec else None, params=jparams)
        ps, pi = loaded.search_dense(
            "", q, 10, flt=pt.parse_filter(flt_spec) if flt_spec else None, params=params)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(ps, js, rtol=1e-5, atol=1e-5)
    seg.save(str(tmp_path / "port"))
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    with open(tmp_path / "port" / "segment.json") as f:
        meta = json.load(f)
    with open(tmp_path / "jax" / "segment.json") as f:
        jmeta = json.load(f)
    assert meta["hnsw"] == jmeta["hnsw"] == [""]
    assert meta["hnsw_blocks"] == jmeta["hnsw_blocks"]
    back = JaxSegment.load(str(tmp_path / "port"))
    for flt_spec in (None, FLT):
        ps, pi = seg.search_dense(
            "", q, 10, flt=pt.parse_filter(flt_spec) if flt_spec else None, params=params)
        js, ji = back.search_dense(
            "", q, 10, flt=jt.parse_filter(flt_spec) if flt_spec else None, params=jparams)
        np.testing.assert_array_equal(ji, pi)
        np.testing.assert_allclose(js, ps, rtol=1e-5, atol=1e-5)


def test_drop_vector_name_drops_its_graphs(sealed, tmp_path):
    seg = sealed["port"]
    seg.save(str(tmp_path))
    copy = Segment.load(str(tmp_path))
    assert copy.hnsw and copy.hnsw_blocks
    copy.drop_vector_name("")
    assert not copy.hnsw and not copy.hnsw_blocks and not copy.dense


def test_rest_search_with_hnsw_ef(tmp_path):
    rng = np.random.default_rng(42)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    toc = TableOfContent(str(tmp_path))
    srv = RestServer(toc, port=0)
    srv.start_background()

    def call(method, path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            assert resp.status == 200
            return json.loads(resp.read())["result"]

    try:
        call("PUT", "/collections/g", {
            "vectors": {"size": 8, "distance": "Cosine"},
            "hnsw_config": {"m": 8, "ef_construct": 32, "full_scan_threshold": 50},
            "optimizers_config": {"indexing_threshold": 200}})
        call("PUT", "/collections/g/points?wait=true", {"points": [
            {"id": i, "vector": x[i].tolist(), "payload": {"n": i}} for i in range(300)]})
        seg, = [s for s in toc.get_collection("g").shards[0].segments if not s.appendable]
        assert seg.hnsw[""].config.m == 8
        hits = call("POST", "/collections/g/points/search",
                    {"vector": x[7].tolist(), "limit": 3, "params": {"hnsw_ef": 64}})
        assert hits[0]["id"] == 7 and abs(hits[0]["score"] - 1.0) < 1e-5
        assert seg.hnsw[""].served["level"] == 1
        hits = call("POST", "/collections/g/points/search", {
            "vector": x[7].tolist(), "limit": 3,
            "params": {"hnsw_ef": 64, "acorn": {"enable": True}},
            "filter": {"must": [{"key": "n", "range": {"gte": 100}}]}})
        assert all(h["id"] >= 100 for h in hits) and len(hits) == 3
        assert seg.hnsw[""].served["acorn"] == 1
    finally:
        srv.shutdown()
        toc.close()
