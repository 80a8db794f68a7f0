"""Multivectors (ColBERT max-sim) in the port against the JAX package (CPU).

The same numpy token matrices, made from a seed, go into both packages:

* `MultiVectorStore`: flat rows, ranges, deleted flags and `padded_block()`
  equal exactly, after set / delete, and each package reads the other's
  files.
* `score_multivector_maxsim` for Dot, Cosine, Euclid and Manhattan, with
  points without tokens and invalid points: -inf in the same places, other
  scores within 1e-5 relative (another summation order over query tokens);
  chunked over points as it is unchunked.
* The pooled proxy rows equal JAX's bit for bit.
* `Segment.search_multi` brute (below `full_scan_threshold`) and through the
  pooled graph: ids equal modulo ties, scores within 1e-5; with the JAX graph
  carried across by `convert`, the graph proposes the same candidates.
* The Collection / REST surface: query, filtered query, retrieval, update,
  delete, restart, on both servers with the same answers; a JAX-written
  multivector segment directory (graph included) loads in the port and
  answers the same, and the reverse.
* A graph built by each package over the same clustered documents: recall@10
  against exact max-sim within 0.03 of the other.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from qdrant_tpu.api.rest import RestServer as JaxRestServer
from qdrant_tpu.api.toc import TableOfContent as JaxToc
from qdrant_tpu.ops.distances import score_multivector_maxsim as jax_maxsim
from qdrant_tpu.storage.segment import Segment as JaxSegment
from qdrant_tpu.storage.vectors import MultiVectorStore as JaxMultiVectorStore
from qdrant_tpu.storage.vectors import PooledMultiVectorStore as JaxPooled
from qdrant_tpu.types import CollectionParams as JaxParams
from qdrant_tpu.types import Datatype as JaxDatatype
from qdrant_tpu.types import Distance as JaxDistance
from qdrant_tpu.types import parse_filter as jax_parse_filter
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.convert import hnsw_index_from_jax, multivector_from_jax
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.ops import distances as port_distances
from qdrant_tpu_torch.ops.distances import score_multivector_maxsim
from qdrant_tpu_torch.storage.segment import Segment
from qdrant_tpu_torch.storage.vectors import MultiVectorStore, PooledMultiVectorStore
from qdrant_tpu_torch.types import CollectionParams, Datatype, Distance, parse_filter

force_cpu()  # the port on the CPU
# the graph programs are thousands of tiny ops: torch's worker threads only
# contend with the other test workers
torch.set_num_threads(1)

DISTANCES = ["Dot", "Cosine", "Euclid", "Manhattan"]


def docs_around_topics(rng, n, d, n_topics, tmin=2, tmax=6, spread=0.1):
    """Token matrices scattered around topic centres (each document's base
    row near its topic, its tokens near its base) → list of [t, d] f32."""
    centres = rng.standard_normal((n_topics, d)).astype(np.float32)
    topic = rng.integers(0, n_topics, n)
    docs = []
    for i in range(n):
        base = centres[topic[i]] + 0.5 * rng.standard_normal(d).astype(np.float32)
        t = int(rng.integers(tmin, tmax + 1))
        docs.append(base[None, :] + spread * rng.standard_normal((t, d)).astype(np.float32))
    return docs


def query_near(rng, doc, t=4, noise=0.05):
    pick = rng.integers(0, len(doc), t)
    return doc[pick] + noise * rng.standard_normal((t, doc.shape[1])).astype(np.float32)


def exact_maxsim(q, docs, distance):
    """Numpy max-sim of one query against every document, independent of
    both packages (cosine tokens normalised here)."""
    def norm(a):
        return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-30)

    out = np.empty(len(docs))
    qq = norm(q) if distance == "Cosine" else q
    for i, doc in enumerate(docs):
        v = norm(doc) if distance == "Cosine" else doc
        if distance in ("Dot", "Cosine"):
            sims = qq @ v.T
        elif distance == "Euclid":
            sims = -((qq[:, None, :] - v[None]) ** 2).sum(-1)
        else:
            sims = -np.abs(qq[:, None, :] - v[None]).sum(-1)
        out[i] = sims.max(axis=1).sum()
    return out


def params_pair(distance="Cosine", threshold=None, m=8, ef=64, datatype=None):
    vp = {"size": 0, "distance": distance, "multivector_config": {"comparator": "max_sim"}}
    if threshold is not None:
        vp["hnsw_config"] = {"m": m, "ef_construct": ef, "full_scan_threshold": threshold}
    if datatype:
        vp["datatype"] = datatype
    return lambda d: (
        CollectionParams.from_dict({"vectors": {"": {**vp, "size": d}}}),
        JaxParams.from_dict({"vectors": {"": {**vp, "size": d}}}),
    )


def seg_pair(docs, distance="Cosine", threshold=None, payloads=None):
    port_p, jax_p = params_pair(distance, threshold)(docs[0].shape[1])
    port, jax = Segment(port_p), JaxSegment(jax_p)
    for i, doc in enumerate(docs):
        payload = payloads[i] if payloads else None
        port.upsert_point(i + 1, i, {"": doc}, payload)
        jax.upsert_point(i + 1, i, {"": doc}, payload)
    return port, jax


def assert_same_hits(port, jax, rtol=1e-5):
    """(scores, ids) [B, k] of both packages: -1 / -inf in the same places,
    scores within rtol, ids equal wherever the score is not tied."""
    (ps, pi), (js, ji) = port, jax
    np.testing.assert_array_equal(pi < 0, ji < 0)
    live = pi >= 0
    np.testing.assert_allclose(ps[live], js[live], rtol=rtol, atol=rtol * np.abs(js[live]).max(initial=1.0))
    for row in range(pi.shape[0]):
        for col in np.flatnonzero(pi[row] != ji[row]):
            tied = np.isclose(js[row], js[row, col], rtol=rtol)
            assert pi[row, col] in ji[row][tied], (row, col, pi[row], ji[row])


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance,datatype", [("Cosine", "Float32"), ("Dot", "BFloat16"),
                                               ("Euclid", "Float32")])
def test_store_and_padded_block_match_jax(tmp_path, distance, datatype):
    rng = np.random.default_rng(1)
    d = 8
    port = MultiVectorStore(d, Distance(distance), Datatype(datatype.lower()))
    jax = JaxMultiVectorStore(d, JaxDistance(distance), JaxDatatype(datatype.lower()))
    mats = [rng.standard_normal((int(t), d)).astype(np.float32) for t in rng.integers(1, 12, 40)]
    mats[7] = np.zeros((0, d), np.float32)  # a point without tokens
    for store in (port, jax):
        np.testing.assert_array_equal(store.add(mats[:25]), np.arange(25))
        for m in mats[25:]:
            store.add([m])
        store.set(3, mats[30][:2])
        store.delete(11)
        store.delete(11)
    assert port.max_tokens == jax.max_tokens and port.deleted_count == jax.deleted_count == 1

    def host(store):
        return (store._flat[: store._flat_count], store._ranges[: len(store)],
                store._deleted[: len(store)])

    def block(store):
        return [np.asarray(torch.as_tensor(a).float()) if isinstance(a, torch.Tensor)
                else np.asarray(a, dtype=np.float32 if a.dtype != bool else bool)
                for a in store.padded_block()]

    for a, b in zip(host(port), host(jax)):
        np.testing.assert_array_equal(a, b)
    tokens, tmask, valid = port.padded_block()
    assert tokens.shape[1] % 8 == 0 and tokens.dtype == (
        torch.bfloat16 if datatype == "BFloat16" else torch.float32)
    for a, b in zip(block(port), block(jax)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.get(3), jax.get(3))

    jax.save(str(tmp_path / "j"))
    port.save(str(tmp_path / "p"))
    back = MultiVectorStore.load(str(tmp_path / "j"), d, Distance(distance),
                                 Datatype(datatype.lower()))
    there = JaxMultiVectorStore.load(str(tmp_path / "p"), d, JaxDistance(distance),
                                     JaxDatatype(datatype.lower()))
    for a, b in zip(block(back), block(jax)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(block(there), block(port)):
        np.testing.assert_array_equal(a, b)
    carried = multivector_from_jax(jax)
    for a, b in zip(host(carried), host(jax)):
        np.testing.assert_array_equal(a, b)
    mem = port.memory_usage_bytes()
    assert mem["host_bytes"] > 0 and mem["device_bytes"] > 0


def test_pooled_proxy_matches_jax():
    rng = np.random.default_rng(2)
    d = 12
    docs = docs_around_topics(rng, 300, d, 10)
    docs[5] = np.zeros((0, d), np.float32)
    port = MultiVectorStore(d, Distance.COSINE)
    jax = JaxMultiVectorStore(d, JaxDistance.COSINE)
    for store in (port, jax):
        store.add(docs)
        store.set(9, docs[20])
        store.delete(4)
    pp, jp = PooledMultiVectorStore(port), JaxPooled(jax)
    np.testing.assert_array_equal(pp.host_array, jp.host_array)
    np.testing.assert_array_equal(pp.deleted_mask, jp.deleted_mask)
    rows, mask = pp.device_block()
    jrows, jmask = jp.device_block()
    assert rows.shape == jrows.shape
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(pp.get_batch(np.array([9, 5])), jp.get_batch(np.array([9, 5])))


# ---------------------------------------------------------------------------
# max-sim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance", DISTANCES)
def test_maxsim_matches_jax(monkeypatch, distance):
    rng = np.random.default_rng(3)
    n, s, d, t = 50, 8, 16, 5
    tokens = rng.standard_normal((n, s, d)).astype(np.float32)
    tmask = np.arange(s)[None, :] < rng.integers(0, s + 1, n)[:, None]
    tmask[0] = False  # a point without tokens
    valid = rng.random(n) < 0.8
    q = rng.standard_normal((t, d)).astype(np.float32)
    want = np.asarray(jax_maxsim(q, tokens, tmask, distance, valid))
    args = (torch.from_numpy(q), torch.from_numpy(tokens), torch.from_numpy(tmask),
            distance, torch.from_numpy(valid))
    got = score_multivector_maxsim(*args).numpy()
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    assert not finite[0] and not finite[~valid].any()
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5,
                               atol=1e-5 * np.abs(want[finite]).max())
    # the same, chunked a few points at a time
    monkeypatch.setattr(port_distances, "MAXSIM_CHUNK_BYTES", 7 * s * 4 * t * d)
    np.testing.assert_array_equal(score_multivector_maxsim(*args).numpy(), got)
    unmasked = score_multivector_maxsim(*args[:4]).numpy()
    np.testing.assert_array_equal(unmasked[valid], got[valid])


# ---------------------------------------------------------------------------
# Segment.search_multi
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance", DISTANCES)
def test_search_multi_brute_matches_jax(distance):
    rng = np.random.default_rng(4)
    docs = docs_around_topics(rng, 120, 8, 6)
    payloads = [{"g": "a" if i % 3 == 0 else "b"} for i in range(len(docs))]
    port, jax = seg_pair(docs, distance, payloads=payloads)
    for seg in (port, jax):
        seg.delete_point(1000, 5)
        seg.update_vectors(1001, 6, {"": docs[40]})
    flt = {"must": [{"key": "g", "match": {"value": "a"}}]}
    for qi in (0, 6, 40, 77):
        q = query_near(rng, docs[qi])
        assert_same_hits(port.search_multi("", q, 7), jax.search_multi("", q, 7))
        got = port.search_multi("", q, 7, parse_filter(flt))
        assert_same_hits(got, jax.search_multi("", q, 7, jax_parse_filter(flt)))
        assert all(i % 3 == 0 for i in got[1][0] if i >= 0)
    q = query_near(rng, docs[0])
    s, i = port.search_multi("", q, 200)  # more than the live points: padded
    assert (i[0, 119:] == -1).all() and 5 not in i[0]
    want = exact_maxsim(q, docs[:6] + [docs[40]] + docs[7:], distance)
    want[5] = -np.inf
    top = np.sort(want)[::-1][:10]  # euclid's 2q·v - |q|² - |v|² cancels near 0
    np.testing.assert_allclose(s[0, :10], top, rtol=1e-5, atol=1e-5 * np.abs(top).max())


def test_mixed_segment_writes_match_jax():
    """A segment with a dense and a multi vector: bulk loads give the multi
    store deleted placeholders, a multi vector name is added and dropped
    live, vectors are deleted one name at a time, in step with the JAX
    segment."""
    rng = np.random.default_rng(9)
    spec = {"vectors": {"": {"size": 4, "distance": "Dot"},
                        "colbert": {"size": 6, "distance": "Cosine",
                                    "multivector_config": {"comparator": "max_sim"}}}}
    segs = [Segment(CollectionParams.from_dict(spec)), JaxSegment(JaxParams.from_dict(spec))]
    x = rng.standard_normal((5, 4)).astype(np.float32)
    docs = [rng.standard_normal((3, 6)).astype(np.float32) for _ in range(3)]
    extra = CollectionParams.from_dict({"vectors": {"e": {
        "size": 6, "distance": "Dot", "multivector_config": {"comparator": "max_sim"}}}})
    out = []
    for seg, params in zip(segs, (extra, JaxParams.from_dict(extra.to_dict()))):
        seg.bulk_ingest(1, list(range(5)), {"": x})
        for i, doc in enumerate(docs):
            seg.upsert_point(2 + i, 10 + i, {"": x[i], "colbert": doc})
        seg.add_vector_name("e", params.vectors["e"])
        seg.upsert_point(9, 20, {"e": docs[0], "colbert": docs[1]})
        seg.delete_vectors(10, 11, ["colbert"])
        q = docs[1][:2]
        out.append((seg.total_offsets, len(seg.multi["colbert"]), len(seg.multi["e"]),
                    sorted(seg.get_vectors(20)), sorted(seg.get_vectors(3)),
                    seg.search_multi("colbert", q, 4)[1].tolist(),
                    seg.search_multi("e", q, 2)[1].tolist(),
                    seg._has_vector("colbert", 11), seg._has_vector("colbert", 10)))
        assert "multi" in seg.memory_usage_bytes()["breakdown"]
        seg.drop_vector_name("e")
        assert "e" not in seg.multi and "e" not in seg.params.vectors
    assert out[0] == out[1]
    # point 20 (offset 8) holds docs[1]; point 11 (offset 6) lost its colbert
    assert out[0][:3] == (9, 9, 9) and out[0][5][0][0] == 8 and 6 not in out[0][5][0]


def test_search_multi_graph_with_carried_graph_matches_jax(monkeypatch):
    monkeypatch.setenv("QDRANT_TPU_DEVICE_BUILD", "force")
    rng = np.random.default_rng(5)
    docs = docs_around_topics(rng, 400, 16, 12)
    payloads = [{"g": "a" if i % 4 == 0 else "b"} for i in range(len(docs))]
    port, jax = seg_pair(docs, "Cosine", threshold=100, payloads=payloads)
    jax.build_indexes()
    jgraph = jax.hnsw_multi[""]
    port.multi[""] = multivector_from_jax(jax.multi[""])
    port.hnsw_multi[""] = hnsw_index_from_jax(jgraph, PooledMultiVectorStore(port.multi[""]))
    flt = {"must": [{"key": "g", "match": {"value": "a"}}]}
    for qi in (3, 42, 128, 300):
        q = query_near(rng, docs[qi])
        pooled = q.mean(axis=0, keepdims=True)
        for pf, jf in ((None, None), (parse_filter(flt), jax_parse_filter(flt))):
            mask = port.alive_mask() if pf is None else port.alive_mask() & port.filter_mask(pf)
            np.testing.assert_array_equal(
                port.hnsw_multi[""].search(pooled, 64, filter_mask=mask)[1],
                jgraph.search(pooled, 64, filter_mask=mask)[1])
            got = port.search_multi("", q, 10, pf)
            assert_same_hits(got, jax.search_multi("", q, 10, jf))
            if pf is None:
                assert got[1][0, 0] == qi
            else:
                assert all(i % 4 == 0 for i in got[1][0] if i >= 0)


def test_graph_recall_within_003_of_jax(monkeypatch):
    """Each package builds its own pooled graph over the same documents."""
    monkeypatch.setenv("QDRANT_TPU_DEVICE_BUILD", "force")
    rng = np.random.default_rng(6)
    # tokens spread wide around each base row: the pooled row is a rough
    # proxy, so the graph misses some of the max-sim top ten
    docs = docs_around_topics(rng, 800, 16, 200, spread=0.8)
    port, jax = seg_pair(docs, "Cosine", threshold=100)
    port.build_indexes()
    jax.build_indexes()
    assert port.hnsw_multi[""].build_stats["device_build"] is True
    recalls = {"port": [], "jax": []}
    for qi in rng.integers(0, len(docs), 24):
        q = query_near(rng, docs[qi], noise=0.5)
        truth = set(np.argsort(-exact_maxsim(q, docs, "Cosine"), kind="stable")[:10].tolist())
        for name, seg in (("port", port), ("jax", jax)):
            ids = seg.search_multi("", q, 10)[1][0]
            recalls[name].append(len(truth & set(ids.tolist())) / 10)
    r_port, r_jax = np.mean(recalls["port"]), np.mean(recalls["jax"])
    assert abs(r_port - r_jax) <= 0.03, (r_port, r_jax)
    assert 0.9 <= r_port < 1.0, r_port


def test_segment_directories_cross_both_ways(tmp_path, monkeypatch):
    monkeypatch.setenv("QDRANT_TPU_DEVICE_BUILD", "force")
    rng = np.random.default_rng(7)
    docs = docs_around_topics(rng, 300, 8, 10)
    port, jax = seg_pair(docs, "Dot", threshold=100)
    for seg in (port, jax):
        seg.delete_point(500, 17)
        seg.build_indexes()
        assert seg.hnsw_multi[""].entry >= 0
    jax.save(str(tmp_path / "jax"))
    port.save(str(tmp_path / "port"))
    meta = json.loads((tmp_path / "port" / "segment.json").read_text())
    assert meta["hnsw_multi"] == [""]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    from_jax = Segment.load(str(tmp_path / "jax"))
    from_port = JaxSegment.load(str(tmp_path / "port"))
    assert "" in from_jax.hnsw_multi and "" in from_port.hnsw_multi
    np.testing.assert_array_equal(from_jax.hnsw_multi[""].links0, jax.hnsw_multi[""].links0)
    for qi in (0, 17, 99, 250):
        q = query_near(rng, docs[qi])
        want = jax.search_multi("", q, 10)
        assert_same_hits(from_jax.search_multi("", q, 10), want)
        assert_same_hits(port.search_multi("", q, 10), from_port.search_multi("", q, 10))
        assert 17 not in from_jax.search_multi("", q, 10)[1]
    assert from_jax.get_vectors(3)[""] == jax.get_vectors(3)[""]


# ---------------------------------------------------------------------------
# the Collection and REST surface, on both servers
# ---------------------------------------------------------------------------


def _call(base, method, path, body=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())["result"]


def _session(toc_cls, server_cls, path, script):
    toc = toc_cls(path)
    srv = server_cls(toc, port=0)
    srv.start_background()
    try:
        return script(f"http://127.0.0.1:{srv.port}")
    finally:
        srv.shutdown()
        toc.close()


def test_collection_rest_surface_matches_jax(tmp_path):
    rng = np.random.default_rng(8)
    docs = docs_around_topics(rng, 60, 8, 5)
    queries = [query_near(rng, docs[i]).tolist() for i in (2, 30, 55)]
    path = "/collections/mv/points"

    def load(base):
        _call(base, "PUT", "/collections/mv", {
            "vectors": {"colbert": {"size": 8, "distance": "Cosine",
                                    "multivector_config": {"comparator": "max_sim"}}},
            "optimizers_config": {"indexing_threshold": 10**9}})
        _call(base, "PUT", f"{path}?wait=true", {"points": [
            {"id": i, "vector": {"colbert": doc.tolist()}, "payload": {"g": i % 2}}
            for i, doc in enumerate(docs)]})
        _call(base, "PUT", f"{path}/vectors?wait=true", {"points": [
            {"id": 4, "vector": {"colbert": docs[30].tolist()}}]})
        _call(base, "POST", f"{path}/delete?wait=true", {"points": [9]})
        return searches(base)

    def searches(base):
        out = []
        for q in queries:
            for flt in (None, {"must": [{"key": "g", "match": {"value": 0}}]}):
                body = {"query": q, "using": "colbert", "limit": 5, "with_payload": True}
                if flt:
                    body["filter"] = flt
                out.append([(h["id"], h["score"], h["payload"]["g"])
                            for h in _call(base, "POST", f"{path}/query", body)["points"]])
        got = _call(base, "POST", path, {"ids": [4, 9, 11], "with_vector": True})
        out.append(sorted((p["id"], p["vector"]["colbert"]) for p in got))
        out.append(_call(base, "POST", f"{path}/count", {})["count"])
        return out

    runs = {}
    for name, toc_cls, srv_cls in (("port", TableOfContent, RestServer),
                                   ("jax", JaxToc, JaxRestServer)):
        where = str(tmp_path / name)
        first = _session(toc_cls, srv_cls, where, load)
        again = _session(toc_cls, srv_cls, where, searches)  # restart: WAL + segments
        runs[name] = (first, again)
    port_first, port_again = runs["port"]
    jax_first, _ = runs["jax"]
    assert port_again == port_first
    assert port_first[-1] == 59
    retrieved = dict(port_first[-2])
    assert 9 not in retrieved
    norm = docs[30] / np.linalg.norm(docs[30], axis=1, keepdims=True)
    np.testing.assert_allclose(retrieved[4], norm, rtol=1e-6)  # cosine-normalised
    for got, want in zip(port_first[:-2], jax_first[:-2]):
        assert [(i, g) for i, _, g in got] == [(i, g) for i, _, g in want]
        np.testing.assert_allclose([s for _, s, _ in got], [s for _, s, _ in want], rtol=1e-5)
        assert 9 not in [i for i, _, _ in got]
    for pid, vec in port_first[-2]:
        np.testing.assert_allclose(vec, dict(jax_first[-2])[pid], rtol=1e-6)
