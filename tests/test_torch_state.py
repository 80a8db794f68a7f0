"""Carrying state from the JAX package to the port.

* A storage directory written by qdrant_tpu (upserts, bulk_ingest, flush,
  WAL-only tail) opens unchanged in qdrant_tpu_torch and answers the same
  searches as the JAX engine (its Pallas kernel in interpret mode, so both
  keep the same survivors). Tolerance: equal ids, scores within 1e-4
  relative (f32 rescore in another summation order).
* `scan_index_from_jax` turns a JAX ScanIndex's arrays into the port's block
  bit for bit (bf16 payload compared as raw 16-bit patterns).
* The port's seal builds the HNSW graph, its own segments reload with it, a
  graph written by the JAX package is loaded, searched and left as it was on
  disk, and configs the port cannot serve yet are refused.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import qdrant_tpu.ops.pallas_scan as pallas_scan
from qdrant_tpu.api.toc import TableOfContent as JaxToc
from qdrant_tpu.ops.scan import ScanIndex as JaxScanIndex
from qdrant_tpu.types import PayloadIndexParams, parse_filter
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.convert import scan_index_from_jax
from qdrant_tpu_torch.ops.scan import ScanIndex
from qdrant_tpu_torch.storage.segment import SearchParams
from qdrant_tpu_torch.types import parse_filter as port_parse_filter
from qdrant_tpu_torch.device import force_cpu

force_cpu()  # the port on the CPU, with the kernels' plain versions

NEVER = {"indexing_threshold": 10**9}


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """Single-device JAX engine on its TPU path, Pallas kernel interpreted."""
    monkeypatch.setenv("QDRANT_TPU_MESH", "0")
    monkeypatch.setattr(pallas_scan, "is_tpu_backend", lambda: True)
    monkeypatch.setattr(
        pallas_scan, "pallas_scan_rescore",
        functools.partial(pallas_scan.pallas_scan_rescore, interpret=True),
    )


def _hits(res):
    return [[(h[1], h[0]) for h in row] for row in res]


def _assert_same(a, b):
    for ra, rb in zip(_hits(a), _hits(b)):
        assert [i for i, _ in ra] == [i for i, _ in rb]
        for (_, sa), (_, sb) in zip(ra, rb):
            assert abs(sa - sb) <= 1e-4 * max(1.0, abs(sb))


def test_jax_storage_opens_in_port(tmp_path, jax_pallas_interpret):
    rng = np.random.default_rng(31)
    n, d = 65536, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    jtoc = JaxToc(str(tmp_path))
    jtoc.create_collection("c", {"vectors": {"size": d, "distance": "Euclid"},
                                 "optimizers_config": NEVER})
    jc = jtoc.get_collection("c")
    jc.create_payload_index("g", PayloadIndexParams.from_dict({"type": "keyword"}))
    jc.bulk_ingest(list(range(n)), {"": x}, [{"g": str(i % 4)} for i in range(n)])
    # a WAL-only tail: acknowledged upserts and deletes after the last flush
    jc.upsert([{"id": 10**6 + i, "vector": (x[i] + 0.01).tolist(),
                "payload": {"g": "1"}} for i in range(20)])
    jc.update_op({"type": "delete", "ids": list(range(0, 200, 5))})
    q = rng.standard_normal((5, d)).astype(np.float32)
    flt_spec = {"must": [{"key": "g", "match": {"value": "1"}}]}
    ref = [jc.search_dense("", q, 10), jc.search_dense("", q, 6, parse_filter(flt_spec))]
    counts = jc.count()

    toc = TableOfContent(str(tmp_path))
    c = toc.get_collection("c")
    assert c.count() == counts == n + 20 - 40
    _assert_same(c.search_dense("", q, 10), ref[0])
    _assert_same(c.search_dense("", q, 6, port_parse_filter(flt_spec)), ref[1])
    toc.close()
    jtoc.close()


def test_scan_index_from_jax_tpu_layout_round_trips_bf16(jax_pallas_interpret):
    rng = np.random.default_rng(32)
    n, d = 40000, 48
    x = rng.standard_normal((n, d)).astype(np.float32)
    valid = rng.random(n) > 0.1
    ref = JaxScanIndex(x, valid_mask=valid, euclid=True)
    assert ref.use_pallas and ref.mesh is None
    arrays = {"_v": np.asarray(ref._v), "_vsq_host": ref._vsq_host,
              "_mask": np.asarray(ref._mask)}
    assert arrays["_v"].dtype.name == "bfloat16"  # ml_dtypes, not torch-readable
    got = scan_index_from_jax(arrays, n=n, euclid=True)
    native = ScanIndex(x, valid_mask=valid, euclid=True)
    np.testing.assert_array_equal(
        got._v.view(torch.int16).numpy().view(np.uint16),
        arrays["_v"].view(np.uint16),
    )
    assert torch.equal(got._v.view(torch.int16), native._v.view(torch.int16))
    assert torch.equal(got._mask, native._mask)
    q = rng.standard_normal((4, d)).astype(np.float32)
    for a, b in zip(got.search(q, 10), native.search(q, 10)):
        np.testing.assert_array_equal(a, b)


def test_port_seals_without_graph_and_reloads(tmp_path):
    rng = np.random.default_rng(34)
    x = rng.standard_normal((1500, 12)).astype(np.float32)
    toc = TableOfContent(str(tmp_path))
    toc.create_collection("s", {"vectors": {"size": 12, "distance": "Dot"},
                                "optimizers_config": {"indexing_threshold": 1000}})
    c = toc.get_collection("s")
    c.upsert([{"id": i, "vector": x[i].tolist()} for i in range(1500)])
    segs = c.shards[0].segments
    assert any(not s.appendable and len(s) == 1500 for s in segs)
    # the seal builds the graph (and an appendable segment has none)
    assert all(bool(s.hnsw) != s.appendable for s in segs)
    q = rng.standard_normal((3, 12)).astype(np.float32)
    res = c.search_dense("", q, 5)
    truth = np.argsort(-(q @ x.T), axis=1)[:, :5]
    assert [[h[1] for h in row] for row in res] == truth.tolist()
    assert c.search_dense("", q, 5, params=SearchParams(exact=True, hnsw_ef=64)) == res
    # an explicit hnsw_ef is answered from the graph: exact scores of the
    # ids it returns, nearly all of the exact top 5 at this size
    graph = c.search_dense("", q, 5, params=SearchParams(hnsw_ef=256))
    sealed = next(s for s in segs if not s.appendable)
    assert sealed.hnsw[""].served["level"] >= 1
    exact = q @ x.T
    for qi, row in enumerate(graph):
        assert len({h[1] for h in row}) == 5
        for score, pid, *_ in row:
            assert abs(score - exact[qi, pid]) <= 1e-4 * max(1.0, abs(exact[qi, pid]))
    hit = sum(len({h[1] for h in row} & set(t)) for row, t in zip(graph, truth.tolist()))
    assert hit >= 13
    toc.close()
    toc2 = TableOfContent(str(tmp_path))
    c2 = toc2.get_collection("s")
    assert c2.search_dense("", q, 5) == res
    assert c2.search_dense("", q, 5, params=SearchParams(hnsw_ef=256)) == graph
    toc2.close()


def test_jax_graph_files_stay_untouched(tmp_path, monkeypatch):
    monkeypatch.setenv("QDRANT_TPU_MESH", "0")
    rng = np.random.default_rng(35)
    x = rng.standard_normal((600, 8)).astype(np.float32)
    jtoc = JaxToc(str(tmp_path))
    jtoc.create_collection("h", {"vectors": {"size": 8, "distance": "Cosine"},
                                 "optimizers_config": {"indexing_threshold": 500}})
    jtoc.get_collection("h").upsert([{"id": i, "vector": x[i].tolist()} for i in range(600)])
    jtoc.close()
    seg_root = os.path.join(str(tmp_path), "collections", "h", "shards", "0", "segments")
    sealed = [s for s in sorted(os.listdir(seg_root))
              if json.load(open(os.path.join(seg_root, s, "segment.json")))["hnsw"]]
    assert sealed, "the JAX seal should have built a graph"
    graph_dir = os.path.join(seg_root, sealed[0], "hnsw__default")
    before = sorted(os.listdir(graph_dir))

    toc = TableOfContent(str(tmp_path))
    c = toc.get_collection("h")
    q = rng.standard_normal((2, 8)).astype(np.float32)
    res = c.search_dense("", q, 4)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    truth = np.argsort(-(q @ xn.T), axis=1)[:, :4].tolist()
    assert [[h[1] for h in row] for row in res] == truth
    # the JAX-built graph is loaded and answers an hnsw_ef search
    graph = c.search_dense("", q, 4, params=SearchParams(hnsw_ef=128))
    assert [[h[1] for h in row] for row in graph] == truth
    toc.flush_all()
    toc.close()
    assert sorted(os.listdir(graph_dir)) == before
    meta = json.load(open(os.path.join(seg_root, sealed[0], "segment.json")))
    assert meta["hnsw"] == [""]


@pytest.mark.parametrize(
    "spec",
    [
        {"vectors": {"size": 4, "distance": "Dot",
                     "multivector_config": {"comparator": "max_sim"}}},
    ],
    ids=["multivector"],
)
def test_unported_configs_are_refused_at_creation(tmp_path, spec):
    toc = TableOfContent(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        toc.create_collection("x", spec)
    assert not toc.has_collection("x")
    toc.close()
