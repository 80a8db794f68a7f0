"""Sparse vectors and dense + sparse RRF queries: the port on the CPU against
the JAX package on its CPU platform, same numpy inputs from a seed, on the
corpus shape of tests/test_sparse_hybrid.py (30,000 rows, so n_pad >= 1024
and the hybrid path is the one run) and against a scipy CSR product.

Tolerances: scores within 1e-5 relative (f32 sums in another order), ids
equal wherever scores differ by more than that; through REST ids equal and
scores within 1e-4 relative.
"""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import qdrant_tpu.ops.sparse as jops
from qdrant_tpu.api.rest import RestServer as JaxRestServer
from qdrant_tpu.api.toc import TableOfContent as JaxToc
from qdrant_tpu.index.sparse import SparseIndex as JaxSparseIndex
from qdrant_tpu.index.sparse import SparseVectorStore as JaxSparseStore
from qdrant_tpu.types import SparseVector as JaxSparseVector
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.convert import sparse_index_from_jax
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.index import sparse as index_sparse
from qdrant_tpu_torch.index.sparse import SparseIndex, SparseVectorStore
from qdrant_tpu_torch.ops import sparse as tops
from qdrant_tpu_torch.types import SparseVector

force_cpu()  # the port on the CPU

N, VOCAB = 30_000, 500
SPLIT_HOT = str(4 * 32768 * 128)  # hot budget -> H = 128 < U: hot AND cold terms


def _zipf_rows(rng, n, vocab, nnz, extra_vocab=0):
    p = 1.0 / np.arange(1, vocab + 1) ** 0.9
    p /= p.sum()
    rows = []
    for _ in range(n):
        t = np.unique(rng.choice(vocab, size=nnz, p=p))
        w = np.abs(rng.normal(1.0, 0.5, size=len(t))).astype(np.float32) + 0.01
        rows.append((t.tolist(), w.tolist()))
    if extra_vocab:  # terms the index has never seen
        for i, (t, w) in enumerate(rows):
            rows[i] = (t + [vocab + 7 + i % extra_vocab], w + [1.5])
    return rows


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(11)
    rows = _zipf_rows(rng, N, VOCAB, 12)
    queries = _zipf_rows(rng, 16, VOCAB, 8, extra_vocab=5)
    jstore, store = JaxSparseStore(), SparseVectorStore()
    jstore.add([JaxSparseVector(*r) for r in rows])
    store.add([SparseVector(*r) for r in rows])
    indptr = np.concatenate([[0], np.cumsum([len(t) for t, _ in rows])])
    csr = sp.csr_matrix(
        (np.concatenate([w for _, w in rows]).astype(np.float32),
         np.concatenate([t for t, _ in rows]), indptr), shape=(N, VOCAB + 20))
    return jstore, store, queries, csr


def _both(queries):
    return [JaxSparseVector(*q) for q in queries], [SparseVector(*q) for q in queries]


def _truth(csr, queries):
    """Exact scores [B, N]: one scipy CSR product, independent of both packages."""
    qm = np.zeros((len(queries), csr.shape[1]), np.float32)
    for i, (t, w) in enumerate(queries):
        qm[i, t] = w
    return np.asarray((csr @ qm.T).T)


def _assert_same(got, ref, rtol=1e-5):
    """(scores, ids): scores within rtol; ids equal wherever the neighbouring
    scores differ by more than rtol (a tie may come back in either order)."""
    s_a, i_a = got
    s_b, i_b = ref
    assert s_a.shape == s_b.shape
    np.testing.assert_array_equal(np.isfinite(s_a), np.isfinite(s_b))
    fin = np.isfinite(s_b)
    np.testing.assert_allclose(s_a[fin], s_b[fin], rtol=rtol, atol=0)
    for row in range(len(s_b)):
        for col in np.flatnonzero(i_a[row] != i_b[row]):
            near = [c for c in (col - 1, col + 1) if 0 <= c < s_b.shape[1]]
            assert any(abs(s_b[row, c] - s_b[row, col]) <= rtol * abs(s_b[row, col])
                       for c in near), (row, col, i_a[row], i_b[row])


def _recall(ids, truth_scores, k):
    top = np.argsort(-truth_scores, axis=1)[:, :k]
    return float(np.mean([len(set(ids[i][ids[i] >= 0].tolist()) & set(top[i].tolist())) / k
                          for i in range(len(top))]))


# ---------------------------------------------------------------------------
# ops/sparse.py, function by function
# ---------------------------------------------------------------------------


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else v


def _jax_args(args):
    return [jnp.asarray(_np(a)) if isinstance(a, (torch.Tensor, np.ndarray)) else a
            for a in args]


def _captured_calls(monkeypatch, run):
    """Run `run()` with the port's sparse programs spied on → {name: (args,
    result)} of the last call of each."""
    real = {n: getattr(tops, n) for n in (
        "sparse_hybrid_search", "sparse_search", "rescore_sparse_packed", "build_hot_matrix")}
    calls = {}

    def spy(name):
        def wrapped(*args):
            out = real[name](*args)
            if name == "build_hot_matrix":  # filled in place: record the zeros
                args = (*args[:4], torch.zeros_like(args[4]))
            calls[name] = (args, out)
            return out
        return wrapped

    for name in real:
        monkeypatch.setattr(tops, name, spy(name))
    monkeypatch.setattr(index_sparse, "sparse_search", spy("sparse_search"))
    run()
    return calls


def test_hybrid_program_and_hot_matrix_match_jax(corpus, monkeypatch):
    _, store, queries, _ = corpus
    monkeypatch.setenv("QDRANT_TPU_SPARSE_HOT_BYTES", SPLIT_HOT)
    index = SparseIndex(store)
    qs = _both(queries)[1]
    calls = _captured_calls(monkeypatch, lambda: index.search(qs, 10))
    args, out = calls["sparse_hybrid_search"]
    assert int((_np(args[5]) > 0).sum()) > 0  # cold terms really present
    ref = jops.sparse_hybrid_search(*_jax_args(args))
    _assert_same(tuple(_np(t) for t in out), tuple(np.asarray(t) for t in ref))
    args, out = calls["build_hot_matrix"]
    ref = jops.build_hot_matrix(*_jax_args(args))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))  # one addend per cell
    assert np.count_nonzero(out.numpy()) > 0


def test_legacy_programs_match_jax(corpus, monkeypatch):
    _, store, queries, _ = corpus
    monkeypatch.setenv("QDRANT_TPU_SPARSE_HOT_MAX", "0")  # no hot matrix: legacy path
    index = SparseIndex(store)
    qs = _both(queries)[1]
    calls = _captured_calls(monkeypatch, lambda: index.search(qs, 10, window=256))
    assert "sparse_hybrid_search" not in calls
    args, out = calls["sparse_search"]
    assert (_np(args[2]) < 0).any()  # padded / absent terms
    ref = jops.sparse_search(*_jax_args(args))
    _assert_same((out[0].numpy(), out[1].numpy()), tuple(np.asarray(t) for t in ref))
    batch = tops.score_sparse_batch(*args[:7], args[8])
    jbatch = jops.score_sparse_batch(*_jax_args(args[:7]), jnp.asarray(_np(args[8])))
    np.testing.assert_allclose(batch.numpy(), np.asarray(jbatch), rtol=1e-5, atol=0)
    args, out = calls["rescore_sparse_packed"]
    ref = jops.rescore_sparse_packed(*_jax_args(args))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# SparseIndex against the JAX index and a scipy product
# ---------------------------------------------------------------------------

MODES = {
    "hybrid": {"QDRANT_TPU_SPARSE_HOT_BYTES": SPLIT_HOT},
    "all_hot": {},
    "legacy": {"QDRANT_TPU_SPARSE_HOT_MAX": "0"},
    "legacy_no_rescore": {"QDRANT_TPU_SPARSE_HOT_MAX": "0", "QDRANT_TPU_SPARSE_RESCORE": "0"},
    "exact_chunked": {"QDRANT_TPU_SPARSE_EXACT": "1"},
}


@pytest.mark.parametrize("modifier", [None, "idf"])
@pytest.mark.parametrize("mode", list(MODES))
def test_index_search_matches_jax_and_scipy(corpus, monkeypatch, mode, modifier):
    jstore, store, queries, csr = corpus
    for key, val in MODES[mode].items():
        monkeypatch.setenv(key, val)
    jindex, index = JaxSparseIndex(jstore, modifier), SparseIndex(store, modifier)
    assert index._hybrid_ready() == jindex._hybrid_ready() == (mode in ("hybrid", "all_hot"))
    jq, tq = _both(queries)
    kw = {"window": 256} if mode.startswith("legacy") or mode == "exact_chunked" else {}
    ref = jindex.search(jq, 10, **kw)
    got = index.search(tq, 10, **kw)
    # the legacy path without forward rows reports windowed sums (scatter-add
    # order): same tolerance, stated here
    _assert_same(got, ref, rtol=1e-5)
    if modifier is None and mode != "legacy_no_rescore":
        truth = _truth(csr, queries)
        # the windowed legacy path loses candidates at window 256, in both packages
        assert _recall(got[1], truth, 10) >= (0.85 if mode == "legacy" else 0.98)
        for row in range(len(queries)):  # reported scores are the exact product's
            ids = got[1][row][got[1][row] >= 0]
            np.testing.assert_allclose(got[0][row][: len(ids)], truth[row, ids], rtol=1e-5)
    if modifier == "idf":
        assert index.idf(3) == pytest.approx(jindex.idf(3), rel=1e-12)


def test_filtered_search_and_mask_cache(corpus, monkeypatch):
    jstore, store, queries, _ = corpus
    monkeypatch.setenv("QDRANT_TPU_SPARSE_HOT_BYTES", SPLIT_HOT)
    jindex, index = JaxSparseIndex(jstore), SparseIndex(store)
    mask = np.random.default_rng(3).random(N) < 0.3
    jq, tq = _both(queries)
    got = index.search(tq, 10, filter_mask=mask)
    _assert_same(got, jindex.search(jq, 10, filter_mask=mask))
    assert np.all(mask[got[1][got[1] >= 0]])
    index.search(tq, 10)
    cached = index._mask_cache
    index.search(tq, 10)
    assert cached is not None and index._mask_cache is cached  # unfiltered mask reused
    assert index.memory_usage_bytes()["device_bytes"] >= index._hot[0].numel() * 4


def test_search_many_matches_search(corpus, monkeypatch):
    jstore, store, queries, _ = corpus
    monkeypatch.setenv("QDRANT_TPU_SPARSE_HOT_BYTES", SPLIT_HOT)
    jindex, index = JaxSparseIndex(jstore), SparseIndex(store)
    jq, tq = _both(queries)
    cuts = [(0, 6), (6, 11), (11, 11), (11, 16)]
    got = index.search_many([tq[a:b] for a, b in cuts], 10)
    ref = jindex.search_many([jq[a:b] for a, b in cuts], 10)
    for g, r, (a, b) in zip(got, ref, cuts):
        assert g[0].shape == (b - a, 10)
        if b > a:
            _assert_same(g, r)
            _assert_same(g, index.search(tq[a:b], 10), rtol=0)


def test_absent_terms_and_repeated_terms(corpus, monkeypatch):
    _, store, _, csr = corpus
    monkeypatch.setenv("QDRANT_TPU_SPARSE_HOT_BYTES", SPLIT_HOT)
    index = SparseIndex(store)
    # only terms the index has never seen: no hit at all
    s, i = index.search([SparseVector([VOCAB + 3, VOCAB + 9], [1.0, 2.0])], 5)
    assert np.all(i == -1) and np.all(np.isneginf(s))
    # a term given three times counts three times (summed on the host, in
    # query order, so no returned score depends on an atomic sum's order)
    once = ([2, 40, 300, VOCAB + 1], [1.5, 1.0, 2.0, 9.0])
    thrice = ([2, 40, 2, 300, 2, VOCAB + 1], [0.5, 1.0, 0.5, 2.0, 0.5, 9.0])
    a = index.search([SparseVector(*once)], 10)
    b = index.search([SparseVector(*thrice)], 10)
    _assert_same(b, a, rtol=1e-6)
    truth = _truth(csr, [once])
    np.testing.assert_allclose(a[0][0], truth[0, a[1][0]], rtol=1e-5)


def test_two_paddings_one_answer(corpus, monkeypatch):
    """The pow-2 batch / term / entry buckets change no result: five queries
    alone (batch padded to 8) and inside a batch of 20 whose longest query
    widens every bucket (padded to 32)."""
    _, store, queries, _ = corpus
    monkeypatch.setenv("QDRANT_TPU_SPARSE_HOT_BYTES", SPLIT_HOT)
    index = SparseIndex(store)
    tq = _both(queries)[1]
    long_query = SparseVector(list(range(0, 400, 3)), [1.0] * len(range(0, 400, 3)))
    alone = index.search(tq[:5], 10)
    padded = index.search(tq[:5] + [long_query] + tq[2:16], 10)
    _assert_same((padded[0][:5], padded[1][:5]), alone, rtol=1e-6)


def test_sparse_index_from_jax(corpus, monkeypatch):
    jstore, _, queries, _ = corpus
    monkeypatch.setenv("QDRANT_TPU_SPARSE_HOT_BYTES", SPLIT_HOT)
    rng = np.random.default_rng(5)
    small = JaxSparseStore()
    small.add([JaxSparseVector(*r) for r in _zipf_rows(rng, 3000, VOCAB, 12)])
    for off in (5, 17, 2999):
        small.delete(off)
    jindex = JaxSparseIndex(small, "idf")
    index = sparse_index_from_jax(jindex)
    assert len(index.store) == 3000 and index.store.deleted_count == 3
    assert index.modifier == "idf" and index.store.get(17) is None
    jq, tq = _both(queries)
    _assert_same(index.search(tq, 10), jindex.search(jq, 10))


# ---------------------------------------------------------------------------
# whole slice, through both packages' REST handlers
# ---------------------------------------------------------------------------

ROWS, DENSE = 3000, 16


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


def _same_hits(a, b):
    assert [h["id"] for h in a] == [h["id"] for h in b]
    for ha, hb in zip(a, b):
        assert abs(ha["score"] - hb["score"]) <= 1e-4 * max(1.0, abs(hb["score"]))
        assert ha.get("payload") == hb.get("payload")


def _points(rng):
    rows = _zipf_rows(rng, ROWS, VOCAB, 12)
    dense = rng.standard_normal((ROWS, DENSE)).astype(np.float32)
    return [
        {"id": i,
         "vector": {"": dense[i].tolist(), "text": {"indices": t, "values": w},
                    "bm": {"indices": t, "values": w}},
         "payload": {"g": "a" if i % 10 == 0 else "b"}}
        for i, (t, w) in enumerate(rows)
    ]


SPEC = {
    "vectors": {"size": DENSE, "distance": "Euclid"},
    "sparse_vectors": {"text": {}, "bm": {"modifier": "idf"}},
    "optimizers_config": {"indexing_threshold": ROWS},
}


@pytest.fixture(scope="module")
def sparse_servers(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("QDRANT_TPU_MESH", "0")
    mp.setenv("QDRANT_TPU_SPARSE_HOT_BYTES", str(4 * 4096 * 128))  # split at ROWS too
    points = _points(np.random.default_rng(51))
    out = []
    for toc_cls, srv_cls, name in ((JaxToc, JaxRestServer, "jax"),
                                   (TableOfContent, RestServer, "port")):
        root = str(tmp_path_factory.mktemp(name))
        toc = toc_cls(root)
        srv = srv_cls(toc, port=0)
        srv.start_background()
        call(srv.port, "PUT", "/collections/s", SPEC)
        call(srv.port, "PUT", "/collections/s/index", {"field_name": "g", "field_schema": "keyword"})
        for lo in range(0, ROWS, 1000):
            call(srv.port, "PUT", "/collections/s/points?wait=true",
                 {"points": points[lo : lo + 1000]})
        toc.optimize_all()
        out.append((toc, srv, root))
    yield [srv.port for _, srv, _ in out], [toc for toc, _, _ in out], [r for _, _, r in out]
    for toc, srv, _ in out:
        srv.shutdown()
        toc.close()
    mp.undo()


def _rest_queries():
    rng = np.random.default_rng(52)
    sparse = [{"indices": t, "values": w} for t, w in _zipf_rows(rng, 5, VOCAB, 8, extra_vocab=3)]
    return sparse, rng.standard_normal((5, DENSE)).astype(np.float32)


@pytest.mark.parametrize(
    "extra",
    [
        {"using": "text"},
        {"using": "bm"},
        {"using": "text", "with_payload": True,
         "filter": {"must": [{"key": "g", "match": {"value": "a"}}]}},
    ],
    ids=["plain", "idf", "filtered"],
)
def test_sparse_query_matches_jax(sparse_servers, extra):
    (jax_port, port), (_, toc), _ = sparse_servers
    seg = next(s for s in toc.get_collection("s").shards[0].segments if not s.appendable)
    assert len(seg) == ROWS and seg.sparse_index["text"]._hybrid_ready()
    for qv in _rest_queries()[0]:
        body = {"query": qv, "limit": 10, **extra}
        a = call(port, "POST", "/collections/s/points/query", body)["points"]
        b = call(jax_port, "POST", "/collections/s/points/query", body)["points"]
        assert len(a) == 10
        _same_hits(a, b)
        if "filter" in extra:
            assert all(h["payload"]["g"] == "a" for h in a)


def test_sparse_search_endpoint_and_retrieve_match_jax(sparse_servers):
    (jax_port, port), _, _ = sparse_servers
    qv = _rest_queries()[0][0]
    body = {"vector": {"name": "text", "vector": qv}, "limit": 7}
    _same_hits(call(port, "POST", "/collections/s/points/search", body),
               call(jax_port, "POST", "/collections/s/points/search", body))
    got = [call(p, "POST", "/collections/s/points", {"ids": [3, 4], "with_vector": True})
           for p in (port, jax_port)]
    assert got[0] == got[1] and "text" in got[0][0]["vector"]


def test_rrf_query_matches_jax(sparse_servers):
    (jax_port, port), _, _ = sparse_servers
    sparse, dense = _rest_queries()
    for qv, dv in zip(sparse, dense):
        body = {"prefetch": [{"query": dv.tolist(), "limit": 30},
                             {"query": qv, "using": "text", "limit": 30}],
                "query": {"fusion": "rrf"}, "limit": 10}
        a = call(port, "POST", "/collections/s/points/query", body)["points"]
        b = call(jax_port, "POST", "/collections/s/points/query", body)["points"]
        assert len(a) == 10
        _same_hits(a, b)


def test_delete_then_search_and_update(sparse_servers):
    """A delete invalidates the index (and its cached unfiltered mask); an
    updated sparse vector is searched with its new terms. Runs on a copy of
    the collection's state: both engines get the same writes."""
    (jax_port, port), _, _ = sparse_servers
    qv = _rest_queries()[0][1]
    body = {"query": qv, "using": "text", "limit": 5}
    before = call(port, "POST", "/collections/s/points/query", body)["points"]
    victim = before[0]["id"]
    for p in (port, jax_port):
        call(p, "POST", "/collections/s/points/delete?wait=true", {"points": [victim]})
        call(p, "PUT", "/collections/s/points/vectors?wait=true", {"points": [
            {"id": before[1]["id"], "vector": {"text": {"indices": [VOCAB + 1], "values": [1.0]}}}]})
    a = call(port, "POST", "/collections/s/points/query", body)["points"]
    b = call(jax_port, "POST", "/collections/s/points/query", body)["points"]
    _same_hits(a, b)
    assert victim not in {h["id"] for h in a} and before[1]["id"] not in {h["id"] for h in a}
    only = {"query": {"indices": [VOCAB + 1], "values": [2.0]}, "using": "text", "limit": 5}
    a = call(port, "POST", "/collections/s/points/query", only)["points"]
    assert [h["id"] for h in a] == [before[1]["id"]] and a[0]["score"] == pytest.approx(2.0)


def test_snapshot_reload_and_jax_written_segment(sparse_servers, tmp_path):
    """The port reloads its own flushed segments, and serves the segment the
    JAX package wrote (same `sparse_*/` files), with the same answers."""
    import shutil

    (jax_port, port), (jax_toc, toc), (jax_root, root) = sparse_servers
    qv = _rest_queries()[0][2]
    body = {"query": qv, "using": "bm", "limit": 10}
    want = call(port, "POST", "/collections/s/points/query", body)["points"]
    jax_toc.flush_all()
    toc.flush_all()
    for src, name in ((root, "own"), (jax_root, "from_jax")):
        copy = str(tmp_path / name)
        shutil.copytree(src, copy)
        reopened = TableOfContent(copy)
        srv = RestServer(reopened, port=0)
        srv.start_background()
        try:
            got = call(srv.port, "POST", "/collections/s/points/query", body)["points"]
            assert [h["id"] for h in got] == [h["id"] for h in want]
            np.testing.assert_allclose([h["score"] for h in got],
                                       [h["score"] for h in want], rtol=1e-4)
        finally:
            srv.shutdown()
            reopened.close()


def test_rows_cut_at_jc_score_their_heaviest_cold_terms(monkeypatch):
    """A document with more cold terms than the forward rows' width Jc scores
    the product over its hot terms and its Jc heaviest cold terms, in both
    packages (scores ≤ 1e-5 relative); every other document scores the full
    product."""
    n, vocab = 8192, 3000
    monkeypatch.setenv("QDRANT_TPU_SPARSE_HOT_BYTES", str(4 * n * 128))  # H = 128
    rng = np.random.default_rng(5)
    p = 1.0 / np.arange(1, vocab + 1) ** 0.9
    p /= p.sum()
    rows = []
    for i in range(n):  # 6 long rows: fewer than the 0.1% that Jc covers
        t = np.unique(rng.choice(vocab, size=600 if i % 1500 == 0 else 10, p=p))
        rows.append((t, np.abs(rng.normal(1.0, 0.6, len(t))).astype(np.float32) + 0.05))
    jstore, store = JaxSparseStore(), SparseVectorStore()
    jstore.add([JaxSparseVector(t.tolist(), w.tolist()) for t, w in rows])
    store.add([SparseVector(t.tolist(), w.tolist()) for t, w in rows])
    jindex, index = JaxSparseIndex(jstore), SparseIndex(store)
    assert index._hybrid_ready() and jindex._hybrid_ready()
    jc = index._fwd_cold.shape[1] // 2
    hot_col = np.full(vocab, -1, dtype=np.int64)
    hot_col[index._csr_host[2]] = index._hot[1]
    qt = np.arange(0, vocab, 7)
    qw = np.abs(rng.normal(1.0, 0.6, len(qt))).astype(np.float32)
    qm = np.zeros(vocab)
    qm[qt] = qw
    got = index.search([SparseVector(qt.tolist(), qw.tolist())], 50)
    _assert_same(got, jindex.search([JaxSparseVector(qt.tolist(), qw.tolist())], 50))
    n_cut = 0
    for score, pid in zip(*(a[0] for a in got)):
        t, w = rows[pid]
        cold = np.flatnonzero(hot_col[t] < 0)
        keep = np.ones(len(t), bool)
        keep[cold[np.argsort(-w[cold], kind="stable")[jc:]]] = False
        n_cut += len(cold) > jc
        assert score == pytest.approx(float(w[keep].astype(np.float64) @ qm[t[keep]]), rel=1e-5)
    assert n_cut == 6  # the long rows outscore the rest and are all returned
