"""The quantized-primary tier (quantized search over on-disk rows): the port
on the CPU against the JAX package on its CPU platform, same numpy inputs
from a seed.

* The four quantized block scans of ops/scan.py against their JAX functions.
  Tolerance: int8 scores equal bit for bit in dot mode (exact int32 sums
  rounded once to f32, times scale² in f32) and within 1e-6 relative in
  euclid mode (XLA's CPU backend may contract `2·dots − …` into an FMA); TQ
  and rescored scores within 1e-5 relative (f32 sums in another order). Ids
  are compared as sets: equal scores may come back in any order, and only an
  id tied with the last kept score may differ.
* `flat_device` / `scan_device` layouts bit-equal, `_host_rescore` equal.
* Whole slice through both packages' REST handlers: a tiered SQ and a tiered
  TQ collection (equal ids, scores ≤ 1e-4 relative), a segment sealed by the
  JAX package served by the port, the low-memory-mode load, and the f32 rows
  of an `on_disk` quantized vector never reaching the device.
"""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qdrant_tpu.ops.quantization as jq
import qdrant_tpu.ops.scan as jscan
import qdrant_tpu.storage.segment as jseg
from qdrant_tpu.api.rest import RestServer as JaxRestServer
from qdrant_tpu.api.toc import TableOfContent as JaxToc
from qdrant_tpu.storage.vectors import DenseVectorStore as JaxDenseStore
from qdrant_tpu.types import Distance as JaxDistance
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.convert import quantized_from_jax
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.ops import scan as tscan
from qdrant_tpu_torch.storage import segment as tseg
from qdrant_tpu_torch.storage.vectors import DenseVectorStore
from qdrant_tpu_torch.types import Distance

force_cpu()  # the port on the CPU


@pytest.fixture(autouse=True)
def tiny_graphs(monkeypatch):
    """Every seal of a resident vector builds its HNSW graph; these tests hold
    the tier, never search a graph, and one seals 20,000 resident rows, whose
    host-orchestrated build takes over a minute on the CPU. Seal with the
    graph over the first 64 rows: real, loadable files."""
    from qdrant_tpu_torch.index.hnsw import HnswIndex

    real = HnswIndex.build

    def build(self, *args, **kwargs):
        ids = np.arange(len(self.store), dtype=np.int32) if self.subset is None else self.subset
        self.subset = ids[:64]
        return real(self, *args, **kwargs)

    monkeypatch.setattr(HnswIndex, "build", build)

BLK = tscan.DEFAULT_BLOCK
assert BLK == jscan.DEFAULT_BLOCK


def _same_candidates(got, ref, rtol):
    """(scores, ids) pairs agree: scores position by position within rtol;
    id sets equal except for ids tied with the last kept score."""
    s_a, i_a = (np.asarray(t) for t in got)
    s_b, i_b = (np.asarray(t) for t in ref)
    assert s_a.shape == s_b.shape and i_a.shape == i_b.shape
    if rtol == 0:
        np.testing.assert_array_equal(s_a, s_b)
    else:
        np.testing.assert_allclose(s_a, s_b, rtol=rtol, atol=0)
    for row in range(s_a.shape[0]):
        score = {**dict(zip(i_a[row].tolist(), s_a[row])),
                 **dict(zip(i_b[row].tolist(), s_b[row]))}
        hits_a = set(i_a[row][np.isfinite(s_a[row])].tolist())  # -inf = no hit
        hits_b = set(i_b[row][np.isfinite(s_b[row])].tolist())
        last = s_b[row][np.isfinite(s_b[row])].min(initial=np.inf)
        for pid in hits_a ^ hits_b:
            assert abs(score[pid] - last) <= rtol * abs(last), (row, pid)


def _sq_inputs(seed, n=BLK * 2, d=1536, b=5):
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (n, d), dtype=np.int8)
    q = rng.integers(-127, 128, (b, d), dtype=np.int8)
    # dots past 2^24: the int32 -> f32 rounding is part of the score
    q[0] = np.where(rng.random(d) < 0.5, 127, -127)
    codes[7], codes[BLK + 130] = q[0], q[0]
    codes[BLK + 3, : d // 2] = q[0, : d // 2]
    # equal rows: equal int8 scores are common, so ties are exercised
    codes[100:104] = codes[99]
    norms = rng.random(n).astype(np.float32) * 3
    qn = rng.random(b).astype(np.float32) * 3
    mask = (rng.random(n) > 0.1).astype(np.int8)
    mask[[7, BLK + 130, 99, 100, 101]] = 1
    return q, qn, codes, norms, np.float32(0.0123), mask


@pytest.mark.parametrize("euclid", [False, True], ids=["dot", "euclid"])
@pytest.mark.parametrize("name", ["scan_search_sq", "scan_search_sq_flat"])
def test_sq_scans_match_jax(name, euclid):
    q, qn, codes, norms, scale, mask = _sq_inputs(1)
    assert int(q[0].astype(np.int64) @ codes[7].astype(np.int64)) > 2**24
    ref = getattr(jscan, name)(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(codes), jnp.asarray(norms),
        jnp.float32(scale), jnp.asarray(mask), BLK, 160, euclid=euclid)
    got = getattr(tscan, name)(
        torch.from_numpy(q), torch.from_numpy(qn), torch.from_numpy(codes),
        torch.from_numpy(norms), float(scale), torch.from_numpy(mask), BLK, 160,
        euclid=euclid)
    _same_candidates(got, ref, rtol=1e-6 if euclid else 0)


def test_sq_scan_pads_queries_and_columns():
    """Codes whose width is not a multiple of 8 are padded with zero columns
    by `scan_device`; the scan pads the queries to match. Same answer."""
    rng = np.random.default_rng(2)
    v = rng.standard_normal((BLK + 50, 27)).astype(np.float32)
    jax_q = jq.ScalarQuantized.encode(v)
    port_q = quantized_from_jax(jax_q)
    codes, norms, n_pad = port_q.scan_device(BLK)
    jcodes, jnorms, jn_pad = jax_q.scan_device(BLK)
    assert n_pad == jn_pad == 2 * BLK and codes.shape == (n_pad, 32)
    np.testing.assert_array_equal(codes[:, :27].numpy(), np.asarray(jcodes))
    assert not codes[:, 27:].any()
    np.testing.assert_array_equal(norms.numpy(), np.asarray(jnorms))
    qv = rng.standard_normal((3, 27)).astype(np.float32)
    qc, qn = port_q.encode_queries(qv), (qv * qv).sum(1).astype(np.float32)
    mask = np.zeros(n_pad, np.int8)
    mask[: len(v)] = 1
    ref = jscan.scan_search_sq_flat(
        jnp.asarray(qc), jnp.asarray(qn), jcodes, jnorms, jnp.float32(jax_q.scale),
        jnp.asarray(mask), BLK, 40, euclid=True)
    got = tscan.scan_search_sq_flat(
        torch.from_numpy(qc), torch.from_numpy(qn), codes, norms, port_q.scale,
        torch.from_numpy(mask), BLK, 40, euclid=True)
    _same_candidates(got, ref, rtol=1e-6)


@pytest.mark.parametrize("euclid", [False, True], ids=["dot", "euclid"])
def test_sq_rescore_scan_matches_jax(euclid):
    q, qn, codes, norms, scale, mask = _sq_inputs(3, d=64)
    rng = np.random.default_rng(4)
    vf = rng.standard_normal(codes.shape).astype(np.float32)
    qf = rng.standard_normal(q.shape).astype(np.float32)
    ref = jscan.scan_search_sq_rescore(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(codes), jnp.asarray(norms),
        jnp.float32(scale), jnp.asarray(mask), jnp.asarray(qf), jnp.asarray(vf),
        BLK, 130, 10, euclid)
    got = tscan.scan_search_sq_rescore(
        torch.from_numpy(q), torch.from_numpy(qn), torch.from_numpy(codes),
        torch.from_numpy(norms), float(scale), torch.from_numpy(mask),
        torch.from_numpy(qf), torch.from_numpy(vf), BLK, 130, 10, euclid)
    _same_candidates(got, ref, rtol=1e-5)


@pytest.mark.parametrize("bits", [4, 2, 1.5, 1])
def test_tq_flat_packing_and_scan_match_jax(bits):
    rng = np.random.default_rng(5)
    v = rng.standard_normal((BLK + 700, 100)).astype(np.float32)
    jax_q = jq.TurboQuantized.encode(v, bits=bits)
    port_q = quantized_from_jax(jax_q)
    assert port_q.pack_factor == jax_q.pack_factor
    jp, jscales, jnorms, jlevels, jn_pad = jax_q.flat_device(BLK)
    packed, scales, norms, levels, n_pad = port_q.flat_device(BLK)
    assert n_pad == jn_pad
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))  # bit-equal
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    np.testing.assert_array_equal(norms.numpy(), np.asarray(jnorms))
    np.testing.assert_array_equal(levels.numpy(), np.asarray(jlevels))
    qv = rng.standard_normal((4, 100)).astype(np.float32)
    q_rot = port_q.rotate_queries(qv)
    np.testing.assert_array_equal(q_rot, jax_q.rotate_queries(qv))
    qn = (qv * qv).sum(1).astype(np.float32)
    mask = np.zeros(n_pad, np.int8)
    mask[: len(v)] = rng.random(len(v)) > 0.1
    bits_w = {4: 4, 2: 2, 1.5: 2, 1: 1}[bits]
    for euclid in (False, True):
        ref = jscan.scan_search_tq_flat(
            jnp.asarray(q_rot), jnp.asarray(qn), jp, jscales, jnorms, jlevels,
            jnp.asarray(mask), BLK, 140, euclid=euclid, pack=jax_q.pack_factor,
            bits_w=bits_w)
        got = tscan.scan_search_tq_flat(
            torch.from_numpy(q_rot), torch.from_numpy(qn), packed, scales, norms,
            levels, torch.from_numpy(mask), BLK, 140, euclid=euclid,
            pack=port_q.pack_factor, bits_w=bits_w)
        assert got[0].dtype == torch.float32  # not rounded to bf16
        _same_candidates(got, ref, rtol=1e-5)


@pytest.mark.parametrize("distance", ["Euclid", "Manhattan", "Cosine", "Dot"])
def test_host_rescore_matches_jax(distance):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((500, 24)).astype(np.float32)
    js = JaxDenseStore(24, JaxDistance(distance), on_disk=True)
    ts = DenseVectorStore(24, Distance(distance), on_disk=True)
    js.add(x)
    ts.add(x)
    q = rng.standard_normal((3, 24)).astype(np.float32)
    cand = rng.integers(0, 500, (3, 40)).astype(np.int32)
    cand[0, :5] = -1
    cand[1, 7] = 900  # past the store: dropped
    ref = jseg.Segment._host_rescore(None, js, q, cand, 12)
    got = tseg.Segment._host_rescore(None, ts, q, cand, 12)
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])


# ---------------------------------------------------------------------------
# whole slice, through both packages' REST handlers
# ---------------------------------------------------------------------------

N, D = 20000, 48
SEAL = {"indexing_threshold": 10000}
CONFIGS = {
    "sq": {"scalar": {"type": "int8", "quantile": 0.99, "always_ram": True}},
    "tq": {"turbo": {"bits": "bits4"}},
    "bq": {"binary": {"always_ram": True}},
}


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


@pytest.fixture(scope="module")
def small_flat_threshold():
    """Both engines take their large-N (flat scan) branches from 8,192 rows."""
    mp = pytest.MonkeyPatch()
    mp.setenv("QDRANT_TPU_MESH", "0")
    mp.setattr(jseg, "FLAT_SCAN_MIN_N", 8192)
    mp.setattr(tseg, "FLAT_SCAN_MIN_N", 8192)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def tier_servers(tmp_path_factory, small_flat_threshold):
    rng = np.random.default_rng(41)
    x = rng.standard_normal((N, D)).astype(np.float32)
    out = []
    for toc_cls, srv_cls, name in ((JaxToc, JaxRestServer, "jax"),
                                   (TableOfContent, RestServer, "port")):
        toc = toc_cls(str(tmp_path_factory.mktemp(name)))
        srv = srv_cls(toc, port=0)
        srv.start_background()
        for coll, qc in CONFIGS.items():
            dist = "Euclid" if coll == "bq" else "Cosine"
            call(srv.port, "PUT", f"/collections/{coll}", {
                "vectors": {"size": D, "distance": dist, "on_disk": True,
                            "quantization_config": qc},
                "optimizers_config": SEAL})
            call(srv.port, "PUT", f"/collections/{coll}/index",
                 {"field_name": "g", "field_schema": "keyword"})
            toc.get_collection(coll).bulk_ingest(
                list(range(N)), {"": x}, [{"g": str(i % 5)} for i in range(N)])
            toc.optimize_all()
            call(srv.port, "POST", f"/collections/{coll}/points/delete?wait=true",
                 {"points": list(range(0, 300, 7))})
        out.append((toc, srv))
    yield [srv.port for _, srv in out], [toc for toc, _ in out]
    for toc, srv in out:
        srv.shutdown()
        toc.close()


QUERIES = np.random.default_rng(42).standard_normal((4, D)).astype(np.float32)


@pytest.mark.parametrize(
    "extra",
    [
        {},
        {"params": {"quantization": {"rescore": False}}},
        {"params": {"quantization": {"oversampling": 8.0}}},
        {"filter": {"must": [{"key": "g", "match": {"value": "2"}}]}},
    ],
    ids=["rescored", "codes_only", "oversampled", "filtered"],
)
@pytest.mark.parametrize("coll", list(CONFIGS))
def test_tiered_collection_matches_jax(tier_servers, coll, extra):
    (jax_port, port), (_, toc) = tier_servers
    seg = next(s for s in toc.get_collection(coll).shards[0].segments if not s.appendable)
    assert "" in seg.quantized and seg.dense[""].on_disk
    for q in QUERIES:
        req = {"vector": q.tolist(), "limit": 10, **extra}
        a = call(port, "POST", f"/collections/{coll}/points/search", req)
        b = call(jax_port, "POST", f"/collections/{coll}/points/search", req)
        assert len(a) == 10
        if "rescore" in json.dumps(extra) and coll != "sq":
            # codes-only f32 scores: ids may swap where scores tie within 1e-5
            assert {h["id"] for h in a} == {h["id"] for h in b}
            np.testing.assert_allclose(
                [h["score"] for h in a], [h["score"] for h in b], rtol=1e-4)
        else:
            _same_hits(a, b)
        assert not {h["id"] for h in a} & set(range(0, 300, 7))  # deleted


@pytest.mark.parametrize("coll", list(CONFIGS))
def test_on_disk_rows_never_reach_the_device(tier_servers, coll, monkeypatch):
    """The tier's f32 block is never uploaded: after sealing and searching,
    the store has built no device block and no bf16 scan block, and a search
    with `device_block` made to raise still answers."""
    (_, port), (_, toc) = tier_servers
    seg = next(s for s in toc.get_collection(coll).shards[0].segments if not s.appendable)
    store = seg.dense[""]
    assert isinstance(store._data, np.memmap)

    def refuse(self):
        raise AssertionError("the tier asked for the f32 device block")

    monkeypatch.setattr(DenseVectorStore, "device_block", refuse)
    monkeypatch.setattr(DenseVectorStore, "scan_index", refuse)
    for extra in ({}, {"params": {"quantization": {"rescore": False}}}):
        hits = call(port, "POST", f"/collections/{coll}/points/search",
                    {"vector": QUERIES[0].tolist(), "limit": 5, **extra})
        assert len(hits) == 5
    assert store._dev is None and store._scan is None
    quant = seg.quantized[""]
    if coll == "sq":
        assert quant._scan_dev is not None and quant._kernel_dev is None and quant._dev is None
    if coll == "tq":
        assert quant._flat_dev is not None and quant._dev is None


@pytest.mark.parametrize("kind", ["sq", "tq"])
def test_jax_sealed_tiered_segment_is_served_by_the_port(tmp_path, small_flat_threshold, kind):
    rng = np.random.default_rng(43)
    x = rng.standard_normal((N, D)).astype(np.float32)
    spec = {"vectors": {"size": D, "distance": "Cosine", "on_disk": True,
                        "quantization_config": CONFIGS[kind]},
            "optimizers_config": SEAL}
    jtoc = JaxToc(str(tmp_path))
    jtoc.create_collection("c", spec)
    jc = jtoc.get_collection("c")
    jc.bulk_ingest(list(range(N)), {"": x})
    jtoc.optimize_all()
    assert any(s.quantized for s in jc.shards[0].segments)
    codes_only = jseg.SearchParams(quantization_rescore=False)
    ref = [jc.search_dense("", QUERIES, 10), jc.search_dense("", QUERIES, 10, params=codes_only)]
    jtoc.close()

    toc = TableOfContent(str(tmp_path))
    c = toc.get_collection("c")
    seg = next(s for s in c.shards[0].segments if not s.appendable)
    assert type(seg.quantized[""]).__name__ == ("ScalarQuantized" if kind == "sq"
                                                else "TurboQuantized")
    got = [c.search_dense("", QUERIES, 10),
           c.search_dense("", QUERIES, 10,
                          params=tseg.SearchParams(quantization_rescore=False))]
    for a, b in zip(got, ref):
        for ra, rb in zip(a, b):
            assert {h[1] for h in ra} == {h[1] for h in rb}
            np.testing.assert_allclose([h[0] for h in ra], [h[0] for h in rb], rtol=1e-4)
    assert seg.dense[""]._dev is None
    toc.close()


def test_low_memory_mode_load_serves_quantized_from_the_memmap(tmp_path, small_flat_threshold):
    """A RAM-resident quantized segment loaded under low_memory_mode has its
    f32 rows on a disk memmap: both engines then serve it as the tier."""
    rng = np.random.default_rng(44)
    x = rng.standard_normal((N, D)).astype(np.float32)
    toc = TableOfContent(str(tmp_path))
    toc.create_collection("c", {
        "vectors": {"size": D, "distance": "Dot", "quantization_config": CONFIGS["sq"]},
        "optimizers_config": SEAL})
    c = toc.get_collection("c")
    c.bulk_ingest(list(range(N)), {"": x})
    toc.optimize_all()
    in_ram = c.search_dense("", QUERIES, 10)
    toc.close()
    results = []
    for mod, toc_cls in ((jseg, JaxToc), (tseg, TableOfContent)):
        mod.set_low_memory_mode("no_populate")
        try:
            t = toc_cls(str(tmp_path))
            seg = next(s for s in t.get_collection("c").shards[0].segments
                       if not s.appendable)
            assert seg.dense[""].on_disk
            results.append(t.get_collection("c").search_dense("", QUERIES, 10))
            if mod is tseg:
                assert seg.dense[""]._dev is None
            t.close()
        finally:
            mod.set_low_memory_mode("disabled")
    for ra, rb, rc in zip(*results, in_ram):
        assert [h[1] for h in ra] == [h[1] for h in rb]
        np.testing.assert_allclose([h[0] for h in ra], [h[0] for h in rb], rtol=1e-4)
        # the in-RAM kernel path bins survivors differently; same exact scores
        assert len({h[1] for h in rb} & {h[1] for h in rc}) >= 9
