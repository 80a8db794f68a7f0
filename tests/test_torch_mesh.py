"""The port's device mesh (qdrant_tpu_torch/parallel/mesh.py and the indexes
that use it) against the JAX package's, on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices, its programs on
`make_mesh(4)`; the port runs 4 logical CPU shards (`make_mesh(4)`, or
`set_logical_devices(4)` where an index makes its own mesh). Every case feeds
both the same numpy inputs from a seed. Tolerances:

* exact search: ids equal, scores within rtol 1e-5;
* the HNSW programs on a ring graph: ids equal (selected rows equal);
* the sharded scan + rescore and the auto-mesh ScanIndex: recall@10 >= 0.99
  against exact f64 on both sides, and ids equal wherever both results hold
  the true top-k (each side's survivor bins may drop a row, as the single-
  device port is held to JAX);
* ShardedHnswIndex: recall@10 within 0.02 of the JAX sharded index on
  clustered data, every filtered hit matching, an empty shard inert; a
  JAX-saved graph loads in the port and searches to JAX's ids;
* REST: a sealed segment served by the port with 4 logical shards against
  the JAX engine on its 8-device mesh: default searches equal where neither
  side lost a bin, graph searches within 0.02 recall.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import qdrant_tpu.index.plain as jax_plain
from qdrant_tpu.api.rest import RestServer as JaxRestServer
from qdrant_tpu.api.toc import TableOfContent as JaxToc
from qdrant_tpu.index.hnsw import ShardedHnswIndex as JaxShardedHnswIndex
from qdrant_tpu.ops.scan import ScanIndex as JaxScanIndex
from qdrant_tpu.parallel import mesh as jmesh
from qdrant_tpu.storage.vectors import DenseVectorStore as JaxDenseVectorStore
from qdrant_tpu import types as jt

import qdrant_tpu_torch.index.plain as port_plain
from qdrant_tpu_torch import device as port_device
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.convert import scan_index_from_jax, sharded_hnsw_index_from_jax
from qdrant_tpu_torch.index.hnsw import ShardedHnswIndex, load_hnsw_any
from qdrant_tpu_torch.ops.fused_scan import NEG_INF
from qdrant_tpu_torch.ops.scan import ScanIndex
from qdrant_tpu_torch.parallel import mesh as pmesh
from qdrant_tpu_torch.storage.vectors import DenseVectorStore
from qdrant_tpu_torch import types as pt

port_device.force_cpu()  # the port on the CPU, with the kernels' plain versions
# the graph programs are thousands of tiny ops: torch's worker threads only
# contend with the other test workers
torch.set_num_threads(1)

S = 4
scan_rescore = pmesh.sharded_scan_rescore


@pytest.fixture
def logical4(monkeypatch):
    """The process's mesh: 4 logical CPU devices (restored afterwards)."""
    monkeypatch.setattr(port_device, "_LOGICAL", None)
    port_device.set_logical_devices(S)
    yield pmesh.make_mesh()


def test_mesh_devices_and_the_gate(monkeypatch):
    """mesh_devices repeats the visible devices up to the logical count
    (set_logical_devices, else QDRANT_TPU_LOGICAL_DEVICES); the mesh gate
    needs more than one and QDRANT_TPU_MESH not "0"; without a card and
    without the CPU asked for it raises, as default_device() does."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(port_device, "_LOGICAL", None)
    monkeypatch.delenv(port_device.LOGICAL_DEVICES_ENV, raising=False)
    assert port_device.mesh_devices() == [cpu] and not pmesh.mesh_enabled()
    monkeypatch.setenv(port_device.LOGICAL_DEVICES_ENV, "3")
    assert port_device.mesh_devices() == [cpu] * 3 and pmesh.make_mesh().size == 3
    port_device.set_logical_devices(2)
    assert pmesh.make_mesh() == pmesh.Mesh((cpu, cpu)) and pmesh.make_mesh(5).size == 5
    assert pmesh.mesh_enabled() and pmesh.make_mesh().one_device
    monkeypatch.setenv(pmesh.MESH_ENV, "0")
    assert not pmesh.mesh_enabled()
    with pytest.raises(ValueError):
        port_device.set_logical_devices(0)
    monkeypatch.setattr(port_device, "_FORCED", None)
    monkeypatch.delenv(port_device.FORCE_CPU_ENV, raising=False)
    monkeypatch.setattr(port_device.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--force-cpu"):
        port_device.mesh_devices()


def _ring(s, np_local, m0):
    links = np.full((s * np_local, m0), -1, dtype=np.int32)
    for shard in range(s):
        for i in range(np_local):
            links[shard * np_local + i] = [(i + j + 1) % np_local for j in range(m0)]
    return links


def _split(a, s=S):
    return [torch.from_numpy(np.ascontiguousarray(p)) for p in np.split(a, s)]


def _exact(x, q, k, euclid=True, valid=None):
    """Exact f64 top-k ids (rows outside `valid` never returned)."""
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    s = -((q64[:, None, :] - x64[None]) ** 2).sum(-1) if euclid else q64 @ x64.T
    if valid is not None:
        s[:, ~valid] = -np.inf
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


def _recall(ids, truth):
    k = truth.shape[1]
    return float(np.mean([len(set(a[:k]) & set(t)) / k
                          for a, t in zip(np.asarray(ids).tolist(), truth.tolist())]))


def _equal_where_both_exact(ids_a, ids_b, truth):
    """Ids equal on every row where both results hold the true top-k; →
    rows compared."""
    k = truth.shape[1]
    rows = [r for r in range(len(truth))
            if set(ids_a[r][:k]) == set(truth[r]) == set(ids_b[r][:k])]
    for r in rows:
        np.testing.assert_array_equal(ids_a[r][:k], ids_b[r][:k])
    return len(rows)


def _clustered(rng, n, d, nq, centres=64):
    c = rng.normal(size=(centres, d)).astype(np.float32)
    x = c[rng.integers(0, centres, n)] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    q = c[rng.integers(0, centres, nq)] + 0.3 * rng.normal(size=(nq, d)).astype(np.float32)
    return x.astype(np.float32), q.astype(np.float32)


# ---------------------------------------------------------------------------
# the four programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("distance", ["Dot", "Euclid"])
def test_sharded_exact_search_matches_jax(distance):
    rng = np.random.default_rng(0)
    np_local, d, b, k = 256, 16, 6, 10
    x = rng.normal(size=(S * np_local, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    valid = np.ones(S * np_local, dtype=bool)
    valid[[5, 300, 301, 900]] = False
    js, jg = jmesh.sharded_exact_search(jmesh.make_mesh(S), jnp.asarray(q), jnp.asarray(x),
                                        jnp.asarray(valid), distance, k)
    ps, pg = pmesh.sharded_exact_search(pmesh.make_mesh(S), torch.from_numpy(q), _split(x),
                                        _split(valid), distance, k)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    assert not set(pg.numpy().ravel().tolist()) & {5, 300, 301, 900}


def test_sharded_hnsw_search_matches_jax():
    rng = np.random.default_rng(1)
    np_local, d, b, k, m0 = 64, 8, 4, 5, 8
    x = rng.normal(size=(S * np_local, d)).astype(np.float32)
    links = _ring(S, np_local, m0)
    entries = np.array([0, 7, -1, 30], dtype=np.int32)  # shard 2 inert
    q = rng.normal(size=(b, d)).astype(np.float32)
    fmask = rng.random(S * np_local) < 0.7
    js, jg = jmesh.sharded_hnsw_search(
        jmesh.make_mesh(S), jnp.asarray(q), jnp.asarray(x), jnp.asarray(links),
        jnp.asarray(entries), jnp.asarray(fmask), "Euclid", ef=32, k=k)
    ps, pg = pmesh.sharded_hnsw_search(
        pmesh.make_mesh(S), torch.from_numpy(q), _split(x), _split(links), entries,
        _split(fmask), "Euclid", ef=32, k=k)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), rtol=1e-5)
    assert not ((pg.numpy() >= 2 * np_local) & (pg.numpy() < 3 * np_local)).any()


def test_sharded_build_step_matches_jax():
    rng = np.random.default_rng(2)
    np_local, d, bb, m0 = 64, 8, 16, 8
    x = rng.normal(size=(S * np_local, d)).astype(np.float32)
    links = _ring(S, np_local, m0)
    entries = np.zeros(S, dtype=np.int32)
    batch = rng.normal(size=(S * bb, d)).astype(np.float32)
    jsel = jmesh.sharded_build_step(
        jmesh.make_mesh(S), jnp.asarray(batch), jnp.asarray(x), jnp.asarray(links),
        jnp.asarray(entries), "Euclid", ef_construct=32, m=m0)
    psel = pmesh.sharded_build_step(
        pmesh.make_mesh(S), _split(batch), _split(x), _split(links), entries, "Euclid",
        ef_construct=32, m=m0)
    np.testing.assert_array_equal(torch.cat(psel).numpy(), np.asarray(jsel))


@pytest.mark.parametrize("euclid", [True, False], ids=["euclid", "dot"])
def test_sharded_scan_rescore_matches_jax(euclid):
    """4,096 rows over 4 shards of 1,024; the JAX program scans 256-row
    blocks (groups of 2 rows a lane), the port its own grid."""
    rng = np.random.default_rng(3)
    np_local, d, dp, b, k = 1024, 24, 128, 16, 10
    x = rng.normal(size=(S * np_local, d)).astype(np.float32)
    q = x[rng.integers(0, len(x), b)] + 0.3 * rng.normal(size=(b, d)).astype(np.float32)
    dead = rng.random(len(x)) < 0.05
    xp = np.zeros((len(x), dp), np.float32)
    xp[:, :d] = x
    qp = np.zeros((b, dp), np.float32)
    qp[:, :d] = q
    vsq = (xp * xp).sum(1) if euclid else np.zeros(len(x), np.float32)
    js, jg = jmesh.sharded_scan_rescore(
        jmesh.make_mesh(S), jnp.asarray(qp), jnp.asarray(xp, dtype=jnp.bfloat16),
        jnp.asarray(vsq), jnp.asarray((~dead).astype(np.int8)), jnp.asarray(xp), 256,
        2 * k, k, euclid)
    v = torch.from_numpy(2 * xp if euclid else xp).to(torch.bfloat16)
    bias = torch.from_numpy(np.where(dead, NEG_INF, -vsq).astype(np.float32))
    ps, pg = pmesh.sharded_scan_rescore(
        pmesh.make_mesh(S), torch.from_numpy(qp), list(v.split(np_local)),
        list(bias.split(np_local)), _split(x), 4096, 2 * k, k, euclid)
    truth = _exact(x, q, k, euclid, valid=~dead)
    pids, jids = pg.numpy(), np.asarray(jg)
    assert _recall(pids, truth) >= 0.99 and _recall(jids, truth) >= 0.99
    assert _equal_where_both_exact(pids, jids, truth) >= b // 2
    ok = pids >= 0
    np.testing.assert_allclose(ps.numpy()[ok], np.asarray(js)[ok], rtol=1e-5, atol=1e-5)


def test_scan_index_auto_mesh_matches_jax(logical4):
    """With 4 logical devices the port's ScanIndex shards itself (as the JAX
    one does over its 8 devices) and serves exact-rescored results; the
    mesh's per-shard blocks are views of one tensor."""
    rng = np.random.default_rng(4)
    n, d, b, k = 4096, 24, 16, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    q = x[rng.integers(0, n, b)] + 0.3 * rng.normal(size=(b, d)).astype(np.float32)
    valid = rng.random(n) > 0.05
    port = ScanIndex(x, valid_mask=valid, euclid=True)
    ref = JaxScanIndex(x, valid_mask=valid, euclid=True, block=256)
    assert port.mesh.size == S and ref.mesh is not None
    assert port.n_pad == 4 * 4096 and port._v[0].shape == (4096, 128)
    assert {t.untyped_storage().data_ptr() for t in port._v} == {
        port._v[0].untyped_storage().data_ptr()}
    ps, pi = port.search(q, k)
    js, ji = ref.search(q, k)
    truth = _exact(x, q, k, valid=valid)
    assert _recall(pi, truth) >= 0.99 and _recall(ji, truth) >= 0.99
    assert _equal_where_both_exact(pi, ji, truth) >= b // 2
    np.testing.assert_allclose(ps[:, 0], -((x[pi[:, 0]] - q) ** 2).sum(1), rtol=1e-4)
    # a filter through the digest cache: per-shard biases, hits all allowed
    allow = valid & (np.arange(n) % 3 == 0)
    _, fi = port.search(q, k, mask=port.mask_device_cached(allow))
    assert allow[fi[fi >= 0]].all() and (fi >= 0).all()
    assert port.mask_device_cached(allow) is port.mask_device_cached(allow)
    # the same block from the JAX mesh index's arrays, over the port's mesh
    carried = scan_index_from_jax(
        {"_v": np.asarray(ref._v), "_vsq": np.asarray(ref._vsq),
         "_mask": np.asarray(ref._mask), "_v_f32": np.asarray(ref._v_f32)},
        n=n, euclid=True, block=256, mesh=logical4)
    assert _recall(carried.search(q, k)[1], truth) >= 0.99


# ---------------------------------------------------------------------------
# ShardedHnswIndex
# ---------------------------------------------------------------------------


def _pair(x, distance, deleted=()):
    jstore = JaxDenseVectorStore(x.shape[1], jt.Distance(distance))
    jstore.add(x)
    pstore = DenseVectorStore(x.shape[1], pt.Distance(distance))
    pstore.add(x)
    for off in deleted:
        jstore.delete(off)
        pstore.delete(off)
    return jstore, pstore


@pytest.fixture(scope="module")
def graphs():
    """The same 1,024 clustered rows, one shard slice fully deleted, built
    into a 4-shard graph by both packages (256-row subgraphs, as the JAX
    engine's 8 shards of the REST case: its compiled programs are reused)."""
    rng = np.random.default_rng(7)
    n, d = 1024, 16
    x, q = _clustered(rng, n, d, 24)
    dead = range(2 * 256, 3 * 256)
    jstore, pstore = _pair(x, "Euclid", dead)
    cfg = dict(m=8, ef_construct=48)
    jidx = JaxShardedHnswIndex(jstore, jt.HnswConfig(**cfg), seed=3, mesh=jmesh.make_mesh(S))
    jidx.build()
    pidx = ShardedHnswIndex(pstore, pt.HnswConfig(**cfg), seed=3, mesh=pmesh.make_mesh(S))
    pidx.build()
    alive = np.ones(n, dtype=bool)
    alive[list(dead)] = False
    return {"x": x, "q": q, "alive": alive, "jax": jidx, "port": pidx}


def test_sharded_hnsw_index_matches_jax(graphs):
    x, q, alive = graphs["x"], graphs["q"], graphs["alive"]
    jidx, pidx = graphs["jax"], graphs["port"]
    assert pidx.n_shards == S and pidx.n_per_shard == jidx.n_per_shard == 256
    np.testing.assert_array_equal(pidx._entries == -1, np.asarray(jidx._entries) == -1)
    assert pidx._entries[2] == -1  # the deleted slice is inert
    assert pidx.build_stats["points"] == int(alive.sum())
    truth = _exact(x, q, 10, valid=alive)
    _, pi = pidx.search(q, 10, ef=64)
    _, ji = jidx.search(q, 10, ef=64)
    assert not (~alive[pi[pi >= 0]]).any()
    assert _recall(pi, truth) >= 0.9
    assert _recall(pi, truth) >= _recall(ji, truth) - 0.02
    # 5% selectivity: every hit matches (the entries are mostly outside it)
    fmask = np.zeros(len(x), dtype=bool)
    fmask[np.random.default_rng(8).integers(0, len(x), len(x) // 20)] = True
    _, fi = pidx.search(q, 10, ef=128, filter_mask=fmask)
    got = fi[fi >= 0]
    assert got.size and (fmask & alive)[got].all()
    assert pidx.memory_usage_bytes()["device_bytes"] == 4 * 256 * 16 * 4  # links only


def test_jax_sharded_graph_loads_and_converts(graphs, tmp_path, logical4):
    """A JAX-saved `hnsw_sharded.npz` loads in the port (the process's mesh
    has the saved 4 shards) and searches to JAX's ids, as does the graph
    carried across by sharded_hnsw_index_from_jax."""
    jidx, pidx, q = graphs["jax"], graphs["port"], graphs["q"]
    jidx.save(str(tmp_path / "g"))
    loaded = load_hnsw_any(str(tmp_path / "g"), pidx.store, pidx.config)
    assert isinstance(loaded, ShardedHnswIndex) and loaded.n_shards == S
    assert not loaded.build_stats  # loaded, not rebuilt
    js, ji = jidx.search(q, 10, ef=64)
    ls, li = loaded.search(q, 10, ef=64)
    np.testing.assert_array_equal(li, ji)
    np.testing.assert_allclose(ls, js, rtol=1e-5)
    carried = sharded_hnsw_index_from_jax(jidx, pidx.store, logical4)
    np.testing.assert_array_equal(carried.search(q, 10, ef=64)[1], ji)
    with pytest.raises(ValueError, match="shard"):
        sharded_hnsw_index_from_jax(jidx, pidx.store, pmesh.make_mesh(2))


# ---------------------------------------------------------------------------
# end to end: a sealed segment through REST
# ---------------------------------------------------------------------------


def _call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        out = json.loads(resp.read())
    assert out["status"] == "ok", out
    return out["result"]


def test_rest_sealed_segment_on_the_mesh_matches_jax(tmp_path, monkeypatch, logical4):
    """2,048 clustered points sealed by each engine's optimizer: the port
    shards its scan and builds a 4-shard graph, the JAX engine uses its
    8-device mesh. The scan threshold is lowered on both so the default
    searches take the sharded scan at this size."""
    for mod in (jax_plain, port_plain):
        monkeypatch.setattr(mod, "SCAN_THRESHOLD", 1024)
    scans = []
    monkeypatch.setattr(pmesh, "sharded_scan_rescore", lambda *a, **kw: scans.append(
        a[0].size) or scan_rescore(*a, **kw))
    rng = np.random.default_rng(9)
    n, d = 2048, 16
    x, q = _clustered(rng, n, d, 16)
    servers = []
    try:
        for toc_cls, srv_cls, name in ((JaxToc, JaxRestServer, "jax"),
                                       (TableOfContent, RestServer, "port")):
            toc = toc_cls(str(tmp_path / name))
            srv = srv_cls(toc, port=0)
            srv.start_background()
            servers.append((toc, srv))
            _call(srv.port, "PUT", "/collections/m", {
                "vectors": {"size": d, "distance": "Euclid"},
                "hnsw_config": {"m": 8, "ef_construct": 48},
                "optimizers_config": {"indexing_threshold": 1000}})
            toc.get_collection("m").bulk_ingest(list(range(n)), {"": x},
                                                [{"n": i} for i in range(n)])
            toc.optimize_all()
        (jtoc, jsrv), (ptoc, psrv) = servers
        seg, = [s for s in ptoc.get_collection("m").shards[0].segments if not s.appendable]
        assert seg.dense[""].scan_index().mesh.size == S
        graph = seg.hnsw[""]
        assert isinstance(graph, ShardedHnswIndex) and graph.n_shards == S
        truth = _exact(x, q, 10)

        def ids(port, body):
            return np.array([[h["id"] for h in _call(port, "POST", "/collections/m/points/search",
                                                     {"vector": v.tolist(), "limit": 10, **body})]
                             for v in q])

        pi, ji = ids(psrv.port, {}), ids(jsrv.port, {})
        assert scans and set(scans) == {S}  # every default search took the mesh scan
        assert _recall(pi, truth) >= 0.99
        assert _equal_where_both_exact(pi, ji, truth) >= len(q) // 2
        graph.served.clear()
        gp = ids(psrv.port, {"params": {"hnsw_ef": 64}})
        gj = ids(jsrv.port, {"params": {"hnsw_ef": 64}})
        assert graph.served["level"] > 0
        assert _recall(gp, truth) >= max(0.9, _recall(gj, truth) - 0.02)
    finally:
        for toc, srv in servers:
            srv.shutdown()
            toc.close()
