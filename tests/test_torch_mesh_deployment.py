"""SIFT-1M's four-card deployment (the benchmark cell `sift1m-mesh4-scan`) at
a small size on the CPU: SIFT-shaped 16-d Euclid rows from the benchmark's
own generator, loaded with `Collection.bulk_ingest`, sealed by
`TableOfContent.optimize_all` and searched through REST, once on 4 logical
devices (the device mesh, parallel/mesh.py) and once on 1.

The rows fill every shard of the mesh (16,000 rows: 4,096 padded rows a
shard, the last holding 3,712). The scan threshold is lowered so that the
default searches take the scan at this size, as `test_torch_mesh.py` does.
Answers are judged by the benchmark's own comparison (`portbench/judge.py`
against `portbench/reference/exact_dense.py`): no bad answer, every score
within the cell's 2e-4 of the exact distance of its id, recall@10 at least
the traffic's 0.99 (a survivor bin of the scan may drop a row, on the card
as here). Where both the mesh and the one device answer the exact top-10,
the answers are identical. The mesh's spans and counters move; with one
device no `mesh.*` span appears."""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

import qdrant_tpu_torch.index.plain as port_plain
from portbench import judge, spec
from qdrant_tpu_torch import device as port_device
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.index.hnsw import HnswIndex, ShardedHnswIndex
from qdrant_tpu_torch.utils import tracing

port_device.force_cpu()
torch.set_num_threads(1)  # the seal's graph programs are many tiny ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                     "sift128-euclid-1m-mesh4.json")))
N, D, NQ, K, S = 16_000, 16, 64, 10, 4
SEED = 3_000_000_019


def _call(port, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        out = json.loads(resp.read())
    assert out["status"] == "ok", out
    return out["result"]


def _serve(path, rows, queries, devices):
    """Seal `rows` through REST on `devices` logical devices and search every
    query alone → what the tests read."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_plain, "SCAN_THRESHOLD", 1024)
        mp.setattr(port_device, "_LOGICAL", None)
        port_device.set_logical_devices(devices)
        tracing.reset()
        toc = TableOfContent(path)
        srv = RestServer(toc, port=0)
        srv.start_background()
        try:
            _call(srv.port, "PUT", "/collections/m", {
                "vectors": {"size": D, "distance": "Euclid"},
                "hnsw_config": {"m": 8, "ef_construct": 32},
                "optimizers_config": {"indexing_threshold": 1000}})
            coll = toc.get_collection("m")
            coll.bulk_ingest(list(range(N)), {"": rows})
            toc.optimize_all()
            sealed = [(len(s), s.appendable) for sh in coll.shards.values() for s in sh.segments]
            seg, = [s for sh in coll.shards.values() for s in sh.segments if not s.appendable]
            seal = {"spans": tracing.aggregates(), "counters": tracing.counters()}
            tracing.timeline_start()
            try:
                hits = [_call(srv.port, "POST", "/collections/m/points/search",
                              {"vector": q.tolist(), "limit": K}) for q in queries]
            finally:
                tracing.timeline_stop()
            return {
                "sealed": sealed, "scan": seg.dense[""].scan_index(), "graph": seg.hnsw[""],
                "ids": np.array([[h["id"] for h in r] for r in hits]),
                "scores": np.array([[h["score"] for h in r] for r in hits]),
                "seal": seal, "spans": tracing.aggregates(), "counters": tracing.counters(),
                "timeline": tracing.timeline(),
            }
        finally:
            srv.shutdown()
            toc.close()
            tracing.reset()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    data = spec.named_module(ROOT, "data", CONFIG["data"]["generator"])
    rows, queries = data.generate(CONFIG["data"], N, D, NQ, SEED, torch.device("cpu"))
    ref = spec.named_module(ROOT, "reference", CONFIG["reference"]).Exact(
        rows, CONFIG["distance"], torch.device("cpu"))
    out = {"rows": rows, "queries": queries, "ref": ref}
    for devices in (S, 1):
        out[devices] = _serve(str(tmp_path_factory.mktemp(f"mesh{devices}")), rows, queries,
                              devices)
    return out


def _judged(served, devices):
    got = served[devices]
    req = {"qidx": np.arange(NQ), "status": np.full(NQ, 200), "n_hits": np.full(NQ, K),
           "ids": got["ids"], "scores": got["scores"]}
    return judge.numbers(req, served["queries"], served["ref"], K, np.ones(NQ, dtype=bool))


def test_the_seal_lays_one_segment_out_over_the_mesh(served):
    got = served[S]
    assert got["sealed"] == [(N, False)]
    assert got["scan"].mesh.size == S and got["scan"].n_pad // S == 4096
    assert isinstance(got["graph"], ShardedHnswIndex) and got["graph"].n_shards == S
    one = served[1]
    assert one["sealed"] == [(N, False)] and one["scan"].mesh is None
    assert type(one["graph"]) is HnswIndex


@pytest.mark.parametrize("devices", [S, 1])
def test_answers_hold_to_the_reference(served, devices):
    num = _judged(served, devices)
    checks = judge.checks(num, CONFIG["limits"], 0.99)
    assert CONFIG["limits"]["score_rel_err"] == 2e-4
    assert num["bad_answers"] == 0 and num["score_rel_err"] <= 2e-4, checks
    assert num["recall_at_10"] >= 0.99, checks


def test_the_mesh_answers_what_one_device_answers(served):
    exact = [(_judged(served, d)["recall"] == 1.0) for d in (S, 1)]
    both = exact[0] & exact[1]
    assert both.sum() >= 0.9 * NQ
    assert np.array_equal(served[S]["ids"][both], served[1]["ids"][both])
    assert np.array_equal(served[S]["scores"][both], served[1]["scores"][both])


def test_every_default_search_takes_the_mesh_scan(served):
    recs = served[S]["timeline"]["mesh.scan"]
    assert len(recs) == NQ  # one a search: each request is a batch of its own
    assert {(r[2]["shards"], r[2]["cards"], r[2]["rows_per_shard"], r[2]["b"])
            for r in recs} == {(S, 1, 4096, 8)}
    merges = served[S]["timeline"]["mesh.merge"]
    assert len(merges) == NQ and {r[2]["parent"] for r in merges} == {
        r[2]["path"] for r in recs}


def test_the_seal_places_and_builds_under_its_spans(served):
    paths = {p: a["count"] for p, a in served[S]["seal"]["spans"].items()
             if p.rsplit("/", 1)[-1].startswith("mesh.")}
    seal = "shard.optimize/segment.build_indexes"
    assert paths == {  # the graph's rows and links, then the scan's blocks, biases and rows
        f"{seal}/hnsw.build/mesh.subgraph": S,
        f"{seal}/hnsw.build/mesh.place": 1,
        f"{seal}/segment.scan_block/mesh.place": 1,
    }
    scan, graph = served[S]["scan"], served[S]["graph"]
    parts = [*scan._v[1:], *scan._mask[1:], *scan._rows[1:], *graph._v[1:], *graph._links[1:]]
    assert [tuple(t.shape) for t in scan._v] == [(4096, scan.d_pad)] * S
    assert [tuple(t.shape) for t in graph._links] == [(graph.n_per_shard, graph.config.m0)] * S
    assert served[S]["seal"]["counters"]["mesh.place_bytes"] == sum(
        t.numel() * t.element_size() for t in parts)


def test_the_mesh_counts_the_bytes_it_sends_between_shards(served):
    c0, c1 = served[S]["seal"]["counters"], served[S]["counters"]
    sent = c1["mesh.peer_bytes"] - c0.get("mesh.peer_bytes", 0)
    queries = 8 * served[S]["scan"].d_pad * 4  # the padded f32 batch, to each other shard
    candidates = 8 * K * (4 + 4)  # f32 scores and int32 ids, back from each
    assert sent == NQ * (S - 1) * (queries + candidates)


def test_one_device_has_no_mesh_span(served):
    one = served[1]
    for spans in (one["seal"]["spans"], one["spans"]):
        assert not [p for p in spans if "mesh." in p]
    assert not [n for n in one["timeline"] if n.startswith("mesh.")]
    assert not [n for n in one["counters"] if n.startswith("mesh.")]


class _Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _reader(name):
    return spec.metric_module(ROOT, name)


def test_the_mesh_readers_read_the_port_and_the_trace():
    tracing.reset()
    with tracing.span("segment.build_indexes"):
        with tracing.span("hnsw.build"):
            for shard in range(2):
                with tracing.span("mesh.subgraph", shard=shard):
                    pass
            with tracing.span("mesh.place"):
                pass
        with tracing.span("mesh.place"):
            pass
    ctx = _Ctx()
    agg = tracing.aggregates()
    assert _reader("mesh.place_s").read(ctx) == pytest.approx(sum(
        a["wall_s"] for p, a in agg.items() if p.endswith("/mesh.place")))
    assert _reader("mesh.subgraph_build_s").read(ctx) == pytest.approx(
        agg["segment.build_indexes/hnsw.build/mesh.subgraph"]["wall_s"])
    tracing.reset()
    assert _reader("mesh.place_s").read(ctx) is None
    assert _reader("mesh.subgraph_build_s").read(ctx) is None

    # 10 calls in the traced window, 4 cards: 2 ms of scan a call on each card
    step = {"bound_s": 1e-3, "cards": 4}
    ctx = _Ctx(trace={"range_calls": {"mesh.scan": 10, "mesh.merge": 10},
                      "range_device_s": {"mesh.scan": 0.08, "mesh.merge": 0.003}},
               profile_window=(0.0, 10.0),
               spans={"mesh.scan": [(1.0 + i, 1.5 + i, step, 7) for i in range(10)]},
               snapshots={"start": {"mesh.card0_excess_gib": [5 * 2**30, 2**30, 2**30, 3 * 2**30]}})
    assert _reader("mesh.scan_bf16_roofline").read(ctx) == pytest.approx(50.0)
    from portbench import roofline
    from qdrant_tpu_torch.parallel.mesh import make_mesh

    blocks = [torch.zeros(4096, 128, dtype=torch.bfloat16)] * 4
    got = _reader("mesh.scan_bf16_roofline").DESCRIBE["mesh.scan"](
        make_mesh(4), torch.zeros(64, 128), blocks, None, None, 4096, 20, 10, True)
    assert got == dict(roofline.scan_step("bf16", 64, 4096, 128, 10, 20), cards=1)
    assert _reader("mesh.merge_ms").read(ctx) == pytest.approx(0.3)
    assert _reader("mesh.card0_excess_gib").read(ctx) == pytest.approx(5 - 5 / 3)
    none = _Ctx(trace={}, profile_window=(0.0, 0.0), spans={}, snapshots={"start": {}})
    for name in ("mesh.scan_bf16_roofline", "mesh.merge_ms", "mesh.card0_excess_gib"):
        assert _reader(name).read(none) is None
    assert _reader("mesh.card0_excess_gib").snapshot() is None  # no card here
