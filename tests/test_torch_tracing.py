"""The port's spans and counters (qdrant_tpu_torch/utils/tracing.py), on the
CPU: nesting and self time, per-path aggregates and thread-CPU seconds, the
timeline's bounds, coalesced batches through the port's micro-batcher (one
batch id, one queue wait per request, each request's own usage), the spans a
seal records, the aggregates in GET /telemetry, and the benchmark's readers
of them on hand-built contexts."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from portbench import spec
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.utils import hw_counter, tracing
from qdrant_tpu_torch.utils.microbatch import MicroBatcher
from qdrant_tpu_torch.utils.telemetry import build_telemetry

force_cpu()
torch.set_num_threads(1)  # the seal's graph programs are many tiny ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _busy(seconds):
    end = time.thread_time() + seconds
    while time.thread_time() < end:
        pass


def test_nesting_parent_and_self_time():
    tr = tracing.Tracer()
    tr.timeline_start()
    with tr.span("outer", kind="a"):
        time.sleep(0.02)
        with tr.span("inner", rows=7):
            time.sleep(0.03)
    tr.timeline_stop()
    agg = tr.aggregates()
    assert set(agg) == {"outer", "outer/inner"}
    outer, inner = agg["outer"], agg["outer/inner"]
    assert outer["count"] == inner["count"] == 1
    assert inner["wall_s"] >= 0.03 and outer["wall_s"] >= 0.05
    assert outer["self_s"] == pytest.approx(outer["wall_s"] - inner["wall_s"])
    assert inner["self_s"] == pytest.approx(inner["wall_s"])
    (o0, o1, o_info, o_tid), = tr.timeline()["outer"]
    (i0, i1, i_info, i_tid), = tr.timeline()["inner"]
    assert o0 <= i0 <= i1 <= o1 and o_tid == i_tid == threading.get_ident()
    assert o_info["parent"] is None and o_info["kind"] == "a"
    assert i_info["parent"] == "outer" and i_info["path"] == "outer/inner"
    assert i_info["rows"] == 7


def test_aggregates_per_path_and_thread_cpu():
    tr = tracing.Tracer()
    for parent in ("load", "seal"):
        with tr.span(parent):
            with tr.span("flush"):
                _busy(0.05)
    with tr.span("seal"):
        with tr.span("flush"):
            time.sleep(0.05)
    tr.count("points", 3)
    tr.count("points")
    agg = tr.aggregates()
    assert agg["load/flush"]["count"] == 1 and agg["seal/flush"]["count"] == 2
    # busy, the thread ran for 50 ms; asleep, it waited 50 ms more
    assert agg["load/flush"]["cpu_s"] >= 0.05
    assert agg["seal/flush"]["cpu_s"] >= 0.05
    assert agg["seal/flush"]["wall_s"] - agg["seal/flush"]["cpu_s"] >= 0.045
    assert tr.total("flush") == pytest.approx(agg["load/flush"]["wall_s"]
                                              + agg["seal/flush"]["wall_s"])
    assert tr.total("seal/flush") == pytest.approx(agg["seal/flush"]["wall_s"])
    assert tr.total("missing") is None
    assert tr.counters() == {"points": 4}


def test_threads_keep_their_own_nesting():
    tr = tracing.Tracer()
    inside = threading.Event()
    done = threading.Event()

    def other():
        with tr.span("worker"):
            inside.set()
            done.wait(10)

    t = threading.Thread(target=other)
    with tr.span("main"):
        t.start()
        assert inside.wait(10)
        with tr.span("step"):
            pass
        done.set()
        t.join(10)
    assert not t.is_alive()
    assert set(tr.aggregates()) == {"main", "main/step", "worker"}


def test_timeline_keeps_nothing_while_off_and_is_bounded_while_on():
    tr = tracing.Tracer()
    with tr.span("before"):
        pass
    assert tr.timeline() == {}
    tr.timeline_start(max_records=3)
    tr.timeline_start()  # starts nest
    for _ in range(5):
        with tr.span("s"):
            pass
    tr.timeline_stop()
    with tr.span("s"):  # still on: one start is left
        pass
    tr.timeline_stop()
    with tr.span("after"):
        pass
    assert list(tr.timeline()) == ["s"] and len(tr.timeline()["s"]) == 3
    assert tr.timeline_dropped() == 3
    assert tr.aggregates()["s"]["count"] == 6  # the aggregates miss nothing
    tr.timeline_start()  # a new timeline starts empty
    assert tr.timeline() == {} and tr.timeline_dropped() == 0
    tr.timeline_stop()


def _coalesce(mb, key, rows, exec_fn, exec_many_fn=None, measure=False):
    """Run one request per row in its own thread, queued behind a held exec
    lock so that one leader serves all of them → (results, usage, thread
    ids), each by row."""
    results, usage, tids = {}, {}, {}

    def worker(i, row):
        tids[i] = threading.get_ident()
        if measure:
            with hw_counter.measure() as acc:
                results[i] = mb.run(key, [row], exec_fn, exec_many_fn)
            usage[i] = acc.to_dict()
        else:
            results[i] = mb.run(key, [row], exec_fn, exec_many_fn)

    threads = [threading.Thread(target=worker, args=(i, r)) for i, r in enumerate(rows)]
    with mb._exec_lock:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while len(mb._pending.get(key, [])) < len(rows):
            assert time.monotonic() < deadline, "the requests did not queue"
            time.sleep(0.001)
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    return results, usage, tids


def test_coalesced_requests_share_a_batch_id_and_wait_each():
    tracing.timeline_start()
    try:
        calls = []

        def exec_fn(rows):
            calls.append(len(rows))
            with tracing.span("inside"):
                pass
            return [r * 2 for r in rows]

        results, _, tids = _coalesce(MicroBatcher(), "k", [1, 2, 3], exec_fn)
    finally:
        tracing.timeline_stop()
    assert calls == [3] and results == {0: [2], 1: [4], 2: [6]}
    recs = tracing.timeline()
    (x0, _, exec_info, leader), = recs["batch.exec"]
    assert (exec_info["rows"], exec_info["padded"], exec_info["chunks"]) == (3, 8, 1)
    batch = exec_info["batch"]
    waits = recs["batch.wait"]
    assert sorted(tid for *_, tid in waits) == sorted(tids.values())
    assert all(info["batch"] == batch and b == x0 and a <= b for a, b, info, _ in waits)
    (_, _, inside, tid), = recs["inside"]
    assert inside["batch"] == batch and inside["parent"] == "batch.exec" and tid == leader


def test_coalesced_requests_each_report_their_own_usage():
    """A batch counts once per chunk, as a segment does for the rows it
    scores; every request in the batch reports that count, whoever led."""

    def exec_fn(rows):
        hw_counter.add(vectors_scored=10, dims=4, payload_reads=1)
        return list(rows)

    def exec_many(row_lists):
        return [exec_fn(r) for r in row_lists]

    with hw_counter.measure() as alone:
        MicroBatcher().run("k", [0], exec_fn)
    assert alone.to_dict() == {"cpu": 40, "vector_io_read": 10, "payload_io_read": 1}
    _, usage, _ = _coalesce(MicroBatcher(), "k", [0, 1], exec_fn, measure=True)
    assert usage == {0: alone.to_dict(), 1: alone.to_dict()}
    # a queue drained as a window of chunks (one row each)
    _, usage, _ = _coalesce(MicroBatcher(max_rows=1), "k", [0, 1, 2], exec_fn, exec_many,
                            measure=True)
    assert usage == {i: alone.to_dict() for i in range(3)}


def test_coalesced_searches_report_what_they_report_alone(tmp_path):
    toc = TableOfContent(str(tmp_path))
    toc.create_collection("c", {"vectors": {"size": 8, "distance": "Dot"}})
    coll = toc.get_collection("c")
    x = np.random.default_rng(3).standard_normal((64, 8)).astype(np.float32)
    coll.bulk_ingest(list(range(64)), {"": x})
    with hw_counter.measure() as alone:
        want = coll.search_dense("", x[:1], 3)
    assert alone.cpu == 64 * 8
    mb = coll._microbatcher()
    results, usage = {}, {}

    def worker(i):
        with hw_counter.measure() as acc:
            results[i] = coll.search_dense("", x[i : i + 1], 3)
        usage[i] = acc.to_dict()

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    with mb._exec_lock:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while sum(len(v) for v in mb._pending.values()) < 2:
            assert time.monotonic() < deadline, "the searches did not queue"
            time.sleep(0.001)
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert [h[1] for h in results[0][0]] == [h[1] for h in want[0]]
    assert usage == {0: alone.to_dict(), 1: alone.to_dict()}
    toc.close()


SETUP_PATHS = {
    "shard.bulk_ingest",
    "shard.bulk_ingest/shard.check_ids",
    "shard.bulk_ingest/segment.bulk_ingest",
    "shard.bulk_ingest/shard.flush",
    "shard.optimize",
    "shard.optimize/shard.defragment",
    "shard.optimize/segment.build_indexes",
    "shard.optimize/segment.build_indexes/hnsw.build",
    "shard.optimize/segment.build_indexes/hnsw.build/build.sync",
    "shard.optimize/segment.build_indexes/segment.scan_block",
    "shard.optimize/segment.build_indexes/segment.quantize",
    "shard.optimize/shard.swap",
    "shard.optimize/shard.swap/shard.rmtree",
    "shard.optimize/shard.swap/shard.flush",
    "shard.optimize/shard.swap/shard.flush/hnsw.save",
}


def _seal(path, rows, monkeypatch):
    """Load `rows` points of a plain and a quantized vector and seal them →
    (the span counts by path, the counters)."""
    import qdrant_tpu_torch.index.plain as plain

    monkeypatch.setattr(plain, "SCAN_THRESHOLD", 512)  # the scan block at this size
    tracing.reset()
    toc = TableOfContent(path)
    toc.create_collection("s", {
        "vectors": {"a": {"size": 8, "distance": "Euclid"},
                    "q": {"size": 8, "distance": "Dot",
                          "quantization_config": {"scalar": {"type": "int8"}}}},
        "hnsw_config": {"m": 4, "ef_construct": 16},
        "optimizers_config": {"indexing_threshold": 100},
    })
    rng = np.random.default_rng(rows)
    coll = toc.get_collection("s")
    coll.bulk_ingest(list(range(rows)), {
        name: rng.standard_normal((rows, 8)).astype(np.float32) for name in ("a", "q")})
    toc.optimize_all()
    toc.close()
    spans = {p: a["count"] for p, a in tracing.aggregates().items() if p in SETUP_PATHS
             or p.startswith(("shard.bulk_ingest", "shard.optimize"))}
    return spans, tracing.counters()


def test_a_seal_records_every_setup_path_whatever_its_rows(tmp_path, monkeypatch):
    small, small_counts = _seal(str(tmp_path / "small"), 1000, monkeypatch)
    large, large_counts = _seal(str(tmp_path / "large"), 4000, monkeypatch)
    assert set(small) == SETUP_PATHS
    assert small == large  # spans sit at phases and calls, never per point
    for counts, rows in ((small_counts, 1000), (large_counts, 4000)):
        assert counts["defragment.points"] == rows
        assert counts["defragment.bulk_rows"] == rows  # the dense seal copies by arrays
        assert counts["flush.bytes"] > rows * 8 * 4  # at least the f32 rows, twice
        assert counts["build.batches"] > 0 and counts["build.insert_rounds"] > 0
    assert large_counts["build.batches"] > small_counts["build.batches"]


def test_graph_search_counts_its_turns_and_flag_reads(tmp_path, monkeypatch):
    tracing.reset()
    toc = TableOfContent(str(tmp_path))
    toc.create_collection("g", {"vectors": {"size": 8, "distance": "Euclid"},
                                "hnsw_config": {"m": 4, "ef_construct": 16},
                                "optimizers_config": {"indexing_threshold": 100}})
    coll = toc.get_collection("g")
    x = np.random.default_rng(5).standard_normal((300, 8)).astype(np.float32)
    coll.bulk_ingest(list(range(300)), {"": x})
    toc.optimize_all()
    built = tracing.counters()
    tracing.timeline_start()
    try:
        from qdrant_tpu_torch.storage.segment import SearchParams

        coll.search_dense("", x[:3], 5, params=SearchParams(hnsw_ef=16))
    finally:
        tracing.timeline_stop()
    toc.close()
    counts = tracing.counters()
    turns = counts["beam.turns"] - built.get("beam.turns", 0)
    reads = counts["beam.flag_reads"] - built.get("beam.flag_reads", 0)
    assert turns > 0 and 0 < reads <= turns // 4 + 1
    recs = tracing.timeline()
    (_, _, info, _), = recs["hnsw.search"]
    assert info["path"] == "batch.exec/shard.batch/segment.dispatch/hnsw.search"
    assert {r[2]["parent"] for r in recs["hnsw.beam"]} == {info["path"]}
    assert {r[2]["path"] for r in recs["segment.alive_mask"]} == {
        "batch.exec/shard.batch/segment.alive_mask"}
    assert "shard.merge" in recs and "device.fetch" in recs and "hnsw.descend" in recs


def test_telemetry_carries_the_aggregates_and_counters(tmp_path):
    toc = TableOfContent(str(tmp_path))
    with tracing.span("telemetry.probe"):
        tracing.count("telemetry.probes")
    assert "tracing" not in build_telemetry(toc, level=0)
    data = build_telemetry(toc, level=1)["tracing"]
    assert data["spans"]["telemetry.probe"]["count"] >= 1
    assert set(data["spans"]["telemetry.probe"]) == {"count", "wall_s", "self_s", "cpu_s"}
    assert data["counters"]["telemetry.probes"] >= 1
    toc.close()


class _Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _reader(name):
    return spec.metric_module(ROOT, name)


def test_the_aggregate_readers_read_their_paths():
    tracing.reset()
    with tracing.span("shard.bulk_ingest"):
        with tracing.span("shard.flush"):
            time.sleep(0.01)
    with tracing.span("shard.optimize"):
        with tracing.span("segment.build_indexes"):
            with tracing.span("hnsw.build"):
                with tracing.span("build.sync"):
                    time.sleep(0.01)
            with tracing.span("segment.scan_block"):
                pass
            with tracing.span("segment.quantize"):
                pass
        with tracing.span("shard.swap"):
            with tracing.span("shard.flush"):
                time.sleep(0.02)
    ctx = _Ctx()
    agg = tracing.aggregates()
    flush = "shard.optimize/shard.swap/shard.flush"
    assert _reader("load.flush_s").read(ctx) == agg["shard.bulk_ingest/shard.flush"]["wall_s"]
    assert _reader("seal.flush_s").read(ctx) == agg[flush]["wall_s"]
    assert _reader("build.sync_wait_s").read(ctx) == pytest.approx(0.01, abs=0.05)
    up = _reader("seal.upload_s").read(ctx)
    assert up == pytest.approx(
        agg["shard.optimize/segment.build_indexes/segment.scan_block"]["wall_s"]
        + agg["shard.optimize/segment.build_indexes/segment.quantize"]["wall_s"])
    tracing.reset()
    assert all(_reader(n).read(ctx) is None for n in (
        "load.flush_s", "seal.flush_s", "seal.upload_s", "build.sync_wait_s"))


TIMELINE_READERS = ("batch.wait_ms", "segment.alive_mask_cpu_share", "device.fetch_ms",
                    "beam.turns_per_batch", "shard.merge_ms")


def test_the_timeline_readers_read_the_traced_window():
    tracing.reset()
    readers = {n: _reader(n) for n in TIMELINE_READERS}
    with tracing.span("shard.batch"):  # before the window: not read
        time.sleep(0.01)
    start = {n: m.snapshot() for n, m in readers.items()}
    t0 = time.monotonic()
    for _ in range(2):
        now = time.monotonic()
        tracing.record("batch.wait", now - 0.004, now)
        with tracing.span("shard.batch"):
            with tracing.span("segment.alive_mask"):
                _busy(0.01)
            with tracing.span("hnsw.search"):
                tracing.count("beam.turns", 12)
                with tracing.span("device.fetch"):
                    time.sleep(0.005)
            with tracing.span("shard.merge"):
                _busy(0.002)
    t1 = time.monotonic()
    end = {n: m.snapshot() for n, m in readers.items()}
    ctx = _Ctx(profile_window=(t0, t1), snapshots={"start": start, "end": end})
    got = {n: m.read(ctx) for n, m in readers.items()}
    assert got["batch.wait_ms"] == pytest.approx(4.0)
    masks = [r for r in tracing.timeline()["segment.alive_mask"] if t0 < r[1] <= t1]
    assert len(masks) == 2
    cpu = sum(info["cpu"] for _, _, info, _ in masks)
    assert cpu >= 0.02  # each ran 10 ms on the thread
    assert got["segment.alive_mask_cpu_share"] == pytest.approx(
        100.0 * cpu / sum(b - a for a, b, *_ in masks))
    fetch = sum(b - a for a, b, *_ in tracing.timeline()["device.fetch"])
    assert fetch >= 0.01 and got["device.fetch_ms"] == pytest.approx(fetch / 2 * 1e3)
    assert got["beam.turns_per_batch"] == 12
    merges = [info["self"] for _, _, info, _ in tracing.timeline()["shard.merge"]]
    assert min(merges) >= 0.002 and got["shard.merge_ms"] == pytest.approx(sum(merges) / 2 * 1e3)
    assert tracing.TRACER._timeline_users == 0  # every reader stopped its hold
    empty = _Ctx(profile_window=(0.0, 0.0), snapshots={"start": {}, "end": {}})
    assert all(m.read(empty) is None for m in readers.values())
