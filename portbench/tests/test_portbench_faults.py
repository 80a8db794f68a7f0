"""A whole run on the CPU (the look for a card skipped), at tiny sizes:
sound, it is correct; with its timed path broken underneath, it is not.
The faults a search cell can have: an answer altered where it is produced,
and half of a batch left out (its rows answered from the other half). A
search holds no state a step could leave unchanged, and these cells use one
chip, so they have no exchange to leave out."""

from __future__ import annotations

import pytest
import torch

from portbench import run, spec, trace


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("QDRANT_TPU_FORCE_CPU", "1")
    torch.set_num_threads(2)


def _run(root, cell):
    bench = spec.load_benchmark(root)
    return run.run_cell(root, bench, cell, 1_234_567_891, 2.0, False, "cpu",
                        run.process_start())


def _break(monkeypatch, fault):
    from qdrant_tpu_torch.collection.shard import LocalShard

    orig = LocalShard.search_dense

    def broken(self, name, queries, k, flt=None, params=None):
        res = orig(self, name, queries, k, flt, params)
        if fault == "altered":
            s, ext, ver = res[0][0]
            res[0][0] = (s, (ext + 1) % 100, ver)
        elif fault == "half_batch":
            half = (len(res) + 1) // 2
            res = res[:half] + res[: len(res) - half]
        return res

    monkeypatch.setattr(LocalShard, "search_dense", broken)


@pytest.mark.parametrize("cell", ["tiny-scan", "tiny-sq", "tiny-graph"])
def test_sound_run_is_correct(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"recall_at_10", "index_s", "setup_s"}
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    _break(monkeypatch, fault)
    res = _run(tiny_root, "tiny-scan")
    assert res["correct"] is False
    assert res["checks"]["score_rel_err"]["value"] > res["checks"]["score_rel_err"]["limit"] \
        or res["checks"]["bad_answers"]["value"] > 0


def test_trace_summary_matches_ops_to_spans_and_names_gaps():
    off = 5e6  # the trace's clock runs 5 s ahead of the host's

    def launch(tid, ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
                "ts": ts + off, "dur": 2, "args": {"correlation": corr}}

    def kernel(ts, dur, name, corr):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts + off, "dur": dur,
                "args": {"correlation": corr}}

    events = [launch(1, 100e6, 1), kernel(100e6 + 10, 1, "spin_kernel(long)", 1),
              launch(1, 101e6, 2), kernel(101e6 + 10, 1, "spin_kernel(long)", 2),
              launch(77, 100.3e6, 3), kernel(100.3e6 + 50, 1000, "fused_scan", 3)]
    spans = {"scan.bf16": [(100.2, 100.4, {"bound_s": 0.0005}, 7)],
             "shard.batch": [(100.1, 100.5, None, 7)],
             "rest.handler": [(100.05, 100.6, None, 7), (100.0, 100.9, None, 8)]}
    s = trace.summarise(events, (100.0, 101.0), spans)
    assert s["busy_s"] == pytest.approx(0.001)
    assert s["trace_window_s"] == pytest.approx(1.0)
    assert s["range_device_s"] == {"scan.bf16": pytest.approx(0.001)}
    assert s["range_calls"] == {"scan.bf16": 1, "shard.batch": 1, "rest.handler": 2}
    assert s["device_ops"] == [["fused_scan", pytest.approx(0.001)]]
    # the gap before the kernel lies inside the shard batch (deeper than the
    # handlers open then); the one after it only inside a handler
    gaps = dict(s["idle_gaps"][:2])
    assert gaps == {"all_gaps:rest.handler": pytest.approx(0.69895),
                    "all_gaps:shard.batch": pytest.approx(0.30005)}

