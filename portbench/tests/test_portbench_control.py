"""The control (the reference in TF32 in the port's place) is not correct,
and the reference at f32 in the port's place is, at every configuration's
own width and limits with fewer rows. On the CPU, TF32 is the operands
rounded to a 10-bit mantissa; the `cuda` case runs it on the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import clients, control, judge, spec

from conftest import ROOT

BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _small(files, rows=20_000, pool=300):
    files = dict(files)
    files["config"] = dict(files["config"], rows=rows)
    files["traffic"] = dict(files["traffic"], pool=pool, clients=10)
    return files


def _f32_in_place(files, seed, per_client, device):
    """The reference at f32 answering in the port's place."""
    cfg, traffic = files["config"], files["traffic"]
    k = int(traffic["limit"])
    rows, pool = files["data"].generate(cfg["data"], cfg["rows"], cfg["dim"],
                                        traffic["pool"], seed, device)
    qidx = np.concatenate([clients.client_order(seed, c, len(pool))[:per_client]
                           for c in range(traffic["clients"])])
    ref = files["reference"].Exact(rows, cfg["distance"], device)
    uniq, inv = np.unique(qidx, return_inverse=True)
    ids, scores = ref.topk(pool[uniq], k)
    got = scores[inv].astype(np.float32).astype(np.float64)  # as a REST answer carries it
    req = {"qidx": qidx, "status": np.full(len(qidx), 200), "n_hits": np.full(len(qidx), k),
           "ids": ids[inv], "scores": got}
    num = judge.numbers(req, pool, ref, k, np.ones(len(qidx), dtype=bool))
    return judge.checks(num, cfg["limits"], float(traffic["recall_floor"]))


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_f32_passes_on_cpu(cell):
    torch.set_num_threads(2)
    files = _small(spec.resolve(ROOT, BENCH, cell))
    out = control.control_numbers(files, 2_000_000_033, 5, torch.device("cpu"))
    assert out["correct"] is False
    assert out["checks"]["score_rel_err"]["value"] > out["checks"]["score_rel_err"]["limit"]
    checks = _f32_in_place(files, 2_000_000_033, 5, torch.device("cpu"))
    assert all(judge.passed(c) for c in checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    files = _small(spec.resolve(ROOT, BENCH, cell), rows=100_000, pool=2000)
    for seed in (11, 2_000_000_033, 4_000_000_007):
        out = control.control_numbers(files, seed, 20, torch.device("cuda"))
        assert out["correct"] is False, out
