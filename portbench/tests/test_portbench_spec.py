"""BENCHMARK.json against its contract, and every cell against its files."""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import pytest

from portbench import spec

from conftest import ROOT

BENCH = spec.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    files = spec.resolve(ROOT, BENCH, cell)
    cfg, traffic = files["config"], files["traffic"]
    assert cfg["name"] == files["cell"]["config"]
    assert {"rows", "dim", "distance", "collection", "data", "reference", "limits"} <= set(cfg)
    assert {"clients", "processes", "pool", "limit", "warmup_s", "tail_s", "profile_s",
            "recall_floor"} <= set(traffic)
    assert hasattr(files["data"], "generate") and hasattr(files["reference"], "Exact")
    for trace in (False, True):
        metrics = spec.cell_metrics(BENCH, cell, trace)
        assert metrics, f"{cell} reports no metric with trace={trace}"
        for m in metrics:
            assert callable(files["readers"][m["name"]].read)


def test_benchmark_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits into 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert set(c["reduced"]) == set(json.load(f)["reduced"])
    cells = BENCH["workloads"]
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
            assert spec.applies(moved, cell), f"{m['name']} in {cell} moves an unreported metric"
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        e = [m["name"] for m in spec.cell_metrics(BENCH, w["name"], False)]
        assert "setup_s" in e and len(e) >= 2
        assert spec.cell_metrics(BENCH, w["name"], True)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            if "__pycache__" not in dirpath:
                p = os.path.join(dirpath, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_new_config_traffic_and_metric_are_found_with_no_file_edited(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    pkg = os.path.join(root, "portbench")
    with open(os.path.join(pkg, "configs", "sift128-euclid-1m.json")) as f:
        cfg = json.load(f)
    cfg.update(name="glove100-cosine", dim=100, distance="Cosine",
               collection={"vectors": {"size": 100, "distance": "Cosine"}})
    with open(os.path.join(pkg, "configs", "glove100-cosine.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pkg, "traffic", "closed100-default.json")) as f:
        traffic = json.load(f)
    traffic.update(clients=10, params={"hnsw_ef": 64})
    with open(os.path.join(pkg, "traffic", "closed10-ef64.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(pkg, "metrics", "load.rows_per_s.py"), "w") as f:
        f.write("def read(ctx):\n"
                "    return ctx.config['rows'] / ctx.phases['load_s']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "glove100-cosine", "source": "ann-benchmarks glove-100",
                             "file": "portbench/configs/glove100-cosine.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "glove-ef64", "config": "glove100-cosine",
                               "traffic": "closed10-ef64", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "load.rows_per_s", "unit": "rows/s", "better": "higher",
                               "source": "host_clock", "layer": "bulk load (collection.py)",
                               "moves": "index_s", "workloads": ["glove-ef64"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    bench = spec.load_benchmark(root)
    files = spec.resolve(root, bench, "glove-ef64")
    assert files["config"]["dim"] == 100 and files["traffic"]["clients"] == 10
    assert "load.rows_per_s" in files["readers"]
    assert "load.rows_per_s" in [m["name"] for m in spec.cell_metrics(bench, "glove-ef64", True)]
    after = _digests(root)
    assert {p: d for p, d in after.items() if p in before} == before
    assert set(after) - set(before) == {
        "portbench/configs/glove100-cosine.json", "portbench/traffic/closed10-ef64.json",
        "portbench/metrics/load.rows_per_s.py"}
