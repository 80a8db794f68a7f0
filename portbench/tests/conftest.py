"""Fixtures of the benchmark's own tests (CPU unless marked `cuda`).

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG_DIR)

# Tiny cells that drive a whole run on the CPU: the configurations keep their
# distance and quantization, with few rows, narrow rows, a small graph and a
# low indexing threshold so that the seal runs in seconds.
TINY = {
    "tiny-euclid": ("sift128-euclid-1m", 16),
    "tiny-sq": ("dbpedia1536-cosine-sq-int8", 32),
}
TINY_CELLS = {
    "tiny-graph": ("tiny-euclid", "closed100-ef128"),
    "tiny-scan": ("tiny-euclid", "closed100-default"),
    "tiny-sq": ("tiny-sq", "closed100-default"),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def make_tiny_root(dest: str, rows: int = 3000) -> str:
    """A copy of BENCHMARK.json and the benchmark's folder with tiny cells
    added (new files and entries only) → the copy's root."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(PKG_DIR, os.path.join(dest, os.path.basename(PKG_DIR)),
                    ignore=shutil.ignore_patterns("__pycache__"))
    pkg = os.path.join(dest, os.path.basename(PKG_DIR))
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, (src, dim) in TINY.items():
        entry = next(c for c in bench["configs"] if c["name"] == src)
        with open(os.path.join(ROOT, entry["file"])) as f:
            cfg = json.load(f)
        cfg.update(name=name, rows=rows, dim=dim)
        cfg["collection"]["vectors"]["size"] = dim
        cfg["collection"]["optimizers_config"] = {"indexing_threshold": rows // 3}
        cfg["collection"]["hnsw_config"] = {"m": 8, "ef_construct": 32}
        cfg["data"]["centres"] = 64
        path = f"{os.path.basename(PKG_DIR)}/configs/{name}.json"
        with open(os.path.join(dest, path), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append(dict(entry, name=name, file=path))
    for mix in {t for _, t in TINY_CELLS.values()}:
        with open(os.path.join(pkg, "traffic", f"{mix}.json")) as f:
            traffic = json.load(f)
        traffic.update(clients=8, processes=2, pool=400, warmup_s=0.5, tail_s=1.0,
                       profile_s=1.0)
        with open(os.path.join(pkg, "traffic", f"tiny-{mix}.json"), "w") as f:
            json.dump(traffic, f)
    for cell, (cfg, mix) in TINY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg, "traffic": f"tiny-{mix}",
                                   "chips": 1, "why": "a CPU rehearsal of a cell"})
    twin = {"sift1m-hnsw-ef128": "tiny-graph", "sift1m-scan": "tiny-scan",
            "dbpedia1536-sq-int8": "tiny-sq"}
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [twin[w] for w in m["workloads"] if w in twin]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny_root")))
