"""Resolve a cell of BENCHMARK.json to its files, by name.

A configuration is the file its entry names, a traffic mix is
`traffic/<mix>.json`, and every metric (end-to-end or per-layer) is read by
`metrics/<metric>.py`. A later cell adds files and entries; none of the
functions here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List, Optional

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG_DIR)
PKG = os.path.basename(PKG_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(root: str, bench: dict, name: str) -> dict:
    """The configuration's own file, as its entry names it."""
    entry = next(c for c in bench["configs"] if c["name"] == name)
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def load_traffic(root: str, name: str) -> dict:
    with open(os.path.join(root, PKG, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _load_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(root: str, name: str) -> ModuleType:
    """The reader of metric `name`: `metrics/<name>.py` (the name may hold
    dots, so it is loaded by path, not imported)."""
    path = os.path.join(root, PKG, "metrics", f"{name}.py")
    return _load_module(path, f"{PKG}_metric_{name.replace('.', '_').replace('-', '_')}")


def named_module(root: str, folder: str, name: str) -> ModuleType:
    """`<folder>/<name>.py` under the benchmark (a data generator or a
    reference), loaded by path."""
    path = os.path.join(root, PKG, folder, f"{name}.py")
    return _load_module(path, f"{PKG}_{folder}_{name.replace('.', '_').replace('-', '_')}")


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell_metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics with
    tracing off, its per-layer metrics with tracing on."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if applies(m, cell_name)]


def readers(root: str, metrics: List[dict]) -> Dict[str, ModuleType]:
    return {m["name"]: metric_module(root, m["name"]) for m in metrics}


def resolve(root: str, bench: dict, cell_name: str) -> Dict[str, Optional[object]]:
    """Every file a cell needs, loaded → {config, traffic, readers, data,
    reference}; raises where one is missing."""
    cell = workload(bench, cell_name)
    cfg = load_config(root, bench, cell["config"])
    traffic = load_traffic(root, cell["traffic"])
    mods = {}
    for trace in (False, True):
        mods.update(readers(root, cell_metrics(bench, cell_name, trace)))
    return {
        "cell": cell, "config": cfg, "traffic": traffic, "readers": mods,
        "data": named_module(root, "data", cfg["data"]["generator"]),
        "reference": named_module(root, "reference", cfg["reference"]),
    }
