"""Layered settings: defaults → config.yaml → {RUN_MODE}.yaml → local.yaml →
env overrides `QDRANT__SECTION__KEY=value`.

Reference: src/settings.rs:243-330 + config/config.yaml. Same cascade and
env-var convention (double-underscore nesting).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

import yaml

DEFAULTS: Dict[str, Any] = {
    "log_level": "INFO",
    # optional second log sink writing to a file (reference:
    # src/tracing/on_disk.rs + config/config.yaml `logger:` section)
    "logger": {
        "on_disk": {
            "enabled": False,
            "log_file": None,
            "log_level": None,
            "format": "text",  # text | json
            "buffer_size_bytes": None,
        }
    },
    "storage": {
        "storage_path": "./storage",
        "snapshots_path": "./snapshots",
        "on_disk_payload": False,
        # disabled | no_resident | no_populate (load-time OOM recovery knob;
        # reference: config/config.yaml:49-63)
        "low_memory_mode": "disabled",
        "optimizers": {
            "deleted_threshold": 0.2,
            "vacuum_min_vector_number": 1000,
            "default_segment_number": 0,
            "indexing_threshold_kb": 20000,
            "flush_interval_sec": 5,
        },
        "hnsw_index": {
            # 20, not the reference's 16: the TPU batched beam needs graph
            # density for ef=128 coverage (types.py::HnswConfig rationale)
            "m": 20,
            "ef_construct": 128,
            "full_scan_threshold_kb": 10000,
            "payload_m": None,
        },
        "wal": {"wal_capacity_mb": 32, "wal_segments_ahead": 0},
        "performance": {"max_search_threads": 0},
    },
    "service": {
        "host": "0.0.0.0",
        "http_port": 6333,
        "grpc_port": 6334,
        "max_request_size_mb": 32,
        "enable_cors": True,
        "api_key": None,
        "read_only_api_key": None,
    },
    "cluster": {
        "enabled": False,
        "p2p": {"port": 6335},
        "consensus": {"tick_period_ms": 100},
    },
    "telemetry_disabled": False,
}


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _coerce(value: str) -> Any:
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", ""):
        return None
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def _apply_env(cfg: Dict[str, Any], environ: Dict[str, str]) -> Dict[str, Any]:
    out = copy.deepcopy(cfg)
    for key, value in environ.items():
        if not key.startswith("QDRANT__"):
            continue
        path = [p.lower() for p in key[len("QDRANT__") :].split("__")]
        node = out
        for part in path[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, dict):
                nxt = {}
                node[part] = nxt
            node = nxt
        node[path[-1]] = _coerce(value)
    return out


class Settings(dict):
    @classmethod
    def load(
        cls,
        config_dir: Optional[str] = None,
        run_mode: Optional[str] = None,
        environ: Optional[Dict[str, str]] = None,
    ) -> "Settings":
        cfg = copy.deepcopy(DEFAULTS)
        config_dir = config_dir or os.environ.get("QDRANT_CONFIG_DIR", "config")
        run_mode = run_mode or os.environ.get("RUN_MODE")
        layers = ["config.yaml"]
        if run_mode:
            layers.append(f"{run_mode}.yaml")
        layers.append("local.yaml")
        for layer in layers:
            path = os.path.join(config_dir, layer)
            if os.path.isfile(path):
                with open(path) as f:
                    data = yaml.safe_load(f) or {}
                cfg = _deep_merge(cfg, data)
        custom = os.environ.get("QDRANT_CONFIG_PATH")
        if custom and os.path.isfile(custom):
            with open(custom) as f:
                cfg = _deep_merge(cfg, yaml.safe_load(f) or {})
        cfg = _apply_env(cfg, environ if environ is not None else dict(os.environ))
        return cls(cfg)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node
