"""Telemetry assembly: detail levels, anonymization, opt-in reporter.

Reference behavior: src/common/telemetry.rs (TelemetryData assembled by
DetailsLevel 0-4: memory/hardware gated behind level>0, per-collection
detail behind level>=2), lib/segment/src/common/anonymize.rs (strings are
replaced by their stable hash, numeric values kept, map keys preserved),
and src/common/telemetry_reporting.rs (hourly anonymized level-2 POST,
failures logged and swallowed).

TPU-repo rendering: one pure function `build_telemetry(toc, level)` over
the live TableOfContent plus a recursive `anonymize()`; the reporter is a
daemon thread, enabled only when `telemetry_disabled` is false.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
import uuid
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

PROCESS_ID = str(uuid.uuid4())
STARTED_AT = time.time()

# keys whose values are never anonymized (reference: #[anonymize(false)]
# on versions/status enums; collection names and ids DO anonymize)
_KEEP_KEYS = {"version", "status", "data_type", "distance"}


def anonymize(obj: Any, _keep: bool = False) -> Any:
    """Recursive anonymization: strings hash to a stable 16-hex digest,
    numbers/bools pass through, dict keys are preserved while values
    recurse (reference: Anonymize derive, anonymize.rs:112-120)."""
    if isinstance(obj, str):
        if _keep:
            return obj
        return hashlib.sha256(obj.encode()).hexdigest()[:16]
    if isinstance(obj, dict):
        return {
            k: anonymize(v, _keep=k in _KEEP_KEYS) for k, v in obj.items()
        }
    if isinstance(obj, (list, tuple)):
        return [anonymize(v) for v in obj]
    return obj


def anonymize_telemetry(data: Dict[str, Any]) -> Dict[str, Any]:
    """Anonymize a telemetry payload but keep the stable process id and
    app identity (reference: #[anonymize(false)] on TelemetryData.id)."""
    out = anonymize(data)
    out["id"] = data.get("id")
    if isinstance(data.get("app"), dict):
        out["app"]["name"] = data["app"].get("name")
    return out


def _memory_telemetry() -> Dict[str, Any]:
    """RSS/VM from /proc (reference: MemoryTelemetry via jemalloc stats —
    here the host allocator is glibc; device memory comes from torch.cuda)."""
    mem: Dict[str, Any] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmRSS", "VmSize", "VmHWM")):
                    key, val = line.split(":", 1)
                    mem[key.lower() + "_kb"] = int(val.strip().split()[0])
    except OSError:
        pass
    import torch

    if torch.cuda.is_available():
        free, total_bytes = torch.cuda.mem_get_info()
        mem["device_bytes_in_use"] = int(total_bytes - free)
        mem["device_bytes_limit"] = int(total_bytes)
    return mem


def _hardware_telemetry() -> Dict[str, Any]:
    import torch

    hw: Dict[str, Any] = {"cpu_count": os.cpu_count(), "accelerators": []}
    if torch.cuda.is_available():
        hw["accelerators"] = [
            {"kind": "gpu", "device": torch.cuda.get_device_name(i)}
            for i in range(torch.cuda.device_count())
        ]
    return hw


def build_telemetry(toc, level: int = 2) -> Dict[str, Any]:
    """Assemble the /telemetry payload at `level` (0-4).

    level 0: app build info + collection count + aggregate request counters
    level 1: + memory, hardware, cluster summary, per-endpoint requests
    level 2: + per-collection info (config, counts)       [reporter level]
    level 3: + per-shard detail per collection
    level 4: + per-segment detail
    """
    from ..api.metrics import METRICS
    from ..utils.flags import feature_flags

    level = max(0, min(int(level), 4))
    collections = []
    names = toc.list_collections()
    for name in names:
        if level < 2:
            break
        coll = toc.get_collection(name)
        entry: Dict[str, Any] = {"id": name, **coll.info()}
        if level >= 3:
            from ..utils.memsize import merge, total

            shards = []
            coll_mem = merge()
            for sid, shard in sorted(coll.shards.items()):
                seg_mems = [
                    seg.memory_usage_bytes() for seg in shard.segments
                ]
                shard_mem = merge(
                    *(
                        {k: m[k] for k in
                         ("host_bytes", "device_bytes", "disk_bytes")}
                        for m in seg_mems
                    )
                )
                coll_mem = merge(coll_mem, shard_mem)
                srow: Dict[str, Any] = {
                    "shard_id": sid,
                    "points_count": shard.point_count(),
                    "segments_count": len(shard.segments),
                    "memory": {**shard_mem, "total_bytes": total(shard_mem)},
                }
                if level >= 4:
                    srow["segments"] = [
                        {
                            "points_count": len(seg),
                            "indexed": bool(
                                seg.hnsw or seg.hnsw_multi or seg.quantized
                            ),
                            "memory": mem,
                        }
                        for seg, mem in zip(shard.segments, seg_mems)
                    ]
                shards.append(srow)
            entry["shards"] = shards
            entry["memory"] = {**coll_mem, "total_bytes": total(coll_mem)}
        collections.append(entry)

    data: Dict[str, Any] = {
        "id": PROCESS_ID,
        "app": {
            "name": "qdrant-tpu",
            "version": toc_version(),
            "startup": STARTED_AT,
            "uptime_s": round(time.time() - STARTED_AT, 1),
            "features": feature_flags().to_dict(),
        },
        "collections": {
            "number_of_collections": len(names),
            "collections": collections if level >= 2 else None,
        },
        "requests": METRICS.telemetry(detail=level >= 1),
    }
    if level >= 1:
        from . import tracing

        # the port's spans per path and its counters (utils/tracing.py)
        data["tracing"] = {"spans": tracing.aggregates(), "counters": tracing.counters()}
        data["memory"] = _memory_telemetry()
        data["hardware"] = _hardware_telemetry()
        quota = getattr(toc, "quota", None)
        if quota is not None:
            # QuotaTelemetry analogue: the verdict (exceeded per resource),
            # not just the raw readings
            st = quota.status()
            data["quota"] = {"config": st["config"], "exceeded": st["exceeded"]}
        node = getattr(toc, "cluster_node", None)
        if node is not None:
            data["cluster"] = {
                "enabled": True,
                "peer_id": node.peer_id,
                "peers_count": len(node.transport.peer_urls) + 1,
                "raft_info": {
                    "term": node.raft.current_term,
                    "commit": node.raft.commit_index,
                    "role": node.raft.role,
                    "leader": node.raft.leader_id,
                },
            }
        else:
            data["cluster"] = {"enabled": False}
    return data


def toc_version() -> str:
    from ..api.rest import VERSION

    return VERSION


class TelemetryReporter:
    """Hourly anonymized level-2 reporter (reference:
    telemetry_reporting.rs:14-80). Opt-in: runs only when the settings'
    `telemetry_disabled` is false. Failures are logged at debug level and
    swallowed — reporting must never affect serving."""

    DEFAULT_URL = "https://telemetry.qdrant.io"

    def __init__(self, toc, url: Optional[str] = None, interval_s: float = 3600.0):
        self.toc = toc
        self.url = url or self.DEFAULT_URL
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_report: Optional[dict] = None  # for tests/inspection

    def build_report(self) -> dict:
        return anonymize_telemetry(build_telemetry(self.toc, level=2))

    def _send(self, payload: dict) -> bool:
        import json
        import urllib.request

        req = urllib.request.Request(
            self.url,
            data=json.dumps(payload).encode(),
            method="POST",
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return 200 <= resp.status < 300
        except Exception as exc:
            logger.debug("telemetry report failed: %s", exc)
            return False

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.last_report = self.build_report()
                self._send(self.last_report)
            except Exception as exc:  # never take the process down
                logger.debug("telemetry reporter error: %s", exc)

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="telemetry-reporter"
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()


# ---------------------------------------------------------------------------
# runtime logger configuration (reference: src/tracing/{config,handle}.rs —
# reloadable log filters; here exposed through GET/POST /logger) and the
# optional on-disk sink (reference: src/tracing/on_disk.rs — a second layer
# writing text or JSON lines to a file with its own level filter and a
# configurable write-buffer size, reconfigurable at runtime)
# ---------------------------------------------------------------------------

_LOGGER_LOCK = threading.Lock()
_LOGGER_OVERRIDES: Dict[str, str] = {}
_ON_DISK: Dict[str, Any] = {
    "enabled": False,
    "log_file": None,
    "log_level": None,
    "format": "text",
    "buffer_size_bytes": None,
}
_ON_DISK_HANDLER: Optional[logging.Handler] = None


class JsonLogFormatter(logging.Formatter):
    """One JSON object per line (reference: config::LogFormat::Json)."""

    def format(self, record: logging.LogRecord) -> str:
        import json as _json

        payload = {
            "timestamp": self.formatTime(record, "%Y-%m-%dT%H:%M:%S%z"),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exception"] = self.formatException(record.exc_info)
        return _json.dumps(payload)


def _apply_on_disk_locked() -> None:
    """(Re)install the file handler on the root logger from _ON_DISK."""
    global _ON_DISK_HANDLER
    root = logging.getLogger()
    if _ON_DISK_HANDLER is not None:
        root.removeHandler(_ON_DISK_HANDLER)
        try:
            _ON_DISK_HANDLER.close()
        except Exception:
            pass
        _ON_DISK_HANDLER = None
    if not _ON_DISK.get("enabled"):
        return
    path = _ON_DISK.get("log_file")
    if not path:
        # same contract as the reference: the sink can only be enabled with
        # a file path (on_disk.rs: "log file is not specified")
        raise ValueError("logger.on_disk.log_file is not specified")
    buf = _ON_DISK.get("buffer_size_bytes")
    # buffer_size_bytes > 0 batches writes (flushed on close/reconfigure);
    # unset/0 = line-buffered so tail -f works out of the box
    stream = open(path, "a", buffering=int(buf) if buf else 1)
    handler = logging.StreamHandler(stream)
    if str(_ON_DISK.get("format") or "text").lower() == "json":
        handler.setFormatter(JsonLogFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
    lvl = _ON_DISK.get("log_level")
    if lvl:
        lvl = str(lvl).upper()
        if lvl not in logging._nameToLevel:
            raise ValueError(f"unknown log level: {lvl}")
        handler.setLevel(lvl)
    root.addHandler(handler)
    # the sink's own filter must be reachable: if the root level is stricter
    # than the sink's, lower the handler-independent root threshold the way
    # tracing's per-layer filters compose (each layer filters independently)
    if lvl and logging._nameToLevel[lvl] < root.level:
        for h in root.handlers:
            if h is not handler and h.level == logging.NOTSET:
                h.setLevel(root.level)
        root.setLevel(lvl)
    _ON_DISK_HANDLER = handler


def configure_on_disk_logging(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Apply an on-disk sink config (startup path: settings `logger.on_disk`)."""
    with _LOGGER_LOCK:
        for key in _ON_DISK:
            if key in (cfg or {}):
                _ON_DISK[key] = cfg[key]
        _apply_on_disk_locked()
    return dict(_ON_DISK)


def logger_config() -> Dict[str, Any]:
    root = logging.getLogger()
    return {
        "log_level": logging.getLevelName(root.level),
        "overrides": dict(_LOGGER_OVERRIDES),
        "on_disk": dict(_ON_DISK),
    }


def set_logger_config(patch: Dict[str, Any]) -> Dict[str, Any]:
    """Apply a runtime logging patch: {"log_level": "DEBUG",
    "overrides": {"qdrant_tpu.cluster": "WARNING", "noisy.mod": null},
    "on_disk": {"enabled": true, "log_file": "...", "format": "json"}}.
    A null override resets that logger to inherit from root."""
    with _LOGGER_LOCK:
        if isinstance(patch.get("on_disk"), dict):
            for key in _ON_DISK:
                if key in patch["on_disk"]:
                    _ON_DISK[key] = patch["on_disk"][key]
            _apply_on_disk_locked()
        if patch.get("log_level"):
            level = str(patch["log_level"]).upper()
            if level not in logging._nameToLevel:
                raise ValueError(f"unknown log level: {level}")
            logging.getLogger().setLevel(level)
        for name, lvl in (patch.get("overrides") or {}).items():
            lg = logging.getLogger(name)
            if lvl is None:
                lg.setLevel(logging.NOTSET)
                _LOGGER_OVERRIDES.pop(name, None)
            else:
                lvl = str(lvl).upper()
                if lvl not in logging._nameToLevel:
                    raise ValueError(f"unknown log level: {lvl}")
                lg.setLevel(lvl)
                _LOGGER_OVERRIDES[name] = lvl
    return logger_config()
