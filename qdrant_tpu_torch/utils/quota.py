"""Node-wide resource quotas: memory/disk limits with hysteresis.

Reference behavior: `lib/shard/src/quota/` + `lib/storage/src/quota.rs` +
`src/actix/api/quota_api.rs` — cluster-wide limits on node-local
resources (resident memory %, storage-disk fill %), enforced on
resource-consuming updates, with a release margin so a node resting on
its limit doesn't flap in and out of service. Config is seeded from
settings, overridden by `quota.json` at the storage root, updated
cluster-wide through the consensus meta plane, and exposed at
GET/PUT `/quotas`.

The manager is also the single measurement point (statvfs / proc RSS):
anything needing to know how full the node is asks here.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

QUOTA_CONFIG_FILE = "quota.json"
DEFAULT_RELEASE_MARGIN_PERCENT = 5


class QuotaExceededError(Exception):
    """An enforced limit is currently tripped; updates are refused."""

    status_code = 507  # Insufficient Storage


def _read_meminfo_total() -> Optional[int]:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _read_cgroup_limit() -> Optional[int]:
    # cgroup v2 then v1; "max" means uncapped
    for path in (
        "/sys/fs/cgroup/memory.max",
        "/sys/fs/cgroup/memory/memory.limit_in_bytes",
    ):
        try:
            with open(path) as f:
                raw = f.read().strip()
            if raw != "max":
                v = int(raw)
                # v1 reports a huge sentinel when uncapped
                if v < 1 << 60:
                    return v
        except (OSError, ValueError):
            continue
    return None


def _read_rss() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class QuotaManager:
    """Owns the quota config + measurements + the exceeded latches."""

    def __init__(self, storage_path: str, config: Optional[Dict[str, Any]] = None):
        self.storage_path = storage_path
        self._lock = threading.Lock()
        self.config: Dict[str, Any] = {
            "enabled": False,
            "max_resident_memory_percent": None,
            "max_disk_usage_percent": None,
            "release_margin_percent": None,
        }
        if config:
            self._merge(config)
        # the persisted file (runtime updates) overrides settings
        persisted = self._load_file()
        if persisted:
            self._merge(persisted)
        # hysteresis latches: once tripped, a resource stays exceeded until
        # it falls `release_margin` points below its limit
        self._exceeded = {"resident_memory": False, "disk_usage": False}

    # -- config -------------------------------------------------------------

    def _merge(self, cfg: Dict[str, Any]) -> None:
        for k in self.config:
            if k in cfg:
                self.config[k] = cfg[k]

    def _file(self) -> str:
        return os.path.join(self.storage_path, QUOTA_CONFIG_FILE)

    def _load_file(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self._file()) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def update_config(self, cfg: Dict[str, Any]) -> Dict[str, Any]:
        for k in ("max_resident_memory_percent", "max_disk_usage_percent",
                  "release_margin_percent"):
            v = cfg.get(k)
            if v is not None and not (0 <= int(v) <= 100):
                raise ValueError(f"{k} must be within 0..=100, got {v}")
        with self._lock:
            self._merge(cfg)
            with open(self._file(), "w") as f:
                json.dump(self.config, f)
            return dict(self.config)

    @property
    def margin(self) -> int:
        m = self.config.get("release_margin_percent")
        return DEFAULT_RELEASE_MARGIN_PERCENT if m is None else int(m)

    # -- measurement (overridable in tests) ---------------------------------

    def disk_usage_percent(self) -> Optional[float]:
        try:
            du = shutil.disk_usage(self.storage_path)
            return 100.0 * (du.total - du.free) / max(du.total, 1)
        except OSError:
            return None

    def resident_memory_percent(self) -> Optional[float]:
        rss = _read_rss()
        if rss is None:
            return None
        total = _read_cgroup_limit() or _read_meminfo_total()
        if not total:
            return None
        return 100.0 * rss / total

    # -- enforcement --------------------------------------------------------

    def _evaluate(self) -> Dict[str, Optional[bool]]:
        """Refresh the latches → per-resource exceeded flags (None when the
        resource is not enforced or not measurable)."""
        out: Dict[str, Optional[bool]] = {
            "resident_memory": None,
            "disk_usage": None,
        }
        if not self.config.get("enabled"):
            self._exceeded = {"resident_memory": False, "disk_usage": False}
            return out
        checks = (
            ("resident_memory", self.config.get("max_resident_memory_percent"),
             self.resident_memory_percent),
            ("disk_usage", self.config.get("max_disk_usage_percent"),
             self.disk_usage_percent),
        )
        for key, limit, measure in checks:
            if limit is None:
                self._exceeded[key] = False
                continue
            usage = measure()
            if usage is None:
                continue
            if self._exceeded[key]:
                # release only once a margin below the limit (no flapping)
                if usage < float(limit) - self.margin:
                    self._exceeded[key] = False
            elif usage >= float(limit):
                self._exceeded[key] = True
            out[key] = self._exceeded[key]
        return out

    def check_write(self) -> None:
        """Raise when any enforced limit is tripped (call on every
        resource-consuming update)."""
        flags = self._evaluate()
        tripped = [k for k, v in flags.items() if v]
        if tripped:
            raise QuotaExceededError(
                f"node quota exceeded ({', '.join(tripped)}); "
                "updates are refused until usage falls below the limit"
            )

    # -- reporting ----------------------------------------------------------

    def usage(self) -> Dict[str, Any]:
        return {
            "resident_memory_percent": self.resident_memory_percent(),
            "disk_usage_percent": self.disk_usage_percent(),
        }

    def status(self) -> Dict[str, Any]:
        flags = self._evaluate()
        return {
            "config": dict(self.config),
            "usage": self.usage(),
            "exceeded": flags,
        }

    def peer_usage(self) -> Dict[str, Any]:
        """What this peer reports to others (PeerQuotaUsage shape)."""
        flags = self._evaluate()
        return {**self.usage(), "exceeded": bool(any(v for v in flags.values()))}
