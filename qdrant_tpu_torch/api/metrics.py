"""Request metrics + Prometheus text endpoint.

Reference: src/common/metrics.rs (TextEncoder over telemetry) and the
hardware-counter layer (lib/common/common/src/counter/hardware_counter.rs) —
here surfaced as request counters/durations plus engine-level gauges.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        # (method, endpoint, status) → count
        self.responses: Dict[Tuple[str, str, int], int] = {}
        self.duration_sum: Dict[Tuple[str, str], float] = {}
        self.duration_count: Dict[Tuple[str, str], int] = {}

    def observe(self, method: str, endpoint: str, status: int, seconds: float) -> None:
        with self._lock:
            key = (method, endpoint, status)
            self.responses[key] = self.responses.get(key, 0) + 1
            dkey = (method, endpoint)
            self.duration_sum[dkey] = self.duration_sum.get(dkey, 0.0) + seconds
            self.duration_count[dkey] = self.duration_count.get(dkey, 0) + 1

    def telemetry(self, detail: bool = False) -> dict:
        with self._lock:
            total = sum(self.responses.values())
            fail = sum(v for (m, e, s), v in self.responses.items() if s >= 400)
            out = {
                "rest": {
                    "responses_total": total,
                    "responses_fail_total": fail,
                }
            }
            if detail:
                # per-endpoint breakdown (reference: requests_telemetry.rs
                # WebApiTelemetry responses map, gated behind level > 0)
                per = {}
                for (method, endpoint, status), count in self.responses.items():
                    ep = endpoint.replace("\\", "").replace("^", "").replace("$", "")
                    key = f"{method} {ep}"
                    row = per.setdefault(key, {"count": 0, "fail": 0})
                    row["count"] += count
                    if status >= 400:
                        row["fail"] += 1 * count
                for (method, endpoint), secs in self.duration_sum.items():
                    ep = endpoint.replace("\\", "").replace("^", "").replace("$", "")
                    key = f"{method} {ep}"
                    row = per.get(key)
                    if row is not None:
                        n = self.duration_count[(method, endpoint)]
                        row["avg_duration_s"] = round(secs / max(n, 1), 6)
                out["rest"]["responses"] = per
            return out

    def render_prometheus(self, extra: Optional[dict] = None) -> str:
        lines = [
            "# HELP rest_responses_total REST API response count",
            "# TYPE rest_responses_total counter",
        ]
        with self._lock:
            for (method, endpoint, status), count in sorted(self.responses.items()):
                ep = endpoint.replace("\\", "").replace("^", "").replace("$", "")
                lines.append(
                    f'rest_responses_total{{method="{method}",endpoint="{ep}",status="{status}"}} {count}'
                )
            lines.append("# HELP rest_responses_duration_seconds REST response durations")
            lines.append("# TYPE rest_responses_duration_seconds summary")
            for (method, endpoint), total in sorted(self.duration_sum.items()):
                ep = endpoint.replace("\\", "").replace("^", "").replace("$", "")
                count = self.duration_count[(method, endpoint)]
                lines.append(
                    f'rest_responses_duration_seconds_sum{{method="{method}",endpoint="{ep}"}} {total}'
                )
                lines.append(
                    f'rest_responses_duration_seconds_count{{method="{method}",endpoint="{ep}"}} {count}'
                )
        for name, value in (extra or {}).items():
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {value}")
        return "\n".join(lines) + "\n"


METRICS = Metrics()
