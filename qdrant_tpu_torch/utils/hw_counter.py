"""Per-request usage accounting.

Reference: lib/common/common/src/counter/hardware_counter.rs —
HardwareCounterCell threaded through every read/write call and accumulated
per request (HwMeasurementAcc), surfaced in API responses and telemetry.

TPU adaptation: the interesting costs are device ones, so we count
vectors scored (→ FLOPs estimate), payload documents read, and filter
evaluations. A contextvar-scoped accumulator keeps call sites untouched
except for `add()` calls in the hot paths.
"""

from __future__ import annotations

import contextvars
from typing import Dict, Optional

_current: contextvars.ContextVar[Optional["HwAcc"]] = contextvars.ContextVar(
    "hw_acc", default=None
)


class HwAcc:
    def __init__(self):
        self.cpu = 0  # scored vector-dims (FLOP/2 estimate)
        self.vector_io_read = 0  # vectors touched
        self.payload_io_read = 0  # payload docs read
        self.filter_evaluations = 0

    def to_dict(self) -> Dict[str, int]:
        return {
            "cpu": self.cpu,
            "vector_io_read": self.vector_io_read,
            "payload_io_read": self.payload_io_read,
        }


class measure:
    """Context manager installing a fresh accumulator for one request."""

    def __enter__(self) -> HwAcc:
        self.acc = HwAcc()
        self.token = _current.set(self.acc)
        return self.acc

    def __exit__(self, *exc):
        _current.reset(self.token)
        return False


def add(
    vectors_scored: int = 0,
    dims: int = 1,
    payload_reads: int = 0,
    filter_evals: int = 0,
) -> None:
    acc = _current.get()
    if acc is None:
        return
    acc.cpu += vectors_scored * dims
    acc.vector_io_read += vectors_scored
    acc.payload_io_read += payload_reads
    acc.filter_evaluations += filter_evals
