"""Device selection for the port (counterpart of the TPU probe
qdrant_tpu/ops/pallas_scan.py::is_tpu_backend).

The engine runs on `cuda` whenever a card is present; the CPU is used only
when none is, or when the process asked for it explicitly (`--force-cpu`).
"""

from __future__ import annotations

from typing import Optional

import torch

_FORCED: Optional[torch.device] = None


def default_device() -> torch.device:
    """The device every store, index and kernel launch of the port uses."""
    if _FORCED is not None:
        return _FORCED
    return torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")


def tensor_bytes(*tensors: Optional[torch.Tensor]) -> int:
    """Bytes held by the given tensors (None counts 0), for memory telemetry:
    the copied memsize walker knows numpy and jax arrays, not torch."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def force_cpu() -> None:
    """Pin the port to the CPU (the explicit `--force-cpu` switch)."""
    global _FORCED
    _FORCED = torch.device("cpu")
