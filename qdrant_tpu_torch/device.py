"""Device selection for the port (counterpart of the TPU probe
qdrant_tpu/ops/pallas_scan.py::is_tpu_backend).

The engine runs on `cuda`. The CPU is used only when the process asks for
it: `--force-cpu`, `force_cpu()`, or a non-empty `QDRANT_TPU_FORCE_CPU`
other than "0". Without a card and without that request `default_device()`
raises, so a machine whose CUDA stack failed to load never serves silently on
the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

FORCE_CPU_ENV = "QDRANT_TPU_FORCE_CPU"

_FORCED: Optional[torch.device] = None


def default_device() -> torch.device:
    """The device every store, index and kernel launch of the port uses."""
    if _FORCED is not None or os.environ.get(FORCE_CPU_ENV, "") not in ("", "0"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "qdrant_tpu_torch found no CUDA device; pass --force-cpu or set "
            f"{FORCE_CPU_ENV}=1 to run on the CPU with the kernels' plain versions"
        )
    return torch.device("cuda")


def tensor_bytes(*tensors: Optional[torch.Tensor]) -> int:
    """Bytes held by the given tensors (None counts 0), for memory telemetry:
    the copied memsize walker knows numpy and jax arrays, not torch."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def require_exact_f32_matmul(t: torch.Tensor) -> None:
    """Raise if an f32 product on `t`'s device would run in TF32. The sparse
    hot product and the TQ scan rely on true f32 products (the JAX programs
    ask for `Precision.HIGHEST` / an f32 result); TF32 rounds the operands to
    10 mantissa bits, which shows in the third digit of a score."""
    if t.is_cuda and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul.allow_tf32 / "
            "float32_matmul_precision); the port's f32 scores need them off"
        )


def force_cpu() -> None:
    """Pin the port to the CPU (the explicit `--force-cpu` switch)."""
    global _FORCED
    _FORCED = torch.device("cpu")
