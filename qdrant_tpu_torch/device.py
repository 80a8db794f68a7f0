"""Device selection for the port (counterpart of the TPU probe
qdrant_tpu/ops/pallas_scan.py::is_tpu_backend).

The engine runs on `cuda`. The CPU is used only when the process asks for
it: `--force-cpu`, `force_cpu()`, or a non-empty `QDRANT_TPU_FORCE_CPU`
other than "0". Without a card and without that request `default_device()`
raises, so a machine whose CUDA stack failed to load never serves silently on
the CPU with the kernels' plain versions.

`mesh_devices()` lists the devices a multi-device mesh (parallel/mesh.py)
spreads its shards over: every visible card, or the one CPU. A process may
ask for a number of logical devices (`set_logical_devices(n)`, or
`QDRANT_TPU_LOGICAL_DEVICES=n`), the counterpart of XLA's
`--xla_force_host_platform_device_count`: the visible devices are then
repeated round-robin up to n entries, so a mesh of n shards runs on one card
(or on the CPU) with every per-shard launch and the merge, and no copy
between cards.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch

FORCE_CPU_ENV = "QDRANT_TPU_FORCE_CPU"
LOGICAL_DEVICES_ENV = "QDRANT_TPU_LOGICAL_DEVICES"

_FORCED: Optional[torch.device] = None
_LOGICAL: Optional[int] = None


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


def set_logical_devices(n: Optional[int]) -> None:
    """Make `mesh_devices()` list n logical devices (None: the visible ones,
    or QDRANT_TPU_LOGICAL_DEVICES where it is set)."""
    global _LOGICAL
    if n is not None and int(n) < 1:
        raise ValueError(f"logical devices must be >= 1, got {n}")
    _LOGICAL = None if n is None else int(n)


def mesh_devices(n: Optional[int] = None) -> List[torch.device]:
    """The ordered devices of a mesh: `cuda:0 .. cuda:{count-1}`, or the one
    CPU where the CPU was asked for, repeated round-robin up to `n` entries
    (default: the logical device count, else one entry per visible device).
    Raises without a card where the CPU was not asked for, as
    default_device() does."""
    if default_device().type == "cpu":
        visible = [torch.device("cpu")]
    else:
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    env = os.environ.get(LOGICAL_DEVICES_ENV, "")
    n = n or _LOGICAL or (int(env) if env else len(visible))
    if n < 1:
        raise ValueError(f"{LOGICAL_DEVICES_ENV} must be >= 1, got {env!r}")
    return [visible[i % len(visible)] for i in range(n)]


def tensor_bytes(*tensors: Optional[torch.Tensor]) -> int:
    """Bytes held by the given tensors (None counts 0), for memory telemetry:
    the copied memsize walker knows numpy and jax arrays, not torch."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def storage_bytes(*tensors: Optional[torch.Tensor]) -> int:
    """Bytes of the distinct storages under the given tensors (None counts
    0): views of one tensor, such as a mesh's per-shard slices on one card,
    count their storage once."""
    seen = {}
    for t in tensors:
        if t is not None:
            st = t.untyped_storage()
            seen[(str(t.device), st.data_ptr())] = st.nbytes()
    return sum(seen.values())


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
