"""Fused exact-scan survivors: the hand-written Hopper kernel and its plain
PyTorch version.

Counterpart of qdrant_tpu/ops/pallas_scan.py. For every query row the scan
keeps `slots * 128` survivors: survivor (slot s, lane l) is the best-scoring
row x = nb*blk + j*128 + l over all vector blocks nb = s (mod slots), ties to
the earliest row. Two modes, chosen by the type of `vectors`, as the Pallas
kernel's `int8_mode`:

  * bf16: scores are `Q . V` in f32 from bf16 operands plus a bias
    (-||v||^2 with V pre-scaled by 2 for euclid, 0 for dot/cosine);
  * int8 (scalar-quantized codes): `f32(q_i8 . v_i8) * scale_sq + bias`, the
    integer product exact and each float step rounded on its own, so kernel
    and plain version agree bit for bit;

NEG_INF in the bias marks deleted or filtered rows. An exact top-k over the
survivors and an f32 rescore of the winners finish the search (plain torch,
as XLA finished it outside the Pallas kernel).

`fused_scan_survivors` launches `csrc/fused_scan.cu` for CUDA tensors and
runs `fused_scan_survivors_plain` for CPU tensors; it never falls back from
one to the other. Launches are counted per mode (`.launches` for bf16,
`.launches_int8`). The kernel library is compiled with nvcc at first use into
`build/kernels/` at the repository root.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from .quantization import int8_dot

LANES = 128
DEFAULT_BLK = 4096
DEFAULT_SLOTS = 16
NEG_INF = float(np.finfo(np.float32).min)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fused_scan.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused scan kernel cannot be built")


def build_library(verbose: bool = False) -> Tuple[str, str]:
    """Compile csrc/fused_scan.cu into build/kernels (keyed by the source's
    hash, so an edited source rebuilds) → (path of the shared library,
    compiler output; empty when the library was already built)."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libfused_scan_{digest}.so")
    if os.path.exists(so_path):
        return so_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so_path)
    return so_path, proc.stdout + proc.stderr


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_library()[0])
            ints = [ctypes.c_int] * 5
            bf16 = lib.fused_scan_survivors_bf16
            bf16.argtypes = [ctypes.c_void_p] * 5 + ints + [ctypes.c_void_p]
            int8 = lib.fused_scan_survivors_int8
            int8.argtypes = (
                [ctypes.c_void_p] * 3 + [ctypes.c_float]
                + [ctypes.c_void_p] * 2 + ints + [ctypes.c_void_p]
            )
            bf16.restype = int8.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _check_inputs(queries, vectors, bias, blk, slots):
    if queries.dim() != 2 or vectors.dim() != 2 or bias.dim() != 1:
        raise ValueError("queries [B, D], vectors [N, D] and bias [N] expected")
    b, d = queries.shape
    n = vectors.shape[0]
    if vectors.shape[1] != d:
        raise ValueError(f"query width {d} != vector width {vectors.shape[1]}")
    if bias.shape[0] != n:
        raise ValueError(f"bias length {bias.shape[0]} != vector rows {n}")
    if blk % LANES or n % blk:
        raise ValueError(f"rows {n} must be a multiple of blk {blk} (a multiple of 128)")
    if slots < 1:
        raise ValueError("slots must be >= 1")
    if vectors.dtype == torch.int8:
        if queries.dtype != torch.int8:
            raise TypeError(f"int8 vectors need int8 queries, got {queries.dtype}")
    elif vectors.dtype != torch.bfloat16:
        raise TypeError(f"vectors must be bfloat16 or int8, got {vectors.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if not (queries.device == vectors.device == bias.device):
        raise ValueError("queries, vectors and bias must be on one device")


def fused_scan_survivors(
    queries: torch.Tensor,  # [B, D] bf16 (f32 is cast to bf16), or int8 codes
    vectors: torch.Tensor,  # [N, D] bf16, or int8 codes; N a multiple of blk
    bias: torch.Tensor,  # [N] f32
    blk: int = DEFAULT_BLK,
    slots: int = DEFAULT_SLOTS,
    scale_sq: Optional[float] = None,  # int8 mode: scale^2 (x2 for euclid)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (survivor scores [B, slots*128] f32, survivor ids [B, slots*128]
    int32). int8 `vectors` select the int8 mode. CUDA tensors launch the
    kernel; CPU tensors run the plain version."""
    _check_inputs(queries, vectors, bias, blk, slots)
    if queries.device.type != "cuda":
        return fused_scan_survivors_plain(queries, vectors, bias, blk, slots, scale_sq)
    int8 = vectors.dtype == torch.int8
    b, d = queries.shape
    n = vectors.shape[0]
    if d * vectors.element_size() % 64:
        raise ValueError(f"kernel needs D % {64 // vectors.element_size()} == 0, got {d}")
    q = (queries if int8 else queries.to(torch.bfloat16)).contiguous()
    if not (vectors.is_contiguous() and bias.is_contiguous()):
        raise ValueError("vectors and bias must be contiguous")
    if q.data_ptr() % 16 or vectors.data_ptr() % 16 or bias.data_ptr() % 8:
        raise ValueError("kernel operands must be 16-byte aligned")
    out_s = torch.empty((b, slots * LANES), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, slots * LANES), dtype=torch.int32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), vectors.data_ptr(), bias.data_ptr())
        outs = (out_s.data_ptr(), out_i.data_ptr(), b, n, d, blk, slots, stream)
        if int8:
            err = lib.fused_scan_survivors_int8(*ptrs, _scale(scale_sq), *outs)
        else:
            err = lib.fused_scan_survivors_bf16(*ptrs, *outs)
    if err != 0:
        raise RuntimeError(f"fused_scan kernel launch failed: CUDA error {err}")
    if int8:
        fused_scan_survivors.launches_int8 += 1
    else:
        fused_scan_survivors.launches += 1
    return out_s, out_i


fused_scan_survivors.launches = 0  # bf16 mode
fused_scan_survivors.launches_int8 = 0


def _scale(scale_sq: Optional[float]) -> float:
    """The int8 mode's score scale as an f32 value (1.0 when not given, as
    pallas_scan_survivors defaults it)."""
    return float(np.float32(1.0 if scale_sq is None else scale_sq))


def fused_scan_survivors_plain(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    bias: torch.Tensor,
    blk: int = DEFAULT_BLK,
    slots: int = DEFAULT_SLOTS,
    scale_sq: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch-op version with the TPU kernel's exact semantics: per block, a
    lane-group max over the blk/128 column groups (the first group wins
    ties), then a strict-'>' merge into slot nb % slots.

    int8 mode takes the exact integer dot rounded once to f32
    (quantization.int8_dot), then multiplies by scale_sq and adds the bias
    as separate f32 ops — the kernel's roundings."""
    int8 = vectors.dtype == torch.int8
    if int8:
        q = queries
        scale = torch.tensor(_scale(scale_sq), dtype=torch.float32, device=q.device)
    else:
        q = queries.to(torch.bfloat16).float()
    b = q.shape[0]
    n = vectors.shape[0]
    g = blk // LANES
    out_s = torch.full((b, slots * LANES), NEG_INF, dtype=torch.float32,
                       device=q.device)
    out_i = torch.full((b, slots * LANES), -1, dtype=torch.int32,
                       device=q.device)
    lane = torch.arange(LANES, dtype=torch.int64, device=q.device)
    group = torch.arange(g, dtype=torch.int64, device=q.device)[None, :, None]
    for nb in range(n // blk):
        rows = slice(nb * blk, (nb + 1) * blk)
        if int8:
            s = int8_dot(q, vectors[rows]) * scale + bias[rows]
        else:
            s = q @ vectors[rows].float().T + bias[rows]
        s = s.view(b, g, LANES)
        bmax = s.max(dim=1).values
        idx = torch.where(s == bmax[:, None, :], group, g).min(dim=1).values
        row_id = (nb * blk + idx * LANES + lane).to(torch.int32)
        cols = slice((nb % slots) * LANES, (nb % slots + 1) * LANES)
        better = bmax > out_s[:, cols]
        out_s[:, cols] = torch.where(better, bmax, out_s[:, cols])
        out_i[:, cols] = torch.where(better, row_id, out_i[:, cols])
    return out_s, out_i


def fused_scan_topk(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    bias: torch.Tensor,
    k: int,
    blk: int = DEFAULT_BLK,
    slots: int = DEFAULT_SLOTS,
    scale_sq: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Survivors + exact top-k over them → (scores [B, k], ids [B, k])."""
    s, i = fused_scan_survivors(queries, vectors, bias, blk, slots, scale_sq)
    top_s, ti = torch.topk(s, k, dim=1)
    top_i = torch.gather(i, 1, ti)
    top_i = torch.where(top_s > NEG_INF / 2, top_i, -1)
    top_s = torch.where(top_i >= 0, top_s, float("-inf"))
    return top_s, top_i


def fused_scan_rescore(
    queries: torch.Tensor,  # [B, D] f32 (distance-preprocessed, un-scaled)
    scan_queries: torch.Tensor,  # [B, D] what the kernel scores with (f32/int8)
    vectors: torch.Tensor,  # [N, D] bf16 pre-scaled, or int8 codes
    bias: torch.Tensor,  # [N] f32
    vectors_f32: torch.Tensor,  # [Nf, D'] rescore source, same row space
    k_fetch: int,
    k: int,
    blk: int = DEFAULT_BLK,
    slots: int = DEFAULT_SLOTS,
    euclid: bool = False,
    scale_sq: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + exact f32 rescore of the k_fetch oversampled winners
    (pallas_scan_rescore's semantics)."""
    _, cand = fused_scan_topk(scan_queries, vectors, bias, k_fetch, blk, slots,
                              scale_sq)
    safe = torch.clamp(cand, min=0).long()
    cv = vectors_f32[safe].float()  # [B, k_fetch, D']
    q = queries[:, : cv.shape[-1]].float()
    if euclid:
        diff = q[:, None, :] - cv
        re = -(diff * diff).sum(dim=-1)
    else:
        re = torch.einsum("bd,bkd->bk", q, cv)
    re = torch.where(cand >= 0, re, float("-inf"))
    top_s, ti = torch.topk(re, k, dim=1)
    top_i = torch.gather(cand, 1, ti)
    top_i = torch.where(torch.isfinite(top_s), top_i, -1)
    return top_s, top_i


def scan_grid(n_pad: int, k_fetch: int, blk: int = DEFAULT_BLK) -> Tuple[int, int]:
    """(blk, slots) for a scan whose top-k takes k_fetch survivors.

    The JAX product shape, blk 4096 with 16 slots (2,048 survivor bins),
    serves every k_fetch ≤ 2,048. Past that, slots rise to ceil(k_fetch/128)
    so that the survivors cover k_fetch. blk halves while some slot would get
    no block (an empty slot yields no survivor); from 65,536 rows up that
    happens only past k_fetch 2,048. The rows must be a multiple of the
    starting blk."""
    slots = max(DEFAULT_SLOTS, -(-min(k_fetch, n_pad) // LANES))
    while blk > LANES and n_pad // blk < slots:
        blk //= 2
    return blk, slots


def pad_rows(n: int, blk: int = DEFAULT_BLK) -> int:
    """Rows must be a multiple of blk."""
    return max((n + blk - 1) // blk * blk, blk)
