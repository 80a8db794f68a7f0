"""Fused exact-scan survivors: the hand-written Hopper kernels and their
plain PyTorch versions.

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

On the card the scan is two kernels of `csrc/fused_scan.cu`. Each slot's walk
over its (block, 128-row group) tiles is cut into `chunks` contiguous ranges
(`scan_split` picks the count from the shape and the card's SMs, so small
batches fill every SM); `fused_scan_partials` scores every range into a
scratch of partial winners [chunks, B, slots*128], and `merge_survivors`
keeps, per element, the first chunk's winner that no later chunk beats, which
is the unsplit walk's answer. With one chunk the scan writes the survivors
directly and no merge runs.

Every wrapper launches its kernel for CUDA tensors and runs its plain version
(`*_plain`) for CPU tensors; none falls back from one to the other. Launches
are counted per kernel: `fused_scan_survivors.launches` (scan, bf16),
`fused_scan_survivors.launches_int8` (scan, int8) and
`merge_survivors.launches`. The kernel library is compiled with nvcc at
first use into `build/kernels/` at the repository root.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .quantization import int8_dot

LANES = 128
DEFAULT_BLK = 4096
DEFAULT_SLOTS = 16
NEG_INF = float(np.finfo(np.float32).min)

# The kernel's shape constants (csrc/fused_scan.cu)
KBYTES = 128  # bytes of each row per pipeline stage (one 16 KB TMA box)
STAGES = 4  # TMA boxes in flight per CTA
QUERY_TILES = (8, 32, 64)  # query rows per CTA: the wgmma N
MAX_QUERY_BYTES = 96 * 1024  # the resident query tile's budget; wider rows stream
SMEM_PER_BLOCK = 232448  # what an H100 CTA may take (227 KB)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fused_scan.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_OCCUPANCY: Dict[Tuple[bool, int, int], int] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_library(verbose: bool = False, source: str = SOURCE) -> Tuple[str, str]:
    """Compile a CUDA source of csrc/ (by default csrc/fused_scan.cu) into
    build/kernels (keyed by the source's hash, so an edited source rebuilds)
    → (path of the shared library, compiler output; empty when the library
    was already built)."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    name = os.path.splitext(os.path.basename(source))[0]
    so_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(so_path):
        return so_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, source]
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
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            ints = [i32] * 8  # b, n, d, blk, slots, n_q, chunks, stream_q
            lib.fused_scan_survivors_bf16.argtypes = [ptr] * 5 + ints + [ptr]
            lib.fused_scan_survivors_int8.argtypes = (
                [ptr] * 3 + [ctypes.c_float] + [ptr] * 2 + ints + [ptr]
            )
            lib.fused_scan_ctas_per_sm.argtypes = [i32] * 4  # int8, n_q, row_bytes, stream_q
            lib.merge_survivors.argtypes = [ptr] * 4 + [i32, ctypes.c_longlong, ptr]
            for fn in (lib.fused_scan_survivors_bf16, lib.fused_scan_survivors_int8,
                       lib.fused_scan_ctas_per_sm, lib.merge_survivors):
                fn.restype = i32
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


# ---------------------------------------------------------------------------
# the split of each slot's walk
# ---------------------------------------------------------------------------


def slot_tiles(n_pad: int, blk: int, slots: int) -> List[int]:
    """Tiles (128-row groups) each slot walks: slot s owns blocks s, s +
    slots, ... and every block has blk/128 groups."""
    nblocks = n_pad // blk
    return [max(0, -(-(nblocks - s) // slots)) * (blk // LANES) for s in range(slots)]


def chunk_bounds(tiles: int, chunks: int) -> List[Tuple[int, int]]:
    """The kernel's cut of one slot's `tiles` into `chunks` contiguous
    ranges [lo, hi) of its walk, in ascending order (empty ones when chunks
    exceed tiles)."""
    return [(tiles * c // chunks, tiles * (c + 1) // chunks) for c in range(chunks)]


def tile_row0(slot: int, t: int, blk: int, slots: int) -> int:
    """First row of tile t of a slot's walk: block slot + (t // groups) *
    slots, group t % groups."""
    groups = blk // LANES
    return (slot + (t // groups) * slots) * blk + (t % groups) * LANES


def chunk_row_mask(n_pad: int, blk: int, slots: int, chunks: int) -> torch.Tensor:
    """[chunks, n_pad] bool: the rows chunk c scores, over every slot."""
    mask = torch.zeros((chunks, n_pad), dtype=torch.bool)
    for s, tiles in enumerate(slot_tiles(n_pad, blk, slots)):
        for c, (lo, hi) in enumerate(chunk_bounds(tiles, chunks)):
            for t in range(lo, hi):
                r0 = tile_row0(s, t, blk, slots)
                mask[c, r0 : r0 + LANES] = True
    return mask


def queries_resident(row_bytes: int) -> bool:
    """Whether the query tile stays in shared memory for the whole walk:
    when its smallest height fits MAX_QUERY_BYTES. Wider rows (D > 6,144
    bf16, 12,288 int8) stream one 128-byte column block per ring stage."""
    return QUERY_TILES[0] * row_bytes <= MAX_QUERY_BYTES


def query_tile(b: int, row_bytes: int) -> int:
    """Query rows per CTA (the wgmma N): the smallest of QUERY_TILES that
    holds b, lowered while a resident tile exceeds MAX_QUERY_BYTES."""
    tiles = [t for t in QUERY_TILES
             if t * row_bytes <= MAX_QUERY_BYTES or not queries_resident(row_bytes)]
    return next((t for t in tiles if t >= b), tiles[-1])


def smem_bytes(n_q: int, row_bytes: int) -> int:
    """Dynamic shared memory of one scan CTA (csrc/fused_scan.cu smem_bytes):
    alignment slack, the V ring with a bias row and two mbarriers per
    stage, the query tile (resident: all of it; streamed: a 128-byte column
    block per stage)."""
    q_blocks = row_bytes // KBYTES if queries_resident(row_bytes) else STAGES
    return 1024 + STAGES * (LANES * KBYTES + LANES * 4 + 16) + q_blocks * n_q * KBYTES


def scan_split(b: int, n_pad: int, blk: int, slots: int, sm_count: int,
               n_q: int = QUERY_TILES[0], ctas_per_sm: int = 2) -> int:
    """Chunks per slot: as many as fill one wave of resident CTAs (sm_count
    x ctas_per_sm, at most two per SM, over slots x query tiles), at least
    one, and no more than the fewest tiles of a non-empty slot, so no chunk
    of a non-empty slot is empty. Two CTAs per SM already keep HBM busy at
    B = 8; more only add merge work (chip_smoke.py --phases sweep). At B = 256
    the query tiles alone fill the card and it picks one to four."""
    work = slots * -(-b // n_q)
    t_min = min((t for t in slot_tiles(n_pad, blk, slots) if t), default=1)
    return max(1, min(sm_count * min(ctas_per_sm, 2) // work, t_min))


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ctas_per_sm(int8: bool, n_q: int, row_bytes: int) -> int:
    """Scan CTAs one SM holds at this shape, as the CUDA runtime reckons
    from the kernel's registers and shared memory (cached)."""
    key = (int8, n_q, row_bytes)
    if key not in _OCCUPANCY:
        got = _lib().fused_scan_ctas_per_sm(int(int8), n_q, row_bytes,
                                            int(not queries_resident(row_bytes)))
        if got <= 0:
            raise RuntimeError(f"fused_scan occupancy query failed: CUDA error {-got}")
        _OCCUPANCY[key] = got
    return _OCCUPANCY[key]


def scan_plan(queries: torch.Tensor, vectors: torch.Tensor, blk: int, slots: int,
              chunks: Optional[int] = None) -> Dict[str, int]:
    """The launch a CUDA call makes: query rows per CTA, whether they stay
    resident, chunks, CTAs, shared memory per CTA, CTAs per SM."""
    b = queries.shape[0]
    row_bytes = vectors.shape[1] * vectors.element_size()
    n_q = query_tile(b, row_bytes)
    if chunks is not None and chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {chunks}")
    occ = ctas_per_sm(vectors.dtype == torch.int8, n_q, row_bytes)
    if chunks is None:
        chunks = scan_split(b, vectors.shape[0], blk, slots, _sm_count(vectors.device),
                            n_q, occ)
    return {"n_q": n_q, "resident": int(queries_resident(row_bytes)), "chunks": chunks,
            "ctas": -(-b // n_q) * slots * chunks, "smem": smem_bytes(n_q, row_bytes),
            "ctas_per_sm": occ}


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def fused_scan_survivors(
    queries: torch.Tensor,  # [B, D] bf16 (f32 is cast to bf16), or int8 codes
    vectors: torch.Tensor,  # [N, D] bf16, or int8 codes; N a multiple of blk
    bias: torch.Tensor,  # [N] f32
    blk: int = DEFAULT_BLK,
    slots: int = DEFAULT_SLOTS,
    scale_sq: Optional[float] = None,  # int8 mode: scale^2 (x2 for euclid)
    chunks: Optional[int] = None,  # CUDA: cut of each slot's walk (scan_split)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (survivor scores [B, slots*128] f32, survivor ids [B, slots*128]
    int32). int8 `vectors` select the int8 mode. CUDA tensors launch the
    scan kernel (and the merge when the walk is split); CPU tensors run the
    plain version."""
    _check_inputs(queries, vectors, bias, blk, slots)
    if queries.device.type != "cuda":
        return fused_scan_survivors_plain(queries, vectors, bias, blk, slots, scale_sq)
    q = _kernel_queries(queries, vectors, bias)
    plan = scan_plan(q, vectors, blk, slots, chunks)
    part_s, part_i = _launch_scan(q, vectors, bias, blk, slots, scale_sq, plan)
    if plan["chunks"] == 1:
        return part_s[0], part_i[0]
    return merge_survivors(part_s, part_i)


fused_scan_survivors.launches = 0  # scan kernel, bf16 mode
fused_scan_survivors.launches_int8 = 0  # scan kernel, int8 mode


def fused_scan_partials(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    bias: torch.Tensor,
    blk: int = DEFAULT_BLK,
    slots: int = DEFAULT_SLOTS,
    scale_sq: Optional[float] = None,
    chunks: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan kernel alone → partial winners ([chunks, B, slots*128]
    scores, ids) of each chunk's range of every slot's walk."""
    _check_inputs(queries, vectors, bias, blk, slots)
    if queries.device.type != "cuda":
        return fused_scan_partials_plain(queries, vectors, bias, blk, slots, scale_sq,
                                         chunks or 1)
    q = _kernel_queries(queries, vectors, bias)
    plan = scan_plan(q, vectors, blk, slots, chunks)
    return _launch_scan(q, vectors, bias, blk, slots, scale_sq, plan)


def _kernel_queries(queries, vectors, bias) -> torch.Tensor:
    """Check what the scan kernel takes beyond _check_inputs → the queries
    as it reads them (contiguous, bf16 unless int8)."""
    d = queries.shape[1]
    row_bytes = d * vectors.element_size()
    if row_bytes % KBYTES:
        raise ValueError(f"kernel needs D % {KBYTES // vectors.element_size()} == 0, got {d}")
    int8 = vectors.dtype == torch.int8
    q = (queries if int8 else queries.to(torch.bfloat16)).contiguous()
    if not (vectors.is_contiguous() and bias.is_contiguous()):
        raise ValueError("vectors and bias must be contiguous")
    if q.data_ptr() % 16 or vectors.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    return q


def _launch_scan(q, vectors, bias, blk, slots, scale_sq, plan):
    int8 = vectors.dtype == torch.int8
    b, d = q.shape
    n = vectors.shape[0]
    chunks = plan["chunks"]
    shape = (chunks, b, slots * LANES)
    out_s = torch.empty(shape, dtype=torch.float32, device=q.device)
    out_i = torch.empty(shape, dtype=torch.int32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), vectors.data_ptr(), bias.data_ptr())
        outs = (out_s.data_ptr(), out_i.data_ptr(), b, n, d, blk, slots,
                plan["n_q"], chunks, 1 - plan["resident"], stream)
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


def merge_survivors(part_s: torch.Tensor, part_i: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[chunks, B, W] partial winners → [B, W]: per element the first
    chunk's winner that no later chunk beats. CUDA tensors launch the merge
    kernel; CPU tensors run merge_survivors_plain."""
    if part_s.shape != part_i.shape or part_s.dim() != 3:
        raise ValueError("partial scores and ids of one [chunks, B, W] shape expected")
    if part_s.dtype != torch.float32 or part_i.dtype != torch.int32:
        raise TypeError("partial scores f32 and ids int32 expected")
    if part_s.device != part_i.device:
        raise ValueError("partial scores and ids must be on one device")
    if part_s.device.type != "cuda":
        return merge_survivors_plain(part_s, part_i)
    part_s, part_i = part_s.contiguous(), part_i.contiguous()
    chunks, b, w = part_s.shape
    out_s = torch.empty((b, w), dtype=torch.float32, device=part_s.device)
    out_i = torch.empty((b, w), dtype=torch.int32, device=part_s.device)
    with torch.cuda.device(part_s.device):
        stream = torch.cuda.current_stream(part_s.device).cuda_stream
        err = _lib().merge_survivors(part_s.data_ptr(), part_i.data_ptr(),
                                     out_s.data_ptr(), out_i.data_ptr(),
                                     chunks, b * w, stream)
    if err != 0:
        raise RuntimeError(f"merge_survivors kernel launch failed: CUDA error {err}")
    merge_survivors.launches += 1
    return out_s, out_i


merge_survivors.launches = 0


def merge_survivors_plain(part_s: torch.Tensor, part_i: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Torch-op version of the merge: a strict-'>' walk over the chunks in
    order, so equal scores keep the earlier chunk's (smaller) row id."""
    out_s, out_i = part_s[0].clone(), part_i[0].clone()
    for c in range(1, part_s.shape[0]):
        better = part_s[c] > out_s
        out_s = torch.where(better, part_s[c], out_s)
        out_i = torch.where(better, part_i[c], out_i)
    return out_s, out_i


def _scale(scale_sq: Optional[float]) -> float:
    """The int8 mode's score scale as an f32 value (1.0 when not given, as
    pallas_scan_survivors defaults it)."""
    return float(np.float32(1.0 if scale_sq is None else scale_sq))


def fused_scan_partials_plain(
    queries: torch.Tensor,
    vectors: torch.Tensor,
    bias: torch.Tensor,
    blk: int = DEFAULT_BLK,
    slots: int = DEFAULT_SLOTS,
    scale_sq: Optional[float] = None,
    chunks: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the scan kernel's partials: chunk c is the plain
    survivors over chunk c's rows alone (the bias kept there, NEG_INF
    elsewhere)."""
    mask = chunk_row_mask(vectors.shape[0], blk, slots, chunks).to(bias.device)
    parts = [
        fused_scan_survivors_plain(queries, vectors, torch.where(m, bias, NEG_INF),
                                   blk, slots, scale_sq)
        for m in mask
    ]
    return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


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
