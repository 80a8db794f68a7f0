"""Device-resident blocked-scan searcher (counterpart of the single-device
bf16 part of qdrant_tpu/ops/scan.py::ScanIndex) and the quantized block scans
of the same file.

The block is stored as the fused scan kernel wants it (ops/fused_scan.py):
bf16 rows padded to [n_pad, d_pad], pre-scaled by 2 for euclid so the
kernel's product yields 2*q.v, plus an f32 bias table (-||v||^2 for live rows,
NEG_INF for deleted, filtered and pad rows). The JAX package sizes its block
and query tile to the TPU's VMEM window; here rows are padded to 4,096-row
blocks and a search scans with 16 slots (2,048 survivor bins) at every width,
widened only for large limits (fused_scan.scan_grid).

The quantized scans (`scan_search_sq`, `scan_search_sq_flat`,
`scan_search_tq_flat`, `scan_search_sq_rescore`) were `jax.jit` programs
outside any Pallas kernel; here they are plain functions on tensors that run
on the device their operands lie on. They keep the JAX candidates: one winner
per (block of DEFAULT_BLOCK rows, lane of 128), first index on ties, then a
top-k. The codes are walked as row slices of the flat [N, D] tensor (views):
no second copy of the codes is ever made, which is what lets a codes block
that fills most of the card's memory be served (the quantized-primary tier).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import default_device, require_exact_f32_matmul, storage_bytes
from ..parallel import mesh as pmesh
from .fused_scan import (
    DEFAULT_BLK,
    NEG_INF,
    fused_scan_topk,
    pad_rows,
    scan_grid,
)

NEG_INF_F = float("-inf")
_UPLOAD_ROWS = 131072  # host→device upload chunk (bounds the f32 staging copy)

LANES = 128
DEFAULT_BLOCK = 8192  # rows per candidate block of the quantized scans
# elements of a [rows, B] temporary a quantized scan may hold at once
_STEP_ELEMS = 1 << 20


def lane_group_winners(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, nb, g, LANES] scores → (max [B, nb, LANES], group index of the
    first maximum [B, nb, LANES] int64): `jnp.max` / `jnp.argmax` over the
    group axis, with the tie order spelled out."""
    g = s.shape[2]
    best = s.max(dim=2).values
    group = torch.arange(g, device=s.device)[None, None, :, None]
    first = torch.where(s == best[:, :, None, :], group, g).min(dim=2).values
    return best, first


def _int8_dots(q_codes: torch.Tensor, cblk: torch.Tensor) -> torch.Tensor:
    """int8 [B, D] · int8 [R, D]ᵀ → [B, R] f32: the exact int32 sums, each
    rounded once to f32 (at D = 1536 they pass 2^24, so the rounding is part
    of the score). On the card `torch._int_mm` (its shape rules: more than 16
    rows on the left, K and N multiples of 8 — the callers pad); an int32
    product on the CPU."""
    if cblk.is_cuda:
        return torch._int_mm(cblk, q_codes.t()).t().contiguous().float()
    return (q_codes.int() @ cblk.int().T).float()


def block_lane_winners(n: int, b: int, blk: int, score_rows, device):
    """Walk [0, n) in steps of whole blocks; `score_rows(off, rows)` → [B,
    rows] f32 scores (-inf where masked). → one winner per (block, lane):
    (scores [B, nb*LANES], row ids [B, nb*LANES] int64)."""
    nb, g = n // blk, blk // LANES
    ms = torch.empty((b, nb, LANES), dtype=torch.float32, device=device)
    ams = torch.empty((b, nb, LANES), dtype=torch.int64, device=device)
    step = min(n, max(blk, _STEP_ELEMS // max(b, 1) // blk * blk))
    for off in range(0, n, step):
        rows = min(step, n - off)
        s = score_rows(off, rows).reshape(b, rows // blk, g, LANES)
        m, a = lane_group_winners(s)
        ms[:, off // blk : (off + rows) // blk] = m
        ams[:, off // blk : (off + rows) // blk] = a
    lane = torch.arange(LANES, device=device)
    ids = torch.arange(nb, device=device)[None, :, None] * blk + ams * LANES + lane
    return ms.reshape(b, -1), ids.reshape(b, -1)


def _top_winners(flat_s, flat_i, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    top_s, ti = torch.topk(flat_s, min(k, flat_s.shape[1]), dim=1)
    top_i = torch.gather(flat_i, 1, ti)
    top_i = torch.where(torch.isfinite(top_s), top_i, -1)
    return top_s, top_i.to(torch.int32)


def _pad_sq_queries(q_codes: torch.Tensor, width: int) -> torch.Tensor:
    """Query codes padded to `torch._int_mm`'s shape rules (rows to a
    multiple of 8, columns to the codes' width); zero rows and columns add
    nothing to a dot."""
    b, d = q_codes.shape
    b_pad = (b + 7) // 8 * 8
    if b_pad == b and d == width:
        return q_codes
    out = torch.zeros((b_pad, width), dtype=torch.int8, device=q_codes.device)
    out[:b, :d] = q_codes
    return out


def scan_search_sq_flat(
    q_codes: torch.Tensor,  # [B, D] int8
    q_norms: torch.Tensor,  # [B] f32
    codes: torch.Tensor,  # [N, D'] int8 — read in place (D' >= D, zero columns)
    norms: torch.Tensor,  # [N] f32
    scale: float,
    mask: torch.Tensor,  # [N] int8 / bool validity
    blk: int = DEFAULT_BLOCK,
    k: int = 10,
    euclid: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked int8 scan with the strided group-reduction top-k, over codes
    that may fill most of the card's memory: each step scores a row slice of
    the flat tensor, so peak memory is the codes plus [rows, B] temporaries.
    Scores are int32 dots → f32, then · scale² (f32), as the JAX program
    rounds them. → (scores [B, k], ids [B, k] int32, -1 = none)."""
    b = q_codes.shape[0]
    n = codes.shape[0]
    qp = _pad_sq_queries(q_codes, codes.shape[1])
    s2 = torch.tensor(scale, dtype=torch.float32, device=codes.device)
    s2 = s2 * s2
    live = mask != 0

    def score_rows(off: int, rows: int) -> torch.Tensor:
        dots = _int8_dots(qp, codes[off : off + rows])[:b] * s2
        if euclid:
            dots = 2.0 * dots - q_norms[:, None] - norms[None, off : off + rows]
        return torch.where(live[None, off : off + rows], dots, NEG_INF_F)

    return _top_winners(*block_lane_winners(n, b, blk, score_rows, codes.device), k)


# In the JAX package the blocked variant reshapes the codes to [nb, blk, D]
# (a second full copy under XLA) and the flat variant exists to avoid that; a
# row slice of a torch tensor is a view either way, so both names are one
# function here.
scan_search_sq = scan_search_sq_flat


def scan_search_tq_flat(
    q_rot: torch.Tensor,  # [B, D_pad] f32 rotated queries
    q_norms: torch.Tensor,  # [B] f32 exact ||q||² (pre-rotation)
    packed: torch.Tensor,  # [N, D_pad/pack] uint8 — TQ level indices, packed
    scales: torch.Tensor,  # [N] f32 per-vector scale
    norms: torch.Tensor,  # [N] f32 exact original norms
    levels: torch.Tensor,  # [L] f32 Lloyd-Max reconstruction levels
    mask: torch.Tensor,  # [N] int8 / bool validity
    blk: int = DEFAULT_BLOCK,
    k: int = 10,
    euclid: bool = False,
    pack: int = 2,
    bits_w: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TQ-as-primary flat scan (reference: vector_storage/turbo/mod.rs — the
    quantized codes ARE the storage): per step, slice the packed bytes, unpack
    `pack` level indices per byte (half-split: byte column j carries dims
    {j, j + D/p, ...}, sub-byte `pack - 1 - j` first), look the levels up and
    score. Queries and levels are rounded to bf16 and their products summed
    in f32, as the JAX program's `preferred_element_type=f32` product does:
    the looked-up block is upcast to f32 (a per-step temporary), because a
    bf16 @ bf16 torch product would round every score to bf16."""
    require_exact_f32_matmul(packed)
    b = q_rot.shape[0]
    n = packed.shape[0]
    qb = q_rot.to(torch.bfloat16).float()
    lv = levels.to(torch.bfloat16).float()
    lmask = (1 << bits_w) - 1
    live = mask != 0
    # the unpacked block is [rows, D_pad] int32 + f32: keep it near 128 MB
    d_pad = packed.shape[1] * pack
    rows_cap = max(blk, (1 << 24) // d_pad // blk * blk)

    def score_rows(off: int, rows: int) -> torch.Tensor:
        out = torch.empty((b, rows), dtype=torch.float32, device=packed.device)
        for lo in range(0, rows, rows_cap):
            hi = min(lo + rows_cap, rows)
            pblk = packed[off + lo : off + hi]  # [r, D/p] view
            subs = [
                (pblk >> ((pack - 1 - j) * bits_w)) & lmask for j in range(pack)
            ]
            recon = lv[torch.cat(subs, dim=1).int()]  # [r, D_pad] f32
            out[:, lo:hi] = (qb @ recon.T) * scales[None, off + lo : off + hi]
        if euclid:
            out = 2.0 * out - q_norms[:, None] - norms[None, off : off + rows]
        return torch.where(live[None, off : off + rows], out, NEG_INF_F)

    return _top_winners(*block_lane_winners(n, b, blk, score_rows, packed.device), k)


def scan_search_sq_rescore(
    q_codes: torch.Tensor,  # [B, D] int8
    q_norms: torch.Tensor,  # [B] f32
    codes: torch.Tensor,  # [N, D] int8
    norms: torch.Tensor,  # [N] f32
    scale: float,
    mask: torch.Tensor,  # [N] int8 / bool
    queries_f32: torch.Tensor,  # [B, D] f32 (distance-preprocessed)
    vectors_f32: torch.Tensor,  # [Nf, D] f32 row-aligned with codes
    blk: int,
    k_fetch: int,
    k: int,
    euclid: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 blocked scan + exact f32 rescore of its k_fetch winners (the
    port of `qdrant_tpu/ops/scan.py::scan_search_sq_rescore`).

    No search path calls it: an in-RAM SQ segment takes the fused scan's
    int8 mode, and the quantized-primary tier scans with `scan_search_sq_flat`
    and rescores on the host from the memmap (`Segment._host_rescore`), since
    its f32 rows are not on the device. It is kept as the JAX package's
    device-resident rescore, held to it by tests/test_torch_tiered.py."""
    _, cand = scan_search_sq(
        q_codes, q_norms, codes, norms, scale, mask, blk, k_fetch, euclid
    )
    cv = vectors_f32[cand.clamp(min=0).long()].float()  # [B, kf, D]
    q = queries_f32[:, : cv.shape[-1]]
    if euclid:
        diff = q[:, None, :] - cv
        re = -(diff * diff).sum(dim=-1)
    else:
        re = torch.einsum("bd,bkd->bk", q, cv)
    re = torch.where(cand >= 0, re, NEG_INF_F)
    top_s, ti = torch.topk(re, min(k, re.shape[1]), dim=1)
    top_i = torch.gather(cand, 1, ti)
    top_i = torch.where(torch.isfinite(top_s), top_i, -1)
    return top_s, top_i


class ScanIndex:
    """Blocked-scan searcher over a frozen [N, D] block (distance-
    preprocessed f32 host rows).

    With more than one mesh device (parallel/mesh.py::mesh_enabled, unless a
    `device` is named) the block is sharded, as the JAX index shards it over
    every device: rows pad to DEFAULT_BLK * S so that each shard holds whole
    4,096-row blocks, each shard's bf16 block and bias table lie on its
    device (views of one tensor where the mesh repeats one card), and a
    search runs the fused scan and the exact f32 rescore on every shard and
    merges (parallel/mesh.py::sharded_scan_rescore). The rescore reads f32
    rows given by the caller (`rows`: the store's device block, cut into
    per-shard views); the JAX mesh index keeps a third, f32 copy of the
    block in its scan layout, which on one card would double the f32 rows.
    Only a ScanIndex built without `rows` uploads its own. Laying the index
    out on a mesh is one `mesh.place` span (parallel/mesh.py::placing): it
    is built once every card holds its shard."""

    def __init__(
        self,
        vectors: np.ndarray,  # [N, D] f32, distance-preprocessed
        valid_mask: Optional[np.ndarray] = None,
        euclid: bool = False,
        block: int = DEFAULT_BLK,
        device: Optional[torch.device] = None,
        rows: Optional[torch.Tensor] = None,  # mesh: device f32 rows [>= N, D]
    ):
        n, d = vectors.shape
        self.mesh = pmesh.make_mesh() if device is None and pmesh.mesh_enabled() else None
        self.device = self.mesh.devices[0] if self.mesh else device or default_device()
        self.n = n
        self.d = d
        self.block = block
        self.euclid = euclid
        self.d_pad = max((d + 127) // 128 * 128, 128)
        shards = self.mesh.size if self.mesh else 1
        self.n_pad = pad_rows(n, block * shards)
        self._vsq_host = np.zeros(self.n_pad, dtype=np.float32)  # to rebuild the bias
        self._rows_src = self._rows = None
        self._own_rows = self.mesh is not None and rows is None
        if self.mesh is None:
            self._v = self._upload(vectors, 0, self.n_pad, self.device)
            self._mask = self.mask_device(valid_mask)
            return
        with pmesh.placing(self.mesh):
            if self.mesh.one_device:
                block_v = self._upload(vectors, 0, self.n_pad, self.device)
                self._v = pmesh.shard_rows(block_v, self.mesh)
            else:
                np_local = self.n_pad // shards
                self._v = pmesh.count_placed([
                    self._upload(vectors, s * np_local, (s + 1) * np_local, dev)
                    for s, dev in enumerate(self.mesh.devices)])
            if self._own_rows:
                rows = torch.tensor(np.asarray(vectors), dtype=torch.float32,
                                    device=self.device)
            self._cut_rows(rows)
            self._mask = self.mask_device(valid_mask)

    def _upload(self, vectors: np.ndarray, lo: int, hi: int, device) -> torch.Tensor:
        """Rows lo..hi of the padded bf16 block (zeros past n) on `device`,
        filling their ||v||^2 on the host."""
        v = torch.zeros((hi - lo, self.d_pad), dtype=torch.bfloat16, device=device)
        for i in range(lo, min(hi, self.n), _UPLOAD_ROWS):
            rows = np.zeros((min(_UPLOAD_ROWS, min(hi, self.n) - i), self.d_pad), np.float32)
            rows[:, : self.d] = vectors[i : i + len(rows)]
            if self.euclid:  # summed over the padded width, as the JAX index does
                self._vsq_host[i : i + len(rows)] = (rows * rows).sum(axis=1)
            chunk = torch.from_numpy(rows).to(device)
            v[i - lo : i - lo + len(rows)] = (2.0 * chunk if self.euclid else chunk).to(
                torch.bfloat16
            )
        return v

    @classmethod
    def from_arrays(
        cls,
        v_bf16: torch.Tensor,  # [n_pad, d_pad] bf16, pre-scaled for euclid
        vsq_host: np.ndarray,  # [n_pad] f32 ||v||^2 (zeros unless euclid)
        bias: Optional[torch.Tensor],  # [n_pad] f32 (None: the caller sets a mask)
        n: int,
        euclid: bool,
        block: int = DEFAULT_BLK,
        mesh=None,  # parallel/mesh.py Mesh: shard the block over it
        rows: Optional[torch.Tensor] = None,  # mesh: f32 rescore rows [>= n, D]
    ) -> "ScanIndex":
        """Wrap operands that already have the kernel's layout (convert.py)."""
        self = cls.__new__(cls)
        self.mesh = mesh
        self.device = v_bf16.device
        self.n, self.block, self.euclid = n, block, euclid
        self.n_pad, self.d_pad = v_bf16.shape
        self.d = self.d_pad
        self._vsq_host = np.asarray(vsq_host, dtype=np.float32)
        self._rows_src = self._rows = None
        self._own_rows = False
        if mesh is None:
            self._v, self._mask = v_bf16, bias
            return self
        if self.n_pad % (block * mesh.size):
            raise ValueError(f"{self.n_pad} rows are not whole {block}-row blocks "
                             f"on each of {mesh.size} shards")
        if rows is None:
            raise ValueError("a mesh ScanIndex needs the f32 rows to rescore")
        with pmesh.placing(mesh):
            self._v = pmesh.shard_rows(v_bf16, mesh)
            self._mask = (self.mask_device(None) if bias is None
                          else pmesh.shard_rows(bias, mesh))
            self._cut_rows(rows)
        return self

    def rescore_rows(self, rows: Optional[torch.Tensor] = None):
        """Per-shard f32 rows of the mesh's rescore, cut from `rows` (views
        on the shard's device, a copy of the slice on another card); kept
        until a search passes another rows tensor (a re-uploaded store
        block). None: the rows cut last."""
        if rows is not None and rows is not self._rows_src:
            with pmesh.placing(self.mesh):
                self._cut_rows(rows)
        return self._rows

    def _cut_rows(self, rows: torch.Tensor) -> None:
        self._rows_src = rows
        self._rows = pmesh.shard_slices(rows, self.mesh, self.n_pad // self.mesh.size)

    def memory_usage_bytes(self):
        """Each distinct storage once: a mesh's per-shard views of one tensor
        count it once, and f32 rows given by the store count only where they
        were copied to another card."""
        shards = self._v if isinstance(self._v, list) else [self._v]
        masks = self._mask if isinstance(self._mask, list) else [self._mask]
        rows = []
        if self._rows is not None:
            src = self._rows_src.untyped_storage().data_ptr()
            rows = [r for r in self._rows
                    if self._own_rows or r.untyped_storage().data_ptr() != src]
        return {
            "host_bytes": int(self._vsq_host.nbytes),
            "device_bytes": storage_bytes(*shards, *masks, *rows),
            "disk_bytes": 0,
        }

    def mask_device(self, valid_mask: Optional[np.ndarray]):
        """Bias table for a validity mask: -||v||^2 (zeros unless euclid) for
        valid rows, NEG_INF for the rest (per shard on a mesh). The mask may
        be shorter than n (pad rows stay invalid)."""
        mask = np.zeros(self.n_pad, dtype=bool)
        if valid_mask is None:
            mask[: self.n] = True
        else:
            m = np.asarray(valid_mask[: self.n], dtype=bool)
            mask[: len(m)] = m
        bias = torch.from_numpy(np.where(mask, -self._vsq_host, NEG_INF).astype(np.float32))
        return bias.to(self.device) if self.mesh is None else pmesh.place_rows(bias, self.mesh)

    def update_mask(self, valid_mask: np.ndarray) -> None:
        self._mask = self.mask_device(valid_mask)
        if hasattr(self, "_mask_cache"):
            self._mask_cache.clear()

    def mask_device_cached(self, valid_mask: np.ndarray):
        """mask_device with a small digest-keyed cache: repeated searches
        with the same filter reuse the device bias instead of re-uploading
        [N] floats per call."""
        if not hasattr(self, "_mask_cache"):
            self._mask_cache = {}
        key = hashlib.blake2b(
            np.ascontiguousarray(valid_mask), digest_size=16
        ).digest()
        hit = self._mask_cache.get(key)
        if hit is None:
            if len(self._mask_cache) >= 16:
                self._mask_cache.pop(next(iter(self._mask_cache)))
            hit = self._mask_cache[key] = self.mask_device(valid_mask)
        return hit

    def search(
        self, queries: np.ndarray, k: int, mask=None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """→ host (scores [B, k], ids [B, k]); -1 = no result. Euclid scores
        are -(q-v)^2: from the bf16 scan (||q||^2 subtracted host-side), or
        exact from the f32 rescore on a mesh."""
        queries = np.atleast_2d(np.asarray(queries, dtype=np.float32))
        b, d = queries.shape
        b_pad = max(8, (b + 7) // 8 * 8)
        q = np.zeros((b_pad, self.d_pad), dtype=np.float32)
        q[:b, :d] = queries
        if self.mesh is not None:
            s, ids = self._search_mesh_device(q, k, mask)
            s, ids = s.cpu().numpy()[:b], ids.cpu().numpy().astype(np.int32)[:b]
        else:
            k_eff = min(k, self.n)
            blk, slots = scan_grid(self.n_pad, k_eff, self.block)
            s, ids = fused_scan_topk(
                torch.from_numpy(q).to(self.device),
                self._v,
                mask if mask is not None else self._mask,
                k_eff,
                blk=blk,
                slots=slots,
            )
            s = s.cpu().numpy()[:b]
            ids = ids.cpu().numpy().astype(np.int32)[:b]
            if self.euclid:
                q_sq = (queries * queries).sum(axis=1, keepdims=True)
                s = np.where(ids >= 0, s - q_sq, -np.inf)
        if k > s.shape[1]:
            pad = k - s.shape[1]
            s = np.pad(s, ((0, 0), (0, pad)), constant_values=-np.inf)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return s.astype(np.float32), ids

    def _search_mesh_device(
        self, q: np.ndarray, k: int, mask=None, rows: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sharded fused scan + per-shard f32 rescore + merge → DEVICE
        (scores [B_pad, k'], ids) on the mesh's first device, k' <= min(k,
        n) (the JAX k_fetch rule: min(max(2k, k+8), n_pad / S)). `rows`: the
        f32 rows to rescore from (default: those cut last)."""
        k_eff = min(k, self.n)
        k_fetch = min(max(2 * k_eff, k_eff + 8), max(self.n_pad // self.mesh.size, 1))
        return pmesh.sharded_scan_rescore(
            self.mesh,
            torch.from_numpy(q).to(self.device),
            self._v,
            mask if mask is not None else self._mask,
            self.rescore_rows(rows),
            self.block,
            k_fetch,
            k_eff,
            self.euclid,
        )
