"""Quantized vector encoding and scoring (counterpart of
qdrant_tpu/ops/quantization.py).

The encoders are the JAX package's numpy code, so codes, scales and
codebooks are bit-identical to its own, and the `sq.npz` / `bq.npz` /
`tq.npz` / `pq.npz` files are the same format: a segment written by either
package opens in the other.

  * SQ — symmetric int8 with a quantile-clipped global scale. A sealed
    in-RAM segment of 65,536 rows or more scans the codes with the fused
    scan kernel's int8 mode (`kernel_device` is the kernel's layout); smaller
    ones score with `score_sq`.
  * BQ — sign bits, held as int8 ±1 on the device (bit-packed on disk).
  * TQ — randomized Hadamard rotation + per-vector Lloyd-Max levels; scored
    as one bf16 product, as the JAX function does. As the primary store of an
    on-disk vector its packed level indices are the only device residency
    (`flat_device`, scanned by ops/scan.py::scan_search_tq_flat).
  * SQ of an on-disk vector (the quantized-primary tier) is scanned by the
    torch scans of ops/scan.py over `scan_device`, as the JAX engine keeps
    that tier off its Pallas kernel.
  * PQ — per-subspace 256-centroid codebooks (k-means on the host) and
    query lookup tables summed over subspaces.

The scorers were XLA programs in the JAX package, outside any Pallas kernel;
here they are plain torch on the device their operands lie on. Every search
oversamples and rescores in f32 (storage/segment.py).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import default_device, tensor_bytes
from ..types import Distance

NEG_INF = float(-np.inf)
_UPLOAD_ROWS = 131072  # host→device upload chunk


def _host_bytes(obj, *attrs):
    from ..utils.memsize import sizeof_attrs

    return sizeof_attrs(obj, *attrs)


def _with_device(host: dict, *tensors) -> dict:
    return {**host, "device_bytes": host["device_bytes"] + tensor_bytes(*tensors)}


def _masked(scores: torch.Tensor, valid_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if valid_mask is None:
        return scores
    return torch.where(valid_mask[None, :], scores, NEG_INF)


def int8_dot(q_codes: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Exact int8 · int8ᵀ → [B, N] f32 (the int32 sum rounded once to f32).
    Summed in f64, where every partial sum of at most 127² · D is an exact
    integer, because torch has no int8 matrix product on CUDA."""
    return (q_codes.double() @ codes.double().T).float()


# ---------------------------------------------------------------------------
# Scalar (int8) quantization
# ---------------------------------------------------------------------------


class ScalarQuantized:
    """Symmetric int8 quantization with quantile-clipped global scale."""

    def __init__(self, codes: np.ndarray, scale: float, norms_sq: np.ndarray):
        self.codes = codes  # [N, D] int8
        self.scale = float(scale)
        self.norms_sq = norms_sq  # [N] f32 — exact ||v||² of ORIGINAL vectors
        self._dev: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._kernel_dev: Optional[Tuple[torch.Tensor, np.ndarray, int]] = None
        self._scan_dev: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None

    @classmethod
    def encode(cls, vectors: np.ndarray, quantile: float = 0.99) -> "ScalarQuantized":
        v = np.asarray(vectors, dtype=np.float32)
        if v.size:
            # quantile over a value sample — exact quantile over N×D floats is
            # host-bound (100s at 200k×1536); 1M samples is statistically ample
            flat = v.reshape(-1)
            if flat.size > 1_000_000:
                rng = np.random.default_rng(0)
                flat = flat[rng.integers(0, flat.size, 1_000_000)]
            bound = np.quantile(np.abs(flat), quantile)
            bound = max(float(bound), 1e-12)
        else:
            bound = 1.0
        scale = bound / 127.0
        codes = np.clip(np.round(v / scale), -127, 127).astype(np.int8)
        norms_sq = (v * v).sum(axis=1).astype(np.float32)
        return cls(codes, scale, norms_sq)

    def device(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (codes [N, D] int8, norms [N] f32) on the device."""
        if self._dev is None:
            dev = default_device()
            self._dev = (
                torch.from_numpy(self.codes).to(dev),
                torch.from_numpy(self.norms_sq).to(dev),
            )
        return self._dev

    def scan_device(self, block: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Block-padded device tensors for the torch scans of ops/scan.py
        (the quantized-primary tier) → (codes [n_pad, d8] int8, norms [n_pad]
        f32, n_pad). Columns are zero-padded to a multiple of 8, the shape
        rule of the card's int8 product; a zero column adds nothing to a dot.
        Uploaded in row chunks, so the host never holds a padded copy."""
        if self._scan_dev is None or self._scan_dev[2] % block:
            n, d = self.codes.shape
            n_pad = max((n + block - 1) // block * block, block)
            self._scan_dev = None  # free the old block before the new upload
            dev = default_device()
            codes = torch.zeros((n_pad, (d + 7) // 8 * 8), dtype=torch.int8, device=dev)
            for i in range(0, n, _UPLOAD_ROWS):
                part = np.ascontiguousarray(self.codes[i : i + _UPLOAD_ROWS])
                codes[i : i + len(part), :d] = torch.from_numpy(part).to(dev)
            norms = torch.zeros(n_pad, dtype=torch.float32, device=dev)
            norms[:n] = torch.from_numpy(np.asarray(self.norms_sq, np.float32)).to(dev)
            self._scan_dev = (codes, norms, n_pad)
        return self._scan_dev

    def kernel_device(self, block: int) -> Tuple[torch.Tensor, np.ndarray, int]:
        """Operands of the fused scan's int8 mode (ops/fused_scan.py) →
        (codes [n_pad, d_pad] int8 on the device, norms [n_pad] f32 on the
        host, n_pad). Rows are padded to the scan block, dims to 128 (the
        kernel needs D % 64 == 0; 128 is the JAX package's padding)."""
        if self._kernel_dev is None or self._kernel_dev[2] % block:
            n, d = self.codes.shape
            n_pad = max((n + block - 1) // block * block, block)
            d_pad = max((d + 127) // 128 * 128, 128)
            self._kernel_dev = None  # free the old block before the new upload
            codes = torch.zeros((n_pad, d_pad), dtype=torch.int8, device=default_device())
            codes[:n, :d] = torch.from_numpy(self.codes).to(codes.device)
            norms = np.zeros(n_pad, dtype=np.float32)
            norms[:n] = self.norms_sq
            self._kernel_dev = (codes, norms, n_pad)
        return self._kernel_dev

    def memory_usage_bytes(self):
        host = _host_bytes(self, "codes", "norms_sq")
        kd = self._kernel_dev or (None, None, 0)
        host["host_bytes"] += 0 if kd[1] is None else int(kd[1].nbytes)
        return _with_device(host, *(self._dev or ()), kd[0], *(self._scan_dev or ())[:2])

    def encode_queries(self, queries: np.ndarray) -> np.ndarray:
        return np.clip(np.round(queries / self.scale), -127, 127).astype(np.int8)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(
            os.path.join(path, "sq.npz"),
            codes=self.codes,
            scale=np.float64(self.scale),
            norms_sq=self.norms_sq,
        )

    @classmethod
    def load(cls, path: str) -> "ScalarQuantized":
        data = np.load(os.path.join(path, "sq.npz"))
        return cls(data["codes"], float(data["scale"]), data["norms_sq"])


def score_sq(
    q_codes: torch.Tensor,  # [B, D] int8 quantized queries
    q_norms_sq: torch.Tensor,  # [B] f32 exact ||q||²
    codes: torch.Tensor,  # [N, D] int8
    norms_sq: torch.Tensor,  # [N] f32
    scale: float,
    distance: str,
    valid_mask: Optional[torch.Tensor] = None,  # [N] bool
) -> torch.Tensor:
    """Int8 scoring → [B, N] f32 approximate scores: the exact integer dot
    times scale² (f32), with the euclid terms as the JAX function adds them."""
    dist = Distance(distance)
    scale32 = torch.tensor(scale, dtype=torch.float32, device=codes.device)
    dots = int8_dot(q_codes, codes) * (scale32 * scale32)
    if dist in (Distance.DOT, Distance.COSINE):
        scores = dots
    else:  # EUCLID; MANHATTAN has no exact matmul form, the L2 proxy ranks
        scores = 2.0 * dots - q_norms_sq[:, None] - norms_sq[None, :]
    return _masked(scores, valid_mask)


# ---------------------------------------------------------------------------
# Binary quantization
# ---------------------------------------------------------------------------


class BinaryQuantized:
    """Sign-bit quantization; device representation is int8 ±1.

    On-disk form is bit-packed (32× compression, like the reference); the
    device-resident ±1 int8 trades 4× memory for one matrix product.
    """

    def __init__(self, signs: np.ndarray):
        self.signs = signs  # [N, D] int8 in {-1, +1}
        self._dev: Optional[torch.Tensor] = None

    @classmethod
    def encode(cls, vectors: np.ndarray) -> "BinaryQuantized":
        v = np.asarray(vectors, dtype=np.float32)
        signs = np.where(v >= 0, 1, -1).astype(np.int8)
        return cls(signs)

    def device(self) -> torch.Tensor:
        if self._dev is None:
            self._dev = torch.from_numpy(self.signs).to(default_device())
        return self._dev

    def memory_usage_bytes(self):
        return _with_device(_host_bytes(self, "signs"), self._dev)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        packed = np.packbits((self.signs > 0).astype(np.uint8), axis=1)
        np.savez(
            os.path.join(path, "bq.npz"), packed=packed, dim=np.int32(self.signs.shape[1])
        )

    @classmethod
    def load(cls, path: str) -> "BinaryQuantized":
        data = np.load(os.path.join(path, "bq.npz"))
        dim = int(data["dim"])
        bits = np.unpackbits(data["packed"], axis=1)[:, :dim]
        signs = np.where(bits > 0, 1, -1).astype(np.int8)
        return cls(signs)


def score_bq(
    queries: torch.Tensor,  # [B, D] f32 (preprocessed) queries
    signs: torch.Tensor,  # [N, D] int8 ±1
    distance: str,
    valid_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Asymmetric binary scoring: f32 query against ±1 vectors (one product).

    For euclid, -||q - s||² ranks identically to dot(q, s) up to the
    per-point constant D, so one formulation serves all metrics.
    """
    return _masked(queries.float() @ signs.float().T, valid_mask)


# ---------------------------------------------------------------------------
# Turbo quantization (rotation + low-bit Lloyd-Max)
# ---------------------------------------------------------------------------

# Lloyd-Max reconstruction levels for a unit gaussian per bit width; decision
# thresholds are the midpoints between adjacent levels. "1.5 bits" = 3 levels.
_LM_LEVELS = {
    1: np.array([-0.7979, 0.7979]),
    1.5: np.array([-1.224, 0.0, 1.224]),
    2: np.array([-1.510, -0.4528, 0.4528, 1.510]),
    4: np.array(
        [
            -2.733, -2.069, -1.618, -1.256, -0.9424, -0.6568, -0.3881,
            -0.1284, 0.1284, 0.3881, 0.6568, 0.9424, 1.256, 1.618, 2.069,
            2.733,
        ]
    ),
}


def _lloyd_max(bits) -> tuple:
    levels = _LM_LEVELS[bits]
    thresholds = (levels[:-1] + levels[1:]) / 2.0
    return thresholds, levels


def _hadamard_rotation(dim: int, seed: int) -> np.ndarray:
    """Randomized orthogonal rotation: D_pad×D_pad scaled Hadamard with random
    sign flips, applied as one dense product."""
    n = 1
    while n < dim:
        n *= 2
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    h = h / np.sqrt(n)
    rng = np.random.default_rng(seed)
    signs = rng.choice([-1.0, 1.0], size=n)
    return (h * signs[None, :]).astype(np.float32)  # orthogonal


class TurboQuantized:
    """TurboQuant: rotate vectors with a randomized Hadamard, normalize per
    vector, quantize each dim to 1/1.5/2/4-bit Lloyd-Max levels.

    The level index of each dim is kept as int8 (packed to `bits` on disk).
    Scoring is asymmetric: the f32 rotated query meets the bf16 matrix of
    reconstruction levels in one product, scaled per vector.
    """

    def __init__(self, codes: np.ndarray, scales: np.ndarray, rotation_seed: int,
                 bits: int, norms_sq: np.ndarray, dim: int):
        self.codes = codes  # [N, D_pad] int8 level indices
        self.scales = scales  # [N] f32 per-vector scale (std of rotated vec)
        self.rotation_seed = rotation_seed
        self.bits = bits
        self.norms_sq = norms_sq  # [N] exact ||v||² of ORIGINAL vectors
        self.dim = dim
        self._dev = None
        self._flat_dev = None
        self._rot = None

    @classmethod
    def encode(cls, vectors: np.ndarray, bits: int = 4, seed: int = 13) -> "TurboQuantized":
        v = np.asarray(vectors, dtype=np.float32)
        n, dim = v.shape
        rot = _hadamard_rotation(dim, seed)
        d_pad = rot.shape[0]
        vp = np.zeros((n, d_pad), dtype=np.float32)
        vp[:, :dim] = v
        r = vp @ rot  # rotated: approximately gaussian per dim
        scales = r.std(axis=1) + 1e-12
        thresholds, levels = _lloyd_max(bits)
        codes = np.searchsorted(thresholds, r / scales[:, None]).astype(np.int8)
        norms_sq = (v * v).sum(axis=1).astype(np.float32)
        return cls(codes, scales.astype(np.float32), seed, bits, norms_sq, dim)

    def rotation(self) -> np.ndarray:
        if self._rot is None:
            self._rot = _hadamard_rotation(self.dim, self.rotation_seed)
        return self._rot

    def device(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """→ (recon [N, D_pad] bf16 levels, scales [N] f32, norms [N] f32)."""
        if self._dev is None:
            _, levels = _lloyd_max(self.bits)
            recon = levels[self.codes.astype(np.int64)].astype(np.float32)
            dev = default_device()
            self._dev = (
                torch.from_numpy(recon).to(dev, torch.bfloat16),
                torch.from_numpy(self.scales).to(dev),
                torch.from_numpy(self.norms_sq).to(dev),
            )
        return self._dev

    def memory_usage_bytes(self):
        return _with_device(
            _host_bytes(self, "codes", "scales", "norms_sq", "_rot"),
            *(self._dev or ()), *(self._flat_dev or ())[:4],
        )

    def rotate_queries(self, queries: np.ndarray) -> np.ndarray:
        q = np.asarray(queries, dtype=np.float32)
        rot = self.rotation()
        qp = np.zeros((q.shape[0], rot.shape[0]), dtype=np.float32)
        qp[:, : self.dim] = q
        return qp @ rot

    @property
    def pack_factor(self) -> int:
        """Level indices per device byte (TQ-as-primary residency)."""
        return {4: 2, 2: 4, 1.5: 4, 1: 8}.get(self.bits, 1)

    def flat_packed(self, n_pad: int) -> np.ndarray:
        """[n_pad, D_pad / pack_factor] uint8, HALF-SPLIT packing: byte
        column j holds dims {j, j + D/p, j + 2D/p, ...}, the first of them in
        the highest bits, so the scan's unpack is a concatenation of p
        contiguous sub-ranges (ops/scan.py::scan_search_tq_flat)."""
        n, d_pad = self.codes.shape
        p = self.pack_factor
        c = np.zeros((n_pad, d_pad), dtype=np.uint8)
        c[:n] = self.codes.astype(np.uint8)
        if p == 1:
            return c
        w = 8 // p
        half = d_pad // p
        packed = np.zeros((n_pad, half), dtype=np.uint8)
        for j in range(p):
            packed |= c[:, j * half : (j + 1) * half] << ((p - 1 - j) * w)
        return packed

    def flat_device(self, block: int):
        """TQ-as-primary device tensors for the flat scan (reference:
        TurboVectorStorageImpl, vector_storage/turbo/mod.rs:1-29 — TQ codes
        ARE the storage, not a sidecar): level indices packed `pack_factor`
        per byte, the only device residency of the vector.
        → (packed [N_pad, D_pad/p] uint8, scales [N_pad], norms [N_pad],
           levels [L] f32, n_pad)."""
        if self._flat_dev is None or self._flat_dev[4] % block:
            n = self.codes.shape[0]
            n_pad = max((n + block - 1) // block * block, block)
            scales = np.zeros(n_pad, dtype=np.float32)
            scales[:n] = self.scales
            norms = np.zeros(n_pad, dtype=np.float32)
            norms[:n] = self.norms_sq
            _, levels = _lloyd_max(self.bits)
            dev = default_device()
            self._flat_dev = None  # free the old block before the new upload
            self._flat_dev = (
                torch.from_numpy(self.flat_packed(n_pad)).to(dev),
                torch.from_numpy(scales).to(dev),
                torch.from_numpy(norms).to(dev),
                torch.from_numpy(levels.astype(np.float32)).to(dev),
                n_pad,
            )
        return self._flat_dev

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        # pack level indices to `bits` on disk
        if self.bits == 4:
            packed = (self.codes[:, 0::2].astype(np.uint8) << 4) | (
                self.codes[:, 1::2].astype(np.uint8) & 0xF
            )
        elif self.bits in (2, 1.5):
            c = self.codes.astype(np.uint8)
            packed = (c[:, 0::4] << 6) | (c[:, 1::4] << 4) | (c[:, 2::4] << 2) | c[:, 3::4]
        else:
            packed = np.packbits(self.codes.astype(np.uint8), axis=1)
        np.savez(
            os.path.join(path, "tq.npz"),
            packed=packed,
            scales=self.scales,
            norms_sq=self.norms_sq,
            bits=np.float64(self.bits),
            seed=np.int32(self.rotation_seed),
            dim=np.int32(self.dim),
            d_pad=np.int32(self.codes.shape[1]),
        )

    @classmethod
    def load(cls, path: str) -> "TurboQuantized":
        data = np.load(os.path.join(path, "tq.npz"))
        bits = float(data["bits"])
        bits = int(bits) if bits in (1.0, 2.0, 4.0) else bits
        d_pad = int(data["d_pad"])
        packed = data["packed"]
        if bits == 4:
            codes = np.zeros((packed.shape[0], d_pad), dtype=np.int8)
            codes[:, 0::2] = (packed >> 4) & 0xF
            codes[:, 1::2] = packed & 0xF
        elif bits in (2, 1.5):
            codes = np.zeros((packed.shape[0], d_pad), dtype=np.int8)
            codes[:, 0::4] = (packed >> 6) & 0x3
            codes[:, 1::4] = (packed >> 4) & 0x3
            codes[:, 2::4] = (packed >> 2) & 0x3
            codes[:, 3::4] = packed & 0x3
        else:
            codes = np.unpackbits(packed, axis=1)[:, :d_pad].astype(np.int8)
        return cls(
            codes,
            data["scales"],
            int(data["seed"]),
            bits,
            data["norms_sq"],
            int(data["dim"]),
        )


def score_tq(
    q_rot: torch.Tensor,  # [B, D_pad] f32 rotated queries
    recon: torch.Tensor,  # [N, D_pad] bf16 reconstruction levels (unit scale)
    scales: torch.Tensor,  # [N] f32 per-vector scale
    norms_sq: torch.Tensor,  # [N] f32 exact original norms
    distance: str,
    valid_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Asymmetric TurboQuant scoring: rotation preserves dot products, so
    dot(q, v) ≈ scale_v · dot(q_rot, recon_v). The query is rounded to bf16
    and the bf16 × bf16 products summed in f32, as the JAX function's
    `preferred_element_type=f32` product does."""
    dist = Distance(distance)
    dots = (q_rot.to(torch.bfloat16).float() @ recon.float().T) * scales[None, :]
    if dist in (Distance.DOT, Distance.COSINE):
        scores = dots
    else:  # euclid / manhattan proxy
        q_sq = (q_rot * q_rot).sum(dim=1, keepdim=True)
        scores = 2.0 * dots - q_sq - norms_sq[None, :]
    return _masked(scores, valid_mask)


# ---------------------------------------------------------------------------
# Product quantization
# ---------------------------------------------------------------------------


def _kmeans(data: np.ndarray, k: int, iters: int, seed: int) -> np.ndarray:
    """Plain Lloyd k-means (vectorized numpy) for PQ codebook training."""
    rng = np.random.default_rng(seed)
    n = data.shape[0]
    if n <= k:
        centroids = np.zeros((k, data.shape[1]), dtype=np.float32)
        centroids[:n] = data
        return centroids
    centroids = data[rng.choice(n, size=k, replace=False)].astype(np.float32)
    for _ in range(iters):
        d2 = (
            (data * data).sum(1)[:, None]
            - 2.0 * data @ centroids.T
            + (centroids * centroids).sum(1)[None, :]
        )
        assign = d2.argmin(1)
        for c in range(k):
            members = data[assign == c]
            if len(members):
                centroids[c] = members.mean(0)
    return centroids


class ProductQuantized:
    """PQ codes + codebooks (reference: lib/quantization PQ, kmeans)."""

    CODEBOOK = 256

    def __init__(self, codes: np.ndarray, codebooks: np.ndarray):
        self.codes = codes  # [N, S] uint8
        self.codebooks = codebooks  # [S, 256, sub_dim] f32
        self._dev: Optional[torch.Tensor] = None

    @classmethod
    def encode(
        cls,
        vectors: np.ndarray,
        compression: str = "x16",
        sample: int = 20_000,
        iters: int = 12,
        seed: int = 7,
    ) -> "ProductQuantized":
        v = np.asarray(vectors, dtype=np.float32)
        n, d = v.shape
        # compression xR: R float32s (4R bytes) represented per 1 byte code
        ratio = int(compression.lstrip("x"))
        sub_dim = max(ratio // 4, 1)
        s = (d + sub_dim - 1) // sub_dim
        pad = s * sub_dim - d
        if pad:
            v = np.concatenate([v, np.zeros((n, pad), dtype=np.float32)], axis=1)
        rng = np.random.default_rng(seed)
        idx = rng.choice(n, size=min(n, sample), replace=False) if n else np.array([], int)
        codebooks = np.zeros((s, cls.CODEBOOK, sub_dim), dtype=np.float32)
        codes = np.zeros((n, s), dtype=np.uint8)
        for si in range(s):
            block = v[:, si * sub_dim : (si + 1) * sub_dim]
            codebooks[si] = _kmeans(block[idx], cls.CODEBOOK, iters, seed + si)
            d2 = (
                (block * block).sum(1)[:, None]
                - 2.0 * block @ codebooks[si].T
                + (codebooks[si] * codebooks[si]).sum(1)[None, :]
            )
            codes[:, si] = d2.argmin(1).astype(np.uint8)
        return cls(codes, codebooks)

    @property
    def sub_dim(self) -> int:
        return self.codebooks.shape[2]

    def device(self) -> torch.Tensor:
        """→ [N, S] int64 flat LUT indices: subspace · 256 + code."""
        if self._dev is None:
            s = self.codes.shape[1]
            flat = self.codes.astype(np.int64) + np.arange(s, dtype=np.int64) * self.CODEBOOK
            self._dev = torch.from_numpy(flat).to(default_device())
        return self._dev

    def memory_usage_bytes(self):
        return _with_device(_host_bytes(self, "codes", "codebooks"), self._dev)

    def query_lut(self, queries: np.ndarray, distance: Distance) -> np.ndarray:
        """Per-query lookup tables [B, S, 256] of sub-scores."""
        q = np.asarray(queries, dtype=np.float32)
        b, d = q.shape
        s, k, sub = self.codebooks.shape
        pad = s * sub - d
        if pad:
            q = np.concatenate([q, np.zeros((b, pad), dtype=np.float32)], axis=1)
        qs = q.reshape(b, s, sub)
        if distance in (Distance.DOT, Distance.COSINE):
            lut = np.einsum("bsd,skd->bsk", qs, self.codebooks)
        elif distance is Distance.EUCLID:
            diff = qs[:, :, None, :] - self.codebooks[None, :, :, :]
            lut = -(diff * diff).sum(-1)
        else:  # MANHATTAN
            diff = qs[:, :, None, :] - self.codebooks[None, :, :, :]
            lut = -np.abs(diff).sum(-1)
        return lut.astype(np.float32)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        np.savez(os.path.join(path, "pq.npz"), codes=self.codes, codebooks=self.codebooks)

    @classmethod
    def load(cls, path: str) -> "ProductQuantized":
        data = np.load(os.path.join(path, "pq.npz"))
        return cls(data["codes"], data["codebooks"])


def score_pq(
    lut: torch.Tensor,  # [B, S, 256] f32 query LUTs
    flat_codes: torch.Tensor,  # [N, S] int64 from ProductQuantized.device()
    valid_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PQ scoring: per-subspace LUT gather summed over subspaces → [B, N]
    (one query at a time, so only an [N, S] gather is ever materialized)."""
    flat = lut.reshape(lut.shape[0], -1)
    scores = torch.stack([row[flat_codes].sum(dim=1) for row in flat])
    return _masked(scores, valid_mask)
