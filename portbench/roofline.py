"""Peaks of the card and the least time of a scan step.

Published peaks of one NVIDIA H100 SXM (data sheet; dense, no sparsity), at
its full power limit of 700 W: 3.35 TB/s of HBM, 989 TFLOP/s bf16, 1,979
TOP/s int8, 67 TFLOP/s f32 outside the tensor cores. A share of a peak is
reported with the card's power limit beside it (the run prints it).

A scan step reads each input once and writes its output once: the stored
block in its dtype (rows padded to 4,096, columns to 128, as stored), the
bias table (one f32 per stored row), the query rows it is given in each
dtype it reads them in, the f32 rows the rescore gathers (`k_fetch` a query)
and the [B, k] output (f32 score and int64 id). Its operations are the
products over the block on the tensor cores plus the f32 rescore. The least
time is the larger of bytes over the HBM rate and operations over the peaks.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
BLOCK_ROWS = 4096
LANE = 128


def padded(n: int, d: int):
    n_pad = max(-(-n // BLOCK_ROWS) * BLOCK_ROWS, BLOCK_ROWS)
    d_pad = max(-(-d // LANE) * LANE, LANE)
    return n_pad, d_pad


def scan_step(kind: str, b: int, n: int, d: int, k: int, k_fetch: int,
              rescore: bool = True) -> dict:
    """Bytes, operations and least seconds of one scan step over n stored
    rows of width d for b query rows. kind: "bf16" (bf16 block, f32 queries
    read once by both the scan and the rescore) or "int8" (int8 codes, int8
    query codes, plus f32 queries for the rescore)."""
    n_pad, d_pad = padded(n, d)
    if kind == "bf16":
        block = n_pad * d_pad * 2
        queries = b * d_pad * 4
    elif kind == "int8":
        block = n_pad * d_pad
        queries = b * d_pad + (b * d_pad * 4 if rescore else 0)
    else:
        raise ValueError(kind)
    gathered = b * k_fetch * d * 4 if rescore else 0
    out = b * k * (4 + 8)
    nbytes = block + 4 * n_pad + queries + gathered + out
    ops_s = (2.0 * b * n_pad * d_pad / PEAK_OPS_PER_S[kind]
             + (3.0 * b * k_fetch * d / PEAK_OPS_PER_S["f32"] if rescore else 0.0))
    bytes_s = nbytes / HBM_BYTES_PER_S
    return {"bytes": nbytes, "bytes_s": bytes_s, "ops_s": ops_s,
            "bound_s": max(bytes_s, ops_s)}


def span_share(ctx, span: str):
    """Percent of the least time in the device time per call of span `span`
    in the traced sub-window: the mean least time of the calls wholly inside
    it (their DESCRIBE records) over the device time of the ops launched
    inside the span's ranges, per range. None where nothing was traced."""
    tr = ctx.trace or {}
    calls = tr.get("range_calls", {}).get(span, 0)
    busy = tr.get("range_device_s", {}).get(span, 0.0)
    w0, w1 = ctx.profile_window
    bounds = [info["bound_s"] for a, b, info, _ in ctx.spans.get(span, []) if w0 <= a and b <= w1]
    if not calls or busy <= 0 or not bounds:
        return None
    return 100.0 * (sum(bounds) / len(bounds)) / (busy / calls)
