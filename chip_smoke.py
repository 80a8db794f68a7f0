#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (qdrant_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--phases build,kernel,rest,graph,filtered,sq,tier,sparse]
    python3 chip_smoke.py --phases build,graph     # the graph path alone (the short call)
    python3 chip_smoke.py --phases build,sweep     # tuning only, not run by default

Phases, each printing its numbers on its own line:

1. build     compile csrc/fused_scan.cu (the scan kernel in both modes and
             the merge kernel) with nvcc into build/kernels/, printing
             ptxas's registers and spills of each kernel (the kernel phase
             prints each launch's shared memory).
2. kernel    the fused scan (scan kernel, then the merge of its split walk)
             against its plain PyTorch version on the same inputs. For each
             shape: the launch (query rows per CTA, whether they stay
             resident, chunks per slot, CTAs, shared memory, CTAs per SM),
             `ms` (the call launched from Python, timed by CUDA events over
             a loop: the yardstick of earlier runs), device times from a
             replayed CUDA graph (`graph_ms` scan + merge, `scan_ms` the scan
             kernel alone), achieved GB/s and ms / bound_ms on both, the
             merge kernel's times held bit for bit against its plain version
             on the scan's own partials,
             the plain version's time and, for reference, the product's
             alone (`product_ms`: bf16 `q @ v.T`, `torch._int_mm`). No single
             PyTorch call computes the survivors (a product, a lane-group
             argmax and a slot-ring merge) or the ordered merge, so the
             kernel table's `library_ms` is null.
             bf16 mode: euclid at 256 queries x 1,000,000 x 128 (10% of
             rows deleted), dot at 256 x 100,000 x 1536, and the shapes the
             REST phases launch: 8 x 1,000,000 x 128 euclid (rest), 8 x
             100,000 x 100 (padded to 128) cosine with 10% of rows live
             (filtered) and 8 x --sparse-rows x 128 euclid (the RRF queries'
             dense prefetch; at 1,000,000 rows it is the rest launch and is
             compared once); and 8 x 65,536 x 12,288 dot, rows too wide for resident queries. Survivor
             scores must agree within a worst-case f32 summation-order bound
             and ids must be equal wherever the class winner beats the
             runner-up by more than that bound.
             int8 mode (scalar-quantized codes, made on the card from
             --seed): 8 and 256 queries x 1,000,000 x 1536 dot on unit-vector
             codes with 10% of rows deleted, 8 x 262,144 x 1536 (the sq
             phase's launch),
             8 x 1,000,000 x 128 euclid (bias -||v||^2, 2*scale^2), and 8 x
             65,536 x 24,576 dot (streamed queries). Survivor scores and ids
             must be equal bit for bit.
3. rest      the port's REST server over a TableOfContent: 1,000,000 x 128
             euclid points in the ann-benchmarks SIFT1M shape (1,024 Gaussian
             clusters, spread 20, clipped to 0-255, made from --seed), each
             with a payload (`n`: its number, under an integer index; `group`:
             "a" on every tenth point, under a keyword index), bulk-ingested
             and sealed by the optimizer (which now builds the HNSW graph
             too), 64 searches with default params from 8 threads (coalesced
             by the micro-batcher; below the crossover they take the scan);
             recall@10 >= 0.99 against a numpy brute force that shares no
             code with the port, and the bf16 scan and the merge kernels'
             launch counts must rise.
   graph     the HNSW graph over the rest phase's sealed segment (built by the
             seal with the device builder: build seconds, us per point,
             batches per ramp shape, peak device memory, degree / in-degree /
             level statistics, and structural checks: every live point has a
             level and a row, no link leaves the live ids, no row links
             itself or repeats an id outside the healer's tail window, rows
             with in-degree 0 under 0.1%). Through REST with
             `params.hnsw_ef`: 64 searches from 8 threads at ef 128 (recall@10
             >= 0.90, scores exact to 1e-4, served by the inline beam), the
             same at ef 64 and 256 (recorded); 16 each of `must match group =
             a` (the payload block's subgraph, recall@10 >= 0.90), `must range
             n < 200,000` (the ACORN beam) and the same with `acorn.enable:
             false` (the bias-filtered inline beam): every hit matches, every
             score exact. In the sq phase, 16 searches each at ef 128 and 512
             over the 1536-d rows (`beam_search_level`: the inline table would
             not fit). Then the graph programs on `cuda` against the same
             functions on `cpu` over a 20,000-row slice, and the device time
             and launches of one beam turn and one insert round.
4. filtered  100,000 x 100 cosine points with a keyword payload index
             matching 10% of them and `filter.must match` searches: every
             hit matches and recall@10 >= 0.99 against exact (a correctness
             check; it reports no throughput).
5. sq        Qdrant's scalar-quantization deployment at its benchmark's
             width (dbpedia-openai-1M-1536-angular: 1536-d cosine, random
             vectors from --seed, 262,144 of its 1,000,000 rows so that the
             seven phases keep inside the script's time;
             `{"scalar": {"type": "int8", "quantile": 0.99, "always_ram":
             true}}`): sealed by the
             optimizer into int8 codes, 64 default (rescored) searches from 8
             threads with recall@10 >= 0.99 and scores equal to the exact
             cosine within 1e-4 relative, then 16 codes-only searches
             (`quantization.rescore: false`) with recall@10 >= 0.95 against
             a numpy brute force over int8 codes it encodes itself (survivor
             bin collisions are the only loss allowed; the recall against
             exact cosine is printed beside it); the int8 scan and the merge
             kernels' launch counts must rise.
6. tier      the quantized-primary tier (Qdrant docs, Quantization ->
             "Quantized vectors in RAM, original on disk"): 262,144 x 1536
             cosine (TIER_ROWS, cut from 1,000,000 when the graph phase came,
             for the script's time) with `on_disk: true` and the sq phase's
             scalar config.
             The sealed segment must hold int8 codes on the card and no f32
             block (peak `torch.cuda.max_memory_allocated` under 1 GB, the
             rows in a memmap under the storage directory); 64 default
             searches from 8 threads with recall@10 >= 0.99 against exact
             cosine and scores within 1e-4 relative, then 16 codes-only
             searches with recall@10 >= 0.95 against the brute force over
             the same codes; no fused-scan kernel may launch (this tier is
             the torch block scan, as in the JAX engine). Then TurboQuant as
             the primary store: the first 262,144 rows with
             `{"turbo": {"bits": "bits4"}}` and `on_disk: true` -> packed
             4-bit codes on the card, rescored recall@10 >= 0.99, codes-only
             recall recorded. Each search window is traced once more with
             torch.profiler for its device idle share and top device ops.
7. sparse    SPLADE-like sparse vectors (vocabulary 30,000, term frequency
             ~ rank^-0.9, Poisson(64) terms per document, weights |N(1, 0.6)|
             + 0.05; queries Poisson(48) terms) beside a 128-d euclid dense
             vector, 262,144 points (--sparse-rows 1000000 for its shape's
             full count; cut when the graph phase came),
             loaded through the collection's upsert and sealed. The index must be
             on its hybrid path; 64 `points/query` requests from 8 threads
             with recall@10 >= 0.95 against one scipy CSR product and every
             score within 1e-4 relative of that product's value (a document
             with more cold terms than the forward rows' width Jc is held to
             the product over its hot and its Jc heaviest cold terms, and
             such rows are counted); 16 with a keyword
             filter matching 10% -> every hit matches; then 64 RRF requests
             (dense + sparse prefetch of 30 each) with recall against RRF
             (k = 60) of the two exact rankings recorded, and the bf16 scan
             kernel's launch count must rise by the dense prefetches.
8. sweep     (only when named) times the scan + merge as a replayed CUDA
             graph for several chunk counts per slot, at the REST launches,
             at B = 64 (one query tile) and B = 256 (four), and at a V small
             enough (34 MB) to stay in L2; `cta_gbps` is the V bytes one CTA
             takes in per ms. One JSON line per point, `sweep ...`.

--profile DIR traces the rest and sq phases' search windows a second time
with torch.profiler (device activity only; device busy and idle share from
each window, traces in DIR) and times the host steps under one rest search;
the tier and sparse phases trace their windows in any case and write the
traces only with --profile.

Before the last line it prints the kernel table as JSON: each row's numbers
are those at the rest (bf16, merge) or sq (int8) launch, `launches` sums the
main-path phases, and `by_phase` gives each phase's own launches beside the
kernel's numbers at that phase's launch shape. The last line is
{"ok": true, "device": {...}}. Any failed check raises (including jax or
the qdrant_tpu package having been imported), so the script exits non-zero
and prints no result; it refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ALL_PHASES = ("build", "kernel", "rest", "graph", "filtered", "sq", "tier", "sparse")
EXTRA_PHASES = ("sweep",)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks
# rows of the sq phase: its benchmark has 1,000,000, which the phase served
# until the tier and sparse phases came; a quarter keeps the script's time
SQ_ROWS = 262_144
# rows of the tier phase's int8 part: its shape has 1,000,000, which the phase
# served until the graph phase came (every seal of a resident vector now
# builds a graph, and the 1M x 128 build takes the time this cut frees)
TIER_ROWS = 262_144
TIER_PEAK_BYTES = 1e9  # 3 GB at 1,000,000 rows: codes 0.40 GB + the upload's chunk


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernel against plain version
# ---------------------------------------------------------------------------


def _time_ms(fn, iters: int) -> float:
    """CUDA-event ms per call of `fn` launched from Python (host overhead
    included where it exceeds the device work)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int, reps: int = 5) -> float:
    """Device ms per call of `fn`: `iters` calls captured in one CUDA graph
    and replayed between two events, so no host time is counted; the median
    of `reps` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm: builds, occupancy and plan caches before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def _split_numbers(fs, q, v, bias, blk, slots, scale_sq, bound):
    """The redesigned scan's launch at this shape, its device times and the
    merge kernel's, with the merge held bit for bit against its plain
    version on the kernel's own partials → dict of numbers."""
    import torch

    plan = fs.scan_plan(q, v, blk, slots)
    out = {"n_q": plan["n_q"], "resident_queries": plan["resident"],
           "chunks": plan["chunks"], "ctas": plan["ctas"], "smem_bytes": plan["smem"],
           "ctas_per_sm": plan["ctas_per_sm"]}
    call = lambda: fs.fused_scan_survivors(q, v, bias, blk, slots, scale_sq)  # noqa: E731
    out["ms"] = _time_ms(call, 20)  # scan + merge launched from Python
    out["graph_ms"] = _graph_ms(call, 20)  # the same, device time only
    out["scan_ms"] = _graph_ms(
        lambda: fs.fused_scan_partials(q, v, bias, blk, slots, scale_sq), 20)
    out["gbps"] = bound["bytes"] / out["ms"] / 1e6
    out["ms_over_bound"] = out["ms"] / bound["bound_ms"]
    out["graph_gbps"] = bound["bytes"] / out["graph_ms"] / 1e6
    out["graph_ms_over_bound"] = out["graph_ms"] / bound["bound_ms"]
    if plan["chunks"] > 1:
        ps, pi = fs.fused_scan_partials(q, v, bias, blk, slots, scale_sq)
        ks, ki = fs.merge_survivors(ps, pi)
        rs, ri = fs.merge_survivors_plain(ps, pi)
        torch.cuda.synchronize()
        check(torch.equal(ks, rs) and torch.equal(ki, ri),
              "merge kernel and plain merge differ")
        mbytes = (ps.numel() + rs.numel()) * 8  # f32 + int32 in, out
        out["merge"] = {
            "ms": _time_ms(lambda: fs.merge_survivors(ps, pi), 50),
            "graph_ms": _graph_ms(lambda: fs.merge_survivors(ps, pi), 50),
            "plain_ms": _time_ms(lambda: fs.merge_survivors_plain(ps, pi), 5),
            "bytes": mbytes, "bound_ms": mbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "max_abs_err": float((ks - rs).abs().max()),
        }
    return out


def compare_kernel(rng, b, n, d, euclid, deleted_frac, d_pad=None, blk=4096,
                   slots=16):
    """Kernel vs plain survivors on one input → dict of numbers. Rows and
    queries of width d are zero-padded to d_pad, as the scan index pads."""
    import torch

    from qdrant_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    n_pad = fs.pad_rows(n, blk)
    d_pad = d_pad or d
    v = rng.standard_normal((n, d), dtype=np.float32)
    q = rng.standard_normal((b, d), dtype=np.float32)
    if not euclid:  # dot on unit vectors, as cosine / embedding collections
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    live = rng.random(n) >= deleted_frac
    vt = torch.zeros((n_pad, d_pad), dtype=torch.float32, device=dev)
    vt[:n, :d] = torch.from_numpy(v).to(dev)
    if euclid:
        vt *= 2.0
    v_bf = vt.to(torch.bfloat16)
    del vt
    bias_h = np.full(n_pad, fs.NEG_INF, dtype=np.float32)
    bias_h[:n] = np.where(live, -(v * v).sum(axis=1) if euclid else 0.0, fs.NEG_INF)
    bias = torch.from_numpy(bias_h).to(dev)
    q_bf = torch.zeros((b, d_pad), dtype=torch.float32, device=dev)
    q_bf[:, :d] = torch.from_numpy(q).to(dev)
    q_bf = q_bf.to(torch.bfloat16)

    fs.fused_scan_survivors.launches = fs.merge_survivors.launches = 0
    s_k, i_k = fs.fused_scan_survivors(q_bf, v_bf, bias, blk, slots)
    s_p, i_p = fs.fused_scan_survivors_plain(q_bf, v_bf, bias, blk, slots)
    torch.cuda.synchronize()
    check(fs.fused_scan_survivors.launches == 1, "kernel launch not counted")
    split_walk = fs.scan_plan(q_bf, v_bf, blk, slots)["chunks"] > 1
    check(fs.merge_survivors.launches == int(split_walk), "merge launch not counted")

    # worst-case f32 summation-order bound over d bf16 products, plus the
    # rounding of the bias add: both versions see the same bf16 operands
    qf, vf = q_bf.float(), v_bf.float()
    qn = float(qf.norm(dim=1).max())
    vn = float(vf.norm(dim=1).max())
    smax = float(np.abs(bias_h[bias_h > fs.NEG_INF / 2]).max()) + qn * vn
    tol = d * 2.0 ** -23 * qn * vn + 2 * float(np.spacing(np.float32(smax)))

    dead_k = s_k <= fs.NEG_INF / 2
    dead_p = s_p <= fs.NEG_INF / 2
    check(bool(torch.equal(dead_k, dead_p)), "kernel and plain disagree on empty classes")
    check(bool(torch.equal(i_k[dead_k], i_p[dead_p])), "empty classes carry ids")
    live_cls = ~dead_p
    err = (s_k - s_p).abs()[live_cls]
    max_err = float(err.max()) if err.numel() else 0.0
    check(max_err <= tol, f"survivor scores differ by {max_err} > tol {tol}")
    # ids may differ only where the runner-up is within tol of the winner:
    # rescore the kernel's choice exactly and compare with the plain winner
    diff = (i_k != i_p) & live_cls
    n_diff = int(diff.sum())
    if n_diff:
        rows = diff.nonzero()[:, 0]
        pick = i_k[diff].long()
        alt = (qf[rows] * vf[pick]).sum(dim=1) + bias[pick]
        gap = float((s_p[diff] - alt).abs().max())
        check(gap <= tol, f"{n_diff} ids differ with a score gap {gap} > tol {tol}")
    bound = _bound(b, n_pad, d_pad, slots, 2, "bf16")
    split = _split_numbers(fs, q_bf, v_bf, bias, blk, slots, None, bound)
    plain_ms = _time_ms(
        lambda: fs.fused_scan_survivors_plain(q_bf, v_bf, bias, blk, slots), 5
    )
    product_ms = _time_ms(lambda: q_bf @ v_bf.T, 20)
    fs.fused_scan_survivors.launches = 0
    flop = 2.0 * b * n_pad * d_pad
    return {
        "shape": f"B={b} N={n} (padded {n_pad}) D={d} (padded {d_pad}) blk={blk} "
        f"slots={slots} {'euclid' if euclid else 'dot'} masked={deleted_frac}",
        "max_abs_err": max_err, "tol": tol, "ids_differing": n_diff,
        **split, "plain_ms": plain_ms, "product_ms": product_ms,
        "kernel_tflops": flop / split["graph_ms"] / 1e9,
        "plain_tflops": flop / plain_ms / 1e9,
        **bound,
    }


def _bound(b, n_pad, d_pad, slots, itemsize, kind):
    """Least time the card could take for one survivors call: each input
    read once (queries, the vector block, the bias), each output written once
    (f32 scores + int32 ids), over the HBM rate; the products over the
    tensor-core peak for the operand type. → bound_ms, bound_by and both
    terms."""
    nbytes = (b + n_pad) * d_pad * itemsize + 4 * n_pad + 8 * b * slots * 128
    ops = 2.0 * b * n_pad * d_pad
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(mem_ms, ops_ms),
            "bound_by": "bytes" if mem_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": mem_ms, "ops_ms": ops_ms}


def sq_codes_on_card(gen, n, d, unit, scale=None):
    """Random normal vectors made on the card from `gen` (unit length for
    cosine), encoded as ScalarQuantized.encode does: a global scale from the
    0.99 quantile of |x| over a 1M-value sample, codes round(x / scale)
    clipped to ±127 → (codes [n, d] int8, ||x||^2 [n] f32, scale)."""
    import torch

    x = torch.randn((n, d), generator=gen, device="cuda")
    if unit:
        x /= x.norm(dim=1, keepdim=True)
    if scale is None:
        idx = torch.randint(0, x.numel(), (1_000_000,), generator=gen, device="cuda")
        scale = float(torch.quantile(x.reshape(-1)[idx].abs(), 0.99)) / 127.0
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, (x * x).sum(dim=1), scale


def compare_kernel_int8(gen, b, n, d, euclid, deleted_frac, blk=4096, slots=16):
    """int8 kernel vs plain survivors on SQ codes made on the card → dict of
    numbers. Scores and ids must be equal bit for bit: the integer dot is
    exact in both and both round the scale and the bias add separately."""
    import torch

    from qdrant_tpu_torch.ops import fused_scan as fs

    dev = torch.device("cuda")
    n_pad = fs.pad_rows(n, blk)
    d_pad = max((d + 127) // 128 * 128, 128)
    codes, norms, scale = sq_codes_on_card(gen, n, d, unit=not euclid)
    v = torch.zeros((n_pad, d_pad), dtype=torch.int8, device=dev)
    v[:n, :d] = codes
    del codes
    q = torch.zeros((b, d_pad), dtype=torch.int8, device=dev)
    q[:, :d] = sq_codes_on_card(gen, b, d, unit=not euclid, scale=scale)[0]
    live = torch.rand(n, generator=gen, device=dev) >= deleted_frac
    bias = torch.full((n_pad,), fs.NEG_INF, dtype=torch.float32, device=dev)
    bias[:n] = torch.where(live, -norms if euclid else torch.zeros_like(norms), fs.NEG_INF)
    scale_sq = float(np.float32((2.0 if euclid else 1.0) * scale * scale))

    fs.fused_scan_survivors.launches_int8 = fs.merge_survivors.launches = 0
    s_k, i_k = fs.fused_scan_survivors(q, v, bias, blk, slots, scale_sq)
    s_p, i_p = fs.fused_scan_survivors_plain(q, v, bias, blk, slots, scale_sq)
    torch.cuda.synchronize()
    check(fs.fused_scan_survivors.launches_int8 == 1, "int8 kernel launch not counted")
    split_walk = fs.scan_plan(q, v, blk, slots)["chunks"] > 1
    check(fs.merge_survivors.launches == int(split_walk), "merge launch not counted")
    n_ids = int((i_k != i_p).sum())
    both = (s_k > fs.NEG_INF / 2) & (s_p > fs.NEG_INF / 2)
    max_err = float((s_k - s_p).abs()[both].max()) if bool(both.any()) else 0.0
    check(n_ids == 0, f"int8 kernel and plain ids differ in {n_ids} survivors")
    check(bool(torch.equal(s_k, s_p)), f"int8 survivor scores differ (max {max_err})")
    bound = _bound(b, n_pad, d_pad, slots, 1, "int8")
    split = _split_numbers(fs, q, v, bias, blk, slots, scale_sq, bound)
    plain_ms = _time_ms(
        lambda: fs.fused_scan_survivors_plain(q, v, bias, blk, slots, scale_sq), 5
    )
    product_ms, product_note = None, "torch._int_mm(v, q.T)"
    try:
        product_ms = _time_ms(lambda: torch._int_mm(v, q.t()), 20)
    except RuntimeError as exc:  # a yardstick only: record why it is missing
        product_note = f"torch._int_mm refused this shape: {exc}".splitlines()[0]
    fs.fused_scan_survivors.launches_int8 = 0
    ops = 2.0 * b * n_pad * d_pad
    return {
        "shape": f"B={b} N={n} (padded {n_pad}) D={d} (padded {d_pad}) blk={blk} "
        f"slots={slots} {'euclid' if euclid else 'dot'} masked={deleted_frac} int8",
        "max_abs_err": max_err, "ids_differing": n_ids,
        **split, "plain_ms": plain_ms, "product_ms": product_ms,
        "product_note": product_note,
        "kernel_tops": ops / split["graph_ms"] / 1e9, "plain_tops": ops / plain_ms / 1e9,
        **bound,
    }


SWEEP_SHAPES = (
    # name, B, rows, D, int8
    ("rest_euclid_1m_128_b8", 8, 1_003_520, 128, False),
    ("sq_cosine_1m_1536_b8", 8, 1_003_520, 1536, True),
    ("filtered_cosine_100k_128_b8", 8, 102_400, 128, False),
    ("euclid_1m_128_b64", 64, 1_003_520, 128, False),
    ("sq_cosine_1m_1536_b64", 64, 1_003_520, 1536, True),
    ("euclid_1m_128_b256", 256, 1_003_520, 128, False),
    ("sq_cosine_1m_1536_b256", 256, 1_003_520, 1536, True),
    ("euclid_131k_128_b256_in_l2", 256, 131_072, 128, False),
)


def sweep(gen, fs, card):
    """The sweep phase: scan + merge device time per chunk count around the
    chooser's pick (`chosen`). The inputs are random: the times depend on the
    shapes, not on the values."""
    import torch

    blk, slots = fs.DEFAULT_BLK, fs.DEFAULT_SLOTS
    for name, b, n, d, int8 in SWEEP_SHAPES:
        if int8:
            v = torch.randint(-127, 128, (n, d), generator=gen, device="cuda",
                              dtype=torch.int8)
            q = torch.randint(-127, 128, (b, d), generator=gen, device="cuda",
                              dtype=torch.int8)
        else:
            v = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
            q = torch.randn((b, d), generator=gen, device="cuda").to(torch.bfloat16)
        bias = torch.zeros(n, device="cuda")
        scale = 1e-4 if int8 else None
        bound = _bound(b, n, d, slots, v.element_size(), "int8" if int8 else "bf16")
        chosen = fs.scan_plan(q, v, blk, slots)["chunks"]
        for chunks in sorted({1, max(1, chosen // 2), chosen, chosen * 2, chosen * 4}):
            plan = fs.scan_plan(q, v, blk, slots, chunks)
            ms = _graph_ms(lambda: fs.fused_scan_survivors(q, v, bias, blk, slots, scale,
                                                           chunks=chunks), 10)
            v_bytes = v.numel() * v.element_size()
            print("sweep " + json.dumps({
                "shape": name, **plan, "chosen": chunks == chosen, "graph_ms": ms,
                "bound_ms": bound["bound_ms"], "ms_over_bound": ms / bound["bound_ms"],
                "gbps": bound["bytes"] / ms / 1e6,
                "cta_gbps": -(-b // plan["n_q"]) * v_bytes / plan["ctas"] / ms / 1e6,
                "card": card}), flush=True)
        del v, q, bias
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 3-4: the main path through REST
# ---------------------------------------------------------------------------


def _call(base: str, method: str, path: str, body=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=600) as resp:
        out = json.loads(resp.read())
    check(out.get("status") == "ok", f"{method} {path} -> {out}")
    return out["result"]


def _concurrent_search(base, coll, queries, threads, body_extra):
    """POST one points/search per query from `threads` threads → (hits per
    query, wall seconds)."""
    return _concurrent_post(
        base, f"/collections/{coll}/points/search",
        [{"vector": q.tolist(), **body_extra} for q in queries], threads)


def _concurrent_post(base, path, bodies, threads):
    """POST each body to `path` from `threads` threads → (result per body,
    wall seconds)."""
    results = [None] * len(bodies)
    errors = []

    def worker(idx):
        try:
            for i in idx:
                results[i] = _call(base, "POST", path, bodies[i])
        except Exception as exc:  # re-raised on the main thread below
            errors.append(exc)

    parts = [list(range(t, len(bodies), threads)) for t in range(threads)]
    ts = [threading.Thread(target=worker, args=(p,)) for p in parts]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return results, wall


def _exact_topk(x: np.ndarray, q: np.ndarray, k: int, metric: str):
    """Numpy brute force, independent of the port: → ids [B, k] best first."""
    if metric == "euclid":
        score = -((x * x).sum(1)[None, :] - 2.0 * (q @ x.T))
    else:
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        score = qn @ xn.T
    part = np.argpartition(-score, k, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(score, part, axis=1), axis=1)
    return np.take_along_axis(part, order, axis=1)


def _recall(hits, truth, k):
    got = [{h["id"] for h in r} for r in hits]
    return float(np.mean([len(g & set(t[:k].tolist())) / k for g, t in zip(got, truth)]))


def _profile_window(fn, out_dir, name):
    """Run fn under torch.profiler, tracing device activity only (no host
    op spans, which would stretch the window) → (device-busy ms, wall ms of
    the same window, top kernels); the chrome trace goes to
    out_dir/<name>_window_trace.json when out_dir is given."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, f"{name}_window_trace.json"))
    rows = [(e.key[:96], e.self_device_time_total / 1e3, e.count)  # names run long
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), wall_ms, rows[:8], sum(r[2] for r in rows)


def _host_breakdown(base, coll, q, reps=5):
    """Host-clock ms of the steps under one sift1m search, each averaged
    over `reps` calls after one warm call. The search_device and shard rows
    include the device work and its sync."""
    import torch

    from qdrant_tpu_torch.index.plain import PlainIndex

    shard = coll.shards[0]
    seg = next(s for s in shard.segments if not s.appendable)
    store = seg.dense[""]
    alive = seg.alive_mask()
    combined = (~store.deleted_mask) & alive[: len(store)]  # as PlainIndex

    def avg(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def device_search(b):
        _, ids, _, _ = PlainIndex(store).search_device(q[:b], 10, alive)
        ids.cpu()

    out = {
        "segment_alive_mask_ms": avg(seg.alive_mask),
        "scan_mask_device_cached_ms": avg(
            lambda: store.scan_index().mask_device_cached(combined)),
    }
    for b in (8, 64):
        out[f"plain_search_device_b{b}_ms"] = avg(lambda: device_search(b))
    out["shard_search_dense_many_b8_ms"] = avg(
        lambda: shard.search_dense_many("", [q[:8]], 10))
    out["rest_search_one_client_ms"] = avg(
        lambda: _call(base, "POST", f"/collections/{coll.name}/points/search",
                      {"vector": q[0].tolist(), "limit": 10}))
    return out


def _clustered(rng, n, d, n_queries, n_clusters=1024, spread=20.0):
    """The SIFT-like data of the repo's `hnsw_1m_sift128` cell (this script's
    own copy of bench.py::make_dataset): a Gaussian mixture, clipped to 0-255
    → (data [n, d], queries [n_queries, d]) f32."""
    centers = rng.uniform(0, 200, size=(n_clusters, d)).astype(np.float32)
    data = centers[rng.integers(0, n_clusters, size=n)]
    data += spread * rng.standard_normal((n, d), dtype=np.float32)
    np.clip(data, 0, 255, out=data)
    queries = centers[rng.integers(0, n_clusters, size=n_queries)] + spread * (
        rng.standard_normal((n_queries, d), dtype=np.float32))
    return data, np.clip(queries, 0, 255).astype(np.float32)


def _euclid_score_err(hits, x, q):
    """Worst relative gap between returned scores and the exact euclid
    distance of the returned ids."""
    worst = 0.0
    for qi, h in enumerate(hits):
        ids = np.array([p["id"] for p in h])
        ref = np.sqrt(((x[ids] - q[qi]) ** 2).sum(1))
        got = np.array([p["score"] for p in h])
        check(np.all(np.isfinite(got)), "non-finite score")
        worst = max(worst, float(np.abs(got - ref).max() / ref.max()))
    return worst


def _graph_stats(index, n):
    """Structure of a built HnswIndex over rows 0..n-1 (all live) → dict of
    statistics; raises where the graph is malformed."""
    links = index.links0  # host mirror (downloads the device adjacency)
    levels, rank = index.levels, index.rank
    check(len(levels) == n and bool((levels >= 0).all()) and bool((rank >= 0).all()),
          "a live point has no level or no row in the graph")
    rows = links[rank]  # [n, m0] in id order
    valid = rows >= 0
    check(bool((rows[valid] < n).all()), "a link points past the live ids")
    check(not bool((rows == np.arange(n)[:, None]).any()), "a row links itself")
    # The healer force-writes a weak node into the tail slots of its forward
    # neighbours' rows without looking for a copy already there (the JAX
    # healer does the same), so a row may hold an id twice, one copy in the
    # tail window. Outside that window no id repeats.
    window = max(index.config.m0 // 4, 6)
    head = np.sort(rows[:, : index.config.m0 - window], axis=1)
    check(not bool(((head[:, 1:] == head[:, :-1]) & (head[:, 1:] >= 0)).any()),
          "a row repeats an id outside the healer's tail window")
    srt = np.sort(rows, axis=1)
    dup_rows = int((((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(axis=1)).sum())
    indeg = np.bincount(rows[valid], minlength=n)
    unreachable = int((indeg == 0).sum())
    check(unreachable < 0.001 * n, f"{unreachable} rows of {n} have in-degree 0")
    return {"mean_degree0": float(valid.sum() / n), "rows_in_degree_0": unreachable,
            "rows_with_healer_duplicate": dup_rows, "max_level": int(index.max_level),
            "level_counts": {str(k): v for k, v in index.level_counts.items()}}


def _graph_window(base, x, q, truth, ef, threads, extra=None, label="graph"):
    """`points/search` with params.hnsw_ef through REST → (hits, numbers)."""
    body = {"limit": 10, "params": {"hnsw_ef": ef, **(extra or {}).get("params", {})},
            **{k: v for k, v in (extra or {}).items() if k != "params"}}
    hits, wall = _concurrent_search(base, "sift1m", q, threads, body)
    check(all(len(h) == 10 for h in hits), f"a {label} search returned fewer than 10 hits")
    check(all(len({p["id"] for p in h}) == 10 for h in hits), f"a {label} search repeats an id")
    worst = _euclid_score_err(hits, x, q)
    check(worst <= 1e-4, f"{label}: returned distances off by {worst} (relative)")
    return hits, {"hnsw_ef": ef, "requests": len(q), "threads": threads, "wall_s": wall,
                  "qps": len(q) / wall, "recall_at_10": _recall(hits, truth, 10),
                  "score_rel_err": worst}


def run_rest(rng, storage, fs, phases, n=1_000_000, d=128, n_queries=64, threads=8,
             n_filtered=16, profile_dir=None):
    """The rest and graph phases over one sealed collection → {"rest": ...,
    "graph": ...} (each only when its phase is named)."""
    import torch

    from qdrant_tpu_torch.api.rest import RestServer
    from qdrant_tpu_torch.api.toc import TableOfContent
    from qdrant_tpu_torch.ops import hnsw as hnsw_ops
    from qdrant_tpu_torch.ops import hnsw_build, hnsw_inline

    toc = TableOfContent(storage)
    srv = RestServer(toc, host="127.0.0.1", port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    out = {}
    try:
        _call(base, "PUT", "/collections/sift1m",
              {"vectors": {"size": d, "distance": "Euclid"}})
        _call(base, "PUT", "/collections/sift1m/index",
              {"field_name": "n", "field_schema": "integer"})
        _call(base, "PUT", "/collections/sift1m/index",
              {"field_name": "group", "field_schema": "keyword"})
        x, q = _clustered(rng, n, d, n_queries)
        payloads = [{"n": i, "group": "a"} if i % 10 == 0 else {"n": i} for i in range(n)]
        coll = toc.get_collection("sift1m")
        t0 = time.perf_counter()
        coll.bulk_ingest(list(range(n)), {"": x}, payloads)
        ingest_s = time.perf_counter() - t0
        del payloads
        torch.cuda.reset_peak_memory_stats()
        hnsw_build.insert_batch_level0.calls = 0
        t0 = time.perf_counter()
        toc.optimize_all()
        optimize_s = time.perf_counter() - t0
        seal_peak = torch.cuda.max_memory_allocated()
        insert_rounds = hnsw_build.insert_batch_level0.calls
        sealed = [s for s in coll.shards[0].segments if not s.appendable and len(s) == n]
        check(bool(sealed), "optimizer did not seal: "
              f"{[(len(s), s.appendable) for s in coll.shards[0].segments]}")
        seg = sealed[0]
        truth = _exact_topk(x, q, 10, "euclid")
        if "rest" in phases:
            _concurrent_search(base, "sift1m", q[:1], 1, {"limit": 10})  # warm-up
            fs.fused_scan_survivors.launches = fs.merge_survivors.launches = 0
            hits, wall = _concurrent_search(base, "sift1m", q, threads, {"limit": 10})
            launches = fs.fused_scan_survivors.launches
            merges = fs.merge_survivors.launches
            check(launches > 0, "the REST search never launched the fused scan kernel")
            check(merges > 0, "the REST search never launched the merge kernel")
            recall = _recall(hits, truth, 10)
            check(all(len(h) == 10 for h in hits), "a search returned fewer than 10 hits")
            # returned scores are euclid distances of the returned ids
            worst = _euclid_score_err(hits, x, q)
            check(worst <= 1e-4, f"returned distances off by {worst} (relative)")
            check(recall >= 0.99, f"recall@10 {recall} < 0.99")
            prof = {}
            if profile_dir:  # the same window again, traced (not in the QPS above)
                busy, traced_ms, top, _ = _profile_window(
                    lambda: _concurrent_search(base, "sift1m", q, threads, {"limit": 10}),
                    profile_dir, "rest")
                prof = {"traced_wall_ms": traced_ms, "device_busy_ms": busy,
                        "device_idle_share": 1 - busy / traced_ms,
                        "top_device_ops_ms": [[k, t, c] for k, t, c in top],
                        "host_breakdown": _host_breakdown(base, coll, q)}
            out["rest"] = {
                "points": n, "dim": d, "ingest_s": ingest_s, "optimize_s": optimize_s,
                "requests": n_queries, "threads": threads, "wall_s": wall,
                "qps": n_queries / wall, "recall_at_10": recall,
                "score_rel_err": worst, "kernel_launches": launches,
                "merge_launches": merges, **prof,
            }
        if "graph" in phases:
            index = seg.hnsw.get("")
            check(index is not None, "the seal built no HNSW graph")
            stats = index.build_stats
            check(stats.get("device_build") is True, "the seal did not use the device builder")
            sub = seg.hnsw_blocks.get("", {}).get(("group", repr("a")))
            check(sub is not None and len(seg.hnsw_blocks[""]) == 1,
                  f"payload-block subgraphs: {list(seg.hnsw_blocks.get('', {}))}")
            build = {
                "build_seconds": stats["seconds"], "us_per_point": stats["seconds"] / n * 1e6,
                "precision": stats["precision"], "batches_per_ramp_shape": stats["batches"],
                "contended_batches": stats["contended_batches"],
                "insert_rounds_in_seal": insert_rounds,
                "subgraph_points": sub.build_stats["points"],
                "subgraph_build_seconds": sub.build_stats["seconds"],
                "seal_max_memory_allocated_bytes": seal_peak,
                **_graph_stats(index, n),
            }
            sub_n = sub.build_stats["points"]
            check(sub_n == len(range(0, n, 10)), f"the block's subgraph holds {sub_n} points")
            t0 = time.perf_counter()  # warm-up: packs the inline link+code table
            _concurrent_search(base, "sift1m", q[:1], 1,
                               {"limit": 10, "params": {"hnsw_ef": 128}})
            first_search_s = time.perf_counter() - t0
            inline = index._inline
            check(isinstance(inline, dict), "the 1M x 128 graph did not get its inline table")
            torch.cuda.reset_peak_memory_stats()
            fs.fused_scan_survivors.launches = 0
            index.served.clear()
            windows = {}
            for ef in (128, 64, 256):
                _, windows[f"ef{ef}"] = _graph_window(base, x, q, truth, ef, threads)
            check(index.served["inline"] > 0 and set(index.served) == {"inline"},
                  f"the graph searches were served by {dict(index.served)}, not the inline beam")
            check(fs.fused_scan_survivors.launches == 0, "a graph search launched the scan kernel")
            check(windows["ef128"]["recall_at_10"] >= 0.90,
                  f"graph recall@10 at ef 128 is {windows['ef128']['recall_at_10']} < 0.90")
            search_peak = torch.cuda.max_memory_allocated()
            trace = _traced_window(
                lambda: _graph_window(base, x, q, truth, 128, threads), profile_dir, "graph")
            trace["device_ops_per_request"] = trace["device_ops"] / n_queries

            # filtered, on the same collection: subgraph, ACORN, biased inline
            qf = q[:n_filtered]
            in_a = np.arange(0, n, 10)
            truth_a = in_a[_exact_topk(x[in_a], qf, 10, "euclid")]
            first_fifth = np.arange(min(200_000, n // 5))
            truth_r = first_fifth[_exact_topk(x[first_fifth], qf, 10, "euclid")]
            flt_a = {"must": [{"key": "group", "match": {"value": "a"}}]}
            flt_r = {"must": [{"key": "n", "range": {"lt": len(first_fifth)}}]}
            filtered = {}
            for name, flt, tr, params, served_by in (
                ("subgraph_group_a", flt_a, truth_a, {}, (sub, "inline")),
                ("acorn_range", flt_r, truth_r, {}, (index, "acorn")),
                ("biased_inline_range", flt_r, truth_r, {"acorn": {"enable": False}},
                 (index, "inline")),
            ):
                index.served.clear()
                sub.served.clear()
                hits, res = _graph_window(
                    base, x, qf, tr, 128, threads,
                    {"filter": flt, "with_payload": True, "params": params}, name)
                ok = (all(p["payload"].get("group") == "a" for h in hits for p in h)
                      if flt is flt_a else
                      all(p["payload"]["n"] < len(first_fifth) for h in hits for p in h))
                check(ok, f"{name}: a hit does not match the filter")
                who, program = served_by
                other = index if who is sub else sub
                check(who.served[program] > 0 and set(who.served) == {program}
                      and not other.served,
                      f"{name}: served by main {dict(index.served)} / sub {dict(sub.served)}")
                filtered[name] = {**res, "served_by": program,
                                  "index": "subgraph" if who is sub else "main"}
            check(filtered["subgraph_group_a"]["recall_at_10"] >= 0.90,
                  "subgraph recall@10 "
                  f"{filtered['subgraph_group_a']['recall_at_10']} < 0.90")
            out["graph"] = {
                "points": n, "dim": d, "m": index.config.m, "ef_construct":
                index.config.ef_construct, "build": build,
                "inline_table_bytes": inline["table"].numel(),
                "first_search_s": first_search_s, **windows, "filtered": filtered,
                "search_max_memory_allocated_bytes": search_peak, **trace,
                "beam_calls": {"inline": hnsw_inline.beam_search_inline.calls,
                               "level": hnsw_ops.beam_search_level.calls,
                               "acorn": hnsw_ops.beam_search_acorn.calls},
            }
        return out
    finally:
        srv.shutdown()
        toc.close()


def _same_beam(s_a, i_a, s_b, i_b, rtol=1e-5, magnitude=1.0, top=None):
    """Two beams (best first) agree → (worst score gap in units of rtol, ids
    differing at ties, share of ids in both beams). Scores are held within
    rtol of their size (or of `magnitude`, the operands of a cancelling
    formula, where that is larger); ids must be equal wherever a score stands
    clear of its neighbours by more than that (two equal scores may swap).
    `top` holds only the first `top` entries to that, position by position:
    an f32-scored beam may take another path at a near-tie, which shows in its
    tail; the rest is then compared id by id, and the share of common ids is
    returned."""
    s_a, s_b = np.asarray(s_a, np.float64), np.asarray(s_b, np.float64)
    i_a, i_b = np.asarray(i_a), np.asarray(i_b)
    shared, worst = [], 0.0
    for r in range(len(i_a)):  # scores of ids found by both, wherever they stand
        both, pa, pb = np.intersect1d(i_a[r][i_a[r] >= 0], i_b[r][i_b[r] >= 0],
                                      return_indices=True)
        ga, gb = s_a[r][i_a[r] >= 0][pa], s_b[r][i_b[r] >= 0][pb]
        if len(both):
            worst = max(worst, float((np.abs(ga - gb)
                                      / (rtol * np.maximum(np.abs(gb), magnitude))).max()))
        shared.append(len(both) / max(int((i_b[r] >= 0).sum()), 1))
    check(worst <= 1.0, f"scores of the same ids differ by {worst} x tol")
    k = top or s_a.shape[1]
    s_a, s_b, i_a, i_b = s_a[:, :k], s_b[:, :k], i_a[:, :k], i_b[:, :k]
    fin = np.isfinite(s_b)
    check(bool((fin == np.isfinite(s_a)).all()), "beams differ in their empty slots")
    s_a, s_b = np.where(fin, s_a, -1e30), np.where(fin, s_b, -1e30)
    tol = rtol * np.maximum(np.abs(s_b), magnitude)
    check(bool((np.abs(s_a - s_b) <= tol).all()), "beam scores differ position by position")
    diff = (i_a != i_b) & fin
    pad = np.full((len(s_b), 1), np.inf)
    near = np.minimum(np.abs(np.diff(s_b, axis=1, prepend=pad)),
                      np.abs(np.diff(s_b, axis=1, append=-pad))) <= 2 * tol
    check(bool((~diff | near).all()), "beam ids differ where the scores are distinct")
    return worst, int(diff.sum()), float(np.mean(shared))


def _device_ms_and_ops(fn):
    """Device-busy ms and device ops (kernels and copies) of one call of
    `fn`, from a torch.profiler trace of device activity."""
    import torch

    fn()
    torch.cuda.synchronize()

    def synced():
        fn()
        torch.cuda.synchronize()

    busy, _, _, n_ops = _profile_window(synced, None, "micro")
    return busy, n_ops


def run_graph_vs_cpu(rng, n=20_000, d=128, b=64, ef=64):
    """The graph programs on `cuda` against the same functions on `cpu` over
    an n x d slice of the clustered data, then the device time and device
    ops of one beam turn and of one insert round at the builder's top batch
    shape → dict of numbers."""
    import torch

    from qdrant_tpu_torch.index.hnsw import HnswIndex
    from qdrant_tpu_torch.ops import hnsw as hnsw_ops
    from qdrant_tpu_torch.ops import hnsw_build as hb
    from qdrant_tpu_torch.ops import quantization as qops
    from qdrant_tpu_torch.ops.hnsw_inline import beam_search_inline
    from qdrant_tpu_torch.storage.vectors import DenseVectorStore
    from qdrant_tpu_torch.types import Distance, HnswConfig

    x, q = _clustered(rng, n, d, b)
    store = DenseVectorStore(d, Distance.EUCLID)
    store.add(x)
    index = HnswIndex(store, HnswConfig())
    index.build()
    check(index.build_stats["device_build"], "the slice was not built on the device")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    vectors = store.device_block()[0]
    links, rank = index._links0_device(), index._rank_device()
    inline = index._inline_state()
    check(inline is not None, "the slice got no inline table")
    m0 = index.config.m0
    scale = inline["scale"]
    scale_sq = float(np.float32(2.0 * scale * scale))
    q_i8 = np.clip(np.round(q / scale), -127, 127).astype(np.int8)
    entries = np.full((b, 1), index.entry, np.int32)

    def on(dev, *arrays):
        return [a.to(dev) if isinstance(a, torch.Tensor) else torch.from_numpy(a).to(dev)
                for a in arrays]

    def level(dev, check_every=hnsw_ops.CHECK_EVERY):
        qd, v, l, r, e = on(dev, q, vectors, links, rank, entries)
        return hnsw_ops.beam_search_level(qd, v, l, e, None, ef, 2 * ef + 16, "Euclid",
                                          compact_of=r, check_every=check_every)

    def inline_beam(dev, ef=ef, check_every=hnsw_ops.CHECK_EVERY, rows=b):
        qd, qi, t, r, v, e = on(dev, q[:rows], q_i8[:rows], inline["table"], rank, vectors,
                                entries[:rows])
        return beam_search_inline(qd, qi, t, scale_sq, r, v, e, None, m=m0, d=d, ef=ef,
                                  iters=max((2 * ef + 16) // 4, 8), expand=4, euclid=True,
                                  k=ef, check_every=check_every)

    out = {"points": n, "dim": d, "queries": b, "ef": ef, "rtol": 1e-5}
    # the inline beam's exact rescore is 2qv - |v|^2 - |q|^2: its rounding is
    # relative to the operands of that cancellation
    cancel = float((x * x).sum(1).max() + (q * q).sum(1).max())
    for name, fn, kw in (("beam_search_level", level, {"top": 10}),
                         ("beam_search_inline", inline_beam, {"magnitude": cancel})):
        s_g, i_g = (t.cpu().numpy() for t in fn(cuda))
        s_c, i_c = (t.numpy() for t in fn(cpu))
        err, n_diff, shared = _same_beam(s_g, i_g, s_c, i_c, **kw)
        out[name] = {"score_err_over_tol": err, "ids_differing_at_ties": n_diff,
                     "shared_ids": shared}
    check(out["beam_search_inline"]["shared_ids"] == 1.0,
          "the inline beam's ids differ between cuda and cpu (its traversal is integer)")
    check(out["beam_search_level"]["shared_ids"] >= 0.95,
          f"the level beams share {out['beam_search_level']['shared_ids']} of their ids")

    # one insert round, int8 codes, from the built graph's state
    sq = qops.ScalarQuantized.encode(x)
    cap = vectors.shape[0]
    codes = np.zeros((cap, d), np.int8)
    codes[:n] = sq.codes
    norms = np.zeros(cap, np.float32)
    norms[:n] = sq.norms_sq
    sq_scale = float(np.float32(2.0 * sq.scale * sq.scale))
    batch = rng.choice(n, size=256, replace=False).astype(np.int32)
    owner = np.full(links.shape[0], -1, np.int32)
    owner[index.rank[index.rank >= 0]] = np.flatnonzero(index.rank >= 0)
    ent = np.full(256, index.entry, np.int32)
    rounds = {}
    for dev in (cuda, cpu):
        l, c, bi, qi, cd, nm, r, ow, e = on(
            dev, links.clone(), (links >= 0).sum(1).to(torch.int32), batch, codes[batch],
            codes, norms, rank, owner, ent)
        hb.insert_batch_level0(l, c, bi, qi, cd, nm, r, ow, e, sq_scale, ef=128, iters=21,
                               expand=8, m0=m0, inc_cap=16, ov_cap=256, euclid=True,
                               sel_c=128, merge_forward=True)
        rounds[dev is cuda] = (l.cpu().numpy()[:-1], c.cpu().numpy()[:-1])
    check(np.array_equal(rounds[True][0], rounds[False][0])
          and np.array_equal(rounds[True][1], rounds[False][1]),
          "an int8 insert round differs between cuda and cpu")
    out["insert_batch_level0_int8"] = {
        "rows_changed": int((rounds[True][0] != links.cpu().numpy()[:-1]).any(1).sum())}

    # device time and ops of the programs at the shapes the main path runs
    # (B = 8 requests at ef 128; the builder's top batch of 4,096 points, on
    # this slice's graph: the shapes are the 1M build's, the gathers' reach is
    # not). All turns run (no early stop), so a per-turn figure is exact.
    turns = max((2 * 128 + 16) // 4, 8)
    busy, n_ops = _device_ms_and_ops(lambda: inline_beam(cuda, ef=128, check_every=None, rows=8))
    out["inline_beam_b8_ef128"] = {"turns": turns, "device_ms_per_turn": busy / turns,
                                   "device_ops_per_turn": n_ops / turns}
    bf16 = vectors.to(torch.bfloat16)
    nrm = (vectors * vectors).sum(1)
    big = rng.choice(n, size=4096, replace=False).astype(np.int32)
    bi, ow, e = on(cuda, big, owner, np.full(4096, index.entry, np.int32))
    state = (links.clone(), (links >= 0).sum(1).to(torch.int32))

    def insert_round():
        hb.insert_batch_level0(*state, bi, bf16[bi.long()], bf16, nrm, rank, ow, e, 2.0,
                               ef=128, iters=21, expand=8, m0=m0, inc_cap=16, ov_cap=4096,
                               euclid=True, sel_c=128, merge_forward=True)

    busy, n_ops = _device_ms_and_ops(insert_round)
    t0 = time.perf_counter()
    insert_round()
    torch.cuda.synchronize()
    out["insert_round_b4096_bf16"] = {
        "device_ms": busy, "device_ops": n_ops, "wall_ms": (time.perf_counter() - t0) * 1e3,
        "beam_turns": 21}
    return out


def run_filtered(rng, storage, fs, n=100_000, d=100, n_queries=64, threads=8):
    from qdrant_tpu_torch.api.rest import RestServer
    from qdrant_tpu_torch.api.toc import TableOfContent

    toc = TableOfContent(storage)
    srv = RestServer(toc, host="127.0.0.1", port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        _call(base, "PUT", "/collections/glove100",
              {"vectors": {"size": d, "distance": "Cosine"}})
        _call(base, "PUT", "/collections/glove100/index",
              {"field_name": "group", "field_schema": "keyword"})
        x = rng.standard_normal((n, d), dtype=np.float32)
        member = rng.random(n) < 0.10
        payloads = [{"group": "a" if m else "b"} for m in member]
        coll = toc.get_collection("glove100")
        coll.bulk_ingest(list(range(n)), {"": x}, payloads)
        toc.optimize_all()
        q = rng.standard_normal((n_queries, d), dtype=np.float32)
        flt = {"must": [{"key": "group", "match": {"value": "a"}}]}
        fs.fused_scan_survivors.launches = fs.merge_survivors.launches = 0
        hits, _ = _concurrent_search(
            base, "glove100", q, threads,
            {"limit": 10, "filter": flt, "with_payload": True},
        )
        launches = fs.fused_scan_survivors.launches
        merges = fs.merge_survivors.launches
        check(launches > 0, "the filtered search never launched the fused scan kernel")
        check(merges > 0, "the filtered search never launched the merge kernel")
        check(all(p["payload"]["group"] == "a" for h in hits for p in h),
              "a hit does not match the filter")
        sub = np.nonzero(member)[0]
        truth = sub[_exact_topk(x[sub], q, 10, "cosine")]
        recall = _recall(hits, truth, 10)
        check(recall >= 0.99, f"filtered recall@10 {recall} < 0.99")
        return {
            "points": n, "dim": d, "matching": int(member.sum()),
            "requests": n_queries, "recall_at_10": recall,
            "kernel_launches": launches, "merge_launches": merges,
        }
    finally:
        srv.shutdown()
        toc.close()


def run_sq(rng, storage, fs, n=SQ_ROWS, d=1536, n_queries=64, threads=8,
           n_codes_only=16, profile_dir=None, graph=False, n_graph=16):
    """The sq phase: Qdrant's scalar-quantization config on an n x 1536
    cosine collection, served through REST."""
    import torch

    from qdrant_tpu_torch.api.rest import RestServer
    from qdrant_tpu_torch.api.toc import TableOfContent

    quant = {"scalar": {"type": "int8", "quantile": 0.99, "always_ram": True}}
    toc = TableOfContent(storage)
    srv = RestServer(toc, host="127.0.0.1", port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    torch.cuda.reset_peak_memory_stats()
    try:
        # The per-vector form of the config: both packages read
        # quantization_config only inside `vectors` (a collection-level one
        # is accepted and ignored).
        _call(base, "PUT", "/collections/dbpedia",
              {"vectors": {"size": d, "distance": "Cosine", "quantization_config": quant}})
        x = rng.standard_normal((n, d), dtype=np.float32)
        coll = toc.get_collection("dbpedia")
        t0 = time.perf_counter()
        coll.bulk_ingest(list(range(n)), {"": x})
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toc.optimize_all()
        optimize_s = time.perf_counter() - t0
        sealed = [s for s in coll.shards[0].segments if not s.appendable and len(s) == n]
        check(bool(sealed) and "" in sealed[0].quantized,
              f"the optimizer did not seal SQ codes: "
              f"{[(len(s), s.appendable, list(s.quantized)) for s in coll.shards[0].segments]}")
        check(sealed[0].dense[""]._scan is None, "the seal uploaded a bf16 scan block")
        q = rng.standard_normal((n_queries, d), dtype=np.float32)
        t0 = time.perf_counter()
        _concurrent_search(base, "dbpedia", q[:1], 1, {"limit": 10})  # warm-up
        first_search_s = time.perf_counter() - t0
        fs.fused_scan_survivors.launches_int8 = fs.merge_survivors.launches = 0
        hits, wall = _concurrent_search(base, "dbpedia", q, threads, {"limit": 10})
        launches = fs.fused_scan_survivors.launches_int8
        merges = fs.merge_survivors.launches
        check(launches > 0, "the SQ search never launched the int8 kernel")
        check(merges > 0, "the SQ search never launched the merge kernel")
        truth, xn = _exact_cosine(x, q, 10)
        recall = _recall(hits, truth, 10)
        check(all(len(h) == 10 for h in hits), "an SQ search returned fewer than 10 hits")
        worst = 0.0
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        for qi, h in enumerate(hits):
            ids = np.array([p["id"] for p in h])
            ref = xn[ids] @ qn[qi]
            got = np.array([p["score"] for p in h])
            check(np.all(np.isfinite(got)), "non-finite score")
            worst = max(worst, float(np.abs(got - ref).max() / np.abs(ref).max()))
        check(worst <= 1e-4, f"returned cosines off by {worst} (relative)")
        check(recall >= 0.99, f"SQ recall@10 {recall} < 0.99")
        codes_body = {"limit": 10, "params": {"quantization": {"rescore": False}}}
        fs.fused_scan_survivors.launches_int8 = fs.merge_survivors.launches = 0
        c_hits, c_wall = _concurrent_search(base, "dbpedia", q[:n_codes_only], threads,
                                            codes_body)
        c_launches = fs.fused_scan_survivors.launches_int8
        c_merges = fs.merge_survivors.launches
        check(c_launches > 0, "the codes-only search never launched the int8 kernel")
        check(c_merges > 0, "the codes-only search never launched the merge kernel")
        check(all(len(h) == 10 and all(0 <= p["id"] < n for p in h) for h in c_hits),
              "a codes-only search returned an invalid id or fewer than 10 hits")
        c_truth = _exact_codes_topk(xn, qn[:n_codes_only], 10)
        c_recall = _recall(c_hits, c_truth, 10)
        c_recall_exact = _recall(c_hits, truth[:n_codes_only], 10)
        check(c_recall >= 0.95, f"codes-only recall@10 {c_recall} < 0.95 (vs the codes)")
        wide = None
        if graph:  # the graph phase's wide rows: beam_search_level at D = 1536
            index = sealed[0].hnsw.get("")
            check(index is not None and index.build_stats.get("device_build") is True,
                  "the SQ seal built no graph with the device builder")
            wide = {"build_seconds": index.build_stats["seconds"],
                    "batches_per_ramp_shape": index.build_stats["batches"]}
            for ef in (128, 512):
                index.served.clear()
                g_hits, g_wall = _concurrent_search(
                    base, "dbpedia", q[:n_graph], threads,
                    {"limit": 10, "params": {"hnsw_ef": ef}})
                check(all(len(h) == 10 and len({p["id"] for p in h}) == 10 for h in g_hits),
                      "a wide-row graph search returned fewer than 10 distinct ids")
                g_worst = _cosine_score_err(g_hits, xn, qn[:n_graph])
                check(g_worst <= 1e-4, f"wide-row graph cosines off by {g_worst} (relative)")
                check(index.served["level"] > 0 and set(index.served) == {"level"},
                      f"wide rows were served by {dict(index.served)}, not beam_search_level")
                wide[f"ef{ef}"] = {"requests": n_graph, "wall_s": g_wall,
                                   "qps": n_graph / g_wall, "score_rel_err": g_worst,
                                   "recall_at_10": _recall(g_hits, truth[:n_graph], 10)}
        prof = {}
        if profile_dir:  # the same window again, traced (not in the QPS above)
            busy, traced_ms, top, _ = _profile_window(
                lambda: _concurrent_search(base, "dbpedia", q, threads, {"limit": 10}),
                profile_dir, "sq")
            prof = {"traced_wall_ms": traced_ms, "device_busy_ms": busy,
                    "device_idle_share": 1 - busy / traced_ms,
                    "top_device_ops_ms": [[k, t, c] for k, t, c in top]}
        return {
            "points": n, "dim": d, "quantization": quant, "ingest_s": ingest_s,
            "optimize_s": optimize_s, "first_search_s": first_search_s,
            "requests": n_queries, "threads": threads, "wall_s": wall,
            "qps": n_queries / wall, "recall_at_10": recall, "score_rel_err": worst,
            "int8_kernel_launches": launches, "merge_launches": merges,
            "codes_only": {"requests": n_codes_only, "wall_s": c_wall,
                           "qps": n_codes_only / c_wall,
                           "recall_at_10_vs_codes": c_recall,
                           "recall_at_10_vs_exact": c_recall_exact,
                           "int8_kernel_launches": c_launches,
                           "merge_launches": c_merges},
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(), **prof,
            **({"graph_wide_rows": wide} if wide else {}),
        }
    finally:
        srv.shutdown()
        toc.close()


def _traced_window(fn, profile_dir, name):
    """The window `fn` once more under torch.profiler → its device busy
    time, idle share and top device ops. A profiler failure, or a window in
    which nothing ran on the device, fails the phase."""
    busy, traced_ms, top, n_ops = _profile_window(fn, profile_dir, name)
    check(busy > 0 and top, f"the traced {name} window shows no device time")
    return {"traced_wall_ms": traced_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / traced_ms, "device_ops": n_ops,
            "top_device_ops_ms": [[k, t, c] for k, t, c in top]}


def _cosine_score_err(hits, xn, qn):
    """Worst relative gap between returned scores and the exact cosine of
    the returned ids."""
    worst = 0.0
    for qi, h in enumerate(hits):
        ids = np.array([p["id"] for p in h])
        ref = xn[ids] @ qn[qi]
        got = np.array([p["score"] for p in h])
        check(np.all(np.isfinite(got)), "non-finite score")
        worst = max(worst, float(np.abs(got - ref).max() / np.abs(ref).max()))
    return worst


def _serve_tier(base, toc, fs, name, quant, kind, x, q, truth, xn, threads,
                n_codes_only, profile_dir):
    """One quantized-primary collection (`on_disk` rows, `quant` codes):
    create, bulk-ingest, seal, check what lives on the card, search through
    REST → dict of numbers. `kind` is "sq" or "tq"."""
    import gc

    import torch

    n, d = x.shape
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _call(base, "PUT", f"/collections/{name}",
          {"vectors": {"size": d, "distance": "Cosine", "on_disk": True,
                       "quantization_config": quant}})
    coll = toc.get_collection(name)
    t0 = time.perf_counter()
    coll.bulk_ingest(list(range(n)), {"": x})
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    toc.optimize_all()
    optimize_s = time.perf_counter() - t0
    sealed = [s for s in coll.shards[0].segments if not s.appendable and len(s) == n]
    check(bool(sealed) and "" in sealed[0].quantized,
          f"the optimizer did not seal {kind} codes: "
          f"{[(len(s), s.appendable, list(s.quantized)) for s in coll.shards[0].segments]}")
    store, codes = sealed[0].dense[""], sealed[0].quantized[""]
    check(store.on_disk and isinstance(store._data, np.memmap),
          "the tier's f32 rows are not in a disk memmap")
    memmap_path = os.path.abspath(store._data.filename)
    check(memmap_path.startswith(os.path.abspath(ROOT) + os.sep),
          f"the tier's memmap lies outside the checkout: {memmap_path}")
    dev_codes = codes._scan_dev[0] if kind == "sq" else codes._flat_dev[0]
    check(dev_codes is not None and dev_codes.is_cuda, "the seal left no codes on the card")
    codes_bytes = dev_codes.numel() * dev_codes.element_size()

    def no_f32_block():
        check(store._dev is None and store._scan is None,
              "the tier uploaded the f32 block or a bf16 scan block")
        check(codes._dev is None and getattr(codes, "_kernel_dev", None) is None,
              "the tier uploaded a second copy of the codes")

    no_f32_block()
    t0 = time.perf_counter()
    _concurrent_search(base, name, q[:1], 1, {"limit": 10})  # warm-up
    first_search_s = time.perf_counter() - t0
    fs.fused_scan_survivors.launches = fs.fused_scan_survivors.launches_int8 = 0
    hits, wall = _concurrent_search(base, name, q, threads, {"limit": 10})
    check(all(len(h) == 10 for h in hits), f"a {kind} tier search returned fewer than 10 hits")
    recall = _recall(hits, truth, 10)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    worst = _cosine_score_err(hits, xn, qn)
    check(worst <= 1e-4, f"{kind} tier: returned cosines off by {worst} (relative)")
    check(recall >= 0.99, f"{kind} tier recall@10 {recall} < 0.99")
    codes_body = {"limit": 10, "params": {"quantization": {"rescore": False}}}
    c_hits, c_wall = _concurrent_search(base, name, q[:n_codes_only], threads, codes_body)
    check(all(len(h) == 10 and all(0 <= p["id"] < n for p in h) for h in c_hits),
          f"a {kind} codes-only search returned an invalid id or fewer than 10 hits")
    codes_only = {"requests": n_codes_only, "wall_s": c_wall, "qps": n_codes_only / c_wall,
                  "recall_at_10_vs_exact": _recall(c_hits, truth[:n_codes_only], 10)}
    if kind == "sq":
        c_truth = _exact_codes_topk(xn, qn[:n_codes_only], 10)
        codes_only["recall_at_10_vs_codes"] = _recall(c_hits, c_truth, 10)
        check(codes_only["recall_at_10_vs_codes"] >= 0.95,
              f"tier codes-only recall@10 {codes_only['recall_at_10_vs_codes']} < 0.95 "
              "(vs the codes)")
    check(fs.fused_scan_survivors.launches_int8 == 0 and fs.fused_scan_survivors.launches == 0,
          "a tier search launched the fused scan kernel (this tier is the torch scan)")
    no_f32_block()
    peak = torch.cuda.max_memory_allocated()
    trace = _traced_window(
        lambda: _concurrent_search(base, name, q, threads, {"limit": 10}),
        profile_dir, f"tier_{kind}")
    return {
        "points": n, "dim": d, "quantization": quant, "on_disk": True,
        "ingest_s": ingest_s, "optimize_s": optimize_s, "first_search_s": first_search_s,
        "codes_on_card_bytes": codes_bytes, "memmap_bytes": int(store._data.nbytes),
        "memory_allocated_before_bytes": before, "max_memory_allocated_bytes": peak,
        "requests": len(q), "threads": threads, "wall_s": wall, "qps": len(q) / wall,
        "recall_at_10": recall, "score_rel_err": worst, "codes_only": codes_only, **trace,
    }


def run_tier(rng, storage, fs, n=TIER_ROWS, n_tq=262_144, d=1536, n_queries=64,
             threads=8, n_codes_only=16, profile_dir=None):
    """The tier phase: int8 codes on the card over on-disk f32 rows at n x
    1536, then 4-bit TurboQuant codes as the primary store of the first
    n_tq rows, both through REST."""
    from qdrant_tpu_torch.api.rest import RestServer
    from qdrant_tpu_torch.api.toc import TableOfContent

    toc = TableOfContent(storage)
    srv = RestServer(toc, host="127.0.0.1", port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        x = rng.standard_normal((n, d), dtype=np.float32)
        q = rng.standard_normal((n_queries, d), dtype=np.float32)
        truth, xn = _exact_cosine(x, q, 10)
        sq = _serve_tier(
            base, toc, fs, "tier_sq",
            {"scalar": {"type": "int8", "quantile": 0.99, "always_ram": True}}, "sq",
            x, q, truth, xn, threads, n_codes_only, profile_dir)
        check(sq["max_memory_allocated_bytes"] < TIER_PEAK_BYTES * n / TIER_ROWS,
              f"tier peak device memory {sq['max_memory_allocated_bytes']} is over "
              f"{TIER_PEAK_BYTES * n / TIER_ROWS:.3g} B: more than the codes went to the card")
        toc.delete_collection("tier_sq")
        n_tq = min(n_tq, n)
        truth_tq, _ = _exact_cosine(x[:n_tq], q, 10)
        tq = _serve_tier(
            base, toc, fs, "tier_tq", {"turbo": {"bits": "bits4"}}, "tq",
            x[:n_tq], q, truth_tq, xn[:n_tq], threads, n_codes_only, profile_dir)
        return {"sq": sq, "tq": tq}
    finally:
        srv.shutdown()
        toc.close()


def _sparse_corpus(rng, n, vocab, avg_nnz=64):
    """SPLADE-like rows: term frequency ~ rank^-0.9, Poisson(avg_nnz) terms
    (min 4) drawn by inverse CDF, duplicate terms of a row dropped, weights
    |N(1, 0.6)| + 0.05 → (indptr [n+1], terms, weights, cdf), rows sorted by
    term."""
    term_p = 1.0 / (np.arange(1, vocab + 1) ** 0.9)
    term_p /= term_p.sum()
    cdf = np.cumsum(term_p)
    lens = np.maximum(rng.poisson(avg_nnz, size=n), 4)
    total = int(lens.sum())
    terms = np.searchsorted(cdf, rng.random(total)).astype(np.int64)
    weights = np.abs(rng.normal(1.0, 0.6, size=total)).astype(np.float32) + 0.05
    row = np.repeat(np.arange(n, dtype=np.int64), lens)
    key = np.unique(row * vocab + terms, return_index=True)
    row, terms, weights = key[0] // vocab, key[0] % vocab, weights[key[1]]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(row, minlength=n))])
    return indptr, terms, weights, cdf


def _rrf_truth(rankings, k, rrf_k=60):
    """Reciprocal rank fusion of per-source id rankings (best first) → the
    top-k ids, as Qdrant defines it: sum of 1 / (rrf_k + rank), rank from 1."""
    scores = {}
    for ids in rankings:
        for rank, pid in enumerate(ids.tolist()):
            scores[pid] = scores.get(pid, 0.0) + 1.0 / (rrf_k + rank + 1)
    return np.array(sorted(scores, key=lambda p: -scores[p])[:k])


def run_sparse(rng, storage, fs, n=1_000_000, d=128, vocab=30_000, n_queries=64,
               threads=8, n_filtered=16, profile_dir=None):
    """The sparse phase: sparse search, filtered sparse search and dense +
    sparse RRF queries through REST over one sealed collection."""
    import gc

    import scipy.sparse as sp
    import torch

    from qdrant_tpu_torch.api.rest import RestServer
    from qdrant_tpu_torch.api.toc import TableOfContent

    toc = TableOfContent(storage)
    srv = RestServer(toc, host="127.0.0.1", port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        # sealed once, by the upsert that brings the segment to n points
        _call(base, "PUT", "/collections/splade",
              {"vectors": {"size": d, "distance": "Euclid"},
               "sparse_vectors": {"text": {}},
               "optimizers_config": {"indexing_threshold": n}})
        _call(base, "PUT", "/collections/splade/index",
              {"field_name": "group", "field_schema": "keyword"})
        indptr, terms, weights, cdf = _sparse_corpus(rng, n, vocab)
        x = rng.standard_normal((n, d), dtype=np.float32)
        member = rng.random(n) < 0.10
        coll = toc.get_collection("splade")
        t0 = time.perf_counter()
        for lo in range(0, n, 8192):
            coll.upsert([
                {"id": i,
                 "vector": {"": x[i].tolist(),
                            "text": {"indices": terms[indptr[i]:indptr[i + 1]].tolist(),
                                     "values": weights[indptr[i]:indptr[i + 1]].tolist()}},
                 # the other nine tenths carry no group: one payload-block
                 # subgraph at the seal, not two
                 "payload": {"group": "a"} if member[i] else {}}
                for i in range(lo, min(lo + 8192, n))])
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toc.optimize_all()
        optimize_s = time.perf_counter() - t0
        sealed = [s for s in coll.shards[0].segments if not s.appendable and len(s) == n]
        check(bool(sealed), "the optimizer did not seal the sparse collection: "
              f"{[(len(s), s.appendable) for s in coll.shards[0].segments]}")
        index = sealed[0].sparse_index["text"]
        t0 = time.perf_counter()
        check(index._hybrid_ready(), "the sparse index is not on its hybrid path")
        index_build_s = time.perf_counter() - t0
        hot = index._hot[0]
        jc = index._fwd_cold.shape[1] // 2
        hot_cols = np.full(vocab, -1, dtype=np.int64)  # by term; the index
        hot_cols[index._csr_host[2]] = index._hot[1]  # keeps them by term rank
        cold_per_row = np.bincount(
            np.repeat(np.arange(n), np.diff(indptr))[hot_cols[terms] < 0], minlength=n)
        rows_cut_at_jc = np.flatnonzero(cold_per_row > jc)

        q_lens = np.maximum(rng.poisson(48, size=n_queries), 4)
        queries = []
        for ln in q_lens:
            t_u = np.unique(np.searchsorted(cdf, rng.random(ln)))
            w = np.abs(rng.normal(1.0, 0.6, size=len(t_u))).astype(np.float32)
            queries.append({"indices": t_u.tolist(), "values": w.tolist()})
        # exact sparse truth: one scipy CSR product, independent of the port
        x_csr = sp.csr_matrix((weights, terms, indptr), shape=(n, vocab))
        q_mat = np.zeros((n_queries, vocab), np.float32)
        for i, qv in enumerate(queries):
            q_mat[i, qv["indices"]] = qv["values"]
        s_all = np.asarray((x_csr @ q_mat.T).T)  # [nq, n]
        part = np.argpartition(-s_all, 30, axis=1)[:, :30]
        rows = np.arange(n_queries)[:, None]
        truth30 = part[rows, np.argsort(-s_all[rows, part], axis=1)]

        path = "/collections/splade/points/query"
        bodies = [{"query": qv, "using": "text", "limit": 10} for qv in queries]
        _concurrent_post(base, path, bodies[:1], 1)  # warm-up
        res, wall = _concurrent_post(base, path, bodies, threads)
        hits = [r["points"] for r in res]
        check(all(len(h) == 10 for h in hits), "a sparse query returned fewer than 10 hits")
        recall = _recall(hits, truth30, 10)
        cut = set(rows_cut_at_jc.tolist())

        def product_cut_at_jc(qi, pid):
            """The product a row cut at Jc can reach: its hot terms and its
            Jc heaviest cold terms (the forward rows keep those)."""
            t = terms[indptr[pid]:indptr[pid + 1]]
            w = weights[indptr[pid]:indptr[pid + 1]]
            cold = np.flatnonzero(hot_cols[t] < 0)
            keep = np.ones(len(t), bool)
            keep[cold[np.argsort(-np.abs(w[cold]), kind="stable")[jc:]]] = False
            return float(np.dot(w[keep].astype(np.float64), q_mat[qi, t[keep]]))

        worst, short, cut_returned = 0.0, 0, 0
        for qi, h in enumerate(hits):
            for p in h:
                ref = float(s_all[qi, p["id"]])
                cut_returned += p["id"] in cut
                if p["id"] in cut:  # may score short of the product, by the
                    ref_cut = product_cut_at_jc(qi, p["id"])  # dropped terms only
                    short += int(abs(ref_cut - ref) > 1e-4 * abs(ref))
                    ref = ref_cut
                worst = max(worst, abs(p["score"] - ref) / abs(ref))
        check(worst <= 1e-4, f"sparse scores off by {worst} (relative)")
        check(recall >= 0.95, f"sparse recall@10 {recall} < 0.95")
        sparse_peak = torch.cuda.max_memory_allocated()
        sparse_trace = _traced_window(
            lambda: _concurrent_post(base, path, bodies, threads), profile_dir, "sparse")

        flt = {"must": [{"key": "group", "match": {"value": "a"}}]}
        f_res, _ = _concurrent_post(
            base, path,
            [{**b, "filter": flt, "with_payload": True} for b in bodies[:n_filtered]], threads)
        f_hits = [r["points"] for r in f_res]
        check(all(h and all(p["payload"]["group"] == "a" for p in h) for h in f_hits),
              "a filtered sparse hit does not match the filter")
        sub = np.nonzero(member)[0]
        f_truth = sub[np.argsort(-s_all[:n_filtered, sub], axis=1)[:, :10]]
        f_recall = _recall(f_hits, f_truth, 10)

        # dense + sparse RRF: prefetch 30 of each, fuse, keep 10
        dq = rng.standard_normal((n_queries, d), dtype=np.float32)
        dense30 = _exact_topk(x, dq, 30, "euclid")
        rrf_truth = [_rrf_truth([dense30[i], truth30[i]], 10) for i in range(n_queries)]
        rrf_bodies = [
            {"prefetch": [{"query": dq[i].tolist(), "limit": 30},
                          {"query": queries[i], "using": "text", "limit": 30}],
             "query": {"fusion": "rrf"}, "limit": 10}
            for i in range(n_queries)]
        _concurrent_post(base, path, rrf_bodies[:1], 1)  # warm-up (uploads the scan block)
        torch.cuda.reset_peak_memory_stats()
        fs.fused_scan_survivors.launches = fs.merge_survivors.launches = 0
        r_res, r_wall = _concurrent_post(base, path, rrf_bodies, threads)
        launches = fs.fused_scan_survivors.launches
        merges = fs.merge_survivors.launches
        check(launches > 0, "the RRF dense prefetch never launched the bf16 scan kernel")
        r_hits = [r["points"] for r in r_res]
        check(all(len(h) == 10 for h in r_hits), "an RRF query returned fewer than 10 hits")
        rrf_recall = _recall(r_hits, rrf_truth, 10)
        rrf_peak = torch.cuda.max_memory_allocated()
        rrf_trace = _traced_window(
            lambda: _concurrent_post(base, path, rrf_bodies, threads), profile_dir, "rrf")
        return {
            "points": n, "dense_dim": d, "vocab": vocab, "postings": int(indptr[-1]),
            "load_s": load_s, "load_points_per_s": n / load_s, "optimize_s": optimize_s,
            "index_build_s": index_build_s, "hot_shape": list(hot.shape),
            "hot_bytes": hot.numel() * 4, "jc": jc, "rows_cut_at_jc": int(len(rows_cut_at_jc)),
            "sparse": {"requests": n_queries, "threads": threads, "wall_s": wall,
                       "qps": n_queries / wall, "recall_at_10": recall,
                       "score_rel_err": worst, "returned_rows_cut_at_jc": cut_returned,
                       "scores_short_at_jc": short,
                       "max_memory_allocated_bytes": sparse_peak, **sparse_trace},
            "filtered": {"requests": n_filtered, "matching": int(member.sum()),
                         "recall_at_10": f_recall},
            "rrf": {"requests": n_queries, "threads": threads, "wall_s": r_wall,
                    "qps": n_queries / r_wall, "recall_at_10_vs_exact_rrf": rrf_recall,
                    "kernel_launches": launches, "merge_launches": merges,
                    "max_memory_allocated_bytes": rrf_peak, **rrf_trace},
        }
    finally:
        srv.shutdown()
        toc.close()


def _exact_cosine(x, q, k, chunk=131072):
    """Numpy cosine brute force, independent of the port, in row chunks →
    (ids [B, k] best first, the unit-normalised rows)."""
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    xn = np.empty_like(x)
    scores = np.empty((len(q), len(x)), dtype=np.float32)
    for i in range(0, len(x), chunk):
        part = x[i : i + chunk]
        xn[i : i + chunk] = part / np.linalg.norm(part, axis=1, keepdims=True)
        scores[:, i : i + chunk] = qn @ xn[i : i + chunk].T
    top = np.argpartition(-scores, k, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(scores, top, axis=1), axis=1)
    return np.take_along_axis(top, order, axis=1), xn


def _exact_codes_topk(xn, qn, k, chunk=131072):
    """Numpy brute force over int8 codes encoded here as Qdrant's scalar
    quantization defines them (scale = 0.99 quantile of |x| over a 1M-value
    sample / 127; codes = round(x / scale) clipped to ±127), ranked by the
    exact integer dot → ids [B, k] best first."""
    flat = xn.reshape(-1)
    if flat.size > 1_000_000:
        flat = flat[np.random.default_rng(0).integers(0, flat.size, 1_000_000)]
    scale = max(float(np.quantile(np.abs(flat), 0.99)), 1e-12) / 127.0
    qc = np.clip(np.round(qn / scale), -127, 127).astype(np.float64)
    scores = np.empty((len(qn), len(xn)), dtype=np.float64)
    for i in range(0, len(xn), chunk):
        codes = np.clip(np.round(xn[i : i + chunk] / scale), -127, 127)
        scores[:, i : i + chunk] = qc @ codes.astype(np.float64).T
    top = np.argpartition(-scores, k, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(scores, top, axis=1), axis=1, kind="stable")
    return np.take_along_axis(top, order, axis=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--sparse-rows", type=int, default=262_144,
                    help="points of the sparse phase (its shape has 1,000,000, "
                    "cut for the script's time; not under 262,144)")
    ap.add_argument("--graph-rows", type=int, default=1_000_000,
                    help="points of the rest and graph phases' collection (fewer, "
                    "not under 100,000, only to find faults quickly)")
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one extra REST window with torch.profiler into DIR")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES) - set(EXTRA_PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from qdrant_tpu_torch.ops import fused_scan as fs
    except ImportError as exc:
        print(f"chip_smoke: the qdrant_tpu_torch package is missing ({exc}); "
              "run from the repository root", file=sys.stderr)
        return 2
    # The port needs true f32 products (plain versions, the sparse hot
    # product, the TQ scan): TF32 must be off, as torch leaves it by default.
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 matmuls are on: the port's f32 scores need them off")
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t_start = time.perf_counter()

    def lap(phase):
        print(f"elapsed after {phase}: {time.perf_counter() - t_start:.1f} s", flush=True)

    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    rows = {
        mode: {
            "name": name, "route": "cuda",
            "source": "qdrant_tpu_torch/csrc/fused_scan.cu",
            "replaces": f"qdrant_tpu/ops/pallas_scan.py:{line}",
            # no single PyTorch call computes the survivors, nor the ordered
            # merge (a max over chunks and a gather of its ids are two)
            "library_ms": None, "launches": 0,
        }
        for mode, name, line in (
            ("bf16", "fused_scan_survivors_bf16", 53),
            ("int8", "fused_scan_survivors_int8", 74),
            # the slot-ring strict-'>' merge the TPU kernel carries across
            # its sequential grid, here across the split walk's chunks
            ("merge", "merge_survivors", 103),
        )
    }
    # `ms` is the call launched from Python (the yardstick of earlier runs);
    # `graph_ms` the same in a replayed CUDA graph, `scan_ms` the scan alone
    row_keys = ("ms", "graph_ms", "scan_ms", "plain_ms", "bound_ms", "bound_by",
                "chunks", "ctas")
    # the kernel phase's comparison at each main-path phase's launch shape,
    # and the launches each of those phases made: {phase: ...}
    at_launch, launched = {}, {}

    if "build" in phases or "kernel" in phases or "sweep" in phases:
        t0 = time.perf_counter()
        so, log = fs.build_library(verbose=True)
        fs._lib()
        print(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(so, ROOT)} ({card})")
        for line in log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                print(f"build: ptxas {line.strip()}")
    if "kernel" in phases:
        # the shapes the main-path phases launch: batches of a few requests
        # padded to 8 rows (the grid is blk 4096 x 16 slots for every limit up
        # to 2,048). filtered: D=100 padded to 128, 10% of rows live. rrf: the
        # dense prefetch (limit 30) over the sparse phase's points.
        rest_kw = dict(b=8, n=args.graph_rows, d=128, euclid=True, deleted_frac=0.0)
        rrf_kw = dict(rest_kw, n=args.sparse_rows)
        max_err = 0.0
        for name, phase, kw in (
            ("euclid_1m_128", None,
             dict(b=256, n=1_000_000, d=128, euclid=True, deleted_frac=0.1)),
            ("dot_100k_1536", None,
             dict(b=256, n=100_000, d=1536, euclid=False, deleted_frac=0.0)),
            ("rest_euclid_1m_128_b8", "rest", rest_kw),
            ("filtered_cosine_100k_100_b8", "filtered",
             dict(b=8, n=100_000, d=100, d_pad=128, euclid=False, deleted_frac=0.9)),
            ("rrf_dense_prefetch_b8", "rrf", rrf_kw),
            # rows too wide for a resident query tile: the queries stream
            ("wide_dot_65k_12288_b8", None,
             dict(b=8, n=65_536, d=12_288, euclid=False, deleted_frac=0.1)),
        ):
            if phase == "rrf" and kw == rest_kw:  # one launch shape, compared once
                at_launch["rrf"] = at_launch["rest"]
                print(f"kernel {name}: the launch of rest_euclid_1m_128_b8", flush=True)
                continue
            res = compare_kernel(rng, **kw)
            print(f"kernel {name}: {json.dumps(res)} ({card})", flush=True)
            max_err = max(max_err, res["max_abs_err"])
            if phase:
                at_launch[phase] = res
        res = at_launch["rest"]  # the row's own numbers: the sift1m launch
        rows["bf16"].update({k: res[k] for k in row_keys}, shape=res["shape"])
        rows["merge"].update({k: res["merge"][k] for k in (
            "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
            shape=res["shape"], chunks=res["chunks"])
        rows["bf16"]["max_abs_err"] = max_err
        max_err = 0.0
        for name, phase, kw in (
            # the sq phase's launch: a few requests padded to 8 rows
            ("sq_cosine_main_path_b8", "sq",
             dict(b=8, n=SQ_ROWS, d=1536, euclid=False, deleted_frac=0.0)),
            # the benchmark's full row count
            ("sq_cosine_1m_1536_b8", None,
             dict(b=8, n=1_000_000, d=1536, euclid=False, deleted_frac=0.1)),
            ("sq_cosine_1m_1536_b256", None,
             dict(b=256, n=1_000_000, d=1536, euclid=False, deleted_frac=0.1)),
            ("sq_euclid_1m_128_b8", None,
             dict(b=8, n=1_000_000, d=128, euclid=True, deleted_frac=0.1)),
            # rows too wide for a resident query tile: the queries stream
            ("sq_wide_65k_24576_b8", None,
             dict(b=8, n=65_536, d=24_576, euclid=False, deleted_frac=0.1)),
        ):
            res = compare_kernel_int8(gen, **kw)
            print(f"kernel {name}: {json.dumps(res)} ({card})", flush=True)
            max_err = max(max_err, res["max_abs_err"])
            if phase:
                at_launch[phase] = res
                rows["int8"].update({k: res[k] for k in row_keys}, shape=res["shape"])
            torch.cuda.empty_cache()
        rows["int8"]["max_abs_err"] = max_err
    lap("kernel")
    if "sweep" in phases:
        sweep(gen, fs, card)
    storage_root = os.path.join(ROOT, "build")
    os.makedirs(storage_root, exist_ok=True)
    # on-disk vector stores put their memmaps under the temp directory: keep
    # them inside the checkout's ignored build/ directory
    tempfile.tempdir = storage_root
    free_gb = shutil.disk_usage(storage_root).free / 1e9
    print(f"storage: {storage_root} ({free_gb:.1f} GB free)", flush=True)
    if "rest" in phases or "graph" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_rest_", dir=storage_root)
        try:
            both = run_rest(rng, storage, fs, phases, n=args.graph_rows,
                            profile_dir=args.profile)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        if "rest" in both:
            res = both["rest"]
            print(f"rest sift1m: {json.dumps(res)} ({card})", flush=True)
            launched["rest"] = ("bf16", res["kernel_launches"], res["merge_launches"])
        if "graph" in both:
            print(f"graph sift1m: {json.dumps(both['graph'])} ({card})", flush=True)
        lap("rest+graph")
    if "graph" in phases:
        res = run_graph_vs_cpu(rng)
        print(f"graph cuda vs cpu: {json.dumps(res)} ({card})", flush=True)
        lap("graph vs cpu")
    if "filtered" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_filtered_", dir=storage_root)
        try:
            res = run_filtered(rng, storage, fs)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        print(f"filtered glove100: {json.dumps(res)} ({card})", flush=True)
        lap("filtered")
        launched["filtered"] = ("bf16", res["kernel_launches"], res["merge_launches"])
    if "sq" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_sq_", dir=storage_root)
        try:
            res = run_sq(rng, storage, fs, profile_dir=args.profile,
                         graph="graph" in phases)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        print(f"sq dbpedia: {json.dumps(res)} ({card})", flush=True)
        lap("sq")
        codes_only = res["codes_only"]
        launched["sq"] = ("int8",
                          res["int8_kernel_launches"] + codes_only["int8_kernel_launches"],
                          res["merge_launches"] + codes_only["merge_launches"])
    if "tier" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_tier_", dir=storage_root)
        tempfile.tempdir = storage  # the tier's memmaps go with its storage
        try:
            res = run_tier(rng, storage, fs, profile_dir=args.profile)
        finally:
            tempfile.tempdir = storage_root
            shutil.rmtree(storage, ignore_errors=True)
        print(f"tier sq: {json.dumps(res['sq'])} ({card})", flush=True)
        print(f"tier tq: {json.dumps(res['tq'])} ({card})", flush=True)
        lap("tier")
    if "sparse" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_sparse_", dir=storage_root)
        try:
            res = run_sparse(rng, storage, fs, n=args.sparse_rows, profile_dir=args.profile)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        print(f"sparse splade: {json.dumps(res)} ({card})", flush=True)
        lap("sparse")
        launched["rrf"] = ("bf16", res["rrf"]["kernel_launches"], res["rrf"]["merge_launches"])
    check(not torch.backends.cuda.matmul.allow_tf32, "a phase turned TF32 matmuls on")
    check("jax" not in sys.modules, "the port imported jax")
    reference = sorted(m for m in sys.modules if m.split(".")[0] == "qdrant_tpu")
    check(not reference, f"the port imported the JAX package: {reference}")
    # each row's `launches` is the sum over the main-path phases; `by_phase`
    # keeps every phase's own count beside the kernel's numbers at the shape
    # that phase launches, so no launch is booked under another shape's time
    for phase, (mode, n_scan, n_merge) in launched.items():
        res = at_launch.get(phase, {})
        for key, count, src in ((mode, n_scan, res), ("merge", n_merge, res.get("merge", {}))):
            rows[key]["launches"] += count
            rows[key].setdefault("by_phase", {})[phase] = {
                "launches": count, "shape": res.get("shape"),
                **{k: src[k] for k in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                                       "max_abs_err") if k in src}}
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
