#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (qdrant_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--phases build,kernel,rest,filtered,sq,tier,sparse]
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
             euclid points made from --seed, bulk-ingested and sealed by the
             optimizer, 64 searches from 8 threads (coalesced by the
             micro-batcher); recall@10 >= 0.99 against a numpy brute force
             that shares no code with the port, and the bf16 scan and the
             merge kernels' launch counts must rise.
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
             "Quantized vectors in RAM, original on disk"): 1,000,000 x 1536
             cosine with `on_disk: true` and the sq phase's scalar config.
             The sealed segment must hold int8 codes on the card and no f32
             block (peak `torch.cuda.max_memory_allocated` under 3 GB, the
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
             vector, 1,000,000 points (--sparse-rows for a shorter run),
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
ALL_PHASES = ("build", "kernel", "rest", "filtered", "sq", "tier", "sparse")
EXTRA_PHASES = ("sweep",)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks
# rows of the sq phase: its benchmark has 1,000,000, which the phase served
# until the tier and sparse phases came; a quarter keeps the script's time
SQ_ROWS = 262_144


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
    return sum(r[1] for r in rows), wall_ms, rows[:8]


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


def run_rest(rng, storage, fs, n=1_000_000, d=128, n_queries=64, threads=8,
             profile_dir=None):
    from qdrant_tpu_torch.api.rest import RestServer
    from qdrant_tpu_torch.api.toc import TableOfContent

    toc = TableOfContent(storage)
    srv = RestServer(toc, host="127.0.0.1", port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        _call(base, "PUT", "/collections/sift1m",
              {"vectors": {"size": d, "distance": "Euclid"}})
        x = rng.standard_normal((n, d), dtype=np.float32)
        coll = toc.get_collection("sift1m")
        t0 = time.perf_counter()
        coll.bulk_ingest(list(range(n)), {"": x})
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toc.optimize_all()
        optimize_s = time.perf_counter() - t0
        segs = [(len(s), s.appendable) for s in coll.shards[0].segments]
        check(any(c == n and not a for c, a in segs), f"optimizer did not seal: {segs}")
        q = rng.standard_normal((n_queries, d), dtype=np.float32)
        _concurrent_search(base, "sift1m", q[:1], 1, {"limit": 10})  # warm-up
        fs.fused_scan_survivors.launches = fs.merge_survivors.launches = 0
        hits, wall = _concurrent_search(base, "sift1m", q, threads, {"limit": 10})
        launches = fs.fused_scan_survivors.launches
        merges = fs.merge_survivors.launches
        check(launches > 0, "the REST search never launched the fused scan kernel")
        check(merges > 0, "the REST search never launched the merge kernel")
        truth = _exact_topk(x, q, 10, "euclid")
        recall = _recall(hits, truth, 10)
        check(all(len(h) == 10 for h in hits), "a search returned fewer than 10 hits")
        # returned scores are euclid distances of the returned ids
        worst = 0.0
        for qi, h in enumerate(hits):
            ids = np.array([p["id"] for p in h])
            ref = np.sqrt(((x[ids] - q[qi]) ** 2).sum(1))
            got = np.array([p["score"] for p in h])
            check(np.all(np.isfinite(got)), "non-finite score")
            worst = max(worst, float(np.abs(got - ref).max() / ref.max()))
        check(worst <= 1e-4, f"returned distances off by {worst} (relative)")
        check(recall >= 0.99, f"recall@10 {recall} < 0.99")
        prof = {}
        if profile_dir:  # the same window again, traced (not in the QPS above)
            busy, traced_ms, top = _profile_window(
                lambda: _concurrent_search(base, "sift1m", q, threads, {"limit": 10}),
                profile_dir, "rest")
            prof = {"traced_wall_ms": traced_ms, "device_busy_ms": busy,
                    "device_idle_share": 1 - busy / traced_ms,
                    "top_device_ops_ms": [[k, t, c] for k, t, c in top],
                    "host_breakdown": _host_breakdown(base, coll, q)}
        return {
            "points": n, "dim": d, "ingest_s": ingest_s, "optimize_s": optimize_s,
            "requests": n_queries, "threads": threads, "wall_s": wall,
            "qps": n_queries / wall, "recall_at_10": recall,
            "score_rel_err": worst, "kernel_launches": launches,
            "merge_launches": merges, **prof,
        }
    finally:
        srv.shutdown()
        toc.close()


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
           n_codes_only=16, profile_dir=None):
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
        prof = {}
        if profile_dir:  # the same window again, traced (not in the QPS above)
            busy, traced_ms, top = _profile_window(
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
        }
    finally:
        srv.shutdown()
        toc.close()


def _traced_window(fn, profile_dir, name):
    """The window `fn` once more under torch.profiler → its device busy
    time, idle share and top device ops. A profiler failure, or a window in
    which nothing ran on the device, fails the phase."""
    busy, traced_ms, top = _profile_window(fn, profile_dir, name)
    check(busy > 0 and top, f"the traced {name} window shows no device time")
    return {"traced_wall_ms": traced_ms, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / traced_ms,
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


def run_tier(rng, storage, fs, n=1_000_000, n_tq=262_144, d=1536, n_queries=64,
             threads=8, n_codes_only=16, profile_dir=None):
    """The tier phase: int8 codes on the card over on-disk f32 rows at 1M x
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
        check(sq["max_memory_allocated_bytes"] < 3e9,
              f"tier peak device memory {sq['max_memory_allocated_bytes']} >= 3 GB: "
              "more than the codes went to the card")
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
                 "payload": {"group": "a" if member[i] else "b"}}
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
    ap.add_argument("--sparse-rows", type=int, default=1_000_000,
                    help="points of the sparse phase (its shape has 1,000,000; "
                    "fewer, not under 262,144, for a short run)")
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
        rest_kw = dict(b=8, n=1_000_000, d=128, euclid=True, deleted_frac=0.0)
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
    if "rest" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_rest_", dir=storage_root)
        try:
            res = run_rest(rng, storage, fs, profile_dir=args.profile)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        print(f"rest sift1m: {json.dumps(res)} ({card})", flush=True)
        lap("rest")
        launched["rest"] = ("bf16", res["kernel_launches"], res["merge_launches"])
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
            res = run_sq(rng, storage, fs, profile_dir=args.profile)
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
