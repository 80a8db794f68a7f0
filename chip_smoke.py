#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (qdrant_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--phases build,kernel,rest,filtered]

Phases, each printing its numbers on its own line:

1. build     compile csrc/fused_scan.cu with nvcc into build/kernels/.
2. kernel    the fused scan kernel against its plain PyTorch version on the
             same inputs: euclid at 256 queries x 1,000,000 x 128 (10% of
             rows deleted), dot at 256 x 100,000 x 1536, and the shapes
             the REST phases launch: 8 x 1,000,000 x 128 euclid and
             8 x 100,000 x 100 (padded to 128) cosine with 10% of rows
             live. Survivor scores must agree within a worst-case f32
             summation-order bound and ids must be equal wherever the class
             winner beats the runner-up by more than that bound. Times from
             CUDA events.
3. rest      the port's REST server over a TableOfContent: 1,000,000 x 128
             euclid points made from --seed, bulk-ingested and sealed by the
             optimizer, 64 searches from 8 threads (coalesced by the
             micro-batcher); recall@10 >= 0.99 against a numpy brute force
             that shares no code with the port, and the kernel's launch
             count must rise.
4. filtered  100,000 x 100 cosine points with a keyword payload index
             matching 10% of them and `filter.must match` searches: every
             hit matches and recall@10 >= 0.99 against exact (a correctness
             check; it reports no throughput).

--profile DIR traces the rest phase's search window a second time with
torch.profiler (device activity only; device busy and idle share from that
one window, trace in DIR) and times the host steps under one search.

Before the last line it prints the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Any failed check raises (including jax
having been imported), so the script exits non-zero and prints no result;
it refuses to run without CUDA.
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
ALL_PHASES = ("build", "kernel", "rest", "filtered")


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

    fs.fused_scan_survivors.launches = 0
    s_k, i_k = fs.fused_scan_survivors(q_bf, v_bf, bias, blk, slots)
    s_p, i_p = fs.fused_scan_survivors_plain(q_bf, v_bf, bias, blk, slots)
    torch.cuda.synchronize()
    check(fs.fused_scan_survivors.launches == 1, "kernel launch not counted")

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
    ms = _time_ms(lambda: fs.fused_scan_survivors(q_bf, v_bf, bias, blk, slots), 20)
    plain_ms = _time_ms(
        lambda: fs.fused_scan_survivors_plain(q_bf, v_bf, bias, blk, slots), 5
    )
    fs.fused_scan_survivors.launches = 0
    flop = 2.0 * b * n_pad * d_pad
    return {
        "shape": f"B={b} N={n} (padded {n_pad}) D={d} (padded {d_pad}) blk={blk} "
        f"slots={slots} {'euclid' if euclid else 'dot'} masked={deleted_frac}",
        "max_abs_err": max_err, "tol": tol, "ids_differing": n_diff,
        "ms": ms, "plain_ms": plain_ms,
        "kernel_tflops": flop / ms / 1e9, "plain_tflops": flop / plain_ms / 1e9,
    }


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
    results = [None] * len(queries)
    errors = []

    def worker(idx):
        try:
            for i in idx:
                results[i] = _call(
                    base, "POST", f"/collections/{coll}/points/search",
                    {"vector": queries[i].tolist(), **body_extra},
                )
        except Exception as exc:  # re-raised on the main thread below
            errors.append(exc)

    parts = [list(range(t, len(queries), threads)) for t in range(threads)]
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


def _profile_window(fn, out_dir):
    """Run fn under torch.profiler, tracing device activity only (no host
    op spans, which would stretch the window) → (device-busy ms, wall ms of
    the same window, top kernels); the chrome trace goes to out_dir."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "rest_window_trace.json"))
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
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
        fs.fused_scan_survivors.launches = 0
        hits, wall = _concurrent_search(base, "sift1m", q, threads, {"limit": 10})
        launches = fs.fused_scan_survivors.launches
        check(launches > 0, "the REST search never launched the fused scan kernel")
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
                profile_dir)
            prof = {"traced_wall_ms": traced_ms, "device_busy_ms": busy,
                    "device_idle_share": 1 - busy / traced_ms,
                    "top_device_ops_ms": [[k, t, c] for k, t, c in top],
                    "host_breakdown": _host_breakdown(base, coll, q)}
        return {
            "points": n, "dim": d, "ingest_s": ingest_s, "optimize_s": optimize_s,
            "requests": n_queries, "threads": threads, "wall_s": wall,
            "qps": n_queries / wall, "recall_at_10": recall,
            "score_rel_err": worst, "kernel_launches": launches, **prof,
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
        fs.fused_scan_survivors.launches = 0
        hits, _ = _concurrent_search(
            base, "glove100", q, threads,
            {"limit": 10, "filter": flt, "with_payload": True},
        )
        launches = fs.fused_scan_survivors.launches
        check(launches > 0, "the filtered search never launched the fused scan kernel")
        check(all(p["payload"]["group"] == "a" for h in hits for p in h),
              "a hit does not match the filter")
        sub = np.nonzero(member)[0]
        truth = sub[_exact_topk(x[sub], q, 10, "cosine")]
        recall = _recall(hits, truth, 10)
        check(recall >= 0.99, f"filtered recall@10 {recall} < 0.99")
        return {
            "points": n, "dim": d, "matching": int(member.sum()),
            "requests": n_queries, "recall_at_10": recall,
            "kernel_launches": launches,
        }
    finally:
        srv.shutdown()
        toc.close()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(ALL_PHASES))
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one extra REST window with torch.profiler into DIR")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(ALL_PHASES)
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
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    rng = np.random.default_rng(args.seed)
    kernel_row = {
        "name": "fused_scan_survivors", "route": "cuda",
        "source": "qdrant_tpu_torch/csrc/fused_scan.cu",
        "replaces": "qdrant_tpu/ops/pallas_scan.py:53",
    }

    if "build" in phases or "kernel" in phases:
        t0 = time.perf_counter()
        so, log = fs.build_library(verbose=True)
        fs._lib()
        print(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(so, ROOT)} ({card})")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: ptxas {line.strip()}")
    if "kernel" in phases:
        max_err = 0.0
        for name, kw in (
            ("euclid_1m_128", dict(b=256, n=1_000_000, d=128, euclid=True, deleted_frac=0.1)),
            ("dot_100k_1536", dict(b=256, n=100_000, d=1536, euclid=False, deleted_frac=0.0)),
            # the shapes the rest and filtered phases launch: batches of a few
            # requests padded to 8 rows; D=100 padded to 128, 10% of rows live
            ("rest_euclid_1m_128_b8", dict(b=8, n=1_000_000, d=128, euclid=True, deleted_frac=0.0)),
            ("filtered_cosine_100k_100_b8",
             dict(b=8, n=100_000, d=100, d_pad=128, euclid=False, deleted_frac=0.9)),
        ):
            res = compare_kernel(rng, **kw)
            print(f"kernel {name}: {json.dumps(res)} ({card})", flush=True)
            max_err = max(max_err, res["max_abs_err"])
            if name == "rest_euclid_1m_128_b8":  # the main path's launch shape
                kernel_row.update(ms=res["ms"], plain_ms=res["plain_ms"])
        kernel_row["max_abs_err"] = max_err
    storage_root = os.path.join(ROOT, "build")
    os.makedirs(storage_root, exist_ok=True)
    if "rest" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_rest_", dir=storage_root)
        try:
            res = run_rest(rng, storage, fs, profile_dir=args.profile)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        print(f"rest sift1m: {json.dumps(res)} ({card})", flush=True)
        kernel_row["launches"] = res["kernel_launches"]
    if "filtered" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_filtered_", dir=storage_root)
        try:
            res = run_filtered(rng, storage, fs)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        print(f"filtered glove100: {json.dumps(res)} ({card})", flush=True)
    check("jax" not in sys.modules, "the port imported jax")
    print(json.dumps({"kernels": [kernel_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
