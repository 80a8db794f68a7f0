"""One run of one benchmark cell of the PyTorch / CUDA port.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. In order:

1. the cell's rows and a pool of queries are made on the card from --seed
   (`data/<generator>.py`) and copied to the host; the peak-memory counter
   is reset, so only the port's allocations count from here on;
2. the port's TableOfContent and RestServer start in this process and the
   collection is created through REST;
3. the rows are loaded through `Collection.bulk_ingest` and sealed by
   `TableOfContent.optimize_all()` (together: `index_s`);
4. every padded batch shape the traffic can form is searched once, then the
   clients (processes of their own, `clients.py`) run closed loops: a
   warm-up, the measured window, a tail. The window starts at the first
   answer after the warm-up and ends at the first answer --seconds later, so
   it holds whole device batches;
5. the peak device memory is read, the port's state is freed, and every
   answer of the run is judged against the plain reference
   (`reference/<reference>.py`, `judge.py`).

With --trace 0 the result carries the cell's end-to-end metrics; with
--trace 1 spans are installed around the port's calls (`trace.py`), a
sub-window of the window is traced with torch.profiler (the clients hold
while the profiler starts and stops), and the result carries the per-layer
metrics, the device's busy and window seconds and a breakdown. Every metric
is read by `metrics/<name>.py`.

The last line on stdout is the result (JSON); the last lines on stderr are
the numbers compared, each beside its limit. Without enough CUDA devices, or
without the port beside it, the run prints no result and exits non-zero; so
it does if jax, jaxlib, flax or qdrant_tpu (the JAX package) is loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import multiprocessing as mp
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import urllib.request
from typing import Dict, Optional

import numpy as np

from . import clients, judge, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "qdrant_tpu")
COLLECTION = "bench"
# A traced run quiets the server around the profiler's start and stop: the
# clients hold for DRAIN_S (longer than one batch), and serve SETTLE_S again
# before the traced window opens.
DRAIN_S = 3.0
SETTLE_S = 3.0


def process_start() -> float:
    """The monotonic time at which this process started (from /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.monotonic() - max(age, 0.0)


def split_cpus(n_client: int):
    """(server's CPUs, clients' CPUs): the clients' processes get the last
    `n_client` CPUs this process may use, the server the others, so that
    the two do not take time from each other."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) <= n_client:
        return cpus, cpus
    return cpus[:-n_client], cpus[-n_client:]


def set_environment(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout; no telemetry."""
    build = os.path.join(root, "build")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ["QDRANT__TELEMETRY_DISABLED"] = "true"
    os.environ["USE_FLAX"] = "0"


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _rest(base: str, method: str, path: str, body=None):
    req = urllib.request.Request(
        base + path, method=method, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        out = json.loads(resp.read())
    if out.get("status") != "ok":
        raise RuntimeError(f"{method} {path} -> {out}")
    return out["result"]


def _sleep_until(t: float) -> None:
    time.sleep(max(0.0, t - time.monotonic()))


def _snapshot(readers) -> Dict[str, object]:
    """Every reader's `snapshot()`, and the time it was taken ("t")."""
    out = {name: mod.snapshot() for name, mod in readers.items() if hasattr(mod, "snapshot")}
    out["t"] = time.monotonic()
    return out


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_clients(traffic, port, pool_file, cpus, seed, seconds, readers, spans, work):
    """Start the client processes, run warm-up / window / tail, and return
    (requests, planned window start, snapshots at the window's start and
    end (the traced window's end in a traced run), trace summary)."""
    ctx = mp.get_context("spawn")
    ready, results, stop, hold = ctx.Queue(), ctx.Queue(), ctx.Event(), ctx.Event()
    ccfg = {"pool_file": pool_file, "traffic": traffic, "collection": COLLECTION,
            "port": port, "seed": seed, "cpus": list(cpus)}
    groups = np.array_split(np.arange(traffic["clients"]), traffic["processes"])
    procs, gos = [], []
    try:
        for g in groups:
            go = ctx.Queue()
            p = ctx.Process(target=clients.process_main,
                            args=(ccfg, g.tolist(), ready, go, results, stop, hold),
                            daemon=True)
            p.start()
            procs.append(p)
            gos.append(go)
        started, deadline = 0, time.monotonic() + 300
        while started < len(procs):
            try:
                ready.get(timeout=1.0)
                started += 1
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"client processes did not start (exit codes {dead})")
        t_go = time.monotonic() + 0.2
        t_a = t_go + float(traffic["warmup_s"])
        t_b = t_a + seconds
        for go in gos:
            go.put(t_go)
        summary = None
        if spans is None:
            _sleep_until(t_a)
            snaps = {"start": _snapshot(readers)}
            _sleep_until(t_b)
            snaps["end"] = _snapshot(readers)
        else:
            length = min(float(traffic["profile_s"]), seconds - SETTLE_S - DRAIN_S)
            _sleep_until(t_b - length - SETTLE_S - DRAIN_S)
            hold.set()
            time.sleep(DRAIN_S)
            summary, (first, second) = trace.profile_window(
                length, SETTLE_S, DRAIN_S, hold, work, lambda: _snapshot(readers), spans)
            hold.clear()
            snaps = {"start": first, "end": second}
        time.sleep(float(traffic["tail_s"]))
        stop.set()
        parts = [results.get(timeout=600) for _ in procs]
        for p in procs:
            p.join(timeout=60)
    finally:
        stop.set()
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    req = {key: np.concatenate([part[key] for part in parts]) for key in parts[0]}
    return req, t_a, snaps, summary


def _window(req, t_a: float, seconds: float, traced: bool):
    """(t0, t1]: from the first answer at or after t_a to the first answer
    at least `seconds` later (in a traced run, whose clients held while the
    profiler stopped, to the last answer if none came that late)."""
    t = np.sort(req["t_recv"])
    i0 = np.searchsorted(t, t_a)
    if i0 >= len(t):
        raise RuntimeError("no answer came after the warm-up")
    t0 = float(t[i0])
    i1 = np.searchsorted(t, t0 + seconds)
    if i1 >= len(t):
        if not traced:
            raise RuntimeError("no answer came after the window's length; lengthen the tail")
        i1 = len(t) - 1
    return t0, float(t[i1])


class Context:
    """What a metric reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(root: str, bench: dict, cell_name: str, seed: int, seconds: float,
             trace_on: bool, device, t_proc: float) -> dict:
    """Measure one cell → the result object (without printing it)."""
    import torch

    from qdrant_tpu_torch.api.rest import RestServer
    from qdrant_tpu_torch.api.toc import TableOfContent
    from qdrant_tpu_torch.storage.segment import SearchParams

    device = torch.device(device)
    files = spec.resolve(root, bench, cell_name)
    cell, cfg, traffic = files["cell"], files["config"], files["traffic"]
    metrics = spec.cell_metrics(bench, cell_name, trace_on)
    readers = spec.readers(root, metrics)
    spans = trace.Spans()
    if trace_on:
        spans.install(readers.values())
    k = int(traffic["limit"])
    phases: Dict[str, float] = {}
    work = tempfile.mkdtemp(prefix="portbench-")
    own_cpus = os.sched_getaffinity(0)
    server_cpus, client_cpus = split_cpus(int(traffic["client_cpus"]))
    os.sched_setaffinity(0, server_cpus)  # threads made from here on inherit it
    try:
        t = time.monotonic()
        rows, pool = files["data"].generate(cfg["data"], cfg["rows"], cfg["dim"],
                                            traffic["pool"], seed, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        phases["data_s"] = time.monotonic() - t
        pool_file = os.path.join(work, "pool.npy")
        np.save(pool_file, pool)

        t = time.monotonic()
        toc = TableOfContent(os.path.join(work, "storage"))
        srv = RestServer(toc, host="127.0.0.1", port=0)
        srv.start_background()
        base = f"http://127.0.0.1:{srv.port}"
        _rest(base, "PUT", f"/collections/{COLLECTION}", cfg["collection"])
        coll = toc.get_collection(COLLECTION)
        phases["server_s"] = time.monotonic() - t

        t = time.monotonic()
        coll.bulk_ingest(list(range(cfg["rows"])), {"": rows})
        _sync(torch, device)
        phases["load_s"] = time.monotonic() - t
        t = time.monotonic()
        toc.optimize_all()
        _sync(torch, device)
        phases["seal_s"] = time.monotonic() - t
        phases["index_s"] = phases["load_s"] + phases["seal_s"]
        segs = [(len(s), s.appendable) for sh in coll.shards.values() for s in sh.segments]
        if (cfg["rows"], False) not in segs:
            raise RuntimeError(f"the seal left segments {segs}, not one sealed "
                               f"segment of {cfg['rows']} rows")

        t = time.monotonic()
        params = SearchParams.from_dict(traffic.get("params"))
        b = 8
        while True:  # every padded batch the clients can form (powers of two from 8)
            coll.search_dense("", pool[:b], k, params=params)
            if b >= traffic["clients"]:
                break
            b *= 2
        _sync(torch, device)
        phases["shapes_s"] = time.monotonic() - t

        req, t_a, snaps, summary = _run_clients(
            traffic, srv.port, pool_file, client_cpus, seed, seconds, readers,
            spans.records if trace_on else None, work)
        if trace_on and device.type == "cuda" and not (summary or {}).get("busy_s"):
            raise RuntimeError("the traced window shows no device time")
        t0, t1 = _window(req, t_a, seconds, trace_on)
        phases["warmup_s"] = t0 - (t_a - float(traffic["warmup_s"]))
        phases["setup_s"] = t0 - t_proc
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None

        srv.shutdown()
        spans.remove()
        del coll, toc, srv
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        t = time.monotonic()
        ref = files["reference"].Exact(rows, cfg["distance"], device)
        in_window = (req["t_recv"] > t0) & (req["t_recv"] <= t1)
        num = judge.numbers(req, pool, ref, k, in_window)
        del ref
        phases["judge_s"] = time.monotonic() - t
        checks = judge.checks(num, cfg["limits"], float(traffic["recall_floor"]))
        ctx = Context(cell=cell, config=cfg, traffic=traffic, req=req, window=(t0, t1),
                      span_window=(snaps["start"]["t"], snaps["end"]["t"]),
                      in_window=in_window,
                      answered=in_window & (req["status"] == 200), numbers=num,
                      phases=phases, memory_peak_bytes=peak, spans=spans.records,
                      snapshots=snaps, trace=summary, seconds=seconds,
                      profile_window=(summary or {}).get("host_window", (0.0, 0.0)))
        out_metrics = {}
        for m in metrics:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                out_metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        status_ok = req["status"] == 200
        result = {
            "correct": all(judge.passed(c) for c in checks.values()),
            "attempted": int(in_window.sum()),
            "failed": int((in_window & ~status_ok).sum()),
            "metrics": out_metrics,
            "device": _device(torch, device, cell["chips"], peak, summary),
        }
        if trace_on and summary:
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
        result["checks"] = {n: {"value": c["value"], "limit": c["limit"]}
                            for n, c in checks.items()}
        t_ans = req["t_recv"][ctx.answered]
        edges = np.arange(t0, t1 + 1e-9, 5.0)
        phases["answers_per_5s"] = np.histogram(t_ans, edges)[0].tolist() if len(edges) > 1 else []
        result["_phases"] = phases
        result["_profiler"] = (summary or {}).get("profiler_s")
        result["_checks"] = checks
        return result
    finally:
        spans.remove()
        os.sched_setaffinity(0, own_cpus)
        shutil.rmtree(work, ignore_errors=True)


def _device(torch, device, chips, peak, summary) -> dict:
    if device.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": int(chips), "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if summary:
        out["busy_s"] = summary["busy_s"]
        out["window_s"] = summary["trace_window_s"]
    return out


def _io_counts() -> Dict[str, int]:
    """This process's write counts (/proc/self/io): bytes passed to write
    calls (wchar) and bytes that reached the storage layer (write_bytes)."""
    out = {}
    try:
        with open("/proc/self/io") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("wchar", "write_bytes"):
                    out[key] = int(value)
    except OSError:
        pass
    return out


def main(argv=None) -> int:
    t_proc = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    try:
        bench = spec.load_benchmark(root)
        cell = spec.workload(bench, args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    set_environment(root)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import qdrant_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the port is missing ({exc}); run from the checkout's root",
              file=sys.stderr)
        return 2
    # the reference and the checks need true f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    try:
        result = run_cell(root, bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda:0", t_proc)
    except Exception:  # the run failed: no result line
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    phases = result.pop("_phases")
    checks = result.pop("_checks")
    info = {"card": card, "phases_s": phases, "io": _io_counts(),
            "profiler_s": result.pop("_profiler", None)}
    print(f"portbench: {json.dumps(info)}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        side = "<=" if c["pass"] == "at_most" else ">="
        verdict = "ok" if judge.passed(c) else "FAIL"
        print(f"check {name} {c['value']!r} {side} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
