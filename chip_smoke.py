#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (qdrant_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--phases build,kernel,rest,graph,mesh,filtered,sq,tier,sparse,multi,cluster]
    python3 chip_smoke.py --phases build,graph     # the graph path alone (the short call)
    python3 chip_smoke.py --phases build,mesh      # the 4-shard mesh path alone
    python3 chip_smoke.py --phases build,multi     # the multivector path alone
    python3 chip_smoke.py --phases build,cluster   # the cluster path alone
    python3 chip_smoke.py --phases build,sweep     # tuning only, not run by default

Phases, each printing its numbers on its own line:

1. build     compile csrc/fused_scan.cu (the scan kernel in both modes and
             the merge kernel) and csrc/hnsw_beam.cu (the graph builder's
             construction beam) with nvcc into build/kernels/, printing
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
             compared once), 8 x --cluster-points / 3 x 128 euclid (a shard
             replica of the cluster phase), 8 x 65,536 x 128 euclid (one of
             the mesh phase's four shards); and 8 x 65,536 x 12,288 dot, rows
             too wide for resident queries. Survivor
             scores must agree within a worst-case f32 summation-order bound
             and ids must be equal wherever the class winner beats the
             runner-up by more than that bound.
             int8 mode (scalar-quantized codes, made on the card from
             --seed): 8 and 256 queries x 1,000,000 x 1536 dot on unit-vector
             codes with 10% of rows deleted, 8 x SQ_ROWS x 1536 (the sq
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
             and launches of one beam turn and one insert round. Last, at
             each main path's size (1M x 128 euclid, 262,144 x 1536 cosine,
             graphs built on the card, bf16 codes): one insert round of the
             builder's top batch (B = 4,096; device ms, ops, transient
             memory) and its construction beam, the kernel
             (csrc/hnsw_beam.cu: `ms`, `graph_ms`, its bound, the code rows
             it read) against `_beam_construct_plain` on the same state
             (`plain_ms`): at least 99.99% of the beams' live ids shared,
             and the score of every shared id within the order of an f32
             sum of the plain one (~3 min).
   mesh      the device mesh (parallel/mesh.py) on MESH_SHARDS = 4 logical
             shards of the card (device.set_logical_devices, the counterpart
             of XLA's forced host device count, on which the JAX package ran
             its mesh). The first MESH_ROWS = 262,144 of the rest phase's
             1,000,000 x 128 rows (--mesh-rows; cut for the script's time)
             and its queries, bulk-ingested into a second
             collection made with the 4-shard mesh set and sealed by the
             optimizer: the vector's ScanIndex must be on the 4-shard mesh
             and the graph a 4-shard ShardedHnswIndex built on the device
             (the sharded build's seconds, per shard). 64 default searches
             from 8 threads: recall@10 >= 0.99, scores exact to 1e-4, the
             bf16 scan and the merge kernels launched 4 times a batch (once
             per shard; batches counted at parallel/mesh.py
             sharded_scan_rescore), the window traced for its idle share;
             64 at `hnsw_ef` 128: recall@10 >= 0.90, every score exact, the
             level beam on every shard and no scan kernel. The four programs
             at the mesh's shapes (the JAX package's `dryrun_multichip`): the
             scan + rescore and the exact search on 4 shards of 65,536 rows
             against one shard (rescored rows bit for bit where the bins kept
             the same ids), the beam and one build step over the sealed
             graph's shards on the card against each shard alone (equal)
             and the CPU. The sealed segment saved by the shard's flush when
             the server closes, loaded on the same mesh (the same ids at ef
             128) and on a 2-shard mesh (the graph rebuilt, recall@10 >=
             0.90). With
             more than one card the serving part runs once more over the
             cards; on one it prints that copies between cards were not
             exercised.
4. filtered  100,000 x 100 cosine points with a keyword payload index
             matching 10% of them and `filter.must match` searches: every
             hit matches and recall@10 >= 0.99 against exact (a correctness
             check; it reports no throughput).
5. sq        Qdrant's scalar-quantization deployment at its benchmark's
             width (dbpedia-openai-1M-1536-angular: 1536-d cosine, random
             vectors from --seed, SQ_ROWS = 131,072 of its 1,000,000 rows so
             that the ten phases keep inside the script's time;
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
             "Quantized vectors in RAM, original on disk"): 163,840 x 1536
             cosine (TIER_ROWS, cut from 1,000,000 when the graph phase came
             and from 262,144 when the cluster phase came, for the script's
             time) with `on_disk: true` and the sq phase's scalar config.
             The sealed segment must hold int8 codes on the card and no f32
             block (peak `torch.cuda.max_memory_allocated` under 0.625 GB, the
             rows in a memmap under the storage directory); 64 default
             searches from 8 threads with recall@10 >= 0.99 against exact
             cosine and scores within 1e-4 relative, then 16 codes-only
             searches with recall@10 >= 0.95 against the brute force over
             the same codes; no fused-scan kernel may launch (this tier is
             the torch block scan, as in the JAX engine). Then TurboQuant as
             the primary store: the same 163,840 rows with
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
8. multi     multivectors (Qdrant docs, "Multivectors": ColBERT late
             interaction, 128-d tokens, Cosine, `max_sim`): 16,384
             documents (MULTI_DOCS, of an MS MARCO corpus's 8.8M, cut from
             131,072 when the cluster phase came; 16-64
             tokens each, where ColBERT's doc_maxlen is 180), made from --seed
             around 4,096 topic centres, with `group` = "a" on every tenth
             under a keyword index. The first 4,096 go through
             Collection.upsert and are timed (the line gives what the whole
             load would take that way); the rest go through the appendable
             segment under one bulk-ingest marker in the WAL. 64 `points/query` requests of 32 query tokens (ColBERT's
             query_maxlen), each drawn around one document's tokens, from 8
             threads before the seal (brute max-sim over the padded block:
             recall@10 >= 0.99 against a numpy max-sim that shares no code
             with the port, scores within 1e-4), then max-sim on the card
             against the CPU on 8,192 documents; the optimizer's seal (pooled
             proxy rows, graph); the same 64 through the pooled graph with
             max-sim rescore (recall printed, under 0.5 fails), 16 filtered
             (every hit matches) and one retrieval of 8 token matrices. Each
             window is traced (the graph window's first 16 requests); no scan
             kernel may launch (max-sim is a torch product, as in the JAX
             package).
9. cluster   Qdrant's distributed deployment (docs, "Distributed deployment":
             3 peers, shard_number a multiple of the peers, replication_factor
             2 so one peer may fail): three peers of the port in this process
             (a TableOfContent, a REST server on loopback, a ClusterNode with
             the settings' 0.1 s Raft tick each, all on the card) and the SIFT
             shape's 128-d euclid rows with the rest phase's payload,
             CLUSTER_POINTS = 212,992 of its 1,000,000 (--cluster-points;
             67,384-75,574 points on each shard replica, over SCAN_THRESHOLD),
             shard_number 3, replication_factor 2, write_consistency_factor 1.
             Loaded through peer 1's REST upsert in batches of 1,024 from 4
             threads of a client process (never bulk_ingest: it bypasses the
             replica sets), with indexing off as Qdrant's bulk-upload advice
             has it, then sealed once per replica (indexing_threshold 65,536
             on each peer). Checks: placement (3 shards, 2 ACTIVE replicas on
             2 peers each); 64 searches through peer 1 from 8 threads with
             recall@10 >= 0.99, scores within 1e-4, and at least one bf16
             scan and one merge launch for each remote shard search (the
             window traced for its idle share); the same ids through peer 2;
             16 `must match group = a` searches whose hits all match; 1,024
             random points read back with their exact vector and payload from
             both replicas of their shard (internal records endpoint); peer 3
             stopped: recall kept, 4,096 upserts acknowledged, its replicas
             moved to the live peers by stream transfers (the JAX package's
             repair), peer 3 restarted from its storage rejoins, drops the
             moved replicas and reads the 4,096 points back; a fourth peer
             started as `python -m qdrant_tpu_torch --uri ... --bootstrap
             <leader>` receives a replica of shard 0 by StreamRecords while
             1,024 upserts go on, turns ACTIVE with the shard's count, answers
             as peer 1 does, and stops cleanly on SIGTERM. Prints load,
             seal, QPS, idle share, transfer seconds and points/s.
10. sweep    (only when named) times the scan + merge as a replayed CUDA
             graph for several chunk counts per slot, at the REST launches,
             at B = 64 (one query tile) and B = 256 (four), and at a V small
             enough (34 MB) to stay in L2; `cta_gbps` is the V bytes one CTA
             takes in per ms. One JSON line per point, `sweep ...`.

--profile DIR traces the rest and sq phases' search windows a second time
with torch.profiler (device activity only; device busy and idle share from
each window, traces in DIR) and times the host steps under one rest search
and one cluster search;
the tier and sparse phases trace their windows in any case and write the
traces only with --profile.

Before the last line it prints the kernel table as JSON: each row's numbers
are those at the rest (bf16, merge) or sq (int8) launch, `launches` sums the
main-path phases, and `by_phase` gives each phase's own launches beside the
kernel's numbers at that phase's launch shape. The beam kernel's row
(`hnsw_beam_construct`) has the graph phase's numbers at 1M x 128
(`at_d1536` beside them) and counts the launches of the main-path phases'
own graph builds, one an insert round on the card. The last line is
{"ok": true, "device": {...}}. Any failed check raises (including jax or
the qdrant_tpu package having been imported), so the script exits non-zero
and prints no result; it refuses to run without CUDA.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ALL_PHASES = ("build", "kernel", "rest", "graph", "mesh", "filtered", "sq", "tier", "sparse",
              "multi", "cluster")
EXTRA_PHASES = ("sweep",)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}  # dense tensor-core peaks
# rows of the sq phase: its benchmark has 1,000,000, which the phase served
# until the tier and sparse phases came; 262,144 until the cluster phase
# came (~240 s); an eighth keeps the script's time and the int8 kernel path
# (at least 65,536 rows)
SQ_ROWS = 131_072
# rows of both tier parts: its shape has 1,000,000, which the phase served
# until the graph phase came, 262,144 until the cluster phase came
TIER_ROWS = 163_840
# the tier's peak device memory bar at TIER_ROWS: 1 GB at 262,144 rows,
# scaled (3 GB at 1,000,000: codes 0.40 GB a 262,144 rows + the upload's chunk)
TIER_PEAK_BYTES = 0.625e9
# documents of the multi phase: an MS MARCO passage corpus has 8.8M; 131,072
# until the cluster phase came (a ~220 s phase; 65,536: ~120 s), 262,144
# would take ~400 s; at least 10,001, or the pooled graph is never searched
MULTI_DOCS = 16_384
# points of the cluster phase: the SIFT1M shape has 1,000,000; the hash ring
# splits 212,992 ids 75,574 / 70,034 / 67,384, so every replica's sealed
# segment is over SCAN_THRESHOLD and takes the fused scan (262,144 took
# 242-387 s, the whole script up to 1,198 s of its 1,200)
CLUSTER_POINTS = 212_992
CLUSTER_LOAD_THRESHOLD = 10**9  # indexing_threshold while loading: no seal
# logical shards of the mesh phase (device.set_logical_devices): the sift1m
# rows split as JAX's mesh splits them, on the one card
MESH_SHARDS = 4
# rows of the mesh phase, a prefix of the rest phase's 1,000,000: at all of
# them the phase took 187.6 s and the whole script 1,141.6 s of its 1,200;
# at 524,288 100.6 s and 996.7 s, under 100 s short of the limit on a host
# 25-30% slower (such hosts have run this script); 65,536 rows a shard
MESH_ROWS = 262_144


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


def _graph_window(base, x, q, truth, ef, threads, extra=None, label="graph", coll="sift1m"):
    """`points/search` with params.hnsw_ef through REST → (hits, numbers)."""
    body = {"limit": 10, "params": {"hnsw_ef": ef, **(extra or {}).get("params", {})},
            **{k: v for k, v in (extra or {}).items() if k != "params"}}
    hits, wall = _concurrent_search(base, coll, q, threads, body)
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
    from qdrant_tpu_torch.utils import tracing

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
        rounds_before = tracing.counters().get("build.insert_rounds", 0)
        t0 = time.perf_counter()
        toc.optimize_all()
        optimize_s = time.perf_counter() - t0
        seal_peak = torch.cuda.max_memory_allocated()
        insert_rounds = tracing.counters().get("build.insert_rounds", 0) - rounds_before
        sealed = [s for s in coll.shards[0].segments if not s.appendable and len(s) == n]
        check(bool(sealed), "optimizer did not seal: "
              f"{[(len(s), s.appendable) for s in coll.shards[0].segments]}")
        seg = sealed[0]
        truth = _exact_topk(x, q, 10, "euclid")
        out["data"] = (x, q, truth)  # the mesh phase serves the same rows
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
                "beam_counters": {k: v for k, v in tracing.counters().items()
                                  if k.startswith("beam.")},
            }
        return out
    finally:
        srv.shutdown()
        toc.close()


# ---------------------------------------------------------------------------
# the mesh phase: the sift1m rows over a 4-shard mesh of one card
# ---------------------------------------------------------------------------


def _mesh_programs(fs, x, q, graph, b=8, k=10):
    """The four parallel/mesh.py programs at the mesh's shapes (the JAX
    package's `dryrun_multichip`, on the card): the scan + rescore and the
    exact search on 4 logical shards against the same call on one shard;
    over the sealed graph's shards, the beam search against each shard's
    beam alone and against the CPU, one build step against each shard's
    step alone → dict of numbers."""
    import torch

    from qdrant_tpu_torch.parallel import mesh as pmesh

    # the phase's 4-shard mesh (4 logical shards of one card, or the cards)
    four, cpu = graph.mesh, torch.device("cpu")
    cuda = four.devices[0]
    one = pmesh.Mesh((cuda,))
    n_local = min(65_536, len(x) // 4 // 4096 * 4096)
    rows = torch.from_numpy(x[: 4 * n_local]).to(cuda)
    qd = torch.from_numpy(q[:b]).to(cuda)
    out = {"scan_rows_per_shard": n_local, "queries": b}

    def timed(fn):
        for dv in set(four.devices):
            torch.cuda.synchronize(dv)
        t0 = time.perf_counter()
        res = fn()
        for dv in set(four.devices):
            torch.cuda.synchronize(dv)
        return res, (time.perf_counter() - t0) * 1e3

    # scan + rescore: the same k_fetch makes the rescore one [B, k_fetch, D]
    # program on both sides, so rows whose bins kept the same ids are equal
    # bit for bit
    v = (2.0 * rows).to(torch.bfloat16)
    bias = -(rows * rows).sum(1)
    split = lambda t: pmesh.shard_rows(t, four)  # noqa: E731
    s1, i1 = pmesh.sharded_scan_rescore(one, qd, [v], [bias], [rows], 4096, 2 * k, k, True)
    fs.fused_scan_survivors.launches = 0
    (s4, i4), ms = timed(lambda: pmesh.sharded_scan_rescore(
        four, qd, split(v), split(bias), split(rows), 4096, 2 * k, k, True))
    check(fs.fused_scan_survivors.launches == 4,
          f"sharded_scan_rescore launched {fs.fused_scan_survivors.launches} scans, not 4")
    fs.fused_scan_survivors.launches = 0
    s1, i1, s4, i4 = (t.cpu().numpy() for t in (s1, i1, s4, i4))
    same = [r for r in range(b) if set(i1[r]) == set(i4[r])]
    check(len(same) >= b - 2 and np.array_equal(i1[same], i4[same])
          and np.array_equal(s1[same].view(np.int32), s4[same].view(np.int32)),
          "sharded_scan_rescore on 4 shards differs from one shard")
    out["sharded_scan_rescore"] = {"ms": ms, "rows_bit_equal": len(same)}
    # exact search
    valid = torch.ones(len(rows), dtype=torch.bool, device=cuda)
    e1 = pmesh.sharded_exact_search(one, qd, [rows], [valid], "Euclid", k)
    e4, ms = timed(lambda: pmesh.sharded_exact_search(four, qd, split(rows), split(valid),
                                                      "Euclid", k))
    cancel = float((x[: 4 * n_local] ** 2).sum(1).max() + (q[:b] ** 2).sum(1).max())
    err, n_diff, _ = _same_beam(*(t.cpu().numpy() for t in (*e4, *e1)), magnitude=cancel)
    out["sharded_exact_search"] = {"ms": ms, "score_err_over_tol": err,
                                   "ids_differing_at_ties": n_diff}
    del rows, v, bias, valid
    # the graph programs over the sealed index's shards, cuda against cpu
    host = pmesh.Mesh((cpu,) * graph.n_shards)
    v_cpu = [t.cpu() for t in graph._v]
    l_cpu = [t.cpu() for t in graph._links]
    ent = [int(e) for e in graph._entries]
    g, ms = timed(lambda: pmesh.sharded_hnsw_search(four, qd, graph._v, graph._links,
                                                    ent, None, "Euclid", 64, k))
    c = pmesh.sharded_hnsw_search(host, qd.cpu(), v_cpu, l_cpu, ent, None, "Euclid", 64, k)
    err, n_diff, shared = _same_beam(*(t.cpu().numpy() for t in (*g, *c)))
    check(shared >= 0.95, f"the sharded beams share {shared} of their ids (cuda / cpu)")
    # ... and against each shard's beam alone, offset and merged here
    alone = [pmesh.Mesh((dv,)) for dv in four.devices]  # each shard by itself
    parts = [pmesh.sharded_hnsw_search(alone[s], qd, [graph._v[s]], [graph._links[s]],
                                       [ent[s]], None, "Euclid", 64, k)
             for s in range(graph.n_shards)]
    flat_s = np.concatenate([p[0].cpu().numpy() for p in parts], axis=1)
    flat_i = np.concatenate([np.where(p[1].cpu().numpy() >= 0,
                                      p[1].cpu().numpy() + s * graph.n_per_shard, -1)
                             for s, p in enumerate(parts)], axis=1)
    order = np.argsort(-flat_s, axis=1, kind="stable")[:, :k]
    check(np.array_equal(np.take_along_axis(flat_i, order, 1), g[1].cpu().numpy()),
          "the sharded beam differs from the shards' beams alone, merged")
    out["sharded_hnsw_search"] = {"ms": ms, "ef": 64, "score_err_over_tol": err,
                                  "shared_ids_with_cpu": shared}
    # one build step on every shard at once against each shard alone (a
    # one-shard mesh on its device: the same launches, so equal rows)
    bb, npl = 64, graph.n_per_shard
    batch = [torch.from_numpy(x[s * npl : s * npl + bb]).to(dv)
             for s, dv in enumerate(four.devices)]
    m = graph.config.m0
    sel, ms = timed(lambda: pmesh.sharded_build_step(
        four, batch, graph._v, graph._links, ent, "Euclid", 128, m))
    sel_alone = [pmesh.sharded_build_step(alone[s], [batch[s]], [graph._v[s]],
                                          [graph._links[s]], [ent[s]], "Euclid", 128, m)[0]
                 for s in range(graph.n_shards)]
    check(all(torch.equal(a, b_) for a, b_ in zip(sel, sel_alone)),
          "the sharded build step differs from each shard's step alone")
    out["sharded_build_step"] = {"ms": ms, "batch_per_shard": bb, "ef_construct": 128,
                                 "m0": m}
    return out


def _mesh_serve(base, toc, fs, coll, x, q, truth, threads, profile_dir):
    """Bulk-ingest x into `coll` on the process's mesh, seal it, and serve
    default and `hnsw_ef` 128 searches through REST → (numbers, sealed
    segment)."""
    import torch

    from qdrant_tpu_torch.index.hnsw import ShardedHnswIndex
    from qdrant_tpu_torch.parallel import mesh as pmesh

    n, d = x.shape
    mesh = pmesh.make_mesh()
    _call(base, "PUT", f"/collections/{coll}", {"vectors": {"size": d, "distance": "Euclid"}})
    collection = toc.get_collection(coll)
    t0 = time.perf_counter()
    collection.bulk_ingest(list(range(n)), {"": x})
    ingest_s = time.perf_counter() - t0
    gc.collect()  # an earlier phase's segments, held in cycles, must not count here
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    toc.optimize_all()
    seal_s = time.perf_counter() - t0
    seal_peak = torch.cuda.max_memory_allocated()
    seg, = [s for s in collection.shards[0].segments if not s.appendable and len(s) == n]
    scan = seg.dense[""].scan_index()
    check(scan.mesh is not None and scan.mesh.size == mesh.size,
          f"the sealed scan is not on the {mesh.size}-shard mesh: {scan.mesh}")
    graph = seg.hnsw.get("")
    check(isinstance(graph, ShardedHnswIndex) and graph.n_shards == mesh.size,
          f"the seal built {type(graph).__name__}, not a {mesh.size}-shard graph")
    out = {"shards": mesh.size, "devices": [str(dv) for dv in mesh.devices],
           "ingest_s": ingest_s, "seal_s": seal_s,
           "sharded_build_s": graph.build_stats["seconds"],
           "shard_build_s": graph.build_stats["shard_seconds"],
           "device_build": graph.build_stats["device_build"],
           "memory_allocated_before_bytes": before,
           "seal_max_memory_allocated_bytes": seal_peak}
    check(graph.build_stats["device_build"], "a shard's subgraph was not built on the device")

    _concurrent_search(base, coll, q[:1], 1, {"limit": 10})  # warm-up
    batches = []
    scan_rescore = pmesh.sharded_scan_rescore
    pmesh.sharded_scan_rescore = lambda *a, **kw: batches.append(1) or scan_rescore(*a, **kw)
    try:
        torch.cuda.reset_peak_memory_stats()
        fs.fused_scan_survivors.launches = fs.merge_survivors.launches = 0
        hits, wall = _concurrent_search(base, coll, q, threads, {"limit": 10})
        launches, merges = fs.fused_scan_survivors.launches, fs.merge_survivors.launches
    finally:
        pmesh.sharded_scan_rescore = scan_rescore
    check(batches and launches == mesh.size * len(batches)
          and merges == mesh.size * len(batches),
          f"{len(batches)} batches launched {launches} scans and {merges} merges "
          f"(not {mesh.size} each a batch)")
    check(all(len(h) == 10 for h in hits), "a mesh search returned fewer than 10 hits")
    recall = _recall(hits, truth, 10)
    worst = _euclid_score_err(hits, x, q)
    check(worst <= 1e-4, f"mesh: returned distances off by {worst} (relative)")
    check(recall >= 0.99, f"mesh scan recall@10 {recall} < 0.99")
    out["scan"] = {"requests": len(q), "threads": threads, "wall_s": wall,
                   "qps": len(q) / wall, "recall_at_10": recall, "score_rel_err": worst,
                   "batches": len(batches), "scan_launches": launches,
                   "merge_launches": merges,
                   "launches_per_batch": launches / len(batches),
                   "search_max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                   **_traced_window(lambda: _concurrent_search(base, coll, q, threads,
                                                               {"limit": 10}),
                                    profile_dir, f"{coll}_scan")}
    graph.served.clear()
    fs.fused_scan_survivors.launches = 0
    _, res = _graph_window(base, x, q, truth, 128, threads, label="mesh graph", coll=coll)
    check(graph.served["level"] > 0 and set(graph.served) == {"level"},
          f"the mesh graph searches were served by {dict(graph.served)}")
    check(fs.fused_scan_survivors.launches == 0, "a mesh graph search launched the scan kernel")
    check(res["recall_at_10"] >= 0.90, f"mesh graph recall@10 {res['recall_at_10']} < 0.90")
    out["graph"] = res
    return out, seg


def run_mesh(storage, fs, x, q, truth, shards=MESH_SHARDS, threads=8, profile_dir=None):
    """The mesh phase → dict of numbers: (b) the sift1m rows served through
    REST over `shards` logical shards of the card, (a) the four programs,
    (c) the sealed segment saved by the shard's flush at close, loaded on
    the same mesh (the same ids) and on a 2-shard mesh (rebuilt); with more
    than one card, (b) once more over the cards."""
    import torch

    from qdrant_tpu_torch import device as tdev
    from qdrant_tpu_torch.api.rest import RestServer
    from qdrant_tpu_torch.api.toc import TableOfContent
    from qdrant_tpu_torch.index.hnsw import ShardedHnswIndex
    from qdrant_tpu_torch.storage.segment import SearchParams, Segment

    n, d = x.shape
    out = {"points": n, "dim": d}
    t_start = time.perf_counter()
    ef = SearchParams(hnsw_ef=128)

    def step(name):  # progress, so that a cut run shows where its time went
        print(f"mesh: {name} after {time.perf_counter() - t_start:.1f} s", flush=True)

    def serve(name):
        toc = TableOfContent(os.path.join(storage, name))
        srv = RestServer(toc, host="127.0.0.1", port=0)
        srv.start_background()
        return toc, srv, f"http://127.0.0.1:{srv.port}"

    tdev.set_logical_devices(shards)
    try:
        toc, srv, base = serve("toc")
        try:
            out["logical"], seg = _mesh_serve(base, toc, fs, "sift_mesh", x, q, truth,
                                              threads, profile_dir)
            step("served")
            out["programs"] = _mesh_programs(fs, x, q, seg.hnsw[""])
            step("programs")
            _, live = seg.search_dense("", q, 10, params=ef)
            shard = toc.get_collection("sift_mesh").shards[0]
            path = os.path.join(shard._segments_root(), shard._segment_dirs[id(seg)])
            del seg
        finally:
            srv.shutdown()
            t0 = time.perf_counter()
            toc.close()  # the shard's flush saves every segment, the sealed one too
            save_s = time.perf_counter() - t0

        # (c) persistence: the same mesh loads the graph, another rebuilds it
        t0 = time.perf_counter()
        same = Segment.load(path)
        load_s = time.perf_counter() - t0
        g = same.hnsw[""]
        check(isinstance(g, ShardedHnswIndex) and g.n_shards == shards and not g.build_stats,
              "the saved sharded graph did not load onto the same mesh")
        _, again = same.search_dense("", q, 10, params=ef)
        check(np.array_equal(live, again), "the loaded graph answers other ids")
        del same, g
        step("saved and loaded")
        tdev.set_logical_devices(2)
        t0 = time.perf_counter()
        two = Segment.load(path)
        rebuild_s = time.perf_counter() - t0
        g = two.hnsw[""]
        check(isinstance(g, ShardedHnswIndex) and g.n_shards == 2
              and g.build_stats.get("shards") == 2,
              "a 2-shard mesh did not rebuild the saved 4-shard graph")
        _, offs = two.search_dense("", q, 10, params=ef)
        ids2 = [{two.id_tracker.external_id(int(o)) for o in row if o >= 0} for row in offs]
        recall2 = float(np.mean([len(a & set(t.tolist())) / 10 for a, t in zip(ids2, truth)]))
        check(recall2 >= 0.90, f"the rebuilt 2-shard graph's recall@10 {recall2} < 0.90")
        out["persistence"] = {"save_s": save_s, "load_same_mesh_s": load_s,
                              "ids_equal_after_load": True, "load_2_shards_s": rebuild_s,
                              "rebuild_build_s": g.build_stats["seconds"],
                              "recall_at_10_2_shards": recall2}
        del two, g
        step("rebuilt on 2 shards")

        cards = torch.cuda.device_count()
        if cards > 1:  # (b) over the real cards: copies between them
            tdev.set_logical_devices(None)
            toc, srv, base = serve("cards")
            try:
                out["cards"], _ = _mesh_serve(base, toc, fs, "sift_cards", x, q, truth,
                                              threads, None)
            finally:
                srv.shutdown()
                toc.close()
        else:
            print("mesh: one card: the shards share it, copies between cards were not "
                  "exercised", flush=True)
        return out
    finally:
        tdev.set_logical_devices(None)


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
    del index, store, vectors, bf16, nrm, state
    gc.collect()
    torch.cuda.empty_cache()
    # the same round and its beam at each main path's size
    for name, rows, dim in (("sift1m", 1_000_000, 128), ("dbpedia", 262_144, 1536)):
        out[f"insert_round_b4096_bf16_d{dim}"] = _main_size_round(rng, name, rows, dim)
    return out


def _beam_agreement(got, plain, q, codes, scale_sq):
    """The beam kernel's (scores, ids) against the plain version's on the
    same state: the share of live ids both beams hold, and for each shared
    id the score gap over its tolerance, 2^-20 of scale_sq x the sum of
    |products| (the order of an f32 sum) plus 2 ulp of the plain score.
    → (shared share, ids-equal share of queries, largest gap over tol)."""
    import torch

    got_s, got_i = got
    plain_s, plain_i = plain
    p_sorted, order = plain_i.sort(dim=1)
    pos = torch.searchsorted(p_sorted, got_i.contiguous()).clamp(max=plain_i.shape[1] - 1)
    hit = (p_sorted.gather(1, pos) == got_i) & (got_i >= 0)
    at = plain_s.gather(1, order.gather(1, pos))
    mag = torch.empty_like(got_s)
    for c in range(0, got_i.shape[0], 256):  # [256, ef, D] f32 at a time
        rows = codes[got_i[c:c + 256].clamp(min=0).long()].float().abs()
        mag[c:c + 256] = torch.einsum("bd,bkd->bk", q[c:c + 256].float().abs(), rows)
    ulp = torch.nextafter(at.abs(), torch.full_like(at, float("inf"))) - at.abs()
    tol = 2.0 ** -20 * scale_sq * mag + 2 * ulp
    over = ((got_s - at).abs() / tol)[hit]
    live = max(int((got_i >= 0).sum()), int((plain_i >= 0).sum()))
    return (int(hit.sum()) / live, float((got_i == plain_i).all(dim=1).float().mean()),
            float(over.max()) if over.numel() else 0.0)


def _main_size_round(rng, name, n, d):
    """One insert round of the builder's top batch (B = 4,096, ef 128, 21
    turns, expand 8, m0 40, bf16 codes) at a main path's size: a graph built
    on the card over n x d rows (euclid at d = 128, unit-norm cosine
    otherwise), then the round re-inserts 4,096 of its points (refine
    mode). The round's device ms, ops and peak memory over what was
    allocated before it; its beam alone, the kernel (`ms` launched from
    Python, `graph_ms` replayed) against `_beam_construct_plain` on the same
    state, and the kernel's bound, the code rows it read → dict."""
    import torch

    from qdrant_tpu_torch.index.hnsw import HnswIndex
    from qdrant_tpu_torch.ops import hnsw_build as hb
    from qdrant_tpu_torch.storage.vectors import DenseVectorStore
    from qdrant_tpu_torch.types import Distance, HnswConfig
    from qdrant_tpu_torch.utils import tracing

    euclid = d == 128
    x, _ = _clustered(rng, n, d, 1)
    if not euclid:  # unit-norm rows, as the dbpedia embeddings
        x -= x.mean(axis=1, keepdims=True)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    store = DenseVectorStore(d, Distance.EUCLID if euclid else Distance.COSINE)
    store.add(x)
    del x
    index = HnswIndex(store, HnswConfig())
    before, launches = tracing.counters(), hb.beam_construct_kernel.launches
    index.build()
    after = tracing.counters()
    check(index.build_stats["device_build"], f"{name}: not built on the device")
    res = {"points": n, "dim": d, "build_s": index.build_stats["seconds"],
           "build_rounds": after["build.insert_rounds"] - before.get("build.insert_rounds", 0),
           "build_beam_kernel": after.get("build.beam_kernel", 0)
           - before.get("build.beam_kernel", 0),
           "build_launches": hb.beam_construct_kernel.launches - launches}
    check(res["build_rounds"] > 0 and res["build_beam_kernel"] == res["build_rounds"]
          == res["build_launches"],
          f"{name}: {res['build_beam_kernel']} of {res['build_rounds']} insert rounds "
          "ran the beam kernel")
    vectors = store.device_block()[0]
    links, rank = index._links0_device(), index._rank_device()
    m0 = index.config.m0
    owner = np.full(links.shape[0], -1, np.int32)
    owner[index.rank[index.rank >= 0]] = np.flatnonzero(index.rank >= 0)
    bf16 = vectors.to(torch.bfloat16)
    nrm = (vectors.float() ** 2).sum(1)
    scale_sq = 2.0 if euclid else 1.0
    big = torch.from_numpy(rng.choice(n, size=4096, replace=False).astype(np.int32)).cuda()
    ow = torch.from_numpy(owner).cuda()
    ent = torch.full((4096,), index.entry, dtype=torch.int32, device="cuda")
    state = (links.clone(), (links >= 0).sum(1).to(torch.int32))
    qc = bf16[big.long()]
    beam_args = (qc, bf16, nrm, state[0], rank, ent, scale_sq, euclid, 128, 21, 8)

    def insert_round():
        hb.insert_batch_level0(*state, big, qc, bf16, nrm, rank, ow, ent, scale_sq,
                               ef=128, iters=21, expand=8, m0=m0, inc_cap=16,
                               ov_cap=4096, euclid=euclid, sel_c=128, merge_forward=True)

    busy, n_ops = _device_ms_and_ops(insert_round)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    insert_round()
    torch.cuda.synchronize()
    res["round"] = {"device_ms": busy, "device_ops": n_ops,
                    "transient_gib": (torch.cuda.max_memory_allocated() - base) / 2**30}
    rows = torch.zeros(1, dtype=torch.int64, device="cuda")
    got = hb.beam_construct_kernel(*beam_args, rows_scored=rows)
    plain = hb._beam_construct_plain(*beam_args)
    shared, equal, over = _beam_agreement(got, plain, qc, bf16, scale_sq)
    rows_read = int(rows.item())
    # code rows and their norms, and at most a link row and a rank entry a pick
    moved = rows_read * (d * 2 + 4) + 4096 * 21 * 8 * (m0 * 4 + 4)
    beam = {
        "ms": _time_ms(lambda: hb.beam_construct_kernel(*beam_args), 3),
        "graph_ms": _graph_ms(lambda: hb.beam_construct_kernel(*beam_args), 1, reps=3),
        "plain_ms": _time_ms(lambda: hb._beam_construct_plain(*beam_args), 2),
        "rows_read": rows_read, "rows_most": 4096 * 21 * 8 * m0,
        "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "shared_ids": shared, "ids_equal_share": equal, "score_err_over_tol": over,
    }
    beam["bound_share"] = beam["bound_ms"] / beam["graph_ms"]
    beam["share_of_round"] = beam["graph_ms"] / busy
    res["beam"] = beam
    # bf16 sums in another order break near ties, and a broken tie turns the
    # rest of that query's walk: the beams are compared as sets of ids
    check(shared >= 0.9999,
          f"{name}: the kernel's beams share {shared:.6f} of their ids with the plain ones")
    check(over <= 1.0, f"{name}: a shared id's score is {over:.3f} x its tolerance off")
    del index, store, vectors, links, rank, bf16, nrm, state, qc, beam_args, got, plain
    gc.collect()
    torch.cuda.empty_cache()
    return res


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
    check(memmap_path.startswith(os.path.abspath(toc.storage_path) + os.sep),
          f"the tier's memmap lies outside its storage directory: {memmap_path}")
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


def run_tier(rng, storage, fs, n=TIER_ROWS, n_tq=TIER_ROWS, d=1536, n_queries=64,
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


# ---------------------------------------------------------------------------
# phase 8: multivectors (ColBERT max-sim) through REST
# ---------------------------------------------------------------------------


def _colbert_corpus(rng, n, d, n_topics, tmin=16, tmax=64, chunk=16384):
    """ColBERT-shaped documents: tmin..tmax tokens (uniform) of d dims, each
    document's base row scattered around one of n_topics centres and its
    tokens around its base → (flat tokens [total, d] f32, starts, lens)."""
    lens = rng.integers(tmin, tmax + 1, n)
    starts = np.cumsum(lens) - lens
    centres = rng.standard_normal((n_topics, d), dtype=np.float32)
    topic = rng.integers(0, n_topics, n)
    flat = np.empty((int(lens.sum()), d), dtype=np.float32)
    for lo in range(0, n, chunk):  # bounded temporaries
        hi = min(lo + chunk, n)
        base = centres[topic[lo:hi]] + 0.5 * rng.standard_normal((hi - lo, d), dtype=np.float32)
        a, b = starts[lo], starts[hi - 1] + lens[hi - 1]
        rng.standard_normal((b - a, d), dtype=np.float32, out=flat[a:b])
        flat[a:b] *= 0.5
        flat[a:b] += np.repeat(base, lens[lo:hi], axis=0)
    return flat, starts, lens


def _unit_rows(a, chunk=1 << 20):
    """Rows scaled to unit length, in place, in chunks."""
    for i in range(0, len(a), chunk):
        part = a[i : i + chunk]
        part /= np.linalg.norm(part, axis=-1, keepdims=True)
    return a


def _exact_maxsim_scores(flat_n, starts, lens, qn, chunk_docs=2048, workers=4):
    """Numpy max-sim of every query against every document, independent of
    the port: unit tokens, one product per chunk of documents against all
    query tokens, a max over each document's tokens, a sum over each query's
    → [B, n] f32. Chunks run on `workers` threads (numpy releases the
    interpreter lock in both steps; the segment max is single-threaded)."""
    from concurrent.futures import ThreadPoolExecutor

    b, t, d = qn.shape
    qrows = np.ascontiguousarray(qn.reshape(b * t, d))
    n = len(starts)
    out = np.empty((b, n), dtype=np.float32)

    def chunk(lo):
        hi = min(lo + chunk_docs, n)
        a = starts[lo]
        # [B*T, tokens]: each document's tokens contiguous in a row, so the
        # segment max runs along rows (5x quicker than down columns)
        sims = qrows @ flat_n[a : starts[hi - 1] + lens[hi - 1]].T
        best = np.maximum.reduceat(sims, starts[lo:hi] - a, axis=1)  # [B*T, docs]
        out[:, lo:hi] = best.reshape(b, t, hi - lo).sum(axis=1)

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(chunk, range(0, n, chunk_docs)))  # re-raises a chunk's error
    return out


def _top(scores, k):
    part = np.argpartition(-scores, k, axis=1)[:, :k]
    order = np.argsort(-np.take_along_axis(scores, part, axis=1), axis=1, kind="stable")
    return np.take_along_axis(part, order, axis=1)


def _maxsim_score_err(hits, flat_n, starts, lens, qn):
    """Worst relative gap between returned scores and the exact max-sim of
    the returned ids."""
    worst = 0.0
    for qi, h in enumerate(hits):
        for p in h:
            i = p["id"]
            ref = float((qn[qi] @ flat_n[starts[i] : starts[i] + lens[i]].T).max(axis=1).sum())
            check(np.isfinite(p["score"]), "non-finite score")
            worst = max(worst, abs(p["score"] - ref) / abs(ref))
    return worst


def _maxsim_cuda_vs_cpu(tokens, tmask, valid, q_dev, distance, n_sub=8192):
    """score_multivector_maxsim on the card against the same function on the
    CPU over the first n_sub documents of the padded block: -inf in the same
    places, scores within a summation-order tolerance (1e-5 of the largest),
    the ten best equal modulo ties → dict of numbers."""
    import torch

    from qdrant_tpu_torch.ops.distances import score_multivector_maxsim

    args = (tokens[:n_sub], tmask[:n_sub])
    worst, swaps = 0.0, 0
    for qi in range(q_dev.shape[0]):
        g = score_multivector_maxsim(q_dev[qi], *args, distance, valid[:n_sub]).cpu().numpy()
        c = score_multivector_maxsim(
            q_dev[qi].cpu(), *(a.cpu() for a in args), distance, valid[:n_sub].cpu()).numpy()
        check(bool((np.isfinite(g) == np.isfinite(c)).all()),
              "max-sim on the card and on the CPU disagree on which documents score")
        fin = np.isfinite(c)
        scale = float(np.abs(c[fin]).max())
        err = float(np.abs(g[fin] - c[fin]).max()) / scale
        check(err <= 1e-5, f"max-sim on the card is off the CPU's by {err} of the largest")
        worst = max(worst, err)
        tg, tc = _top(g[None], 10)[0], _top(c[None], 10)[0]
        for pos in np.flatnonzero(tg != tc):  # only where the scores tie
            check(abs(c[tg[pos]] - c[tc[pos]]) <= 1e-5 * scale,
                  "the ten best differ between the card and the CPU beyond ties")
            swaps += 1
    torch.cuda.synchronize()
    return {"documents": n_sub, "queries": int(q_dev.shape[0]),
            "max_rel_err_of_largest": worst, "top10_swaps_at_ties": swaps}


def _multi_host_breakdown(coll, seg, q, reps=3):
    """Host-clock ms of the steps under one brute multivector search on the
    sealed-or-not segment `seg`, each averaged over `reps` calls after one
    warm call. The max-sim and top-k rows include the device work and its
    sync."""
    import torch

    from qdrant_tpu_torch.ops.distances import preprocess_vectors, score_multivector_maxsim
    from qdrant_tpu_torch.ops.hnsw import topk_first
    from qdrant_tpu_torch.types import parse_filter

    store = seg.multi["colbert"]
    tokens, tmask, valid = store.padded_block()
    q_dev = torch.from_numpy(preprocess_vectors(q, store.distance)).to(tokens.device)
    flt = parse_filter({"must": [{"key": "group", "match": {"value": "a"}}]})
    scores = score_multivector_maxsim(q_dev, tokens, tmask, "Cosine", valid)

    def avg(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    def mask_upload():
        alive = seg.alive_mask()
        valid & torch.from_numpy(alive).to(tokens.device)

    return {
        "segment_alive_mask_ms": avg(seg.alive_mask),
        "filter_mask_group_a_ms": avg(lambda: seg.filter_mask(flt)),
        "mask_upload_and_and_ms": avg(mask_upload),
        "padded_block_cached_ms": avg(store.padded_block),
        "maxsim_ms": avg(lambda: score_multivector_maxsim(
            q_dev, tokens, tmask, "Cosine", valid)),
        "topk_ms": avg(lambda: topk_first(scores, 10)[1].cpu()),
        "segment_search_multi_ms": avg(lambda: seg.search_multi("colbert", q, 10)),
        "collection_search_multi_ms": avg(lambda: coll.search_multi("colbert", q, 10)),
    }


def _multi_window(base, bodies, threads, truth, flat_n, starts, lens, qn, label, full=True):
    """`points/query` with the token matrices through REST → (hits,
    numbers). `full`: every query must return 10 hits (a filtered graph
    walk may return fewer: counted)."""
    res, wall = _concurrent_post(base, "/collections/colbert/points/query", bodies, threads)
    hits = [r["points"] for r in res]
    check(not full or all(len(h) == 10 for h in hits),
          f"a {label} query returned fewer than 10 hits")
    check(all(len({p["id"] for p in h}) == len(h) for h in hits), f"a {label} query repeats an id")
    worst = _maxsim_score_err(hits, flat_n, starts, lens, qn)
    check(worst <= 1e-4, f"{label}: returned max-sim scores off by {worst} (relative)")
    return hits, {"requests": len(bodies), "threads": threads, "wall_s": wall,
                  "qps": len(bodies) / wall, "recall_at_10": _recall(hits, truth, 10),
                  "score_rel_err": worst, "hits_per_query": [min(map(len, hits)),
                                                             max(map(len, hits))]}


def run_multi(rng, storage, fs, n=MULTI_DOCS, d=128, n_topics=4096, n_queries=64,
              q_tokens=32, threads=8, n_filtered=16, profile_dir=None):
    """The multi phase: a ColBERT collection through REST, its brute max-sim
    before the seal and its pooled-proxy graph after it → dict of numbers."""
    import gc

    import torch

    from qdrant_tpu_torch.api.rest import RestServer
    from qdrant_tpu_torch.api.toc import TableOfContent
    from qdrant_tpu_torch.storage.vectors import PooledMultiVectorStore

    t_phase = time.perf_counter()

    def step(name):  # progress, so that a cut run shows where its time went
        print(f"multi: {name} done at {time.perf_counter() - t_phase:.1f} s", flush=True)

    toc = TableOfContent(storage)
    srv = RestServer(toc, host="127.0.0.1", port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counters = ((fs.fused_scan_survivors, "launches"), (fs.fused_scan_survivors, "launches_int8"),
                (fs.merge_survivors, "launches"))
    for obj, attr in counters:
        setattr(obj, attr, 0)
    try:
        # sealed once, by the optimizer pass after the brute queries
        _call(base, "PUT", "/collections/colbert",
              {"vectors": {"colbert": {"size": d, "distance": "Cosine",
                                       "multivector_config": {"comparator": "max_sim"}}},
               "optimizers_config": {"indexing_threshold": n}})
        _call(base, "PUT", "/collections/colbert/index",
              {"field_name": "group", "field_schema": "keyword"})
        t0 = time.perf_counter()
        flat, starts, lens = _colbert_corpus(rng, n, d, n_topics)
        corpus_s = time.perf_counter() - t0
        step("corpus")
        src = rng.integers(0, n, n_queries)
        queries = np.stack([
            flat[starts[i] + rng.integers(0, lens[i], q_tokens)] for i in src
        ]) + 0.5 * rng.standard_normal((n_queries, q_tokens, d), dtype=np.float32)

        def doc(i):
            return flat[starts[i] : starts[i] + lens[i]]

        def payload(i):
            return {"group": "a"} if i % 10 == 0 else None

        coll = toc.get_collection("colbert")
        shard = coll.shards[0]
        # Collection.upsert writes every token of every point into the WAL:
        # time it on the first documents and report what the whole load would
        # take that way (146-171 s at 131,072 on the H100's host), then load
        # the rest through the appendable segment under one bulk-ingest
        # marker in the WAL (Shard.bulk_ingest's contract; the JAX
        # bulk_ingest has no multivector route)
        probe = 4096
        t0 = time.perf_counter()
        for lo in range(0, probe, 512):
            coll.upsert([{"id": i, "vector": {"colbert": doc(i).tolist()},
                          "payload": payload(i) or {}} for i in range(lo, lo + 512)],
                        wait=False)
        probe_s = time.perf_counter() - t0
        step(f"upsert of {probe} documents")
        upsert_projection_s = probe_s * n / probe
        t0 = time.perf_counter()
        with shard._lock:
            op_num = shard.wal.append(
                {"type": "bulk_ingest_marker", "n": n - probe, "names": ["colbert"]})
            seg = shard.appendable_segment
            for i in range(probe, n):
                seg.upsert_point(op_num, i, {"colbert": doc(i)}, payload(i))
            del seg
        load_s = probe_s + time.perf_counter() - t0
        step("load")
        check(coll.count() == n, f"{coll.count()} points after loading {n}")

        # the numpy truth: unit tokens (the store normalises its own copy)
        t0 = time.perf_counter()
        flat_n = _unit_rows(flat)
        qn = queries / np.linalg.norm(queries, axis=-1, keepdims=True)
        exact = _exact_maxsim_scores(flat_n, starts, lens, qn)
        truth = _top(exact, 10)
        member = np.arange(n)[::10]
        truth_a = member[_top(exact[:n_filtered, member], 10)]
        truth_s = time.perf_counter() - t0
        step("numpy truth")
        bodies = [{"query": q.tolist(), "using": "colbert", "limit": 10} for q in queries]

        # brute max-sim: the appendable segment has no graph
        appendable = shard.appendable_segment
        t0 = time.perf_counter()
        tokens, tmask, valid = appendable.multi["colbert"].padded_block()
        torch.cuda.synchronize()
        block = {"padded_block_build_s": time.perf_counter() - t0,
                 "padded_block_shape": list(tokens.shape),
                 "padded_block_bytes": tokens.numel() * tokens.element_size()}
        step("padded block")
        _concurrent_post(base, "/collections/colbert/points/query", bodies[:1], 1)  # warm-up
        _, brute = _multi_window(base, bodies, threads, truth, flat_n, starts, lens, qn, "brute")
        check(brute["recall_at_10"] >= 0.99,
              f"brute max-sim recall@10 {brute['recall_at_10']} < 0.99")
        step("brute window")
        brute.update(_traced_window(
            lambda: _concurrent_post(base, "/collections/colbert/points/query", bodies,
                                     threads), profile_dir, "multi_brute"))
        brute["host_breakdown"] = _multi_host_breakdown(coll, appendable, queries[0])
        q_dev = torch.from_numpy(qn[:4].astype(np.float32)).to(tokens.device)
        step("brute trace and host breakdown")
        cuda_vs_cpu = _maxsim_cuda_vs_cpu(tokens, tmask, valid, q_dev, "Cosine")
        step("max-sim cuda vs cpu")
        del tokens, tmask, valid, appendable, q_dev
        brute_peak = torch.cuda.max_memory_allocated()

        # the seal: defragment, pooled proxy rows, graph over them
        t0 = time.perf_counter()
        toc.optimize_all()
        optimize_s = time.perf_counter() - t0
        step("seal")
        sealed = [s for s in shard.segments if not s.appendable and len(s) == n]
        check(bool(sealed) and "colbert" in sealed[0].hnsw_multi,
              "the optimizer did not seal the multivector collection with a pooled graph: "
              f"{[(len(s), s.appendable, list(s.hnsw_multi)) for s in shard.segments]}")
        seg = sealed[0]
        index = seg.hnsw_multi["colbert"]
        stats = index.build_stats
        check(stats.get("device_build") is True, "the seal did not use the device builder")
        t0 = time.perf_counter()
        PooledMultiVectorStore(seg.multi["colbert"])
        pool_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        seal = {"optimize_s": optimize_s, "graph_build_s": stats["seconds"],
                "pooled_proxy_s": pool_s,
                "graph": _graph_stats(index, n)}

        # the pooled graph: the same queries, then the filtered ones
        t0 = time.perf_counter()
        _concurrent_post(base, "/collections/colbert/points/query", bodies[:1], 1)
        first_graph_s = time.perf_counter() - t0
        index.served.clear()
        _, graph = _multi_window(base, bodies, threads, truth, flat_n, starts, lens, qn, "graph")
        check(sum(index.served.values()) >= n_queries,
              f"the graph answered {dict(index.served)} of {n_queries} queries")
        check(graph["recall_at_10"] >= 0.5,
              f"pooled-graph recall@10 {graph['recall_at_10']} < 0.5: a broken graph or rescore")
        step("graph window")
        graph["served_by"] = dict(index.served)
        graph["first_search_s"] = first_graph_s
        # a quarter of the window under the profiler: at ~3,700 device ops a
        # request, reading back the whole window's trace takes longer than
        # the window itself
        graph["traced_requests"] = len(bodies) // 4
        graph.update(_traced_window(
            lambda: _concurrent_post(base, "/collections/colbert/points/query",
                                     bodies[: len(bodies) // 4], threads),
            profile_dir, "multi_graph"))
        flt = {"must": [{"key": "group", "match": {"value": "a"}}]}
        f_hits, filtered = _multi_window(
            base, [{**b, "filter": flt, "with_payload": True} for b in bodies[:n_filtered]],
            threads, truth_a, flat_n, starts, lens, qn[:n_filtered], "filtered", full=False)
        check(all(p["payload"].get("group") == "a" for h in f_hits for p in h),
              "a filtered multivector hit does not match the filter")
        filtered["matching"] = len(member)
        step("graph trace and filtered window")

        ids = [int(i) for i in rng.choice(n, 8, replace=False)]
        got = _call(base, "POST", "/collections/colbert/points",
                    {"ids": ids, "with_vector": True})
        check(sorted(p["id"] for p in got) == sorted(ids), "retrieval lost a point")
        for p in got:
            stored = np.asarray(p["vector"]["colbert"], dtype=np.float32)
            check(stored.shape == (lens[p["id"]], d) and np.allclose(
                stored, flat_n[starts[p["id"]] : starts[p["id"]] + lens[p["id"]]],
                rtol=1e-5, atol=1e-6), f"point {p['id']} came back with other tokens")
        launches = {f"{obj.__name__}.{attr}": getattr(obj, attr) for obj, attr in counters}
        check(not any(launches.values()), f"the multi phase launched a scan kernel: {launches}")
        return {
            "documents": n, "dim": d, "tokens": int(lens.sum()),
            "tokens_per_document": [int(lens.min()), int(lens.max())],
            "query_tokens": q_tokens, "topics": n_topics,
            "cuts": {"documents": f"{n} of MS MARCO's 8.8M", "doc_maxlen": "64 of ColBERT's 180"},
            "load_route": ("Segment.upsert_point under one bulk-ingest marker in the WAL "
                           "(the WAL records of Collection.upsert bypassed)"),
            "upsert_probe_docs": probe, "upsert_probe_s": probe_s,
            "upsert_projection_s": upsert_projection_s, "load_s": load_s,
            "corpus_s": corpus_s, "numpy_truth_s": truth_s, **block,
            "brute": brute, "maxsim_cuda_vs_cpu": cuda_vs_cpu,
            "brute_max_memory_allocated_bytes": brute_peak, "seal": seal,
            "graph": graph, "filtered": filtered, "retrieved": len(got),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "kernel_launches": launches,
        }
    finally:
        srv.shutdown()
        toc.close()


# ---------------------------------------------------------------------------
# phase 9: a three-peer cluster
# ---------------------------------------------------------------------------


def _payload(i):
    return {"n": i, "group": "a"} if i % 10 == 0 else {"n": i}


def _load_client(base, path, npy, start, stop, batch, threads):
    """A client process: PUT points [start, stop) of the rows saved in `npy`
    to `base` + `path` in batches of `batch` from `threads` threads (the
    JSON is encoded here, not in the process that serves) → (wall seconds,
    points acknowledged, errors)."""
    x = np.load(npy, mmap_mode="r")
    spans = [(s, min(s + batch, stop)) for s in range(start, stop, batch)]
    acked, errors, lock = [0], [], threading.Lock()

    def worker(idx):
        try:
            for j in idx:
                s, e = spans[j]
                _call(base, "PUT", path, {"points": [
                    {"id": i, "vector": x[i].tolist(), "payload": _payload(i)}
                    for i in range(s, e)]})
                with lock:
                    acked[0] += e - s
        except Exception as exc:  # reported to the caller
            errors.append(repr(exc))

    ts = [threading.Thread(target=worker, args=(list(range(t, len(spans), threads)),))
          for t in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return time.perf_counter() - t0, acked[0], errors


def _wait(pred, seconds, what, step=0.1):
    """Poll `pred` until it holds → seconds waited (printed); fails the
    phase after `seconds`."""
    t0 = time.perf_counter()
    while True:
        try:
            if pred():
                waited = time.perf_counter() - t0
                print(f"cluster: {what} after {waited:.2f} s", flush=True)
                return waited
        except SmokeError:
            raise
        except Exception:
            pass  # a peer between states: ask again
        check(time.perf_counter() - t0 < seconds, f"cluster: {what} not within {seconds} s")
        time.sleep(step)


class _Peer:
    """A cluster peer of the port in this process: a TableOfContent under
    `path`, a REST server on loopback and a ClusterNode with its Raft log
    under `path`/raft."""

    def __init__(self, peer_id, path, port=0):
        from qdrant_tpu_torch.api.rest import RestServer
        from qdrant_tpu_torch.api.toc import TableOfContent

        self.peer_id, self.path = peer_id, path
        # as the JAX package's cluster tests build a peer: no flush thread.
        # With the entry point's 5 s flush, three peers in one process spend
        # most of each interval re-saving ~87,000-point segments under their
        # shard locks, and a replica's write passes its 5 s deadline
        self.toc = TableOfContent(path)
        self.srv = RestServer(self.toc, host="127.0.0.1", port=port)
        self.srv.start_background()
        self.base = f"http://127.0.0.1:{self.srv.port}"
        self.node = None

    def join(self, urls, tick):
        from qdrant_tpu_torch.cluster.node import ClusterNode

        self.node = ClusterNode(self.peer_id, self.toc, urls, tick_period=tick,
                                raft_storage=os.path.join(self.path, "raft"))
        self.node.start()

    def stop(self):
        if self.node is not None:
            self.node.stop()
        self.srv.shutdown()
        self.toc.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leader(peers):
    """The in-process peer that leads the Raft group now."""
    _wait(lambda: sum(p.node.raft.role == "leader" for p in peers) == 1, 60, "a leader")
    return next(p for p in peers if p.node.raft.role == "leader")


def _replica_counts(peers, name, sid):
    """{peer id: points} over the in-process peers placed to hold `sid`."""
    out = {}
    for p in peers:
        coll = p.toc.get_collection(name)
        if p.peer_id in coll.placement.get(sid, []) and sid in coll.shards:
            out[p.peer_id] = coll.shards[sid].point_count()
    return out


def _all_sealed(peer, name, min_rows):
    """Every local shard of `peer` holds one sealed segment of at least
    `min_rows` points and an empty appendable one."""
    for shard in peer.toc.get_collection(name).shards.values():
        sealed = [s for s in shard.segments if not s.appendable]
        if len(sealed) != 1 or len(sealed[0]) < min_rows:
            return False
        if any(len(s) for s in shard.segments if s.appendable):
            return False
    return True


def _cluster_breakdown(peers, coll, name, q, reps=5):
    """Host-clock ms of the steps under one search through peer 1: the REST
    call, the remote shard's HTTP round trip from peer 1, the search of that
    shard on the peer that holds it, and of a shard peer 1 holds."""
    import torch

    from qdrant_tpu_torch.cluster.remote import RemoteShardHandle

    remote_sid = next(s for s, h in coll.remote_shards.items()
                      if isinstance(h, RemoteShardHandle))
    holder_id = coll.remote_shards[remote_sid].replicas[0][0]
    holder = next(p for p in peers if p.peer_id == holder_id)
    local_sid = next(iter(coll.shards))

    def avg(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    q8 = q[:8]
    return {
        "rest_search_peer1_one_client_ms": avg(
            lambda: _call(peers[0].base, "POST", f"/collections/{name}/points/search",
                          {"vector": q[0].tolist(), "limit": 10})),
        "remote_shard_http_b8_ms": avg(
            lambda: coll.remote_shards[remote_sid].search_dense("", q8, 10)),
        "holder_shard_search_dense_b8_ms": avg(
            lambda: holder.toc.get_collection(name).shards[remote_sid].search_dense("", q8, 10)),
        "peer1_shard_search_dense_b8_ms": avg(
            lambda: coll.shards[local_sid].search_dense("", q8, 10)),
    }


def run_cluster(rng, storage, fs, n=CLUSTER_POINTS, d=128, n_queries=64, threads=8,
                n_small=16, profile_dir=None):
    """The cluster phase: three peers of the port in this process and a
    fourth as a process, all on the card, over HTTP on loopback → dict of
    numbers. Any failed check raises."""
    import multiprocessing
    import signal

    import torch

    from qdrant_tpu_torch.cluster.remote import RemoteReplica
    from qdrant_tpu_torch.cluster.replica_set import ReplicaState
    from qdrant_tpu_torch.device import default_device
    from qdrant_tpu_torch.index.plain import SCAN_THRESHOLD

    name, tick = "sift_cluster", 0.1  # the settings' consensus tick
    check(default_device().type == "cuda", "the peers would not run on the card")
    out = {"points": n, "dim": d, "peers": 3, "shard_number": 3, "replication_factor": 2}
    peers = [_Peer(i, os.path.join(storage, f"peer{i}")) for i in (1, 2, 3)]
    urls = {p.peer_id: p.base for p in peers}
    for p in peers:
        p.join(urls, tick)
    fourth, pool = None, None
    put = f"/collections/{name}/points?wait=true"
    try:
        _wait(lambda: all(p.node.raft.leader_id is not None for p in peers), 60,
              "a leader known to every peer")
        leader = _leader(peers)
        out["leader"] = leader.peer_id
        _call(leader.base, "PUT", f"/collections/{name}", {
            "vectors": {"size": d, "distance": "Euclid"}, "shard_number": 3,
            "replication_factor": 2, "write_consistency_factor": 1,
            # no seal while the points arrive (Qdrant's bulk-upload advice)
            "optimizers_config": {"indexing_threshold": CLUSTER_LOAD_THRESHOLD}})
        _wait(lambda: all(p.toc.has_collection(name) for p in peers), 60, "the collection")
        for p in peers:  # a payload index is each peer's own
            _call(p.base, "PUT", f"/collections/{name}/index",
                  {"field_name": "n", "field_schema": "integer"})
            _call(p.base, "PUT", f"/collections/{name}/index",
                  {"field_name": "group", "field_schema": "keyword"})

        # 1. placement
        colls = [p.toc.get_collection(name) for p in peers]
        placement = colls[0].placement
        check(all(c.placement == placement for c in colls), "the peers disagree on placement")
        check(sorted(placement) == [0, 1, 2]
              and all(len(set(v)) == 2 for v in placement.values()),
              f"placement {placement}: not 3 shards on 2 peers each")
        for p in peers:
            info = _call(p.base, "GET", "/cluster")
            check(len(info["peers"]) == 3 and info["raft_info"]["leader"] == leader.peer_id,
                  f"GET /cluster on peer {p.peer_id}: {info}")
            ci = _call(p.base, "GET", f"/collections/{name}/cluster")
            local = sorted(s["shard_id"] for s in ci["local_shards"])
            check(local == sorted(s for s, v in placement.items() if p.peer_id in v),
                  f"peer {p.peer_id} holds shards {local}, placement {placement}")
            for sid in local:
                states = p.toc.get_collection(name).replica_sets[sid].states
                check(sorted(states) == sorted(placement[sid])
                      and all(s is ReplicaState.ACTIVE for s in states.values()),
                      f"peer {p.peer_id} shard {sid} replica states {states}")
        out["placement"] = {str(k): v for k, v in placement.items()}

        # load through peer 1 from a client process; the rows written later
        # (while peer 3 is down, during the transfer) follow the first n
        n_down, n_during = 4096, 1024
        x, q = _clustered(rng, n + n_down + n_during, d, n_queries)
        npy = os.path.join(storage, "rows.npy")
        np.save(npy, x)
        x_all, x = x, x[:n]
        torch.cuda.reset_peak_memory_stats()
        pool = multiprocessing.get_context("spawn").Pool(1)
        wall, acked, errors = pool.apply(
            _load_client, (peers[0].base, put, npy, 0, n, 1024, 4))
        check(not errors and acked == n, f"load: {acked} of {n} acknowledged, {errors[:3]}")
        out["load_s"], out["load_points_per_s"] = wall, n / wall
        print(f"cluster load: {wall:.2f} s, {n / wall:.1f} points/s", flush=True)
        for sid, peer_ids in placement.items():
            counts = _replica_counts(peers, name, sid)
            check(sorted(counts) == sorted(peer_ids) and len(set(counts.values())) == 1,
                  f"shard {sid} replicas hold {counts}")
            check(counts[peer_ids[0]] >= SCAN_THRESHOLD,
                  f"shard {sid} holds {counts[peer_ids[0]]} points, under the scan threshold")
        out["shard_points"] = {str(s): _replica_counts(peers, name, s)[placement[s][0]]
                               for s in placement}

        # seal: each replica once, into one segment the fused scan serves;
        # the peers' optimizer passes run side by side, as their flush
        # threads would run them
        for p in peers:
            _call(p.base, "PATCH", f"/collections/{name}",
                  {"optimizers_config": {"indexing_threshold": SCAN_THRESHOLD}})
        seal_s = {}

        def seal(peer):
            t0 = time.perf_counter()
            peer.toc.optimize_all()
            seal_s[peer.peer_id] = time.perf_counter() - t0

        sealers = [threading.Thread(target=seal, args=(p,)) for p in peers]
        for t in sealers:
            t.start()
        for t in sealers:
            t.join()
        for p in peers:
            check(_all_sealed(p, name, SCAN_THRESHOLD), f"peer {p.peer_id} did not seal: "
                  + str({sid: [(len(s), s.appendable) for s in sh.segments] for sid, sh in
                         p.toc.get_collection(name).shards.items()}))
        for p in peers:  # no further seal: a replica a transfer fills stays
            _call(p.base, "PATCH", f"/collections/{name}",  # appendable, and scanned
                  {"optimizers_config": {"indexing_threshold": CLUSTER_LOAD_THRESHOLD}})
        out["seal_s_by_peer"] = {str(k): v for k, v in sorted(seal_s.items())}
        print(f"cluster seal: {json.dumps(out['seal_s_by_peer'])}", flush=True)
        out["load_and_seal_max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()

        # 2. searches through peer 1, reaching the remote shard over HTTP
        truth = _exact_topk(x, q, 10, "euclid")
        _concurrent_search(peers[0].base, name, q[:1], 1, {"limit": 10})  # warm-up
        remote_calls = []
        real_search = RemoteReplica.search_dense

        def counted(self, *a, **k):
            remote_calls.append(self.base_url)
            return real_search(self, *a, **k)

        RemoteReplica.search_dense = counted
        try:
            torch.cuda.reset_peak_memory_stats()
            fs.fused_scan_survivors.launches = fs.merge_survivors.launches = 0
            hits, wall = _concurrent_search(peers[0].base, name, q, threads, {"limit": 10})
            launches = fs.fused_scan_survivors.launches
            merges = fs.merge_survivors.launches
            n_remote = len(remote_calls)
        finally:
            RemoteReplica.search_dense = real_search
        check(n_remote > 0, "no search reached a remote shard")
        check(launches >= n_remote and merges >= n_remote,
              f"{launches} scan / {merges} merge launches for {n_remote} remote shard searches")
        check(all(len(h) == 10 for h in hits), "a search returned fewer than 10 hits")
        recall = _recall(hits, truth, 10)
        worst = _euclid_score_err(hits, x, q)
        check(recall >= 0.99, f"cluster recall@10 {recall} < 0.99")
        check(worst <= 1e-4, f"cluster: returned distances off by {worst} (relative)")
        out["search"] = {
            "requests": n_queries, "threads": threads, "wall_s": wall, "qps": n_queries / wall,
            "recall_at_10": recall, "score_rel_err": worst, "kernel_launches": launches,
            "merge_launches": merges, "remote_shard_searches": n_remote,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            **_traced_window(lambda: _concurrent_search(
                peers[0].base, name, q, threads, {"limit": 10}), profile_dir, "cluster")}
        if profile_dir:
            out["search"]["host_breakdown"] = _cluster_breakdown(peers, colls[0], name, q)

        # 3. the same queries through peer 2
        hits2, _ = _concurrent_search(peers[1].base, name, q[:n_small], threads, {"limit": 10})
        check([[h["id"] for h in r] for r in hits2] == [[h["id"] for h in r]
                                                        for r in hits[:n_small]],
              "peer 2 answers with other ids than peer 1")

        # 4. filtered
        flt = {"must": [{"key": "group", "match": {"value": "a"}}]}
        in_a = np.arange(0, n, 10)
        truth_a = in_a[_exact_topk(x[in_a], q[:n_small], 10, "euclid")]
        hits_a, _ = _concurrent_search(peers[0].base, name, q[:n_small], threads,
                                       {"limit": 10, "filter": flt, "with_payload": True})
        check(all(len(h) == 10 and all(p["payload"].get("group") == "a" for p in h)
                  for h in hits_a), "a filtered hit does not match the filter")
        out["filtered"] = {"requests": n_small, "recall_at_10": _recall(hits_a, truth_a, 10)}

        # 5. acknowledged writes, read back from both replicas of each shard
        ids = np.sort(rng.choice(n, 1024, replace=False))
        by_shard = {}
        for i in ids.tolist():
            by_shard.setdefault(colls[0]._route_sid(i), []).append(i)
        for sid, sids in by_shard.items():
            for pid in placement[sid]:
                peer = next(p for p in peers if p.peer_id == pid)
                recs = _call(peer.base, "POST",
                             f"/internal/collections/{name}/shards/{sid}/records",
                             {"ids": sids})["records"]
                check(sorted(r["id"] for r in recs) == sids,
                      f"peer {pid} shard {sid}: {len(recs)} of {len(sids)} records")
                for r in recs:
                    check(np.array_equal(np.asarray(r["vectors"][""], np.float32), x[r["id"]])
                          and r["payload"] == _payload(r["id"]),
                          f"peer {pid} shard {sid}: point {r['id']} differs")
        out["replica_reads"] = {"points": len(ids), "replicas_read": sum(
            len(placement[s]) for s in by_shard)}

        # 6. peer 3 fails, the cluster repairs itself, peer 3 comes back
        victim = peers[2]
        victim_port = victim.srv.port
        held3 = sorted(victim.toc.get_collection(name).shards)
        victim.stop()
        live = peers[:2]
        hits_d, _ = _concurrent_search(peers[0].base, name, q[:n_small], threads,
                                       {"limit": 10})
        recall_down = _recall(hits_d, truth[:n_small], 10)
        check(recall_down >= 0.99, f"recall@10 {recall_down} < 0.99 with peer 3 down")
        wall, acked, errors = pool.apply(
            _load_client, (peers[0].base, put, npy, n, n + n_down, 1024, 4))
        check(not errors and acked == n_down,
              f"with peer 3 down: {acked} of {n_down} acknowledged, {errors[:3]}")
        # the failed fan-out confirms peer 3's replicas dead, and the leader
        # moves each to the live peer that lacked it (a stream transfer)

        def repaired():
            pl = live[0].toc.get_collection(name).placement
            if any(victim.peer_id in v for v in pl.values()):
                return False
            if any(p.toc.get_collection(name).placement != pl for p in live):
                return False
            return all(len(set(_replica_counts(live, name, s).values())) == 1
                       and len(_replica_counts(live, name, s)) == len(pl[s]) for s in pl)

        repair_s = _wait(repaired, 600, "the repair of peer 3's replicas", step=0.25)
        peers[2] = victim = _Peer(3, victim.path, port=victim_port)
        t0 = time.perf_counter()
        victim.join(urls, tick)
        leader = _leader(peers)
        _wait(lambda: victim.node.raft.commit_index == leader.node.raft.commit_index
              and victim.toc.get_collection(name).placement
              == live[0].toc.get_collection(name).placement, 120, "peer 3's rejoin")
        rejoin_s = time.perf_counter() - t0
        placement = live[0].toc.get_collection(name).placement
        for sid in placement:
            counts = _replica_counts(peers, name, sid)
            check(sorted(counts) == sorted(placement[sid]) and len(set(counts.values())) == 1,
                  f"after the repair shard {sid} replicas hold {counts}")
        placed3 = {s for s, v in placement.items() if victim.peer_id in v}
        _wait(lambda: set(victim.toc.get_collection(name).shards) == placed3, 60,
              "peer 3 dropping the replicas moved away from it")
        total = n + n_down
        for p in peers:
            cnt = _call(p.base, "POST", f"/collections/{name}/points/count", {})["count"]
            check(cnt == total, f"peer {p.peer_id} counts {cnt} of {total}")
        got = _call(victim.base, "POST", f"/collections/{name}/points",
                    {"ids": list(range(n, total)), "with_vector": True, "with_payload": True})
        check(sorted(r["id"] for r in got) == list(range(n, total))
              and all(np.array_equal(np.asarray(r["vector"], np.float32), x_all[r["id"]])
                      for r in got),
              "the points written while peer 3 was down do not read back through it")
        out["failure"] = {
            "recall_at_10_peer3_down": recall_down, "upserts_peer3_down": n_down,
            "upsert_s": wall, "repair_s": repair_s, "rejoin_s": rejoin_s,
            "peer3_shards_before": held3, "peer3_shards_after": sorted(placed3),
            "placement_after": {str(k): v for k, v in placement.items()}}

        # 7. a fourth peer, started by the entry point, receives a replica
        port4 = _free_port()
        uri4 = f"http://127.0.0.1:{port4}"
        env = {**os.environ, "QDRANT__TELEMETRY_DISABLED": "true",
               "QDRANT__SERVICE__GRPC_PORT": "0"}
        log4 = open(os.path.join(storage, "peer4.log"), "w")
        t0 = time.perf_counter()
        fourth = subprocess.Popen(
            [sys.executable, "-m", "qdrant_tpu_torch", "--storage-dir",
             os.path.join(storage, "peer4"), "--host", "127.0.0.1", "--http-port", str(port4),
             # a follower refuses the join (NotLeader), as in the JAX package
             "--uri", uri4, "--bootstrap", _leader(peers).base],
            cwd=ROOT, env=env, stdout=log4, stderr=subprocess.STDOUT)

        def joined():
            if fourth.poll() is not None:
                log4.flush()
                raise SmokeError(f"the fourth peer exited with {fourth.returncode}: "
                                 + open(log4.name).read()[-3000:])
            return all(len(_call(b, "GET", "/cluster")["peers"]) == 4
                       for b in (peers[0].base, uri4)) and _call(
                uri4, "GET", f"/collections/{name}")

        _wait(joined, 240, "the fourth peer's join", step=0.5)
        # a replica may be placed on it only once it has applied the whole
        # log: the transfer's driver starts streaming when it applies the
        # replicate op, and gives up without a word after 40 quick failures
        # while the target has not created the shard yet
        leader = _leader(peers)
        _wait(lambda: _call(uri4, "GET", "/cluster")["raft_info"]["commit"]
              >= leader.node.raft.commit_index, 240, "the fourth peer's catch-up", step=0.5)
        start4_s = time.perf_counter() - t0
        id4 = int(_call(uri4, "GET", "/cluster")["peer_id"])
        sid = 0
        holder = next(p for p in peers if p.peer_id == min(placement[sid]))
        # a failed attempt is retried by the driver without a word: keep what
        # each attempt raised, to report it if the replica never turns ACTIVE
        from qdrant_tpu_torch.cluster import transfer as transfer_mod

        attempts, stream = [], transfer_mod.transfer_shard_stream_records

        def recorded(*a, **k):
            try:
                moved = stream(*a, **k)
                attempts.append(f"streamed {moved}")
                return moved
            except Exception as exc:
                attempts.append(repr(exc)[:200])
                raise

        transfer_mod.transfer_shard_stream_records = recorded
        t0 = time.perf_counter()
        _call(_leader(peers).base, "POST", f"/collections/{name}/cluster", {
            "replicate_shard": {"shard_id": sid, "from_peer_id": holder.peer_id,
                                "to_peer_id": id4}})
        # writes begin once the target holds the shard: the source applies
        # the op first and fans writes out to the new replica at once, and a
        # write that reaches the target before it has created the shard
        # marks the new replica dead and moves it elsewhere (ROADMAP queue 3)
        _wait(lambda: sid in [s["shard_id"] for s in _call(
            uri4, "GET", f"/collections/{name}/cluster")["local_shards"]], 120,
            "the fourth peer's empty replica", step=0.05)
        driving = bool(holder.node.active_transfers)
        check(driving, "the transfer ended before the writes began")
        during = pool.apply_async(_load_client, (peers[0].base, put, npy, total,
                                                 total + n_during, 64, 1))
        _, acked_w, errors_w = during.get(timeout=600)
        check(not errors_w and acked_w == n_during,
              f"during the transfer: {acked_w} of {n_during} acknowledged, {errors_w[:3]}")

        def transfer_state():
            rs = holder.toc.get_collection(name).replica_sets[sid]
            ci = _call(uri4, "GET", f"/collections/{name}/cluster")
            return {"state": str(rs.states.get(id4)),
                    "driving": [list(k) for k in holder.node.active_transfers],
                    "holder_points": holder.toc.get_collection(name).shards[sid].point_count(),
                    "fourth_points": [s["points_count"] for s in ci["local_shards"]
                                      if s["shard_id"] == sid],
                    "commit": {"peers": [p.node.raft.commit_index for p in peers],
                               "fourth": _call(uri4, "GET", "/cluster")["raft_info"]["commit"]}}

        def transferred():
            st = transfer_state()
            return (st["state"] == str(ReplicaState.ACTIVE) and not st["driving"]
                    and st["fourth_points"] == [st["holder_points"]])

        try:
            _wait(transferred, 300, "the transfer to the fourth peer", step=0.25)
        except SmokeError as exc:  # say where it stopped
            log4.flush()
            raise SmokeError(f"{exc}: {json.dumps(transfer_state())}; attempts "
                             f"{attempts[:5]} ... {attempts[-3:]} ({len(attempts)}); the fourth "
                             "peer's log ends: " + open(log4.name).read()[-4000:]) from exc
        finally:
            transfer_mod.transfer_shard_stream_records = stream
        out_attempts = attempts[-5:]
        transfer_s = time.perf_counter() - t0
        moved = holder.toc.get_collection(name).shards[sid].point_count()
        hits1, _ = _concurrent_search(peers[0].base, name, q[:n_small], threads, {"limit": 10})
        hits4, _ = _concurrent_search(uri4, name, q[:n_small], threads, {"limit": 10})
        check([[h["id"] for h in r] for r in hits4] == [[h["id"] for h in r] for r in hits1],
              "the fourth peer answers with other ids than peer 1")
        fourth.send_signal(signal.SIGTERM)
        rc = fourth.wait(timeout=120)
        check(rc == 0, f"the fourth peer exited with {rc}")
        out["fourth_peer"] = {"start_and_join_s": start4_s, "shard": sid, "points": moved,
                              "transfer_s": transfer_s, "points_per_s": moved / transfer_s,
                              "upserts_during_transfer": acked_w, "stream_attempts": out_attempts,
                              "exit_code": rc}
        print(f"cluster transfer: {transfer_s:.2f} s, {moved / transfer_s:.1f} points/s",
              flush=True)
        return out
    finally:
        if fourth is not None and fourth.poll() is None:
            fourth.kill()
            fourth.wait()
        if pool is not None:
            pool.terminate()
            pool.join()
        for p in peers:
            try:
                p.stop()
            except Exception:
                pass  # stopped already (the failure check)


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
    ap.add_argument("--multi-docs", type=int, default=MULTI_DOCS,
                    help="documents of the multi phase (fewer only to find faults quickly)")
    ap.add_argument("--cluster-points", type=int, default=CLUSTER_POINTS,
                    help="points of the cluster phase (not under 208,896, or a "
                    "replica's segment would not take the scan kernel)")
    ap.add_argument("--mesh-rows", type=int, default=MESH_ROWS,
                    help="points of the mesh phase, a prefix of the rest phase's rows "
                    "(at most --graph-rows; cut from 1,000,000 for the script's time)")
    ap.add_argument("--profile", metavar="DIR",
                    help="trace one extra REST window with torch.profiler into DIR")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    mesh_rows = min(args.mesh_rows, args.graph_rows)
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
        from qdrant_tpu_torch.ops import hnsw_build as hb
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

    # the beam kernel's launches in each phase, booked at its lap
    beam_launched, beam_seen = {}, [hb.beam_construct_kernel.launches]

    def lap(phase):
        print(f"elapsed after {phase}: {time.perf_counter() - t_start:.1f} s", flush=True)
        count = hb.beam_construct_kernel.launches - beam_seen[0]
        beam_seen[0] += count
        if count:
            beam_launched[phase] = count

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
    rows["beam"] = {
        "name": "hnsw_beam_construct", "route": "cuda",
        "source": "qdrant_tpu_torch/csrc/hnsw_beam.cu",
        # no Pallas kernel: the JAX _beam_construct is an XLA program
        "replaces": None, "library_ms": None, "launches": 0,
    }
    # `ms` is the call launched from Python (the yardstick of earlier runs);
    # `graph_ms` the same in a replayed CUDA graph, `scan_ms` the scan alone
    row_keys = ("ms", "graph_ms", "scan_ms", "plain_ms", "bound_ms", "bound_by",
                "chunks", "ctas")
    # the kernel phase's comparison at each main-path phase's launch shape,
    # and the launches each of those phases made: {phase: ...}
    at_launch, launched = {}, {}

    if "build" in phases or "kernel" in phases or "sweep" in phases:
        for source, load in ((fs.SOURCE, fs._lib), (hb.BEAM_SOURCE, hb._beam_lib)):
            t0 = time.perf_counter()
            so, log = fs.build_library(verbose=True, source=source)
            load()
            print(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(so, ROOT)} "
                  f"({card})")
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
        # one shard of the mesh phase: its rows padded to whole blocks on
        # every shard, a quarter of them
        mesh_kw = dict(rest_kw, n=fs.pad_rows(mesh_rows, 4096 * MESH_SHARDS) // MESH_SHARDS)
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
            # a shard replica of the cluster phase: a third of its points
            ("cluster_shard_euclid_b8", "cluster",
             dict(rest_kw, n=args.cluster_points // 3)),
            ("mesh_shard_euclid_b8", "mesh", mesh_kw),
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
    free_gb = shutil.disk_usage(storage_root).free / 1e9
    print(f"storage: {storage_root} ({free_gb:.1f} GB free)", flush=True)
    data = None  # the rest phase's rows, queries and exact top-10, for the mesh phase
    if "rest" in phases or "graph" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_rest_", dir=storage_root)
        try:
            both = run_rest(rng, storage, fs, phases, n=args.graph_rows,
                            profile_dir=args.profile)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        data = both.pop("data")
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
        main_size = res["insert_round_b4096_bf16_d128"]["beam"]
        rows["beam"].update({k: main_size[k] for k in (
            "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "bound_share")},
            shape="B 4096 x 1M x 128 bf16, ef 128, 21 turns, expand 8, m0 40",
            at_d1536={k: res["insert_round_b4096_bf16_d1536"]["beam"][k] for k in (
                "ms", "graph_ms", "plain_ms", "bound_ms", "bound_share")})
    if "mesh" in phases:
        if data is None:  # the rest phase did not run: the same rows from the seed
            x, q = _clustered(rng, args.graph_rows, 128, 64)
            data = (x, q, _exact_topk(x, q, 10, "euclid"))
        x, q, truth = data
        if mesh_rows < len(x):
            x = x[:mesh_rows]
            truth = _exact_topk(x, q, 10, "euclid")
        storage = tempfile.mkdtemp(prefix="smoke_mesh_", dir=storage_root)
        try:
            res = run_mesh(storage, fs, x, q, truth, profile_dir=args.profile)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        print(f"mesh sift1m: {json.dumps(res)} ({card})", flush=True)
        lap("mesh")
        scan = res["logical"]["scan"]
        launched["mesh"] = ("bf16", scan["scan_launches"], scan["merge_launches"])
    data = None
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
        try:
            res = run_tier(rng, storage, fs, profile_dir=args.profile)
        finally:
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
    multi_launches = None
    if "multi" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_multi_", dir=storage_root)
        try:
            res = run_multi(rng, storage, fs, n=args.multi_docs, profile_dir=args.profile)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        print(f"multi colbert: {json.dumps(res)} ({card})", flush=True)
        lap("multi")
        multi_launches = list(res["kernel_launches"].values())  # bf16, int8, merge
    if "cluster" in phases:
        storage = tempfile.mkdtemp(prefix="smoke_cluster_", dir=storage_root)
        try:
            res = run_cluster(rng, storage, fs, n=args.cluster_points,
                              profile_dir=args.profile)
        finally:
            shutil.rmtree(storage, ignore_errors=True)
        print(f"cluster sift: {json.dumps(res)} ({card})", flush=True)
        lap("cluster")
        launched["cluster"] = ("bf16", res["search"]["kernel_launches"],
                               res["search"]["merge_launches"])
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
    # the beam kernel: one launch an insert round of the main-path phases' own
    # graph builds (the graph phase's comparisons and probes are not booked)
    for phase, count in beam_launched.items():
        if phase != "graph vs cpu":
            rows["beam"]["launches"] += count
            rows["beam"].setdefault("by_phase", {})[phase] = {"launches": count}
    rows["beam"]["check_launches"] = beam_launched.get("graph vs cpu", 0)
    if multi_launches is not None:  # checked 0: max-sim and the graph take no kernel
        for key, count in zip(("bf16", "int8", "merge"), multi_launches):
            rows[key]["launches"] += count
            rows[key].setdefault("by_phase", {})["multi"] = {"launches": count, "shape": None}
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
