"""The control of `correct`: the reference put in the port's place, one
precision step below the configuration's f32 (TF32), judged as a run's
answers are judged. It has to come out not correct.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --per-client 40

For each seed it makes the cell's rows and query pool as a run does, takes
the first `--per-client` queries of every client's seeded order (the
requests a run of the cell sends), answers them with the reference in TF32
(`Exact.topk(..., precision="tf32")`) and prints the judged numbers beside
the cell's limits, one JSON line a seed. The port is not started: the
control needs no seal. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from . import clients, judge, spec


def control_numbers(files: dict, seed: int, per_client: int, device) -> dict:
    cfg, traffic = files["config"], files["traffic"]
    k = int(traffic["limit"])
    rows, pool = files["data"].generate(cfg["data"], cfg["rows"], cfg["dim"],
                                        traffic["pool"], seed, device)
    qidx = np.concatenate([clients.client_order(seed, c, len(pool))[:per_client]
                           for c in range(traffic["clients"])])
    ref = files["reference"].Exact(rows, cfg["distance"], device)
    uniq, inv = np.unique(qidx, return_inverse=True)
    ids, scores = ref.topk(pool[uniq], k, precision="tf32")
    r = len(qidx)
    req = {"qidx": qidx, "status": np.full(r, 200), "n_hits": np.full(r, k),
           "ids": ids[inv], "scores": scores[inv]}
    num = judge.numbers(req, pool, ref, k, np.ones(r, dtype=bool))
    checks = judge.checks(num, cfg["limits"], float(traffic["recall_floor"]))
    return {"seed": seed, "requests": r,
            "correct": all(judge.passed(c) for c in checks.values()),
            "checks": {n: {"value": c["value"], "limit": c["limit"]} for n, c in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--per-client", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.getcwd()
    files = spec.resolve(root, spec.load_benchmark(root), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = control_numbers(files, seed, args.per_client, torch.device("cuda:0"))
        print(json.dumps({"workload": args.workload, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
