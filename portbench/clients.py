"""Closed-loop REST clients, in processes of their own.

Each client holds one keep-alive HTTP connection and sends its next search
when the previous one has returned. Its queries come from the pool in an
order drawn from (seed, client). Every request is recorded: query, send and
receive time (CLOCK_MONOTONIC, which all processes share), HTTP status, and
the returned ids and scores. This module imports numpy and the standard
library only, so a client process starts quickly and never touches the card.
"""

from __future__ import annotations

import http.client
import json
import os
import threading
import time
from typing import List

import numpy as np

ERROR = -1  # status of a request that got no HTTP answer
HOLD_POLL_S = 0.002


def body_prefix(traffic: dict) -> bytes:
    """The JSON body after the vector: limit, payload flag and params."""
    extra = {"limit": traffic["limit"], "with_payload": traffic["with_payload"]}
    if traffic.get("params"):
        extra["params"] = traffic["params"]
    return json.dumps(extra, separators=(",", ":"))[1:].encode()


def encode(vec: np.ndarray, tail: bytes) -> bytes:
    # repr of each f32 widened to a double: parsed back, it is the same f32
    return b'{"vector":[' + ",".join(map(repr, vec.tolist())).encode() + b"]," + tail


def client_order(seed: int, client: int, pool: int) -> np.ndarray:
    """The pool in this client's order (cycled if a run outlasts it)."""
    return np.random.default_rng([int(seed) % (1 << 63), client]).permutation(pool)


class _Client:
    def __init__(self, port: int, path: str, order: np.ndarray):
        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        self.conn.connect()
        self.path = path
        self.order = order
        self.rec: List[tuple] = []

    def loop(self, pool, tail, bodies, t_go, stop, hold):
        time.sleep(max(0.0, t_go - time.monotonic()))
        i = 0
        while not stop.is_set():
            if hold.is_set():  # a traced run quiets the server to start its profiler
                time.sleep(HOLD_POLL_S)
                continue
            qi = int(self.order[i % len(self.order)])
            i += 1
            body = bodies.get(qi)
            if body is None:
                body = bodies[qi] = encode(pool[qi], tail)
            t0 = time.monotonic()
            try:
                self.conn.request("POST", self.path, body,
                                  {"Content-Type": "application/json"})
                resp = self.conn.getresponse()
                raw = resp.read()
                status = resp.status
            except (OSError, http.client.HTTPException):
                self.rec.append((qi, t0, time.monotonic(), ERROR, None))
                self.conn.close()  # the next request reconnects
                continue
            t1 = time.monotonic()
            hits = None
            if status == 200:
                try:
                    hits = json.loads(raw)["result"]
                except (ValueError, KeyError, TypeError):
                    hits = None
            self.rec.append((qi, t0, t1, status, hits))
        self.conn.close()


def _pack(recs: List[tuple], limit: int) -> dict:
    """Records → arrays; a response that is not a list of `limit` hits with
    integer ids and numeric scores keeps n_hits != limit (judged bad)."""
    r = len(recs)
    out = {
        "qidx": np.zeros(r, np.int64), "t_send": np.zeros(r), "t_recv": np.zeros(r),
        "status": np.zeros(r, np.int64), "n_hits": np.zeros(r, np.int64),
        "ids": np.full((r, limit), -1, np.int64),
        "scores": np.full((r, limit), np.nan),
    }
    for j, (qi, t0, t1, status, hits) in enumerate(recs):
        out["qidx"][j], out["t_send"][j], out["t_recv"][j] = qi, t0, t1
        out["status"][j] = status
        if not isinstance(hits, list):
            continue
        out["n_hits"][j] = len(hits)
        try:
            for h, p in enumerate(hits[:limit]):
                out["ids"][j, h] = int(p["id"])
                out["scores"][j, h] = float(p["score"])
        except (KeyError, TypeError, ValueError):
            out["n_hits"][j] = -1
    return out


def process_main(cfg: dict, clients: List[int], ready, go, results, stop, hold) -> None:
    """One client process: connect every client, report ready, wait for the
    start time `t_go`, run the loops until `stop` is set (sending nothing
    while `hold` is set), send back the packed records."""
    pool = np.load(cfg["pool_file"])
    tail = body_prefix(cfg["traffic"])
    limit = cfg["traffic"]["limit"]
    path = f"/collections/{cfg['collection']}/points/search"
    cs = [_Client(cfg["port"], path, client_order(cfg["seed"], c, len(pool)))
          for c in clients]
    bodies: dict = {}
    ready.put(len(cs))
    t_go = go.get()
    ts = [threading.Thread(target=c.loop, args=(pool, tail, bodies, t_go, stop, hold))
          for c in cs]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    recs = [r for c in cs for r in c.rec]
    packed = _pack(recs, limit)
    packed["client"] = np.concatenate(
        [np.full(len(c.rec), cid, np.int64) for c, cid in zip(cs, clients)]
    ) if cs else np.zeros(0, np.int64)
    results.put(packed)
