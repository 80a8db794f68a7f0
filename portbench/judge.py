"""Judge answers against the reference → the numbers that decide `correct`.

Every answer of the run is judged, not a sample:

* `bad_answers` (limit 0): requests with no HTTP 200, not exactly `limit`
  hits, an id that is no row, an id twice, a score that is not finite, or
  hits out of the distance's order.
* `score_rel_err`: the widest gap between a returned score and the exact
  score (float64, from the raw rows) of the returned id for that request's
  own query, relative to the largest exact score of the answer. It catches
  lower precision, and an answer given to another query after coalescing.
* `recall_at_10`: the returned ids found in the exact top-k, over k times
  the answers completed in the window. Its floor is stated by the traffic.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def numbers(req: Dict[str, np.ndarray], pool: np.ndarray, ref, k: int,
            in_window: np.ndarray, truth=None) -> dict:
    """req: the clients' records (qidx, status, n_hits, ids, scores); ref:
    the reference's `Exact` over the rows. → {bad_answers, score_rel_err,
    recall (per request, NaN where not judged), recall_at_10 (window)}."""
    lower = ref.distance == "Euclid"
    r = len(req["qidx"])
    ok = (req["status"] == 200) & (req["n_hits"] == k)
    ids, got = req["ids"], req["scores"]
    exact = np.full((r, k), np.nan)
    if ok.any():
        exact[ok] = ref.scores(pool[req["qidx"][ok]], ids[ok])
    srt = np.sort(ids, axis=1)
    dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    step = np.diff(got, axis=1)
    unordered = (step < 0).any(axis=1) if lower else (step > 0).any(axis=1)
    bad_row = (~ok | dup | unordered | ~np.isfinite(got).all(axis=1)
               | ~np.isfinite(exact).all(axis=1))
    with np.errstate(invalid="ignore"):
        gap = np.abs(got - exact).max(axis=1) / np.maximum(np.abs(exact).max(axis=1), 1e-30)
    good = ok & ~bad_row
    score_err = float(gap[good].max()) if good.any() else float("inf")
    if truth is None:
        uniq, inv = np.unique(req["qidx"], return_inverse=True)
        t_ids, _ = ref.topk(pool[uniq], k)
        truth = t_ids[inv]
    recall = np.full(r, np.nan)
    recall[ok] = (ids[ok][:, :, None] == truth[ok][:, None, :]).any(axis=2).sum(axis=1) / k
    win = in_window & ok
    return {
        "bad_answers": int(bad_row.sum()),
        "score_rel_err": score_err,
        "recall": recall,
        "recall_at_10": float(np.nanmean(recall[win])) if win.any() else float("nan"),
    }


def checks(num: dict, limits: dict, recall_floor: float) -> Dict[str, dict]:
    """The compared numbers, each beside its limit and which side passes."""
    return {
        "bad_answers": {"value": num["bad_answers"], "limit": 0, "pass": "at_most"},
        "score_rel_err": {"value": num["score_rel_err"],
                          "limit": limits["score_rel_err"], "pass": "at_most"},
        "recall_at_10": {"value": num["recall_at_10"], "limit": recall_floor,
                         "pass": "at_least"},
    }


def passed(c: dict) -> bool:
    v, lim = c["value"], c["limit"]
    if v != v:  # NaN never passes
        return False
    return v <= lim if c["pass"] == "at_most" else v >= lim
