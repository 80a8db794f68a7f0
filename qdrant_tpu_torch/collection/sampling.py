"""Probabilistic per-segment limit subsampling.

Reference: lib/collection/src/collection_manager/
probabilistic_search_sampling.rs (Poisson-quantile sampling table) and
segments_searcher.rs:212-306 (per-segment sampled limits + re-run of any
segment whose sampled result might hide better points).

With S segments holding shares p_i of the points, the number of the true
global top-`limit` hits living in segment i is ~Poisson(limit * p_i); asking
every segment for the full `limit` over-fetches by ~S×. Each segment is
instead asked for the q=0.999^(1/S) Poisson quantile of its share. The
quantile is computed directly (CDF summation for small λ, normal
approximation with continuity correction for large λ) instead of the
reference's precomputed table.
"""

from __future__ import annotations

import math
from typing import Optional

# probability that the sampled limits cover the full global top-k
_COVER_Q = 0.999
# z-score of _COVER_Q**(1/s) stays below ~3.3 for any realistic s
_MIN_SAMPLED = 4


def poisson_quantile(q: float, lam: float) -> int:
    """Smallest k with P(Poisson(lam) <= k) >= q."""
    if lam <= 0:
        return 0
    if lam < 200:
        # exact CDF summation
        pmf = math.exp(-lam)
        cdf = pmf
        k = 0
        while cdf < q and k < 10_000:
            k += 1
            pmf *= lam / k
            cdf += pmf
        return k
    # normal approximation with continuity correction
    z = _norm_ppf(q)
    return int(math.ceil(lam + z * math.sqrt(lam) + 0.5))


def _norm_ppf(q: float) -> float:
    """Inverse normal CDF (Acklam's rational approximation)."""
    if q <= 0.0:
        return -math.inf
    if q >= 1.0:
        return math.inf
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    p_low = 0.02425
    if q < p_low:
        u = math.sqrt(-2 * math.log(q))
        return (((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / \
            ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    if q > 1 - p_low:
        u = math.sqrt(-2 * math.log(1 - q))
        return -(((((c[0] * u + c[1]) * u + c[2]) * u + c[3]) * u + c[4]) * u + c[5]) / \
            ((((d[0] * u + d[1]) * u + d[2]) * u + d[3]) * u + 1)
    u = q - 0.5
    t = u * u
    return (((((a[0] * t + a[1]) * t + a[2]) * t + a[3]) * t + a[4]) * t + a[5]) * u / \
        (((((b[0] * t + b[1]) * t + b[2]) * t + b[3]) * t + b[4]) * t + 1)


def find_search_sampling(limit: float, segment_probability: float,
                         n_segments: int = 8) -> int:
    """Sampled per-segment limit (probabilistic_search_sampling.rs)."""
    lam = limit * segment_probability
    q = _COVER_Q ** (1.0 / max(n_segments, 1))
    return max(poisson_quantile(q, lam), _MIN_SAMPLED)


def sampling_limit(
    limit: int,
    ef_limit: Optional[int],
    segment_points: int,
    total_points: int,
    n_segments: int = 8,
) -> int:
    """Per-segment search limit (segments_searcher.rs::sampling_limit):
    the Poisson quantile of the segment's point share, floored by ef_limit
    for graph searches, never above `limit`."""
    if segment_points == 0:
        return 0
    if total_points == 0:
        return limit
    p = segment_points / total_points
    poisson = find_search_sampling(float(limit), p, n_segments)
    if ef_limit is None:
        return min(max(poisson, _MIN_SAMPLED), limit)
    return min(max(poisson, ef_limit), limit)
