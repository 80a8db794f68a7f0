"""Port parity: qdrant_tpu_torch/ops/distances.py against
qdrant_tpu/ops/distances.py on the same numpy inputs (CPU).

Tolerance: f32 scores agree to rtol 1e-5, atol 1e-4 (the two frameworks sum
the D products in different orders); top-k ids are equal except where two
candidates tie exactly in score.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qdrant_tpu.ops import distances as jd
from qdrant_tpu.types import Distance
from qdrant_tpu_torch.ops import distances as td
from qdrant_tpu_torch.types import Distance as PortDistance
from qdrant_tpu_torch.device import force_cpu

force_cpu()  # the port on the CPU, with the kernels' plain versions

DISTANCES = [d.value for d in Distance]
RTOL, ATOL = 1e-5, 1e-4


def _inputs(seed, b=6, n=300, d=24, distance="Dot"):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = jd.preprocess_vectors(q, Distance(distance))
    v = jd.preprocess_vectors(v, Distance(distance))
    mask = rng.random(n) > 0.3
    return q, v, mask


def _assert_topk_equal(ids_a, ids_b, scores):
    """Ids equal position by position, except inside runs of exactly equal
    scores (where any order is a correct top-k)."""
    for r in range(ids_a.shape[0]):
        for c in range(ids_a.shape[1]):
            if ids_a[r, c] != ids_b[r, c]:
                tied = np.sum(scores[r] == scores[r, c])
                assert tied > 1, (r, c, ids_a[r], ids_b[r])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("distance", DISTANCES)
def test_score_dense_matches_jax(distance, masked):
    q, v, mask = _inputs(1, distance=distance)
    m = mask if masked else None
    ref = np.asarray(
        jd.score_dense(jnp.asarray(q), jnp.asarray(v), distance,
                       None if m is None else jnp.asarray(m))
    )
    got = td.score_dense(torch.from_numpy(q), torch.from_numpy(v), distance,
                         None if m is None else torch.from_numpy(m)).numpy()
    assert got.shape == ref.shape == (q.shape[0], v.shape[0])
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("distance", DISTANCES)
def test_score_and_topk_matches_jax(distance, masked):
    q, v, mask = _inputs(2, distance=distance)
    m = mask if masked else None
    k = 7
    rs, ri = jd.score_and_topk(jnp.asarray(q), jnp.asarray(v), distance, k,
                               None if m is None else jnp.asarray(m))
    gs, gi = td.score_and_topk(torch.from_numpy(q), torch.from_numpy(v),
                               distance, k,
                               None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=RTOL, atol=ATOL)
    full = np.asarray(jd.score_dense(jnp.asarray(q), jnp.asarray(v), distance,
                                     None if m is None else jnp.asarray(m)))
    _assert_topk_equal(gi.numpy(), np.asarray(ri), full)
    if masked:
        assert mask[gi.numpy()].all()


@pytest.mark.parametrize("distance", DISTANCES)
def test_score_ids_batch_matches_jax(distance):
    q, v, _ = _inputs(3, distance=distance)
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, v.shape[0], size=(q.shape[0], 9)).astype(np.int32)
    ref = np.asarray(jd.score_ids_batch(jnp.asarray(q), jnp.asarray(v),
                                        jnp.asarray(ids), distance))
    got = td.score_ids_batch(torch.from_numpy(q), torch.from_numpy(v),
                             torch.from_numpy(ids), distance).numpy()
    np.testing.assert_array_equal(np.isneginf(got), ids < 0)
    fin = ids >= 0
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, atol=ATOL)


def test_bf16_storage_scores_with_f32_accumulation():
    q, v, _ = _inputs(5, distance="Dot")
    ref = np.asarray(jd.score_dense(jnp.asarray(q), jnp.asarray(v, jnp.bfloat16), "Dot"))
    got = td.score_dense(torch.from_numpy(q), torch.from_numpy(v).to(torch.bfloat16),
                         "Dot").numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_preprocess_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((10, 5)).astype(np.float32)
    x[3] = 0.0  # zero vector stays zero under cosine
    for dist in Distance:
        np.testing.assert_array_equal(td.preprocess_vectors(x, PortDistance(dist.value)),
                                      jd.preprocess_vectors(x, dist))
