"""Port parity: qdrant_tpu_torch ScanIndex and PlainIndex against the JAX
ones (single-device path, QDRANT_TPU_MESH=0) and against exact f64 truth, at
the scan threshold N = 65,536 (D=128 euclid, D=100 cosine) and on a segment
below it.

Tolerance: a ScanIndex alone returns bf16 scan scores, so ranks within bf16
rounding may swap at the k-th place: recall@10 >= 0.95 against exact truth
for both packages, and the port's scores are the exact scores of its ids
within 2% (bf16).
PlainIndex rescores in f32: recall@10 >= 0.99 for both, every returned score
equals the exact score of its id to rtol 1e-5, atol 1e-4, and so do the
scores of ids both packages return. At limit 100 (2,048 survivor bins for
200 candidates, so bin collisions cost more) recall@100 >= 0.95 for both.
"""

import numpy as np
import pytest
import torch

from qdrant_tpu.index.plain import PlainIndex as JaxPlainIndex
from qdrant_tpu.ops.scan import ScanIndex as JaxScanIndex
from qdrant_tpu.storage.vectors import DenseVectorStore as JaxStore
from qdrant_tpu.types import Distance as JaxDistance
from qdrant_tpu_torch.index.plain import SCAN_THRESHOLD, PlainIndex
from qdrant_tpu_torch.ops import fused_scan as fs
from qdrant_tpu_torch.ops.distances import preprocess_vectors
from qdrant_tpu_torch.ops.scan import ScanIndex
from qdrant_tpu_torch.storage.vectors import DenseVectorStore
from qdrant_tpu_torch.types import Distance
from qdrant_tpu_torch.device import force_cpu

force_cpu()  # the port on the CPU, with the kernels' plain versions

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    monkeypatch.setenv("QDRANT_TPU_MESH", "0")


def _data(seed, n, d, b):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


def _exact(x, q, distance, k, valid=None):
    """f64 brute force → (ids [B, k], scores [B, k]) in the engine's
    larger-is-better convention."""
    xp = preprocess_vectors(x, distance).astype(np.float64)
    qp = preprocess_vectors(q, distance).astype(np.float64)
    if distance is Distance.EUCLID:
        s = -((qp * qp).sum(1)[:, None] - 2 * qp @ xp.T + (xp * xp).sum(1)[None])
    else:
        s = qp @ xp.T
    if valid is not None:
        s[:, ~valid] = -np.inf
    ids = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(s, ids, axis=1)


def _exact_scores(x, q, distance, ids):
    """f64 scores of given ids [B, k]."""
    xp = preprocess_vectors(x, distance).astype(np.float64)
    qp = preprocess_vectors(q, distance).astype(np.float64)
    rows = xp[ids]  # [B, k, D]
    if distance is Distance.EUCLID:
        return -((rows - qp[:, None, :]) ** 2).sum(-1)
    return np.einsum("bkd,bd->bk", rows, qp)


def _recall(ids, truth):
    return np.mean([len(set(a.tolist()) & set(t.tolist())) / truth.shape[1]
                    for a, t in zip(ids, truth)])


def _stores(x, distance, deleted=()):
    js = JaxStore(x.shape[1], JaxDistance(distance.value))
    ts = DenseVectorStore(x.shape[1], distance)
    js.add(x)
    ts.add(x)
    for off in deleted:
        js.delete(int(off))
        ts.delete(int(off))
    return js, ts


CASES = [(128, Distance.EUCLID), (100, Distance.COSINE)]


@pytest.mark.parametrize("d,distance", CASES)
def test_scan_index_recall_vs_jax_and_truth(d, distance):
    x, q = _data(11, SCAN_THRESHOLD, d, 16)
    k = 10
    xp, qp = preprocess_vectors(x, distance), preprocess_vectors(q, distance)
    euclid = distance is Distance.EUCLID
    port = ScanIndex(xp, euclid=euclid)
    ref = JaxScanIndex(xp, euclid=euclid)
    assert ref.mesh is None and not ref.use_pallas  # the XLA reference path
    ps, pi = port.search(qp, k)
    rs, ri = ref.search(qp, k)
    truth, tscores = _exact(x, q, distance, k)
    assert _recall(pi, truth) >= 0.95
    assert _recall(ri, truth) >= 0.95
    # bf16 scan scores agree with the exact scores of the returned ids.
    # (Not compared with the JAX scores: its XLA scan returns 2*q.v for
    # dot/cosine off the TPU — ROADMAP queue 3.)
    exact = _exact_scores(x, q, distance, pi)
    assert np.all(np.abs(ps - exact) <= 2e-2 * (1 + np.abs(exact)))


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("d,distance", CASES)
def test_plain_index_at_threshold_matches_jax(d, distance, filtered):
    x, q = _data(12, SCAN_THRESHOLD, d, 16)
    deleted = np.arange(0, SCAN_THRESHOLD, 7)
    js, ts = _stores(x, distance, deleted)
    valid = ~js.deleted_mask
    fmask = None
    if filtered:
        fmask = np.random.default_rng(13).random(SCAN_THRESHOLD) < 0.3
        valid = valid & fmask
    k = 10
    ps, pi = PlainIndex(ts).search(q, k, fmask)
    rs, ri = JaxPlainIndex(js).search(q, k, fmask)
    truth, tscores = _exact(x, q, distance, k, valid)
    assert _recall(pi, truth) >= 0.99
    assert _recall(ri, truth) >= 0.99
    assert valid[pi[pi >= 0]].all()
    exact = _exact_scores(x, q, distance, pi)
    np.testing.assert_allclose(ps, exact, rtol=RTOL, atol=ATOL)
    for r in range(len(q)):
        for i in np.intersect1d(pi[r], ri[r]):
            sp = ps[r][pi[r] == i][0]
            sr = rs[r][ri[r] == i][0]
            assert abs(sp - sr) <= ATOL + RTOL * abs(sr)


@pytest.mark.parametrize("distance", list(Distance))
def test_plain_index_below_threshold_matches_jax(distance):
    x, q = _data(14, 5000, 64, 9)
    js, ts = _stores(x, distance, deleted=range(0, 5000, 11))
    fmask = np.random.default_rng(15).random(5000) < 0.5
    k = 12
    ps, pi = PlainIndex(ts).search(q, k, fmask)
    rs, ri = JaxPlainIndex(js).search(q, k, fmask)
    np.testing.assert_allclose(ps, rs, rtol=RTOL, atol=ATOL)
    for r in range(len(q)):
        for c in range(k):
            if pi[r, c] != ri[r, c]:
                assert abs(ps[r, c] - rs[r, c]) <= ATOL + RTOL * abs(rs[r, c])
    valid = (~js.deleted_mask) & fmask
    assert valid[pi[pi >= 0]].all()


def test_scan_index_large_limit_raises_slots():
    """limit 1,500 oversamples to k_fetch 3,000, more than the 2,048 default
    survivors; the port raises slots to ceil(3000/128) = 24 (blk 2,048 so
    every slot gets a block) instead of failing. The result is the exact
    top-1,500 of those survivors' rows; bins that hold two true winners
    keep one, so recall against all rows is what 3,072 bins allow."""
    x, q = _data(16, SCAN_THRESHOLD, 32, 2)
    ts = DenseVectorStore(32, Distance.DOT)
    ts.add(x)
    s, i = PlainIndex(ts).search(q, 1500)
    assert i.shape == (2, 1500) and (i >= 0).all()
    assert np.all(np.diff(s, axis=1) <= 0)
    np.testing.assert_allclose(s, _exact_scores(x, q, Distance.DOT, i),
                               rtol=RTOL, atol=ATOL)
    scan = ts.scan_index()
    assert fs.scan_grid(scan.n_pad, 3000) == (2048, 24)
    qp = torch.zeros((len(q), scan.d_pad))
    qp[:, :32] = torch.from_numpy(q)
    _, surv = fs.fused_scan_survivors_plain(
        qp.to(torch.bfloat16), scan._v, scan._mask, 2048, 24)
    full = x.astype(np.float64) @ q.astype(np.float64).T  # [N, B]
    for r in range(len(q)):
        rows = surv[r].numpy()
        rows = rows[rows >= 0]
        best = rows[np.argsort(-full[rows, r])[:1500]]
        assert set(i[r].tolist()) == set(best.tolist())
    truth, _ = _exact(x, q, Distance.DOT, 1500)
    assert _recall(i, truth) >= 0.75


def test_plain_index_mid_limit_keeps_product_shape():
    """Limits 17..1,024 (k_fetch ≤ 2,048) scan with the JAX product shape,
    blk 4,096 × 16 slots, and agree with the JAX PlainIndex and exact truth."""
    x, q = _data(19, SCAN_THRESHOLD, 128, 8)
    js, ts = _stores(x, Distance.EUCLID, deleted=range(0, SCAN_THRESHOLD, 7))
    assert fs.scan_grid(ts.scan_index().n_pad, 200) == (4096, 16)
    k = 100
    ps, pi = PlainIndex(ts).search(q, k)
    rs, ri = JaxPlainIndex(js).search(q, k)
    truth, _ = _exact(x, q, Distance.EUCLID, k, ~js.deleted_mask)
    assert _recall(pi, truth) >= 0.95
    assert _recall(ri, truth) >= 0.95
    np.testing.assert_allclose(ps, _exact_scores(x, q, Distance.EUCLID, pi),
                               rtol=RTOL, atol=ATOL)
    for r in range(len(q)):
        for i in np.intersect1d(pi[r], ri[r]):
            sp = ps[r][pi[r] == i][0]
            sr = rs[r][ri[r] == i][0]
            assert abs(sp - sr) <= ATOL + RTOL * abs(sr)


def test_scan_index_mask_updates():
    x, q = _data(17, 4096 * 3, 32, 4)
    port = ScanIndex(x, euclid=False)
    dead = np.zeros(len(x), bool)
    dead[::2] = True
    port.update_mask(~dead)
    _, ids = port.search(q, 20)
    assert not dead[ids[ids >= 0]].any()
    cached = port.mask_device_cached(~dead)
    assert cached is port.mask_device_cached(~dead)
    assert torch.equal(cached, port._mask)


@pytest.mark.parametrize("n", [3000, SCAN_THRESHOLD])
def test_plain_index_search_many_matches_search(n):
    """One device→host copy for every batch gives what per-batch search does
    (and what the JAX search_many gives, up to the rescore tolerance)."""
    x, q = _data(18, n, 24, 12)
    js, ts = _stores(x, Distance.DOT, deleted=range(0, n, 9))
    batches = [q[:5], q[5:6], q[6:]]
    idx = PlainIndex(ts)
    many = idx.search_many(batches, 7)
    ref = JaxPlainIndex(js).search_many(batches, 7)
    for (s, i), qb, (rs, ri) in zip(many, batches, ref):
        s1, i1 = idx.search(qb, 7)
        np.testing.assert_array_equal(i, i1)
        np.testing.assert_array_equal(s, s1)
        np.testing.assert_allclose(s, rs, rtol=RTOL, atol=ATOL)
