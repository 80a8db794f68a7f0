"""Port parity: the fused scan's plain PyTorch version
(qdrant_tpu_torch/ops/fused_scan.py) against the Pallas TPU kernel run in
interpret mode on the CPU (qdrant_tpu/ops/pallas_scan.py), on the same bf16
inputs.

Tolerance: survivor scores agree to atol 1e-4 + rtol 1e-5 (both accumulate
bf16 products in f32, in different orders); survivor ids are equal except
where the class's winner and runner-up are within that tolerance. The three
cases of tests/test_pallas_scan.py are mirrored through the port's topk and
rescore (the third in bf16: the kernel's int8 mode is not ported yet).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qdrant_tpu.ops.pallas_scan import NEG_INF, pallas_scan_survivors
from qdrant_tpu_torch.ops import fused_scan as fs

RTOL, ATOL = 1e-5, 1e-4


def _bf16(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _case(seed, b, n, d, euclid, deleted_every):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    dead = np.zeros(n, dtype=bool)
    if deleted_every:
        dead[::deleted_every] = True
    vsq = (v * v).sum(1) if euclid else np.zeros(n, np.float32)
    bias = np.where(dead, NEG_INF, -vsq).astype(np.float32)
    vk = _bf16(2.0 * v if euclid else v)  # the kernel's operand, bf16-exact
    return _bf16(q), vk, bias, dead


def _exact(q, vk, bias):
    """Survivor-independent f64 scores of every row (for tie checks)."""
    return q.astype(np.float64) @ vk.astype(np.float64).T + bias


@pytest.mark.parametrize(
    "euclid,blk,slots,deleted_every",
    [
        (False, 128, 4, 0),
        (True, 128, 4, 3),
        (False, 256, 4, 5),
        (True, 256, 2, 0),
        (True, 256, 4, 2),
    ],
)
def test_plain_survivors_match_pallas_interpret(euclid, blk, slots, deleted_every):
    b, n, d = 16, 2048, 128
    q, vk, bias, _ = _case(7, b, n, d, euclid, deleted_every)
    rs, ri = pallas_scan_survivors(
        jnp.asarray(q), jnp.asarray(vk, jnp.bfloat16), jnp.asarray(bias),
        blk=blk, qt=8, slots=slots, interpret=True,
    )
    rs, ri = np.asarray(rs), np.asarray(ri)
    gs, gi = fs.fused_scan_survivors_plain(
        torch.from_numpy(q), torch.from_numpy(vk).to(torch.bfloat16),
        torch.from_numpy(bias), blk=blk, slots=slots,
    )
    gs, gi = gs.numpy(), gi.numpy()
    assert gs.shape == gi.shape == (b, slots * fs.LANES)
    empty = rs <= NEG_INF / 2
    np.testing.assert_array_equal(gs <= NEG_INF / 2, empty)
    np.testing.assert_array_equal(gi[empty], ri[empty])
    np.testing.assert_allclose(gs[~empty], rs[~empty], rtol=RTOL, atol=ATOL)
    full = _exact(q, vk, bias)
    for r, c in zip(*np.nonzero((gi != ri) & ~empty)):
        a, bb = full[r, gi[r, c]], full[r, ri[r, c]]
        assert abs(a - bb) <= ATOL + RTOL * abs(a), (r, c)


def test_plain_survivors_ragged_batch_and_narrow_width():
    """B not a multiple of any tile, D = 100 padded to 128 as the scan pads."""
    b, n, d = 5, 1024, 100
    q, vk, bias, _ = _case(8, b, n, d, True, 4)
    qp = np.zeros((8, 128), np.float32)
    qp[:b, :d] = q
    vp = np.zeros((n, 128), np.float32)
    vp[:, :d] = vk
    rs, ri = pallas_scan_survivors(
        jnp.asarray(qp), jnp.asarray(vp, jnp.bfloat16), jnp.asarray(bias),
        blk=128, qt=8, slots=4, interpret=True,
    )
    gs, gi = fs.fused_scan_survivors_plain(
        torch.from_numpy(qp[:b]), torch.from_numpy(vp).to(torch.bfloat16),
        torch.from_numpy(bias), blk=128, slots=4,
    )
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs)[:b], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri)[:b])


def _exact_topk(q, v, k, euclid):
    s = 2 * q @ v.T - (v * v).sum(1)[None, :] if euclid else q @ v.T
    return np.argsort(-s, axis=1)[:, :k]


def _recall(ids, truth):
    b, k = truth.shape
    return sum(len(set(ids[r].tolist()) & set(truth[r].tolist())) for r in range(b)) / (b * k)


def test_port_scan_topk_matches_exact_dot():
    rng = np.random.default_rng(0)
    n, d, b, k = 512, 128, 8, 5
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    s, i = fs.fused_scan_topk(
        torch.from_numpy(q), torch.from_numpy(v).to(torch.bfloat16),
        torch.zeros(n), k, blk=128, slots=4,
    )
    assert _recall(i.numpy(), _exact_topk(q, v, k, False)) >= 0.9


def test_port_scan_topk_euclid_and_mask():
    rng = np.random.default_rng(1)
    n, d, b, k = 384, 128, 8, 4
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    deleted = np.zeros(n, dtype=bool)
    deleted[::3] = True
    bias = np.where(~deleted, -(v * v).sum(1), NEG_INF).astype(np.float32)
    _, i = fs.fused_scan_topk(
        torch.from_numpy(q), torch.from_numpy(2.0 * v).to(torch.bfloat16),
        torch.from_numpy(bias), k, blk=128, slots=4,
    )
    i = i.numpy()
    assert not np.isin(i[i >= 0], np.nonzero(deleted)[0]).any()
    sc = 2 * q @ v.T - (v * v).sum(1)[None, :]
    sc[:, deleted] = -np.inf
    truth = np.argsort(-sc, axis=1)[:, :k]
    assert _recall(i, truth) >= 0.9


def test_port_scan_rescore_exact():
    rng = np.random.default_rng(2)
    n, d, b, k = 512, 128, 8, 5
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    bias = (-(v * v).sum(1)).astype(np.float32)
    qt = torch.from_numpy(q)
    s, i = fs.fused_scan_rescore(
        qt, qt, torch.from_numpy(2.0 * v).to(torch.bfloat16),
        torch.from_numpy(bias), torch.from_numpy(v), 64, k,
        blk=128, slots=4, euclid=True,
    )
    s, i = s.numpy(), i.numpy()
    assert _recall(i, _exact_topk(q, v, k, True)) >= 0.9
    for r in range(b):  # rescored euclid scores are exact -(q-v)^2
        for c in range(k):
            if i[r, c] >= 0:
                ref = -((q[r] - v[i[r, c]]) ** 2).sum()
                assert abs(s[r, c] - ref) < 1e-2


def test_cpu_wrapper_runs_plain_version_without_counting():
    q, vk, bias, _ = _case(9, 8, 512, 128, False, 0)
    before = fs.fused_scan_survivors.launches
    args = (torch.from_numpy(q), torch.from_numpy(vk).to(torch.bfloat16),
            torch.from_numpy(bias))
    a = fs.fused_scan_survivors(*args, blk=128, slots=4)
    p = fs.fused_scan_survivors_plain(*args, blk=128, slots=4)
    assert fs.fused_scan_survivors.launches == before
    assert torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda q, v, b: (q, v.float(), b), TypeError),  # vectors not bf16
        (lambda q, v, b: (q, v, b.double()), TypeError),  # bias not f32
        (lambda q, v, b: (q, v[:-128], b), ValueError),  # bias length
        (lambda q, v, b: (q[:, :64], v, b), ValueError),  # width mismatch
        (lambda q, v, b: (q, v[:-64], b[:-64]), ValueError),  # rows % blk
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, err):
    q, vk, bias, _ = _case(10, 8, 512, 128, False, 0)
    args = mutate(torch.from_numpy(q), torch.from_numpy(vk).to(torch.bfloat16),
                  torch.from_numpy(bias))
    with pytest.raises(err):
        fs.fused_scan_survivors(*args, blk=128, slots=4)


@pytest.mark.parametrize(
    "n_pad,k_fetch,grid",
    [
        (1003520, 20, (4096, 16)),  # the product shape: limit 10
        (1003520, 200, (4096, 16)),  # limit 100: still the JAX shape
        (1003520, 2048, (4096, 16)),  # limit 1,024: the last that fits 2,048
        (1003520, 3000, (4096, 24)),  # limit 1,500: slots cover k_fetch
        (65536, 3000, (2048, 24)),  # blk halves until every slot has a block
        (12288, 20, (512, 16)),  # small ScanIndex: every slot gets a block
    ],
)
def test_scan_grid(n_pad, k_fetch, grid):
    blk, slots = fs.scan_grid(n_pad, k_fetch)
    assert (blk, slots) == grid
    assert n_pad % blk == 0 and slots * fs.LANES >= min(k_fetch, n_pad)
    assert n_pad // blk >= slots
