"""Port parity: the fused scan's plain PyTorch version
(qdrant_tpu_torch/ops/fused_scan.py) against the Pallas TPU kernel run in
interpret mode on the CPU (qdrant_tpu/ops/pallas_scan.py), on the same
inputs, in both of its modes.

bf16 mode. Survivor scores agree to atol 1e-4 + rtol 1e-5 (both accumulate
bf16 products in f32, in different orders); survivor ids are equal except
where the class's winner and runner-up are within that tolerance.

int8 mode. The integer dot is exact in both, so survivor ids are equal and
scores within 1 ulp: the plain version (like the CUDA kernel) rounds
`f32(dot) * scale_sq` and `+ bias` separately, while XLA's CPU backend
contracts the interpreted kernel body's multiply and bias add into one
fused multiply-add, which rounds once. The inputs are small integers, so
scores tie often, and the earliest row must win every tie.

The three cases of tests/test_pallas_scan.py are mirrored through the port's
topk and rescore.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qdrant_tpu.ops.pallas_scan import NEG_INF, pallas_scan_rescore, pallas_scan_survivors
from qdrant_tpu_torch.ops import fused_scan as fs
from qdrant_tpu_torch.device import force_cpu

force_cpu()  # the port on the CPU, with the kernels' plain versions

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


def _int8_case(seed, b, n, d, euclid, dead_frac):
    """Small-integer codes (many exact ties), NEG_INF rows, and for euclid an
    integer-valued -||v||^2-like bias, so that ties survive the bias."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-3, 4, size=(n, d)).astype(np.int8)
    q = rng.integers(-3, 4, size=(b, d)).astype(np.int8)
    dead = rng.random(n) < dead_frac
    live = -rng.integers(0, 4, n).astype(np.float32) if euclid else np.zeros(n, np.float32)
    bias = np.where(dead, NEG_INF, live).astype(np.float32)
    scale = 0.0123
    scale_sq = float(np.float32((2.0 if euclid else 1.0) * scale * scale))
    return q, v, bias, scale_sq


@pytest.mark.parametrize(
    "euclid,n,blk,slots",
    [
        (False, 4096, 128, 4),
        (True, 4096, 128, 4),
        (False, 8192, 256, 8),
        (True, 16384, 4096, 4),
        (False, 16384, 4096, 16),  # more slots than blocks: empty classes
        (True, 16384, 512, 16),
    ],
)
def test_int8_plain_survivors_match_pallas_interpret(euclid, n, blk, slots):
    b, d = 8, 128
    q, v, bias, scale_sq = _int8_case(20 + n // 4096, b, n, d, euclid, 0.2)
    rs, ri = pallas_scan_survivors(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(bias), jnp.float32(scale_sq),
        blk=blk, qt=8, slots=slots, int8_mode=True, interpret=True,
    )
    rs, ri = np.asarray(rs), np.asarray(ri)
    gs, gi = fs.fused_scan_survivors_plain(
        torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(bias),
        blk=blk, slots=slots, scale_sq=scale_sq,
    )
    gs, gi = gs.numpy(), gi.numpy()
    np.testing.assert_array_equal(gi, ri)
    live = ri >= 0
    np.testing.assert_array_equal(gs[~live], rs[~live])  # NEG_INF, empty classes
    assert np.all(np.abs(gs - rs)[live] <= np.spacing(np.abs(rs[live])))
    # the ties were real: some survivor class held more than one best row
    acc = q.astype(np.int64) @ v.astype(np.int64).T
    sc = (acc.astype(np.float32) * np.float32(scale_sq)).astype(np.float32) + bias
    cls = (np.arange(n) // blk % slots) * fs.LANES + np.arange(n) % fs.LANES
    best = (sc == gs[:, cls]) & (bias > NEG_INF / 2)[None, :]
    per_class = np.stack([np.bincount(cls[row], minlength=gs.shape[1]) for row in best])
    assert (per_class > 1).sum() > 0


def test_int8_plain_survivors_break_ties_to_the_earliest_row():
    """All rows score alike: every class keeps its first row."""
    n, blk, slots = 2048, 256, 4
    q = np.ones((3, 64), np.int8)
    v = np.ones((n, 64), np.int8)
    s, i = fs.fused_scan_survivors_plain(
        torch.from_numpy(q), torch.from_numpy(v), torch.zeros(n), blk, slots, 1.0)
    lane = np.arange(fs.LANES)
    first = np.concatenate([sl * blk + lane for sl in range(slots)])
    assert (i.numpy() == first[None, :]).all() and (s.numpy() == 64.0).all()


def test_int8_wrapper_runs_plain_version_and_needs_int8_queries():
    q, v, bias, scale_sq = _int8_case(30, 8, 1024, 128, True, 0.1)
    before = (fs.fused_scan_survivors.launches, fs.fused_scan_survivors.launches_int8)
    args = (torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(bias))
    a = fs.fused_scan_survivors(*args, 128, 4, scale_sq)
    p = fs.fused_scan_survivors_plain(*args, 128, 4, scale_sq)
    assert (fs.fused_scan_survivors.launches, fs.fused_scan_survivors.launches_int8) == before
    assert torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])
    with pytest.raises(TypeError):
        fs.fused_scan_survivors(args[0].float(), *args[1:], 128, 4, scale_sq)


def test_port_scan_rescore_exact_int8():
    """tests/test_pallas_scan.py::test_pallas_scan_int8_rescore_exact through
    the port, with the JAX result as the reference as well."""
    rng = np.random.default_rng(2)
    n, d, b, k = 512, 128, 8, 5
    v = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    scale = float(np.quantile(np.abs(v), 0.99) / 127.0)
    codes = np.clip(np.round(v / scale), -127, 127).astype(np.int8)
    q_codes = np.clip(np.round(q / scale), -127, 127).astype(np.int8)
    bias = (-(v * v).sum(1)).astype(np.float32)
    scale_sq = float(np.float32(2 * scale * scale))
    s, i = fs.fused_scan_rescore(
        torch.from_numpy(q), torch.from_numpy(q_codes), torch.from_numpy(codes),
        torch.from_numpy(bias), torch.from_numpy(v), 64, k,
        blk=128, slots=4, euclid=True, scale_sq=scale_sq,
    )
    s, i = s.numpy(), i.numpy()
    rs, ri = pallas_scan_rescore(
        jnp.asarray(q), jnp.asarray(q_codes), jnp.asarray(codes), jnp.asarray(bias),
        jnp.asarray(v), 64, k, scale_sq=jnp.float32(scale_sq),
        blk=128, qt=8, slots=4, euclid=True, int8_mode=True, interpret=True,
    )
    np.testing.assert_array_equal(i, np.asarray(ri))
    np.testing.assert_allclose(s, np.asarray(rs), rtol=RTOL, atol=ATOL)
    assert _recall(i, _exact_topk(q, v, k, True)) >= 0.9
    for r in range(b):  # rescored euclid scores are exact -(q-v)^2
        for c in range(k):
            ref = -((q[r] - v[i[r, c]]) ** 2).sum()
            assert abs(s[r, c] - ref) < 1e-2


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
        (lambda q, v, b: (q, v.float(), b), TypeError),  # vectors not bf16 / int8
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
