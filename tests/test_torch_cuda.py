"""The hand-written fused scan kernels on the card (the scan, in both modes,
and the merge of its split walk) against their plain PyTorch versions (the
CPU has no CUDA kernel to run: these tests skip there).

Run on a GPU machine:  python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerance, bf16 mode: survivor scores within D * 2^-23 * max|q| * max|v|
(+2 ulp of the largest score) — a worst-case bound for summing D bf16
products in f32 in another order; ids equal wherever the winner beats the
runner-up by more. int8 mode: bit for bit (the integer dot is exact in
both, and both round the scale and the bias add separately).

The tier's torch scans, the sparse programs, the graph programs (beams and
one insert round) and the multivector max-sim are held on `cuda` against the
same functions on `cpu`.
"""

import numpy as np
import pytest
import torch

from qdrant_tpu_torch.ops import fused_scan as fs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused scan kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_tol(q, v, bias, d):
    qn, vn = float(q.float().norm(dim=1).max()), float(v.float().norm(dim=1).max())
    smax = float(bias[bias > fs.NEG_INF / 2].abs().max()) + qn * vn
    return d * 2.0 ** -23 * qn * vn + 2 * float(np.spacing(np.float32(smax)))


def _inputs(dev, b, n_pad, d, euclid, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n_pad, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    dead = rng.random(n_pad) < 0.1
    vsq = (v * v).sum(1) if euclid else np.zeros(n_pad, np.float32)
    bias = np.where(dead, fs.NEG_INF, -vsq).astype(np.float32)
    vk = torch.from_numpy(2 * v if euclid else v).to(dev).to(torch.bfloat16)
    return (torch.from_numpy(q).to(dev).to(torch.bfloat16), vk,
            torch.from_numpy(bias).to(dev))


@pytest.mark.parametrize(
    "b,n_pad,d,blk,slots,euclid",
    [
        (8, 4096, 128, 128, 4, False),
        (5, 8192, 128, 256, 4, True),  # B not a multiple of the 32-row tile
        (37, 65536, 64, 4096, 16, True),
        (256, 131072, 1536, 4096, 16, False),
        (64, 4096 * 3, 128, 4096, 16, True),  # more slots than blocks
        # rows too wide for a resident query tile: the queries stream
        (5, 8192, 12288, 1024, 4, False),
        (37, 8192, 12288, 2048, 8, True),
    ],
)
def test_kernel_matches_plain(cuda, b, n_pad, d, blk, slots, euclid):
    q, v, bias = _inputs(cuda, b, n_pad, d, euclid)
    before = fs.fused_scan_survivors.launches
    ks, ki = fs.fused_scan_survivors(q, v, bias, blk, slots)
    ps, pi = fs.fused_scan_survivors_plain(q, v, bias, blk, slots)
    torch.cuda.synchronize()
    assert fs.fused_scan_survivors.launches == before + 1
    qn, vn = float(q.float().norm(dim=1).max()), float(v.float().norm(dim=1).max())
    smax = float(bias[bias > fs.NEG_INF / 2].abs().max()) + qn * vn
    tol = d * 2.0 ** -23 * qn * vn + 2 * float(np.spacing(np.float32(smax)))
    empty = ps <= fs.NEG_INF / 2
    assert torch.equal(ks <= fs.NEG_INF / 2, empty)
    assert torch.equal(ki[empty], pi[empty])
    assert float((ks - ps).abs()[~empty].max()) <= tol
    diff = (ki != pi) & ~empty
    if diff.any():
        rows = diff.nonzero()[:, 0]
        alt = (q.float()[rows] * v.float()[ki[diff].long()]).sum(1) + bias[ki[diff].long()]
        assert float((ps[diff] - alt).abs().max()) <= tol


def test_kernel_rejects_misaligned_width(cuda):
    q, v, bias = _inputs(cuda, 8, 4096, 128, False)
    with pytest.raises(ValueError):
        fs.fused_scan_survivors(q[:, :100], v[:, :100].contiguous(), bias, 128, 4)


def test_kernel_rejects_mixed_devices(cuda):
    q, v, bias = _inputs(cuda, 8, 4096, 128, False)
    with pytest.raises(ValueError):
        fs.fused_scan_survivors(q.cpu(), v, bias, 128, 4)


@pytest.mark.parametrize(
    "b,n_pad,d,blk,slots,euclid",
    [
        (5, 8192, 128, 256, 4, True),  # B not a multiple of the 32-row tile
        (37, 65536, 1536, 4096, 16, False),
        (8, 4096 * 3, 128, 4096, 16, False),  # more slots than blocks
        (64, 65536, 1536, 2048, 16, True),
        (8, 8192, 12288, 1024, 4, False),  # the widest resident query tile
        # rows too wide for a resident query tile: the queries stream
        (5, 8192, 24576, 1024, 4, False),
        (64, 8192, 24576, 2048, 8, True),
    ],
)
def test_int8_kernel_matches_plain_bit_exact(cuda, b, n_pad, d, blk, slots, euclid):
    rng = np.random.default_rng(1)
    # small codes: integer scores tie often, and the earliest row must win
    v = torch.from_numpy(rng.integers(-8, 9, (n_pad, d)).astype(np.int8)).to(cuda)
    q = torch.from_numpy(rng.integers(-8, 9, (b, d)).astype(np.int8)).to(cuda)
    dead = rng.random(n_pad) < 0.1
    live = -rng.integers(0, 8, n_pad).astype(np.float32) if euclid else 0.0
    bias = torch.from_numpy(np.where(dead, fs.NEG_INF, live).astype(np.float32)).to(cuda)
    scale_sq = float(np.float32((2.0 if euclid else 1.0) * 0.0123 ** 2))
    before = fs.fused_scan_survivors.launches_int8
    ks, ki = fs.fused_scan_survivors(q, v, bias, blk, slots, scale_sq)
    ps, pi = fs.fused_scan_survivors_plain(q, v, bias, blk, slots, scale_sq)
    torch.cuda.synchronize()
    assert fs.fused_scan_survivors.launches_int8 == before + 1
    assert fs.scan_plan(q, v, blk, slots)["resident"] == int(d <= 12288)
    assert torch.equal(ki, pi)
    assert torch.equal(ks, ps)


def test_int8_kernel_rejects_width_not_multiple_of_64(cuda):
    q = torch.zeros((8, 96), dtype=torch.int8, device=cuda)
    v = torch.zeros((4096, 96), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        fs.fused_scan_survivors(q, v, torch.zeros(4096, device=cuda), 128, 4, 1.0)


def _small_codes(dev, b, n_pad, d, euclid, seed=1):
    rng = np.random.default_rng(seed)
    # small codes: integer scores tie often, and the earliest row must win
    v = torch.from_numpy(rng.integers(-8, 9, (n_pad, d)).astype(np.int8)).to(dev)
    q = torch.from_numpy(rng.integers(-8, 9, (b, d)).astype(np.int8)).to(dev)
    dead = rng.random(n_pad) < 0.1
    live = -rng.integers(0, 8, n_pad).astype(np.float32) if euclid else 0.0
    bias = torch.from_numpy(np.where(dead, fs.NEG_INF, live).astype(np.float32)).to(dev)
    return q, v, bias, float(np.float32((2.0 if euclid else 1.0) * 0.0123 ** 2))


# forced cuts of each slot's walk: none, a few, the chooser's, and more chunks
# than a slot has tiles (slot 0 walks 64 tiles here, slot 1 32)
CHUNKS = [1, 2, 7, None, 1000]


@pytest.mark.parametrize("chunks", CHUNKS)
def test_int8_split_walk_matches_plain_bit_exact(cuda, chunks):
    q, v, bias, scale_sq = _small_codes(cuda, 5, 4096 * 3, 128, False)
    ps, pi = fs.fused_scan_survivors_plain(q, v, bias, 4096, 2, scale_sq)
    before = fs.merge_survivors.launches
    ks, ki = fs.fused_scan_survivors(q, v, bias, 4096, 2, scale_sq, chunks=chunks)
    torch.cuda.synchronize()
    split = fs.scan_plan(q, v, 4096, 2, chunks)["chunks"] > 1
    assert fs.merge_survivors.launches == before + int(split)
    assert torch.equal(ki, pi)
    assert torch.equal(ks, ps)


@pytest.mark.parametrize("chunks", CHUNKS)
def test_bf16_split_walk_matches_plain(cuda, chunks):
    q, v, bias = _inputs(cuda, 37, 4096 * 3, 128, True)
    ps, pi = fs.fused_scan_survivors_plain(q, v, bias, 4096, 2)
    ks, ki = fs.fused_scan_survivors(q, v, bias, 4096, 2, chunks=chunks)
    torch.cuda.synchronize()
    tol = _bf16_tol(q, v, bias, 128)
    empty = ps <= fs.NEG_INF / 2
    assert torch.equal(ks <= fs.NEG_INF / 2, empty)
    assert torch.equal(ki[empty], pi[empty])
    assert float((ks - ps).abs()[~empty].max()) <= tol
    diff = (ki != pi) & ~empty
    if diff.any():
        rows = diff.nonzero()[:, 0]
        alt = (q.float()[rows] * v.float()[ki[diff].long()]).sum(1) + bias[ki[diff].long()]
        assert float((ps[diff] - alt).abs().max()) <= tol


@pytest.mark.parametrize("chunks,d", [(2, 128), (7, 128), (1000, 128), (7, 24576)])
def test_partials_match_plain_partials(cuda, chunks, d):
    """The scan kernel's own scratch, chunk by chunk, against the plain
    survivors over each chunk's rows alone (D = 24,576: streamed queries)."""
    q, v, bias, scale_sq = _small_codes(cuda, 8, 4096 * 3, d, True)
    ks, ki = fs.fused_scan_partials(q, v, bias, 4096, 2, scale_sq, chunks)
    ps, pi = fs.fused_scan_partials_plain(q, v, bias, 4096, 2, scale_sq, chunks)
    torch.cuda.synchronize()
    assert torch.equal(ki, pi)
    assert torch.equal(ks, ps)


def test_merge_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    s = rng.integers(-3, 3, (9, 13, 512)).astype(np.float32)  # ties everywhere
    s[rng.random(s.shape) < 0.2] = fs.NEG_INF
    ids = rng.integers(0, 1 << 20, s.shape).astype(np.int32)
    ids[s == fs.NEG_INF] = -1
    part_s, part_i = torch.from_numpy(s).to(cuda), torch.from_numpy(ids).to(cuda)
    before = fs.merge_survivors.launches
    ks, ki = fs.merge_survivors(part_s, part_i)
    ps, pi = fs.merge_survivors_plain(part_s, part_i)
    torch.cuda.synchronize()
    assert fs.merge_survivors.launches == before + 1
    assert torch.equal(ks, ps) and torch.equal(ki, pi)


# ---------------------------------------------------------------------------
# The torch programs of the quantized-primary tier and of sparse search: the
# same function on `cuda` and on `cpu`, same inputs. Tolerances: int8 scores
# equal (exact integer sums rounded once); f32 scores within 1e-5 relative
# (another summation order); ids equal wherever scores are further apart.
# ---------------------------------------------------------------------------


def _same_candidates(s_a, i_a, s_b, i_b, rtol):
    """Scores agree within rtol, position by position; the id sets agree
    except for ids tied (within rtol) with the last kept score, which either
    side may keep. The order among equal scores is free."""
    s_a, i_a, s_b, i_b = (t.cpu().numpy() for t in (s_a, i_a, s_b, i_b))
    np.testing.assert_allclose(s_a, s_b, rtol=rtol, atol=0)
    for row in range(s_a.shape[0]):
        score = {**dict(zip(i_a[row].tolist(), s_a[row])),
                 **dict(zip(i_b[row].tolist(), s_b[row]))}
        hits_a = set(i_a[row][np.isfinite(s_a[row])].tolist())  # -inf = no hit
        hits_b = set(i_b[row][np.isfinite(s_b[row])].tolist())
        last = s_b[row][np.isfinite(s_b[row])].min(initial=np.inf)
        for pid in hits_a ^ hits_b:
            assert abs(score[pid] - last) <= rtol * abs(last), (row, pid, score[pid], last)


@pytest.mark.parametrize("euclid", [False, True])
def test_sq_scan_on_card_equals_cpu(cuda, euclid):
    from qdrant_tpu_torch.ops import scan

    rng = np.random.default_rng(3)
    n, d = 8192 * 5, 104
    codes = torch.from_numpy(rng.integers(-127, 128, (n, d), dtype=np.int8))
    q = torch.from_numpy(rng.integers(-127, 128, (5, 100), dtype=np.int8))
    norms = torch.from_numpy(rng.random(n).astype(np.float32) * 50)
    qn = torch.from_numpy(rng.random(5).astype(np.float32) * 50)
    mask = torch.from_numpy((rng.random(n) > 0.1).astype(np.int8))
    args = (q, qn, codes, norms, 0.0123, mask)
    ref = scan.scan_search_sq_flat(*args, k=200, euclid=euclid)
    got = scan.scan_search_sq_flat(
        *(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args),
        k=200, euclid=euclid)
    assert got[0].device.type == cuda.type
    _same_candidates(*got, *ref, rtol=0.0)


def test_sq_scan_peak_memory_is_the_codes(cuda):
    """No second copy of the codes: peak memory of a scan stays under the
    codes + 10%."""
    from qdrant_tpu_torch.ops import scan

    n, d = 262_144, 1536
    gen = torch.Generator(device="cuda").manual_seed(0)
    codes = torch.randint(-127, 128, (n, d), generator=gen, device=cuda, dtype=torch.int8)
    q = torch.randint(-127, 128, (8, d), generator=gen, device=cuda, dtype=torch.int8)
    norms = torch.zeros(n, device=cuda)
    mask = torch.ones(n, dtype=torch.int8, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s, i = scan.scan_search_sq_flat(q, torch.zeros(8, device=cuda), codes, norms, 0.01,
                                    mask, k=128)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= 0.10 * codes.numel(), (extra, codes.numel())
    assert int((i >= 0).sum()) == 8 * 128


@pytest.mark.parametrize("bits,pack,bits_w", [(4, 2, 4), (2, 4, 2), (1, 8, 1)])
def test_tq_scan_on_card_equals_cpu(cuda, bits, pack, bits_w):
    from qdrant_tpu_torch.ops import quantization as qops
    from qdrant_tpu_torch.ops import scan

    rng = np.random.default_rng(4)
    n, d_pad = 8192 * 3, 256
    packed = torch.from_numpy(rng.integers(0, 256, (n, d_pad // pack), dtype=np.uint8))
    levels = torch.from_numpy(qops._lloyd_max(bits)[1].astype(np.float32))
    args = (
        torch.from_numpy(rng.standard_normal((6, d_pad)).astype(np.float32)),
        torch.from_numpy(rng.random(6).astype(np.float32)),
        packed,
        torch.from_numpy(rng.random(n).astype(np.float32) + 0.5),
        torch.from_numpy(rng.random(n).astype(np.float32)),
        levels,
        torch.from_numpy((rng.random(n) > 0.1).astype(np.int8)),
    )
    for euclid in (False, True):
        ref = scan.scan_search_tq_flat(*args, k=150, euclid=euclid, pack=pack, bits_w=bits_w)
        got = scan.scan_search_tq_flat(*(a.to(cuda) for a in args), k=150, euclid=euclid,
                                       pack=pack, bits_w=bits_w)
        _same_candidates(*got, *ref, rtol=1e-5)


def test_tf32_is_refused(cuda):
    from qdrant_tpu_torch.device import require_exact_f32_matmul

    t = torch.zeros(1, device=cuda)
    require_exact_f32_matmul(t)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            require_exact_f32_matmul(t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.get_float32_matmul_precision() == "highest"


def _zipf_rows(rng, n, vocab, nnz):
    p = 1.0 / np.arange(1, vocab + 1) ** 0.9
    p /= p.sum()
    rows = []
    for _ in range(n):
        t = np.unique(rng.choice(vocab, size=nnz, p=p))
        w = np.abs(rng.normal(1.0, 0.5, size=len(t))).astype(np.float32) + 0.01
        rows.append((t.tolist(), w.tolist()))
    return rows


def test_sparse_programs_on_card_equal_cpu(cuda, monkeypatch):
    """The hybrid search, the legacy windowed search and its forward-row
    rescore, and the hot-matrix build: the index runs them on the card; the
    captured operands, copied to the CPU, go through the same functions."""
    from qdrant_tpu_torch.index import sparse as index_sparse
    from qdrant_tpu_torch.index.sparse import SparseIndex, SparseVectorStore
    from qdrant_tpu_torch.ops import sparse as ops
    from qdrant_tpu_torch.types import SparseVector

    rng = np.random.default_rng(5)
    store = SparseVectorStore()
    store.add([SparseVector(*r) for r in _zipf_rows(rng, 6000, 500, 12)])
    queries = [SparseVector(*r) for r in _zipf_rows(rng, 9, 520, 8)]
    real = {name: getattr(ops, name) for name in (
        "sparse_hybrid_search", "sparse_search", "rescore_sparse_packed", "build_hot_matrix")}
    calls = {}

    def spy(name):
        def run(*args):
            out = real[name](*args)
            calls[name] = (args, out)
            return out
        return run

    for name in real:
        monkeypatch.setattr(ops, name, spy(name))
    # the index binds sparse_search when it is imported
    monkeypatch.setattr(index_sparse, "sparse_search", spy("sparse_search"))
    monkeypatch.setenv("QDRANT_TPU_SPARSE_HOT_BYTES", str(4 * 8192 * 128))
    index = SparseIndex(store)
    assert index._hybrid_ready() and index._hot[0].device.type == cuda.type
    index.search(queries, 10)
    monkeypatch.setenv("QDRANT_TPU_SPARSE_HOT_MAX", "0")
    legacy = SparseIndex(store)
    assert not legacy._hybrid_ready()
    legacy.search(queries, 10, window=64)
    assert set(calls) == set(real)

    def on_cpu(v):
        return v.cpu() if isinstance(v, torch.Tensor) else v

    for name, (args, out) in calls.items():
        cpu_args = [on_cpu(a) for a in args]
        if name == "build_hot_matrix":  # filled in place: start from zeros again
            cpu_args[4] = torch.zeros_like(cpu_args[4])
        ref = real[name](*cpu_args)
        if isinstance(out, tuple):
            _same_candidates(*out, *ref, rtol=1e-5)
        else:
            np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=1e-5, atol=0)


def _knn_graph(rng, n, d, m):
    """Clustered rows with a brute-force m-nearest adjacency and SQ codes."""
    centers = rng.uniform(0, 200, size=(64, d)).astype(np.float32)
    x = np.clip(centers[rng.integers(0, 64, n)]
                + 20 * rng.standard_normal((n, d)).astype(np.float32), 0, 255)
    n2 = (x * x).sum(1)
    dist = n2[:, None] - 2 * (x @ x.T) + n2[None, :]
    np.fill_diagonal(dist, np.inf)
    links = np.argsort(dist, axis=1)[:, :m].astype(np.int32)
    scale = float(np.quantile(np.abs(x), 0.99)) / 127.0
    codes = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return x, links, codes, n2.astype(np.float32), scale


def test_graph_programs_on_card_equal_cpu(cuda):
    """The level beam, the inline beam and one int8 insert round on `cuda`
    against the same functions on `cpu`. The inline beam traverses in
    integers: ids equal, rescored f32 within 1e-5 of |q|^2 + |v|^2 (its
    formula cancels). The level beam scores in f32: its ten best are equal
    (ids, scores 1e-5 relative). The insert round is integer: links equal."""
    from qdrant_tpu_torch.ops import hnsw as ops
    from qdrant_tpu_torch.ops import hnsw_build as hb
    from qdrant_tpu_torch.ops.hnsw_inline import beam_search_inline, pack_linkcodes_device

    rng = np.random.default_rng(11)
    n, d, m, b = 4000, 128, 16, 32
    x, links, codes, norms, scale = _knn_graph(rng, n, d, m)
    q = x[rng.integers(0, n, b)] + rng.standard_normal((b, d)).astype(np.float32)
    q_i8 = np.clip(np.round(q / scale), -127, 127).astype(np.int8)
    rows = n + 1  # one spare row
    links_p = np.vstack([links, np.full((1, m), -1, np.int32)])
    rank = np.arange(n, dtype=np.int32)
    entries = np.zeros((b, 1), np.int32)
    scale_sq = float(np.float32(2.0 * scale * scale))

    def on(dev, *arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    out = {}
    for dev in (cuda, torch.device("cpu")):
        qd, qi, v, l, c, nr, r, e = on(dev, q, q_i8, x, links_p, codes, norms, rank, entries)
        table = pack_linkcodes_device(l, c, nr)
        level = ops.beam_search_level(qd, v, l, e, None, 48, 112, "Euclid", compact_of=r)
        inline = beam_search_inline(qd, qi, table, scale_sq, r, v, e, None, m=m, d=d, ef=48,
                                    iters=28, expand=4, euclid=True, k=48)
        batch = np.arange(100, 356, dtype=np.int32)
        bi, ow, ent = on(dev, batch, np.append(rank, -1).astype(np.int32),
                         np.zeros(256, np.int32))
        counts = (l >= 0).sum(1).to(torch.int32)
        hb.insert_batch_level0(l, counts, bi, c[bi.long()], c, nr, r, ow, ent, scale_sq,
                               ef=48, iters=10, expand=8, m0=m, inc_cap=16, ov_cap=256,
                               euclid=True, sel_c=48, merge_forward=True)
        out[dev.type] = [t.cpu().numpy() for t in (*level, *inline, table, l, counts)]
    g, c = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(g[4], c[4])  # the packed table
    np.testing.assert_array_equal(g[3], c[3])  # inline ids
    np.testing.assert_allclose(g[2], c[2], rtol=0, atol=1e-5 * float(2 * norms.max()))
    np.testing.assert_array_equal(g[1][:, :10], c[1][:, :10])  # level beam, ten best
    np.testing.assert_allclose(g[0][:, :10], c[0][:, :10], rtol=1e-5)
    np.testing.assert_array_equal(g[5][:-1], c[5][:-1])  # links after the round
    np.testing.assert_array_equal(g[6][:-1], c[6][:-1])
    assert (g[5][:-1] != links).any()


def test_int8_dots_past_f32_exactness_on_card(cuda):
    """D = 1536 saturated codes: the chunked f32 product on the card gives
    the int32 sum, bit for bit, where one f32 sum would round."""
    from qdrant_tpu_torch.ops.hnsw_inline import int8_dots

    rng = np.random.default_rng(12)
    q = rng.choice(np.array([126, 127], np.int8), size=(4, 1536))
    codes = rng.choice(np.array([125, 126, 127], np.int8), size=(4, 64, 1536))
    exact = np.einsum("bd,bkd->bk", q.astype(np.int64), codes.astype(np.int64))
    assert exact.max() > 2 ** 24
    got = int8_dots(torch.from_numpy(q).to(cuda), torch.from_numpy(codes).to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), exact.astype(np.float32))


@pytest.mark.parametrize("distance", ["Dot", "Cosine", "Euclid", "Manhattan"])
def test_maxsim_on_card_equals_cpu(cuda, monkeypatch, distance):
    """score_multivector_maxsim on `cuda` against `cpu` (chunked over points
    on both): -inf in the same places, scores within 1e-5 relative of the
    largest (another summation order), the ten best the same modulo ties."""
    from qdrant_tpu_torch.ops import distances

    monkeypatch.setattr(distances, "MAXSIM_CHUNK_BYTES", 1 << 22)
    rng = np.random.default_rng(13)
    n, s, d, t = 3000, 64, 128, 32
    tokens = rng.standard_normal((n, s, d)).astype(np.float32)
    tmask = np.arange(s)[None, :] < rng.integers(0, 65, n)[:, None]
    valid = rng.random(n) < 0.9
    q = rng.standard_normal((t, d)).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        args = [torch.from_numpy(a).to(dev) for a in (q, tokens, tmask)]
        scores = distances.score_multivector_maxsim(
            *args, distance, torch.from_numpy(valid).to(dev))
        out[dev.type] = scores.cpu().numpy()
    g, c = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(c))
    fin = np.isfinite(c)
    np.testing.assert_allclose(g[fin], c[fin], rtol=0, atol=1e-5 * np.abs(c[fin]).max())
    top_g, top_c = np.argsort(-g, kind="stable")[:10], np.argsort(-c, kind="stable")[:10]
    np.testing.assert_allclose(np.sort(g[top_g]), np.sort(c[top_c]), rtol=1e-5)


@pytest.mark.parametrize("distance", ["Euclid", "Dot"])
def test_device_store_scan_index_on_card(cuda, distance):
    """DeviceVectorStore.scan_index() lays out the full block on the card in
    the kernel's format: the bf16 rows bit for bit those ScanIndex uploads
    from the same host rows, the bias within the last bits of |v|² (summed
    on the card there, by numpy here), pad rows past `count` invalid."""
    from qdrant_tpu_torch.ops.scan import ScanIndex
    from qdrant_tpu_torch.storage.vectors import DeviceVectorStore
    from qdrant_tpu_torch.types import Distance

    rng = np.random.default_rng(5)
    data = rng.standard_normal((384, 24)).astype(np.float32)
    store = DeviceVectorStore(torch.from_numpy(data).to(cuda), Distance(distance), count=300)
    store.delete(7)
    scan = store.scan_index()
    host = ScanIndex(data, valid_mask=~store.deleted_mask, euclid=distance == "Euclid",
                     device=cuda)
    assert scan.n == 384 and scan._v.is_cuda
    assert torch.equal(scan._v.view(torch.int16), host._v.view(torch.int16))
    np.testing.assert_allclose(scan._mask.cpu().numpy(), host._mask.cpu().numpy(), rtol=1e-6)
    assert (scan._mask.cpu().numpy()[[7, 300, 383]] < -1e38).all()
