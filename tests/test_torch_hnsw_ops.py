"""The port's graph traversal programs against the JAX ones (CPU).

One JAX-built graph per file (module scope) is carried into the port with
`convert.hnsw_index_from_jax`, so both packages walk the same adjacency; the
same numpy inputs go through the JAX function and its counterpart.

Tolerances: f32-scored beams (`greedy_descend_*`, `beam_search_level`,
`beam_search_acorn`) — scores within 1e-5 relative, ids equal wherever a
score stands clear of its neighbours by more than that (two equal scores may
swap). The inline beam traverses in integer arithmetic, so its ids are equal
and only the final f32 rescore carries the tolerance: its euclid form
2qv - |v|^2 - |q|^2 cancels, so there the 1e-5 is relative to |q|^2 + |v|^2,
the operands of the cancellation. Selections fed the same
`pair` matrix, and the packed tables, are equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qdrant_tpu.index.hnsw import HnswIndex as JaxHnswIndex
from qdrant_tpu.ops import hnsw as jax_ops
from qdrant_tpu.ops import hnsw_build as jax_build
from qdrant_tpu.ops import hnsw_inline as jax_inline
from qdrant_tpu.storage.vectors import DenseVectorStore as JaxStore
from qdrant_tpu.types import Distance as JaxDistance
from qdrant_tpu.types import HnswConfig as JaxHnswConfig
from qdrant_tpu_torch.convert import hnsw_index_from_jax
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.ops import hnsw as ops
from qdrant_tpu_torch.ops import hnsw_build as build_ops
from qdrant_tpu_torch.ops import hnsw_inline as inline_ops
from qdrant_tpu_torch.storage.vectors import DenseVectorStore
from qdrant_tpu_torch.types import Distance

force_cpu()  # the port on the CPU
# the graph programs are thousands of tiny ops: torch's worker threads only
# contend with the other test workers
torch.set_num_threads(1)

N, D, B = 2000, 24, 16
RTOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_same_beam(got_s, got_i, ref_s, ref_i, rtol=RTOL, magnitude=1.0):
    """Scores within rtol (of the score, or of `magnitude` where that is
    larger); ids equal except where equal scores may swap."""
    got_s, ref_s = np.asarray(got_s, np.float64), np.asarray(ref_s, np.float64)
    got_i, ref_i = np.asarray(got_i), np.asarray(ref_i)
    fin = np.isfinite(ref_s)
    assert np.array_equal(fin, np.isfinite(got_s))
    assert np.array_equal(got_i[~fin], ref_i[~fin])
    got_s, ref_s = np.where(fin, got_s, -1e30), np.where(fin, ref_s, -1e30)  # empty slots
    tol = rtol * np.maximum(np.abs(ref_s), magnitude)
    assert np.all(np.where(fin, np.abs(got_s - ref_s), 0.0) <= tol)
    diff = (got_i != ref_i) & fin
    pad = np.full((len(ref_s), 1), np.inf)
    near = np.minimum(np.abs(np.diff(ref_s, axis=1, prepend=pad)),
                      np.abs(np.diff(ref_s, axis=1, append=-pad))) <= 2 * tol
    assert np.all(~diff | near), f"{int((diff & ~near).sum())} ids differ at distinct scores"


@pytest.fixture(scope="module")
def graph():
    """A JAX-built euclid graph, the port's copy of it, and shared inputs."""
    rng = np.random.default_rng(5)
    centers = rng.uniform(0, 8, size=(40, D)).astype(np.float32)
    x = (centers[rng.integers(0, 40, N)] + rng.standard_normal((N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 40, B)] + rng.standard_normal((B, D))).astype(np.float32)
    jstore = JaxStore(D, JaxDistance.EUCLID)
    jstore.add(x)
    jidx = JaxHnswIndex(jstore, JaxHnswConfig(m=8, ef_construct=48), seed=3)
    jidx.build(batch_size=256)
    store = DenseVectorStore(D, Distance.EUCLID)
    store.add(x)
    idx = hnsw_index_from_jax(jidx, store)
    mask = rng.random(jstore.device_block()[0].shape[0]) < 0.3
    return {"x": x, "q": q, "jidx": jidx, "idx": idx, "mask": mask, "rng": rng}


def _descent_inputs(g):
    jidx, idx = g["jidx"], g["idx"]
    jv = jidx.store.device_block()[0]
    v = idx.store.device_block()[0]
    np.testing.assert_array_equal(np.asarray(jv), v.numpy())
    cur = np.full(B, jidx.entry, np.int32)
    js = jax_ops.score_ids_batch(jnp.asarray(g["q"]), jv, jnp.asarray(cur)[:, None], "Euclid")[:, 0]
    ps = ops.score_ids_batch(t(g["q"]), v, t(cur)[:, None], "Euclid")[:, 0]
    return jv, v, cur, js, ps


def test_carried_graph_is_the_jax_graph(graph):
    jidx, idx = graph["jidx"], graph["idx"]
    assert idx.entry == jidx.entry and idx.max_level == jidx.max_level >= 1
    assert idx.level_counts == jidx.level_counts
    np.testing.assert_array_equal(idx.links0, jidx.links0)
    np.testing.assert_array_equal(idx.links_upper, jidx.links_upper)
    np.testing.assert_array_equal(idx._rank_device().numpy(), np.asarray(jidx._rank_device()))


def test_greedy_descend_level_and_stack(graph):
    jidx, idx = graph["jidx"], graph["idx"]
    jv, v, cur, js, ps = _descent_inputs(graph)
    jq, pq = jnp.asarray(graph["q"]), t(graph["q"])
    ji, jsc = jax_ops.greedy_descend_level(
        jq, jv, jidx._upper_device()[0], jidx._rank_device(), jnp.asarray(cur), js, "Euclid")
    pi, psc = ops.greedy_descend_level(
        pq, v, idx._upper_device()[0], idx._rank_device(), t(cur), ps, "Euclid")
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), rtol=RTOL)
    ji, jsc = jax_ops.greedy_descend_stack(
        jq, jv, jidx._upper_device(), jidx._rank_device(), jidx._stack_counts(),
        jnp.asarray(cur), js, "Euclid")
    pi, psc = ops.greedy_descend_stack(
        pq, v, idx._upper_device(), idx._rank_device(), idx._stack_counts(), t(cur), ps,
        "Euclid")
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(psc.numpy(), np.asarray(jsc), rtol=RTOL)
    assert len(set(pi.tolist())) > 1  # the descent moved the queries apart


@pytest.mark.parametrize("masked", [False, True], ids=["unfiltered", "masked"])
@pytest.mark.parametrize("expand", [1, 4])
def test_beam_search_level(graph, masked, expand):
    jidx, idx = graph["jidx"], graph["idx"]
    jv, v, cur, _, _ = _descent_inputs(graph)
    entries = np.stack([cur, np.arange(B, dtype=np.int32) * 7], axis=1)
    jm = jnp.asarray(graph["mask"]) if masked else None
    pm = t(graph["mask"]) if masked else None
    js, ji = jax_ops.beam_search_level(
        jnp.asarray(graph["q"]), jv, jidx._links0_device(), jnp.asarray(entries), jm,
        32, 80, "Euclid", compact_of=jidx._rank_device(), expand=expand)
    ps, pi = ops.beam_search_level(
        t(graph["q"]), v, idx._links0_device(), t(entries), pm, 32, 80, "Euclid",
        compact_of=idx._rank_device(), expand=expand)
    assert_same_beam(ps.numpy(), pi.numpy(), js, ji)
    assert np.isfinite(ps.numpy()).all()


def test_beam_search_acorn(graph):
    jidx, idx = graph["jidx"], graph["idx"]
    jv, v, cur, _, _ = _descent_inputs(graph)
    entries = cur[:, None]
    js, ji = jax_ops.beam_search_acorn(
        jnp.asarray(graph["q"]), jv, jidx._links0_device(), jnp.asarray(entries),
        jnp.asarray(graph["mask"]), 32, 80, "Euclid", compact_of=jidx._rank_device())
    ps, pi = ops.beam_search_acorn(
        t(graph["q"]), v, idx._links0_device(), t(entries), t(graph["mask"]), 32, 80,
        "Euclid", compact_of=idx._rank_device())
    assert_same_beam(ps.numpy(), pi.numpy(), js, ji)
    got = pi.numpy()
    assert graph["mask"][got[got >= 0]].all()  # only matching ids are returned


@pytest.mark.parametrize("program", ["level", "acorn", "inline", "inline_filtered", "descend"])
def test_early_stop_equals_all_turns(graph, program):
    """Reading the stop flag every 4 turns, every turn, or never (all `iters`
    turns run) gives equal beams: a loop body changes nothing once no
    candidate is left."""
    idx = graph["idx"]
    _, v, cur, _, ps = _descent_inputs(graph)
    q, links, rank = t(graph["q"]), idx._links0_device(), idx._rank_device()
    mask = t(graph["mask"])

    def run(check_every):
        if program == "level":
            return ops.beam_search_level(q, v, links, t(cur)[:, None], mask, 24, 200,
                                         "Euclid", compact_of=rank, check_every=check_every)
        if program == "acorn":
            return ops.beam_search_acorn(q, v, links, t(cur)[:, None], mask, 24, 200,
                                         "Euclid", compact_of=rank, check_every=check_every)
        if program == "descend":
            return ops.greedy_descend_level(q, v, idx._upper_device()[-1], rank, t(cur), ps,
                                            "Euclid", check_every=check_every)[::-1]
        table, scale, q_i8 = _inline_inputs(graph, D)
        bias = None
        if program == "inline_filtered":
            bias = torch.where(mask, 0.0, float("-inf"))
        return inline_ops.beam_search_inline(
            q, t(q_i8), t(table), 2.0 * scale * scale, rank, v, t(cur)[:, None], bias,
            m=idx.config.m0, d=D, ef=24, iters=60, expand=4, euclid=True, k=24,
            check_every=check_every)

    full = run(None)
    for every in (1, 4):
        got = run(every)
        assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])


def _inline_inputs(g, d):
    """SQ codes of the graph's rows, the packed table and int8 queries."""
    x = g["x"]
    scale = float(np.quantile(np.abs(x), 0.99)) / 127.0
    cap = g["idx"].store.device_block()[0].shape[0]
    codes = np.zeros((cap, d), np.int8)
    codes[:N] = np.clip(np.round(x / scale), -127, 127)
    norms = np.zeros(cap, np.float32)
    norms[:N] = (x * x).sum(1)
    table = inline_ops.pack_linkcodes(g["idx"].links0, codes, norms)
    g.setdefault("_codes", (codes, norms))
    return table, scale, np.clip(np.round(g["q"] / scale), -127, 127).astype(np.int8)


def test_pack_linkcodes_bytes_equal(graph):
    table, _, _ = _inline_inputs(graph, D)
    codes, norms = graph["_codes"]
    links = graph["idx"].links0
    np.testing.assert_array_equal(table, jax_inline.pack_linkcodes(links, codes, norms))
    on_dev = inline_ops.pack_linkcodes_device(t(links), t(codes), t(norms))
    ref = jax_inline.pack_linkcodes_device(jnp.asarray(links), jnp.asarray(codes),
                                           jnp.asarray(norms))
    np.testing.assert_array_equal(on_dev.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(on_dev.numpy(), table)
    rows = np.array([3, 0, 77])
    np.testing.assert_array_equal(
        inline_ops.pack_linkcode_rows(links[rows], codes, norms), table[rows])


@pytest.mark.parametrize("filtered", [False, True], ids=["unfiltered", "filtered"])
def test_beam_search_inline_on_the_graph(graph, filtered):
    jidx, idx = graph["jidx"], graph["idx"]
    jv, v, cur, _, _ = _descent_inputs(graph)
    table, scale, q_i8 = _inline_inputs(graph, D)
    scale_sq = np.float32(2.0 * scale * scale)
    bias = np.where(graph["mask"], 0.0, -np.inf).astype(np.float32)
    kw = dict(m=idx.config.m0, d=D, ef=32, iters=24, expand=4, euclid=True, k=32)
    js, ji = jax_inline.beam_search_inline(
        jnp.asarray(graph["q"]), jnp.asarray(q_i8), jnp.asarray(table), jnp.float32(scale_sq),
        jidx._rank_device(), jv, jnp.asarray(cur)[:, None],
        jnp.asarray(bias) if filtered else None, **kw)
    ps, pi = inline_ops.beam_search_inline(
        t(graph["q"]), t(q_i8), t(table), float(scale_sq), idx._rank_device(), v,
        t(cur)[:, None], t(bias) if filtered else None, **kw)
    x, q = graph["x"], graph["q"]
    assert_same_beam(ps.numpy(), pi.numpy(), js, ji,
                     magnitude=float((x * x).sum(1).max() + (q * q).sum(1).max()))
    if filtered:
        got = pi.numpy()
        assert graph["mask"][got[got >= 0]].all()


def test_beam_search_inline_wide_rows_past_f32_exactness():
    """D = 1536 with saturated codes: integer dots pass 2^24, where an f32
    sum would round; the port's chunked product must give the int32 sum the
    JAX program gives, so the traversal (ids) is equal."""
    rng = np.random.default_rng(8)
    n, d, m, b = 192, 1536, 8, 8
    x = rng.choice(np.array([-1.0, 1.0], np.float32), size=(n, d)) * rng.uniform(
        0.9, 1.0, size=(n, d)).astype(np.float32)
    x[:, : d // 2] = np.abs(x[:, : d // 2])  # correlated rows: large dots
    sims = x @ x.T
    np.fill_diagonal(sims, -np.inf)
    links = np.argsort(-sims, axis=1)[:, :m].astype(np.int32)
    scale = 1.0 / 127.0
    codes = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    norms = (x * x).sum(1).astype(np.float32)
    assert np.abs(codes.astype(np.int64) @ codes[0].astype(np.int64)).max() > 2 ** 24
    table = inline_ops.pack_linkcodes(links, codes, norms)
    q = x[rng.integers(0, n, b)] + 0.05 * rng.standard_normal((b, d)).astype(np.float32)
    q_i8 = np.clip(np.round(q / scale), -127, 127).astype(np.int8)
    compact = np.arange(n, dtype=np.int32)
    entries = np.zeros((b, 1), np.int32)
    kw = dict(m=m, d=d, ef=24, iters=16, expand=4, euclid=False, k=24)
    js, ji = jax_inline.beam_search_inline(
        jnp.asarray(q), jnp.asarray(q_i8), jnp.asarray(table), jnp.float32(scale * scale),
        jnp.asarray(compact), jnp.asarray(x), jnp.asarray(entries), None, **kw)
    ps, pi = inline_ops.beam_search_inline(
        t(q), t(q_i8), t(table), float(np.float32(scale * scale)), t(compact), t(x),
        t(entries), None, **kw)
    assert_same_beam(ps.numpy(), pi.numpy(), js, ji)
    # and the product itself, bit for bit, against the integer sum
    cand = t(codes[links[:b]])  # [b, m, d]
    exact = (codes[links[:b]].astype(np.int64) @ q_i8[0].astype(np.int64)).astype(np.float32)
    got = inline_ops.int8_dots(t(np.repeat(q_i8[:1], b, 0)), cand).numpy()
    np.testing.assert_array_equal(got, exact)
    assert np.abs(exact).max() > 2 ** 24


def _selection_inputs(rng, b=12, c=20):
    """Candidates sorted by score desc with -1 padding and a random pair
    matrix whose gaps are far above 1e-4."""
    scores = -np.sort(rng.uniform(1, 50, size=(b, c)).astype(np.float32), axis=1)
    ids = rng.permutation(1000)[: b * c].reshape(b, c).astype(np.int32)
    n_valid = rng.integers(3, c + 1, size=b)
    pad = np.arange(c)[None, :] >= n_valid[:, None]
    ids[pad] = -1
    scores[pad] = -np.inf
    pair = -rng.uniform(1, 50, size=(b, c, c)).astype(np.float32)
    return ids, scores, pair


@pytest.mark.parametrize("m", [6, 32])
def test_selection_heuristics_equal(m):
    rng = np.random.default_rng(9)
    ids, scores, pair = _selection_inputs(rng)
    ref = jax_ops.heuristic_select(jnp.asarray(ids), jnp.asarray(scores), jnp.asarray(pair), m)
    got = ops.heuristic_select(t(ids), t(scores), t(pair), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for fill in (False, True):
        ref = jax_build._heuristic_select(
            jnp.asarray(ids), jnp.asarray(scores), jnp.asarray(pair), m, fill=fill)
        got = build_ops._heuristic_select(t(ids), t(scores), t(pair), m, fill=fill)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # unsorted scores for the plain selection, with ties broken by position
    scores[:, 3] = scores[:, 2]
    ref = jax_ops.simple_select(jnp.asarray(ids), jnp.asarray(scores), m)
    np.testing.assert_array_equal(ops.simple_select(t(ids), t(scores), m).numpy(),
                                  np.asarray(ref))


def test_select_neighbors_and_reprune_rows(graph):
    """On a lattice of well-separated points every score gap exceeds 1e-4,
    so both packages must select the same neighbours."""
    rng = np.random.default_rng(10)
    n, d = 400, 6
    x = (rng.integers(0, 9, size=(n, d)) * 3.0 + rng.uniform(-1, 1, size=(n, d))).astype(
        np.float32)
    b, c = 10, 24
    q = x[:b] + 0.3
    dist = -((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    order = np.argsort(-dist, axis=1)[:, :c].astype(np.int32)
    cand_scores = np.take_along_axis(dist, order, axis=1).astype(np.float32)
    order[:, -3:] = -1
    cand_scores[:, -3:] = -np.inf
    ref = jax_ops.select_neighbors(jnp.asarray(order), jnp.asarray(cand_scores),
                                   jnp.asarray(x), 8, "Euclid")
    got = ops.select_neighbors(t(order), t(cand_scores), t(x), 8, "Euclid")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    nb = np.arange(b, dtype=np.int32) + 50
    cands = rng.permutation(n)[: b * c].reshape(b, c).astype(np.int32)
    cands[:, -4:] = -1
    for distance in ("Euclid", "Dot"):
        ref = jax_ops.reprune_rows(jnp.asarray(nb), jnp.asarray(cands), jnp.asarray(x), 8,
                                   distance)
        got = ops.reprune_rows(t(nb), t(cands), t(x), 8, distance)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_scatter_link_rows_and_topk_first():
    links = torch.full((6, 3), -1, dtype=torch.int32)
    out = ops.scatter_link_rows(links, [4, 1], [[1, 2, 3], [7, -1, -1]])
    assert out is links and links[4].tolist() == [1, 2, 3] and links[1].tolist() == [7, -1, -1]
    s = torch.tensor([[1.0, 3.0, 3.0, -np.inf, 3.0, -np.inf]])
    vals, idx = ops.topk_first(s, 5)
    assert idx.tolist() == [[1, 2, 4, 0, 3]]  # equal scores in index order, as lax.top_k
    assert vals.tolist()[0][:4] == [3.0, 3.0, 3.0, 1.0]
    dup = ops.dup_earlier(torch.tensor([[5, 2, 5, -1, 2, -1]]))
    assert dup.tolist() == [[False, False, True, False, True, True]]
