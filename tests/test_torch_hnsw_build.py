"""The port's graph builder and HnswIndex against the JAX ones (CPU).

* `insert_batch_level0`: one round from the same state. With int8 codes the
  whole round is integer arithmetic, so links and counts are equal (the spare
  last row excluded); with bf16 codes the f32 sums may differ in their order,
  so at least 99% of the rows are equal. Also with `merge_forward`.
* `heal_low_indegree_device`: equal except where several weak nodes meet in
  one slot (both packages are order-undefined there): the slot holds one of
  the contenders.
* `HnswIndex.build`: level assignment, rank, entry, level counts and the
  seed graph are seeded numpy and equal exactly; the full graph is compared
  by recall@10 at ef 64 against exact, port >= JAX - 0.03: here for the
  host-orchestrated builder (the CPU's default), in test_torch_hnsw_index.py
  for the device builder, which imports this file's helpers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qdrant_tpu.index.hnsw import HnswIndex as JaxHnswIndex
from qdrant_tpu.ops import hnsw_build as jax_build
from qdrant_tpu.ops import quantization as jax_qops
from qdrant_tpu.storage.vectors import DenseVectorStore as JaxStore
from qdrant_tpu.types import Distance as JaxDistance
from qdrant_tpu.types import HnswConfig as JaxHnswConfig
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.index.hnsw import HnswIndex
from qdrant_tpu_torch.ops import hnsw_build as build_ops
from qdrant_tpu_torch.storage.vectors import DenseVectorStore
from qdrant_tpu_torch.types import Distance, HnswConfig

force_cpu()  # the port on the CPU
# the graph programs are thousands of tiny ops: torch's worker threads only
# contend with the other test workers
torch.set_num_threads(1)

N, D = 1600, 16


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def clustered(rng, n, d, n_q=48):
    centers = rng.uniform(0, 8, size=(32, d)).astype(np.float32)
    x = (centers[rng.integers(0, 32, n)] + rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, 32, n_q)] + rng.standard_normal((n_q, d))).astype(np.float32)
    return x, q


def recall_at_10(ids, x, q, distance, alive=None):
    if distance == "Euclid":
        s = -((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    else:
        xn = x / np.linalg.norm(x, axis=1, keepdims=True) if distance == "Cosine" else x
        s = q @ xn.T
    if alive is not None:
        s[:, ~alive] = -np.inf
    truth = np.argsort(-s, axis=1)[:, :10]
    return float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ids.tolist(), truth.tolist())]))


@pytest.fixture(scope="module")
def state():
    """A JAX-built graph over half the rows (the other half is inserted by
    the rounds under test) and the codes both packages score with."""
    rng = np.random.default_rng(21)
    x, q = clustered(rng, N, D)
    jstore = JaxStore(D, JaxDistance.EUCLID)
    jstore.add(x)
    half = np.arange(N // 2, dtype=np.int32)
    jidx = JaxHnswIndex(jstore, JaxHnswConfig(m=8, ef_construct=48), seed=2, subset=half)
    jidx.build(batch_size=256)
    # every row gets a table row: the built half keeps its rank, the rest follow
    rank = jidx.rank.copy()
    rest = np.flatnonzero(rank < 0)
    rank[rest] = np.arange(len(rest), dtype=np.int32) + (N // 2)
    rows = 2048  # > N + 1: the last row is the spare
    links = np.full((rows, 16), -1, np.int32)
    links[: jidx.links0.shape[0]] = jidx.links0[: rows]
    cap = jstore.device_block()[0].shape[0]
    sq = jax_qops.ScalarQuantized.encode(x)
    codes = np.zeros((cap, D), np.int8)
    codes[:N] = sq.codes
    norms = np.zeros(cap, np.float32)
    norms[:N] = sq.norms_sq
    rank_cap = np.full(cap, -1, np.int32)
    rank_cap[:N] = rank
    owner = np.full(rows, -1, np.int32)
    owner[rank] = np.arange(N, dtype=np.int32)
    return {"x": x, "q": q, "jidx": jidx, "links": links, "codes": codes, "norms": norms,
            "scale": sq.scale, "rank": rank_cap, "owner": owner, "rng": rng}


def _round(st, codes_kind, merge_forward, batch):
    """One insert round in both packages from the same state."""
    links = st["links"]
    counts = (links >= 0).sum(1).astype(np.int32)
    b = len(batch)
    entries = np.full(b, st["jidx"].entry, np.int32)
    if codes_kind == "int8":
        jcodes, pcodes = jnp.asarray(st["codes"]), t(st["codes"])
        scale_sq = np.float32(2.0 * st["scale"] * st["scale"])
    else:
        full = np.zeros((len(st["codes"]), D), np.float32)
        full[:N] = st["x"]
        pcodes = t(full).to(torch.bfloat16)
        jcodes = jnp.asarray(full).astype(jnp.bfloat16)
        scale_sq = np.float32(2.0)
    safe = np.maximum(batch, 0)
    kw = dict(ef=48, iters=10, expand=8, m0=16, inc_cap=16, ov_cap=b, euclid=True,
              sel_c=48, merge_forward=merge_forward)
    jl, jc, jbeam = jax_build.insert_batch_level0(
        jnp.asarray(links), jnp.asarray(counts), jnp.asarray(batch),
        jnp.where(jnp.asarray(batch)[:, None] >= 0, jcodes[safe], 0), jcodes,
        jnp.asarray(st["norms"]), jnp.asarray(st["rank"]), jnp.asarray(st["owner"]),
        jnp.asarray(entries), jnp.float32(scale_sq), **kw)
    pl, pc = t(links.copy()), t(counts.copy())
    q_codes = torch.where(t(batch)[:, None] >= 0, pcodes[t(safe).long()], 0)
    out = build_ops.insert_batch_level0(
        pl, pc, t(batch), q_codes, pcodes, t(st["norms"]), t(st["rank"]), t(st["owner"]),
        t(entries), float(scale_sq), **kw)
    assert out[0] is pl and out[1] is pc  # updated in place
    return (np.asarray(jl), np.asarray(jc), np.asarray(jbeam)), (
        pl.numpy(), pc.numpy(), out[2].numpy())


@pytest.mark.parametrize("merge_forward", [False, True], ids=["insert", "merge_forward"])
def test_insert_batch_level0_int8_equal(state, merge_forward):
    # new points (or, for the refine mode, points already in the graph), -1 padded
    lo = 0 if merge_forward else N // 2
    batch = np.full(256, -1, np.int32)
    batch[:200] = np.arange(lo, lo + 200)
    (jl, jc, jbeam), (pl, pc, pbeam) = _round(state, "int8", merge_forward, batch)
    np.testing.assert_array_equal(pbeam, jbeam)
    np.testing.assert_array_equal(pl[:-1], jl[:-1])
    np.testing.assert_array_equal(pc[:-1], jc[:-1])
    assert (pl[-1] == -1).all() and pc[-1] == 0  # the spare row is wiped
    changed = (pl != state["links"]).any(1).sum()
    assert changed > 200  # forward rows and reverse links were written


def test_insert_batch_level0_bf16_rows_equal(state):
    batch = np.arange(N // 2, N // 2 + 256, dtype=np.int32)
    (jl, jc, _), (pl, pc, _) = _round(state, "bf16", False, batch)
    same = (pl[:-1] == jl[:-1]).all(1)
    assert same.mean() >= 0.99, f"only {same.mean():.4f} of the rows are equal"
    assert (pc[:-1] == jc[:-1]).mean() >= 0.99
    written = (pl != state["links"]).any(1)
    assert written.sum() > 256 and same[written[:-1]].mean() >= 0.9


def test_heal_low_indegree_device(state):
    rng = np.random.default_rng(22)
    links = state["links"].copy()
    # starve 60 built nodes of their incoming links
    weak = rng.choice(N // 2, size=60, replace=False)
    links[np.isin(links, weak)] = -1
    counts = (links >= 0).sum(1).astype(np.int32)
    jl, jc = jax_build.heal_low_indegree_device(
        jnp.asarray(links), jnp.asarray(counts), jnp.asarray(state["rank"]),
        jnp.asarray(state["owner"]), m0=16)
    pl, pc = t(links.copy()), t(counts.copy())
    build_ops.heal_low_indegree_device(pl, pc, t(state["rank"]), t(state["owner"]), m0=16)
    jl, pl = np.asarray(jl), pl.numpy()
    # contenders per (row, slot): every weak node's forced writes
    indeg = np.bincount(state["rank"][links[links >= 0]], minlength=len(links))
    window, contenders = max(16 // 4, 6), {}
    for row in np.flatnonzero((indeg < 8) & (state["owner"] >= 0)):
        for j, tgt in enumerate(links[row, :6]):
            if tgt >= 0:
                key = (int(state["rank"][tgt]), 16 - 1 - ((row + j) % window))
                contenders.setdefault(key, set()).add(int(state["owner"][row]))
    assert contenders
    differ = np.argwhere(pl != jl)
    for r, s in differ:
        assert len(contenders[(int(r), int(s))]) > 1
    for (r, s), who in contenders.items():
        assert pl[r, s] in who and jl[r, s] in who
    untouched = np.ones_like(pl, dtype=bool)
    for r, s in contenders:
        untouched[r, s] = False
    np.testing.assert_array_equal(pl[untouched], links[untouched])
    np.testing.assert_array_equal(pc.numpy(), (pl >= 0).sum(1))


def _pair(distance, x, deleted=(), subset=None, m=8, efc=24, seed=4):
    jstore = JaxStore(x.shape[1], JaxDistance(distance))
    jstore.add(x)
    store = DenseVectorStore(x.shape[1], Distance(distance))
    store.add(x)
    for off in deleted:
        jstore.delete(int(off))
        store.delete(int(off))
    jidx = JaxHnswIndex(jstore, JaxHnswConfig(m=m, ef_construct=efc), seed=seed, subset=subset)
    idx = HnswIndex(store, HnswConfig(m=m, ef_construct=efc), seed=seed, subset=subset)
    return jidx, idx


def build_case(distance, variant, n=900, d=D, seed=23):
    """Both packages' indexes over the same rows, built → (jidx, idx, q,
    alive). Dot rows are unit-normalised (an embedding collection); on raw
    clustered rows the largest norms win every query and recall says little."""
    rng = np.random.default_rng(seed)
    x, q = clustered(rng, n, d)
    if distance == "Dot":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    deleted = rng.choice(n, size=n // 12, replace=False) if variant == "deleted" else ()
    subset = np.sort(rng.choice(n, size=n * 2 // 3, replace=False)).astype(np.int32) \
        if variant == "subset" else None
    jidx, idx = _pair(distance, x, deleted, subset)
    jidx.build(batch_size=256)
    idx.build(batch_size=256)
    alive = np.ones(n, bool)
    alive[list(deleted)] = False
    if subset is not None:
        alive[:] = False
        alive[subset] = True
    return jidx, idx, q, alive


def assert_built_like_jax(jidx, idx, q, alive, distance):
    # seeded numpy: equal exactly
    np.testing.assert_array_equal(idx.levels, jidx.levels)
    np.testing.assert_array_equal(idx.rank, jidx.rank)
    assert (idx.entry, idx.max_level, idx.level_counts) == (
        jidx.entry, jidx.max_level, jidx.level_counts)
    assert idx.links0.shape == jidx.links0.shape
    assert idx.links_upper.shape == jidx.links_upper.shape
    assert ((idx.levels >= 0) == alive).all()
    links = idx.links0
    assert set(np.unique(links[links >= 0]).tolist()) <= set(np.flatnonzero(alive).tolist())
    assert idx.build_stats["seconds"] > 0
    xs = idx.store.host_array
    _, jids = jidx.search(q, 10, ef=64)
    _, pids = idx.search(q, 10, ef=64)
    r_jax = recall_at_10(jids, xs, q, distance, alive)
    r_port = recall_at_10(pids, xs, q, distance, alive)
    assert r_port >= r_jax - 0.03, (r_port, r_jax)
    assert r_port >= 0.85


@pytest.mark.parametrize("distance", ["Euclid", "Cosine", "Dot"])
def test_host_build_matches_jax(monkeypatch, distance):
    monkeypatch.setenv("QDRANT_TPU_DEVICE_BUILD", "1")  # the CPU's default builder
    jidx, idx, q, alive = build_case(distance, "plain")
    assert idx.build_stats["device_build"] is False
    assert_built_like_jax(jidx, idx, q, alive, distance)


def test_seed_graph_equal(monkeypatch):
    """A store no larger than the seed set is linked by the host's all-pairs
    heuristic alone: the whole graph is equal."""
    monkeypatch.setenv("QDRANT_TPU_DEVICE_BUILD", "0")
    rng = np.random.default_rng(24)
    x, _ = clustered(rng, 200, D)
    jidx, idx = _pair("Cosine", x)
    jidx.build()
    idx.build()
    # the healer is host numpy over the same links in both
    np.testing.assert_array_equal(idx.links0, jidx.links0)
    np.testing.assert_array_equal(idx.links_upper, jidx.links_upper)
    np.testing.assert_array_equal(idx.counts0, jidx.counts0)


def _beam_inputs(dtype, d, width, b=8, n=400, seed=0):
    """A beam's inputs on the CPU: random codes, `width` random links a row
    with holes and a spare row, every point ranked, random entries."""
    rng = np.random.default_rng(seed)
    if dtype == torch.int8:
        codes = t(rng.integers(-127, 128, (n, d)).astype(np.int8))
        scale_sq = 0.02
    else:
        codes = t(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
        scale_sq = 2.0
    norms = (codes.float() ** 2).sum(1) * scale_sq / 2
    links = rng.integers(0, n, (n + 1, width)).astype(np.int32)
    links[rng.random(links.shape) < 0.1] = -1
    links[-1] = -1
    q = codes[t(rng.integers(0, n, b)).long()].clone()
    entries = t(rng.integers(0, n, b).astype(np.int32))
    return q, codes, norms, t(links), t(np.arange(n, dtype=np.int32)), entries, scale_sq


@pytest.mark.parametrize(
    "dtype,d,width,ef,expand",
    [
        (torch.bfloat16, 1536, 40, 128, 8),  # dbpedia's level 0
        (torch.int8, 128, 20, 128, 8),  # an upper level
        (torch.bfloat16, 100, 40, 128, 8),  # glove-100
        (torch.int8, 99, 16, 48, 4),  # rows of an odd byte count
        (torch.bfloat16, 7, 3, 16, 2),
        (torch.bfloat16, 128, 128, 128, 8),  # m 64: m0 128
        (torch.bfloat16, 128, 40, 600, 8),  # ef_construct past 512
        (torch.int8, 128, 40, 128, 17),
        (torch.int8, 1536, 64, 256, 16),
        (torch.bfloat16, 16, 8, 48, 4),
        (torch.int8, 16, 16, 48, 8),
    ],
)
def test_cpu_beam_is_the_plain_version(monkeypatch, dtype, d, width, ef, expand):
    """On the CPU the construction beam is `_beam_construct_plain` at every
    shape, those the kernel runs on the card included: the kernel is never
    called and `build.beam_kernel` does not move."""
    from qdrant_tpu_torch.utils import tracing

    def no_kernel(*a, **k):
        raise AssertionError("the beam kernel ran on the CPU")

    args = _beam_inputs(dtype, d, width)
    want_s, want_i = build_ops._beam_construct_plain(*args, True, ef, 10, expand)
    monkeypatch.setattr(build_ops, "beam_construct_kernel", no_kernel)
    before = tracing.counters().get("build.beam_kernel", 0)
    got_s, got_i = build_ops._beam_construct(*args, True, ef, 10, expand)
    assert tracing.counters().get("build.beam_kernel", 0) == before
    np.testing.assert_array_equal(got_i.numpy(), want_i.numpy())
    np.testing.assert_array_equal(got_s.numpy(), want_s.numpy())
    assert (got_i[:, 0] >= 0).all()


def _refuse(name):
    """The beam kernel's inputs with one fault, on the CPU."""
    q, codes, norms, links, rank, entries, scale_sq = _beam_inputs(torch.int8, 16, 16)
    kw = dict(ef=48, iters=10, expand=8)
    if name == "f32_codes":
        q, codes = q.float(), codes.float()
    elif name == "query_type":
        q = q.to(torch.bfloat16)
    elif name == "query_width":
        q = q[:, :8]
    elif name == "int64_links":
        links = links.long()
    elif name == "no_ef":
        kw["ef"] = 0
    elif name == "no_expand":
        kw["expand"] = 0
    return (q, codes, norms, links, rank, entries, scale_sq, True), kw


def test_beam_kernel_refuses_cpu_tensors(state):
    """The kernel's wrapper raises on what it does not take: it never falls
    back to the plain version."""
    q = t(state["codes"][:8])
    with pytest.raises(ValueError):
        build_ops.beam_construct_kernel(
            q, t(state["codes"]), t(state["norms"]), t(state["links"]), t(state["rank"]),
            torch.zeros(8, dtype=torch.int32), 1.0, True, 48, 10, 8)


@pytest.mark.parametrize("name", ["f32_codes", "query_type", "query_width", "int64_links",
                                  "no_ef", "no_expand"])
def test_beam_kernel_refuses_what_it_does_not_take(name):
    """The kernel's wrapper raises on inputs it cannot run, whatever their
    device: codes other than bf16 or int8, queries of another type or width,
    links not int32, no beam, no picks."""
    args, kw = _refuse(name)
    with pytest.raises((ValueError, TypeError)):
        build_ops.beam_construct_kernel(*args, **kw)


def test_cpu_rounds_take_the_plain_beam(state):
    """On the CPU every insert round's beam is the plain version: the rounds
    count, the kernel's rounds do not, and the round's beam is
    `_beam_construct_plain`'s."""
    from qdrant_tpu_torch.utils import tracing

    before = tracing.counters()
    batch = np.arange(N // 2, N // 2 + 64, dtype=np.int32)
    _, (_, _, pbeam) = _round(state, "int8", False, batch)
    after = tracing.counters()
    assert after["build.insert_rounds"] == before.get("build.insert_rounds", 0) + 1
    assert after.get("build.beam_kernel", 0) == before.get("build.beam_kernel", 0)
    codes = t(state["codes"])
    entries = torch.full((64,), int(state["jidx"].entry), dtype=torch.int32)
    scale_sq = float(np.float32(2.0 * state["scale"] * state["scale"]))
    _, ids = build_ops._beam_construct_plain(
        codes[t(batch).long()], codes, t(state["norms"]), t(state["links"]), t(state["rank"]),
        entries, scale_sq, True, 48, 10, 8)
    np.testing.assert_array_equal(pbeam, ids.numpy())
