"""The port's HnswIndex against the JAX one (CPU): the device builder
(`QDRANT_TPU_DEVICE_BUILD=force`, as the JAX tests force it) for Euclid,
Cosine and Dot, with deleted points and with `subset=`; persistence both ways
in the same files; the inline table's gate and the three level-0 programs.

Levels, rank, entry and level counts are seeded numpy and equal exactly; a
full graph is compared by recall@10 at ef 64 against exact, port >= JAX -
0.03 (helpers in test_torch_hnsw_build.py).
"""

import numpy as np
import pytest
import torch

from qdrant_tpu.index.hnsw import HnswIndex as JaxHnswIndex
from qdrant_tpu_torch.convert import hnsw_index_from_jax
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.index.hnsw import load_hnsw_any
from qdrant_tpu_torch.storage.vectors import DenseVectorStore
from qdrant_tpu_torch.types import Distance, HnswConfig

from test_torch_hnsw_build import (
    D,
    _pair,
    assert_built_like_jax,
    build_case,
    clustered,
    recall_at_10,
)

force_cpu()  # the port on the CPU
# the graph programs are thousands of tiny ops: torch's worker threads only
# contend with the other test workers
torch.set_num_threads(1)


@pytest.mark.parametrize(
    "distance,variant",
    [("Euclid", "plain"), ("Cosine", "plain"), ("Dot", "plain"), ("Euclid", "deleted"),
     ("Euclid", "subset")],
)
def test_device_build_matches_jax(monkeypatch, distance, variant):
    monkeypatch.setenv("QDRANT_TPU_DEVICE_BUILD", "force")
    jidx, idx, q, alive = build_case(distance, variant)
    assert idx.build_stats["device_build"] is True
    assert sum(idx.build_stats["batches"].values()) >= 2
    assert_built_like_jax(jidx, idx, q, alive, distance)


def test_persistence_both_ways(tmp_path, monkeypatch):
    monkeypatch.setenv("QDRANT_TPU_DEVICE_BUILD", "force")
    rng = np.random.default_rng(25)
    x, q = clustered(rng, 1000, D)
    jidx, idx = _pair("Euclid", x)
    jidx.build(batch_size=256)
    jidx.save(str(tmp_path / "from_jax"))
    loaded = load_hnsw_any(str(tmp_path / "from_jax"), idx.store, idx.config)
    np.testing.assert_array_equal(loaded.links0, jidx.links0)
    js, ji = jidx.search(q, 10, ef=48)
    ps, pi = loaded.search(q, 10, ef=48)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(ps, js, rtol=1e-5)
    carried = hnsw_index_from_jax(jidx, idx.store)
    np.testing.assert_array_equal(carried.search(q, 10, ef=48)[1], ji)

    idx.build(batch_size=256)  # device builder: the host mirror syncs at save
    assert idx._host_stale
    ps, pi = idx.search(q, 10, ef=48)
    idx.save(str(tmp_path / "from_port"))
    assert sorted(p.name for p in (tmp_path / "from_port").iterdir()) == sorted(
        p.name for p in (tmp_path / "from_jax").iterdir())
    back = JaxHnswIndex.load(str(tmp_path / "from_port"), jidx.store, jidx.config)
    js, ji = back.search(q, 10, ef=48)
    np.testing.assert_array_equal(ji, pi)
    np.testing.assert_allclose(js, ps, rtol=1e-5)
    mem = idx.memory_usage_bytes()
    assert mem["host_bytes"] > 0 and mem["device_bytes"] > 0


def test_sharded_directory_loads(tmp_path, monkeypatch):
    """A sharded graph directory (`hnsw_sharded.npz`) loads through
    load_hnsw_any onto a mesh of the saved size with the same answers, and a
    mesh of another size rebuilds it for that size (the JAX load's rule).
    The JAX files and their search against the JAX index: test_torch_mesh.py."""
    from qdrant_tpu_torch import device
    from qdrant_tpu_torch.index.hnsw import ShardedHnswIndex
    from qdrant_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(26)
    x, q = clustered(rng, 1024, D)
    store = DenseVectorStore(D, Distance.DOT)
    store.add(x)
    cfg = HnswConfig(m=8, ef_construct=32)
    idx = ShardedHnswIndex(store, cfg, mesh=make_mesh(4))
    idx.build()
    _, before = idx.search(q, 10, ef=32)
    idx.save(str(tmp_path / "g"))
    monkeypatch.setattr(device, "_LOGICAL", 4)
    same = load_hnsw_any(str(tmp_path / "g"), store, cfg)
    assert isinstance(same, ShardedHnswIndex) and not same.build_stats
    np.testing.assert_array_equal(same.search(q, 10, ef=32)[1], before)
    monkeypatch.setattr(device, "_LOGICAL", 2)
    rebuilt = load_hnsw_any(str(tmp_path / "g"), store, cfg)
    assert rebuilt.n_shards == 2 and rebuilt.build_stats["shards"] == 2
    assert rebuilt.n_per_shard == 512 and (rebuilt.search(q, 10, ef=32)[1] >= 0).all()


def test_inline_gate_and_search_programs(monkeypatch):
    """On the CPU the level beam serves; QDRANT_TPU_INLINE=force builds the
    table (never for Manhattan, never past the byte gate) and the inline beam
    serves, filtered and not, with the answers of the level beam."""
    monkeypatch.setenv("QDRANT_TPU_DEVICE_BUILD", "force")  # the quicker builder here
    rng = np.random.default_rng(26)
    x, q = clustered(rng, 1500, D)
    _, idx = _pair("Euclid", x)
    idx.build(batch_size=256)
    mask = rng.random(1500) < 0.5
    ref = idx.search(q, 10, ef=64)
    ref_f = idx.search(q, 10, ef=64, filter_mask=mask)
    assert dict(idx.served) == {"level": 2} and idx._inline is False
    monkeypatch.setenv("QDRANT_TPU_INLINE", "force")
    idx._inline = None
    got = idx.search(q, 10, ef=64)
    got_f = idx.search(q, 10, ef=64, filter_mask=mask)
    got_a = idx.search(q, 10, ef=64, filter_mask=mask, acorn=True)
    assert idx.served["inline"] == 2 and idx.served["acorn"] == 1
    assert recall_at_10(got[1], x, q, "Euclid") >= recall_at_10(ref[1], x, q, "Euclid") - 0.05
    for s, i in (ref_f, got_f, got_a):
        assert mask[i[i >= 0]].all()
        assert recall_at_10(i, x, q, "Euclid", mask) >= 0.85
    exact = -((q[:, None, :] - x[None]) ** 2).sum(-1)
    np.testing.assert_allclose(got[0], np.take_along_axis(exact, got[1], 1), rtol=1e-4,
                               atol=1e-3)
    monkeypatch.setenv("QDRANT_TPU_INLINE_MAX_BYTES", "1000")
    idx._inline = None
    assert idx._inline_state() is None
    _, man = _pair("Manhattan", x[:300])
    man.build()
    monkeypatch.delenv("QDRANT_TPU_INLINE_MAX_BYTES")
    assert man._inline_state() is None
    assert (man.search(q[:4], 5, ef=32)[1] >= 0).all()
