"""The port's LocalShard (its own file since the cluster slice) against the
JAX one: the same writes give the same scroll pages, counts and searches.
The port's unfiltered scroll keeps its ordered ids until a segment changes;
pages read between writes, across a seal and across a delete equal the JAX
shard's, which sorts on every call."""

import uuid

import numpy as np
import pytest

from qdrant_tpu.collection.shard import LocalShard as JaxShard
from qdrant_tpu.types import CollectionParams as JaxParams
from qdrant_tpu.types import OptimizersConfig as JaxOptimizers
from qdrant_tpu.types import parse_filter as jax_parse_filter
from qdrant_tpu_torch.collection.shard import LocalShard
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.types import CollectionParams, OptimizersConfig, parse_filter

force_cpu()

SPEC = {"vectors": {"": {"size": 8, "distance": "Euclid"}}}


@pytest.fixture
def shards(tmp_path):
    both = [
        JaxShard(str(tmp_path / "jax"), JaxParams.from_dict(SPEC),
                 JaxOptimizers(indexing_threshold=10**9)),
        LocalShard(str(tmp_path / "port"), CollectionParams.from_dict(SPEC),
                   OptimizersConfig(indexing_threshold=10**9)),
    ]
    yield both
    for s in both:
        s.close()


def _apply(shards, op):
    for s in shards:
        s.update(op)


def _pages(shard, limit, flt=None, parse=None):
    """Every page of a paged scroll, as a shard transfer reads it."""
    out, offset = [], None
    f = None if flt is None else parse(flt)
    while True:
        ids = shard.scroll_ids(limit + 1, offset, f)
        out.append(ids[:limit])
        if len(ids) <= limit:
            return out
        offset = ids[limit]


def test_scroll_pages_match_jax(shards):
    rng = np.random.default_rng(5)
    uuids = sorted(str(uuid.UUID(int=int(v))) for v in rng.integers(1, 2**62, 40))
    ids = [int(i) for i in rng.permutation(300)] + uuids
    x = rng.standard_normal((len(ids), 8)).astype(np.float32)
    _apply(shards, {"type": "upsert", "points": [
        {"id": pid, "vectors": {"": x[i].tolist()}, "payload": {"odd": i % 2}}
        for i, pid in enumerate(ids)]})
    flt = {"must": [{"key": "odd", "match": {"value": 1}}]}

    def compare():
        jax_shard, port_shard = shards
        for limit in (1, 7, 100, 10**9):
            assert _pages(port_shard, limit) == _pages(jax_shard, limit)
            assert (_pages(port_shard, limit, flt, parse_filter)
                    == _pages(jax_shard, limit, flt, jax_parse_filter))
        for offset in (None, 0, 17, 299, 10**6, uuids[0], uuids[20], "ffffffff"):
            assert port_shard.scroll_ids(25, offset) == jax_shard.scroll_ids(25, offset)
        assert port_shard.count(None) == jax_shard.count(None)

    compare()
    compare()  # from the cache
    _apply(shards, {"type": "delete", "points": ids[::7]})
    compare()
    _apply(shards, {"type": "upsert", "points": [
        {"id": 1000 + i, "vectors": {"": x[i].tolist()}} for i in range(30)]})
    compare()
    for s in shards:  # a seal replaces the appendable segment
        s.optimizers.indexing_threshold = 10
        s.maybe_optimize()
        assert any(not seg.appendable for seg in s.segments)
    compare()
    q = rng.standard_normal((4, 8)).astype(np.float32)
    jax_hits, port_hits = (s.search_dense("", q, 5) for s in shards)
    assert [[h[1] for h in r] for r in port_hits] == [[h[1] for h in r] for r in jax_hits]
    np.testing.assert_allclose([[h[0] for h in r] for r in port_hits],
                               [[h[0] for h in r] for r in jax_hits], rtol=1e-5)
