"""The optimizer's copy of live points into a new segment
(`LocalShard._defragment_into` through `Segment.append_from`) against the
loop it replaced, kept here as the oracle: each point's vectors and payload
read back and upserted one point at a time. Every case must give the same
segment bit for bit: offsets and versions, rows and deleted masks, multi and
sparse contents, payloads and the payload index, the segment's version, the
directory `Segment.save` writes and the segment loaded back from it."""

import os
import types
import uuid

import numpy as np
import pytest
import torch

from qdrant_tpu_torch.collection.shard import LocalShard, _decode_vectors
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.storage.segment import Segment
from qdrant_tpu_torch.storage.vectors import DeviceVectorStore
from qdrant_tpu_torch.types import (
    CollectionParams,
    OptimizersConfig,
    PayloadIndexParams,
    SparseVector,
    parse_filter,
)
from qdrant_tpu_torch.utils import tracing

force_cpu()


def _oracle(sources, seg):
    """The per-point copy the optimizer ran before the array path."""
    for src in sources:
        for field, p in src.payload_index.indexed_fields().items():
            if field not in seg.payload_index.indexed_fields():
                seg.create_field_index(field, p)
        for ext in src.id_tracker.iter_sorted_external():
            internal = src.id_tracker.internal_id(ext)
            if internal is None:
                continue
            version = src.id_tracker.version(internal)
            vectors = _decode_vectors(src.get_vectors(ext) or {})
            payload = src.get_payload(ext)
            seg.upsert_point(version, ext, vectors, payload)
    seg.version = max((s.version for s in sources), default=0)
    return seg


def _copy(sources, params, path):
    """The optimizer's copy through its entry point."""
    shard = types.SimpleNamespace(
        _new_segment=lambda appendable: Segment(params, appendable, storage_dir=path))
    return LocalShard._defragment_into(shard, sources, appendable=False)


def _vectors(spec, rng, i):
    """Point i's vectors: every named vector of `spec`, some left out."""
    out = {}
    for name, vp in spec["vectors"].items():
        if name == "b" and i % 5 == 0:
            continue  # a point without its second dense vector
        if "multivector_config" in vp:
            if i % 4 != 1:
                out[name] = rng.standard_normal((1 + i % 3, vp["size"])).astype(np.float32)
        else:
            out[name] = rng.standard_normal(vp["size"]).astype(np.float32)
    for name in spec.get("sparse_vectors", {}):
        if i % 3 != 2:
            dims = rng.choice(50, size=1 + i % 4, replace=False)
            out[name] = SparseVector(dims.tolist(), rng.random(len(dims)).tolist())
    if i == 7 and "" in out and spec["vectors"][""]["distance"] == "Cosine":
        out[""] = np.zeros_like(out[""])  # a zero row: cosine leaves it as is
    return out


def _payload(i):
    if i % 6 == 0:
        return None
    if i % 6 == 1:
        return {}
    return {"city": ["berlin", "paris", "rome"][i % 3], "n": i}


def _source(spec, path, ids, seed, op=1, deferred=()):
    """A sealed segment of `ids`, written in a shuffled order by ops that
    each write a few points (so the versions come in runs)."""
    rng = np.random.default_rng(seed)
    seg = Segment(CollectionParams.from_dict(spec), appendable=False, storage_dir=path)
    order = rng.permutation(len(ids))
    for j, k in enumerate(order):
        seg.upsert_point(op + j // 7, ids[k], _vectors(spec, rng, int(k)), _payload(int(k)),
                         deferred=ids[k] in deferred)
    return seg


EUCLID = {"vectors": {"": {"size": 8, "distance": "Euclid"}}}
COSINE = {"vectors": {"": {"size": 8, "distance": "Cosine"}}}
NAMED = {"vectors": {"a": {"size": 6, "distance": "Dot"},
                     "b": {"size": 5, "distance": "Cosine"}}}
MULTI = {"vectors": {"d": {"size": 4, "distance": "Dot"},
                     "mv": {"size": 4, "distance": "Cosine",
                            "multivector_config": {"comparator": "max_sim"}}},
         "sparse_vectors": {"s": {}}}
WIDE = {"vectors": {"": {"size": 1536, "distance": "Cosine"}}}
ON_DISK = {"vectors": {"": {"size": 8, "distance": "Cosine", "on_disk": True}}}
UUIDS = [str(uuid.UUID(int=int(v))) for v in np.random.default_rng(3).integers(1, 2**62, 40)]
CITY = parse_filter({"must": [{"key": "city", "match": {"value": "paris"}}]})


def _case(name, tmp):
    """→ (spec, sources, filter)."""
    d = lambda n: str(tmp / n)  # noqa: E731
    ids = list(range(0, 400, 2))
    if name == "euclid":
        return EUCLID, [_source(EUCLID, d("s"), ids, 1)], None
    if name == "cosine":
        return COSINE, [_source(COSINE, d("s"), ids, 2)], None
    if name == "cosine_1536":
        return WIDE, [_source(WIDE, d("s"), ids[:120], 15)], None
    if name == "named_vector_deleted":
        src = _source(NAMED, d("s"), ids, 3)
        for ext in ids[1::9]:
            src.delete_vectors(10**4, ext, ["b"])
        src.delete_vectors(10**4, ids[4], ["a", "b"])
        return NAMED, [src], None
    if name == "vacuum":
        src = _source(EUCLID, d("s"), ids, 4)
        for ext in ids[::3]:
            src.delete_point(10**4, ext)
        return EUCLID, [src], None
    if name == "merge":
        a = _source(EUCLID, d("a"), ids, 5)
        b = _source(EUCLID, d("b"), list(range(1, 300, 2)), 6, op=500)
        a.create_field_index("city", PayloadIndexParams())
        b.create_field_index("n", PayloadIndexParams.from_dict("integer"))
        return EUCLID, [a, b], CITY
    if name == "merge_shared_ids":
        a = _source(EUCLID, d("a"), ids, 7, op=500)
        b = _source(EUCLID, d("b"), list(range(0, 600, 3)), 8)
        return EUCLID, [a, b], None
    if name == "int_and_uuid_ids":
        return COSINE, [_source(COSINE, d("s"), ids[:60] + UUIDS, 9)], None
    if name == "payload_index":
        src = _source(EUCLID, d("s"), ids, 10)
        src.create_field_index("city", PayloadIndexParams())
        src.set_payload(10**4, ids[6], {"city": "paris"})
        src.clear_payload(10**4, ids[8])
        return EUCLID, [src], CITY
    if name == "multi_and_sparse":
        src = _source(MULTI, d("s"), ids, 11)
        src.delete_vectors(10**4, ids[2], ["mv", "s"])
        src.update_vectors(10**4 + 1, ids[3], {"mv": np.ones((2, 4), np.float32)})
        return MULTI, [src], None
    if name == "on_disk":
        src = _source(ON_DISK, d("s"), ids, 12)
        src.delete_point(10**4, ids[5])
        return ON_DISK, [src], None
    if name == "device_store":
        src = _source(COSINE, d("s"), ids, 13)
        src.delete_point(10**4, ids[9])
        host = src.dense[""]
        dev = DeviceVectorStore(torch.from_numpy(host.host_array.copy()), host.distance,
                                count=len(host))
        dev.delete_many(np.flatnonzero(host.deleted_mask))
        src.dense[""] = dev
        return COSINE, [src], None
    if name == "deferred":
        return EUCLID, [_source(EUCLID, d("s"), ids, 14, deferred=set(ids[::4]))], None
    raise AssertionError(name)


CASES = ["euclid", "cosine", "cosine_1536", "named_vector_deleted", "vacuum", "merge", "merge_shared_ids",
         "int_and_uuid_ids", "payload_index", "multi_and_sparse", "on_disk", "device_store",
         "deferred"]


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _assert_same(got, want, flt):
    assert got.version == want.version
    assert got.deferred == want.deferred == set()
    assert got.total_offsets == want.total_offsets
    g, w = got.id_tracker, want.id_tracker
    assert list(g._ext_to_int.items()) == list(w._ext_to_int.items())
    assert g._int_to_ext == w._int_to_ext and g._versions == w._versions
    for name, store in want.dense.items():
        mine = got.dense[name]
        assert np.array_equal(_bits(mine.host_array), _bits(store.host_array)), name
        assert np.array_equal(mine.deleted_mask, store.deleted_mask)
        assert mine.deleted_count == store.deleted_count
    for name, store in want.multi.items():
        mine = got.multi[name]
        assert mine._flat_count == store._flat_count and len(mine) == len(store)
        assert np.array_equal(_bits(mine._flat[: mine._flat_count]),
                              _bits(store._flat[: store._flat_count]))
        assert np.array_equal(mine._ranges[: len(mine)], store._ranges[: len(store)])
        assert np.array_equal(mine.deleted_mask, store.deleted_mask)
    for name, store in want.sparse.items():
        mine = got.sparse[name]
        assert len(mine) == len(store) and mine.deleted_count == store.deleted_count
        for off in range(len(store)):
            assert mine.get(off) == store.get(off)
    assert got.payload_storage._payloads == want.payload_storage._payloads
    assert got.payload_index.indexed_fields() == want.payload_index.indexed_fields()
    if flt is not None:
        mask = got.filter_mask(flt)
        assert mask.any() and np.array_equal(mask, want.filter_mask(flt))


def _files(path):
    out = {}
    for dirpath, _, files in os.walk(path):
        for f in files:
            full = os.path.join(dirpath, f)
            with open(full, "rb") as fh:
                out[os.path.relpath(full, path)] = fh.read()
    return out


@pytest.mark.parametrize("name", CASES)
def test_array_copy_equals_the_per_point_copy(name, tmp_path):
    spec, sources, flt = _case(name, tmp_path)
    params = CollectionParams.from_dict(spec)
    tracing.reset()
    got = _copy(sources, params, str(tmp_path / "got"))
    counts = tracing.counters()
    want = _oracle(sources, Segment(params, appendable=False, storage_dir=str(tmp_path / "want")))
    assert counts["defragment.points"] == sum(len(s) for s in sources)
    # only a merge whose sources share an id goes point by point
    shared = name == "merge_shared_ids"
    assert counts["defragment.bulk_rows"] == (0 if shared else counts["defragment.points"])
    assert len(got) == len(want) > 0
    _assert_same(got, want, flt)
    got.save(str(tmp_path / "got_saved"))
    want.save(str(tmp_path / "want_saved"))
    saved = _files(str(tmp_path / "got_saved"))
    assert saved.keys() == _files(str(tmp_path / "want_saved")).keys()
    assert saved == _files(str(tmp_path / "want_saved"))
    _assert_same(Segment.load(str(tmp_path / "got_saved")),
                 Segment.load(str(tmp_path / "want_saved")), flt)


def test_a_shard_seals_by_arrays_and_searches_what_it_held(tmp_path):
    """Through the shard: the optimizer's seal copies every point by arrays,
    and the sealed segment answers as the points written."""
    spec = {"vectors": {"": {"size": 8, "distance": "Euclid"}},
            "hnsw_config": {"m": 4, "ef_construct": 16}}
    shard = LocalShard(str(tmp_path / "shard"), CollectionParams.from_dict(spec),
                       OptimizersConfig(indexing_threshold=100))
    rng = np.random.default_rng(21)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    ids = [int(i) for i in rng.permutation(1000)[:300]]
    tracing.reset()
    try:
        shard.update({"type": "upsert", "points": [
            {"id": pid, "vectors": {"": x[i].tolist()}, "payload": {"i": i}}
            for i, pid in enumerate(ids)]})
        counts = tracing.counters()
        assert counts["defragment.points"] == counts["defragment.bulk_rows"] == 300
        assert [s.appendable for s in shard.segments].count(False) == 1
        q = rng.standard_normal((4, 8)).astype(np.float32)
        hits = shard.search_dense("", q, 5)
        d = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
        for qi, row in enumerate(hits):
            assert [pid for _, pid, _ in row] == [ids[j] for j in np.argsort(d[qi])[:5]]
        for ext, seg, off in shard.retrieve(ids[:20]):
            i = ids.index(ext)
            assert seg.get_payload(ext) == {"i": i}
            assert np.array_equal(seg.dense[""].get(off), x[i])
    finally:
        shard.close()
