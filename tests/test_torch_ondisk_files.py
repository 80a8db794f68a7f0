"""Where an `on_disk` vector's rows live in the port: in its segment's
directory (segments/seg_NNNNNN/dense_<name>/vectors.f32) from the first row,
not under the system temp directory, and nowhere once the segment is
replaced or discarded. Restarting from that file keeps the rows (the JAX
store rewrites the file it maps at the next save and reads zeros back)."""

import os
import tempfile

import numpy as np
import pytest

from qdrant_tpu.api.toc import TableOfContent as JaxToc
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.device import force_cpu

force_cpu()

TIER = {"vectors": {"size": 8, "distance": "Cosine", "on_disk": True,
                    "quantization_config": {"scalar": {"type": "int8", "always_ram": True}}},
        "optimizers_config": {"indexing_threshold": 100}}


@pytest.fixture
def temp_dir(monkeypatch, tmp_path):
    """The system temp directory, empty and watched."""
    d = tmp_path / "tmp"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


def _files(root, suffix):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs if suffix in f)


def _check_layout(shard, storage):
    """Every rows file lies in a live segment's directory, one per segment
    with an on-disk store, and no growth file is left."""
    live = {shard._segment_dirs[id(s)] for s in shard.segments}
    files = _files(storage, ".f32")
    assert files and not [f for f in files if f.endswith(".grow")], files
    segs = [f.split(os.sep) for f in files]
    assert all(p[-4] == "segments" and p[-3] in live and p[-1] == "vectors.f32"
               for p in segs), (files, live)
    return {p[-3] for p in segs}


def test_tier_memmaps_live_in_segment_dirs_and_swaps_leave_no_orphan(tmp_path, temp_dir):
    storage = tmp_path / "storage"
    toc = TableOfContent(str(storage), flush_interval_sec=0)
    toc.create_collection("t", TIER)
    coll = toc.get_collection("t")
    shard = coll.shards[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((400, 8)).astype(np.float32)
    coll.upsert([{"id": i, "vector": x[i].tolist()} for i in range(60)])
    (appendable,) = shard.segments
    assert _check_layout(shard, storage) == {shard._segment_dirs[id(appendable)]}

    # a write lands on the segment being sealed: the first result is
    # discarded (its directory with it) and the seal is planned again
    real_build = type(appendable).build_indexes
    raced = []

    def racing_build(seg, *a, **k):
        if not raced:
            raced.append(seg.storage_dir)
            assert os.path.isfile(os.path.join(seg.storage_dir, "dense__default", "vectors.f32"))
            shard.update({"type": "upsert", "points": [
                {"id": 399, "vector": x[399].tolist()}]}, wait=False)
        return real_build(seg, *a, **k)

    type(appendable).build_indexes = racing_build
    try:
        coll.upsert([{"id": i, "vector": x[i].tolist()} for i in range(60, 150)])
    finally:
        type(appendable).build_indexes = real_build
    assert raced and not os.path.exists(raced[0])
    sealed = [s for s in shard.segments if not s.appendable]
    assert len(sealed) == 1 and "" in sealed[0].quantized and len(sealed[0]) == 151
    assert not os.path.exists(appendable.storage_dir)  # replaced: its rows went with it
    shard.flush()
    dirs = _check_layout(shard, storage)
    assert shard._segment_dirs[id(sealed[0])] in dirs
    # growth past the first capacity renames the larger file over the old one
    coll.upsert([{"id": i, "vector": x[i].tolist()} for i in range(150, 399)])
    shard.flush()
    _check_layout(shard, storage)
    assert os.listdir(temp_dir) == []
    hits = coll.search_dense("", x[:3], 1)
    assert [h[0][1] for h in hits] == [0, 1, 2]
    toc.close()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_on_disk_rows_survive_restart_and_flush(tmp_path, package):
    """Reopen, flush (which saves every segment in place), reopen: the port
    reads its rows back; the JAX store has rewritten the file it maps and
    reads zeros (a fault of the reference, recorded in ROADMAP.md)."""
    cls = TableOfContent if package == "port" else JaxToc
    spec = {"vectors": {"size": 4, "distance": "Euclid", "on_disk": True}}
    toc = cls(str(tmp_path), flush_interval_sec=0)
    toc.create_collection("d", spec)
    toc.get_collection("d").upsert([{"id": i, "vector": [float(i), 1, 2, 3]} for i in range(50)])
    toc.close()
    toc = cls(str(tmp_path), flush_interval_sec=0)
    toc.get_collection("d").shards[0].flush()
    toc.close()
    toc = cls(str(tmp_path), flush_interval_sec=0)
    (seg,) = toc.get_collection("d").shards[0].segments
    got = seg.get_vectors(7)[""]
    toc.close()
    assert got == ([7.0, 1.0, 2.0, 3.0] if package == "port" else [0.0, 0.0, 0.0, 0.0])
