"""The embedded client (`qdrant_tpu_torch.embedded`, a held copy of the JAX
package's) and the three tools (`qdrant_tpu_torch.tools`: the segment
inspector, which loads on the card unless `--force-cpu` asks for the CPU, the
WAL inspector, which needs no device, and `wal_pop`, a held copy):

* the embedded flow of tests/test_embedded.py (dense + BM25 sparse, filters,
  payload, delete, scroll, persistence) and a multivector collection give
  the answers the JAX package's embedded client gives on the same data;
* each tool prints what the JAX package's tool prints over the same storage
  (the segment inspector reports the multivector and its pooled graph), and
  `wal_pop` leaves the same records;
* the embedded client and the three tools run with `jax` and `qdrant_tpu`
  unimportable.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from qdrant_tpu.embedded import QdrantTpu as JaxQdrantTpu
from qdrant_tpu.tools import segment_inspector as jax_segment_inspector
from qdrant_tpu.tools import wal_inspector as jax_wal_inspector
from qdrant_tpu.tools import wal_pop as jax_wal_pop
from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.embedded import QdrantTpu
from qdrant_tpu_torch.tools import segment_inspector, wal_inspector, wal_pop

force_cpu()  # the port on the CPU
torch.set_num_threads(1)  # the multivector seal builds a small graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flow(cls, path):
    """tests/test_embedded.py's flow plus a multivector collection → every
    answer, in order."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(30, 8)).astype(np.float32)
    docs = [rng.normal(size=(int(t), 6)).astype(np.float32) for t in rng.integers(2, 6, 40)]
    out = []
    with cls(path) as db:
        db.create_collection(
            "docs", vectors={"size": 8, "distance": "Cosine"},
            sparse_vectors={"text": {"modifier": "idf"}})
        db.upsert("docs", [
            {"id": i, "vector": {"": data[i].tolist(),
                                 "text": {"text": f"document number {i} about topic{i % 3}"}},
             "payload": {"topic": i % 3}}
            for i in range(30)])
        out.append(db.count("docs"))
        out.append(db.search("docs", data[4].tolist(), limit=3))
        out.append(db.query("docs", query=data[4].tolist(),
                            filter={"must": [{"key": "topic", "match": {"value": 2}}]},
                            limit=3, with_payload=True))
        out.append(db.query("docs", query={"text": "topic1"}, using="text", limit=5))
        db.set_payload("docs", {"flag": True}, ids=[1, 2])
        out.append(db.count("docs", {"must": [{"key": "flag", "match": {"value": True}}]}))
        db.delete("docs", ids=[0])
        out.append(db.scroll("docs", limit=3))
        db.create_collection(
            "mv", vectors={"size": 6, "distance": "Dot",
                           "multivector_config": {"comparator": "max_sim"}},
            hnsw_config={"m": 4, "ef_construct": 16, "full_scan_threshold": 10},
            optimizers_config={"indexing_threshold": 20})
        db.upsert("mv", [{"id": i, "vector": doc.tolist(), "payload": {"odd": i % 2}}
                         for i, doc in enumerate(docs)])
        for qi in (3, 17):
            out.append(db.query("mv", query=docs[qi][:2].tolist(), limit=4))
        out.append(db.retrieve("mv", [5], with_vectors=True))
    with cls(path) as db:  # persistence across sessions
        out.append(db.count("docs"))
        out.append(db.query("mv", query=docs[3][:2].tolist(), limit=4))
    return out


def _same(a, b):
    """Equal structures, floats within 1e-5 relative."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (a, b)
    else:
        assert a == b


def test_embedded_matches_jax(tmp_path):
    got = _flow(QdrantTpu, str(tmp_path / "port"))
    want = _flow(JaxQdrantTpu, str(tmp_path / "jax"))
    # the BM25 query ties ten documents at one score: each package returns
    # five of them, not necessarily the same five
    bm25, jax_bm25 = got.pop(3), want.pop(3)
    _same([h["score"] for h in bm25], [h["score"] for h in jax_bm25])
    assert all(h["id"] % 3 == 1 for h in bm25 + jax_bm25)
    _same(got, want)
    assert got[0] == 30 and got[1][0]["id"] == 4 and got[3] == 2
    assert [p["id"] for p in got[4]] == [1, 2, 3]
    assert got[5][0]["id"] == 3 and got[-1] == got[5] and got[-2] == 29
    assert np.asarray(got[7][0]["vector"]).shape[1] == 6  # the token matrix


def _storage(path):
    """A storage with a sealed multivector segment and a WAL → (segments
    root, WAL directory)."""
    rng = np.random.default_rng(1)
    with QdrantTpu(path) as db:
        db.create_collection(
            "mv", vectors={"size": 6, "distance": "Cosine",
                           "multivector_config": {"comparator": "max_sim"}},
            hnsw_config={"m": 4, "ef_construct": 16, "full_scan_threshold": 10},
            optimizers_config={"indexing_threshold": 30})
        db.create_payload_index("mv", "g", "keyword")
        db.upsert("mv", [{"id": i, "vector": rng.normal(size=(3, 6)).tolist(),
                          "payload": {"g": str(i % 2)}} for i in range(40)])
        db.delete("mv", ids=[7])
        shard = db.toc.get_collection("mv").shards[0]
        return os.path.join(shard.path, "segments"), os.path.join(shard.path, "wal")


def _run(main, args, capsys):
    rc = main(args)
    out, err = capsys.readouterr()
    return rc, out, err


def test_tools_match_jax(tmp_path, capsys):
    seg_root, wal_dir = _storage(str(tmp_path / "db"))
    rc, out, _ = _run(segment_inspector.main, ["--force-cpu", seg_root], capsys)
    assert rc == 0 and "multi[<default>]: dim=6" in out and "hnsw (pooled proxy): built" in out
    assert _run(jax_segment_inspector.main, [seg_root], capsys) == (rc, out, "")
    got = _run(wal_inspector.main, [wal_dir, "--limit", "2"], capsys)
    want = _run(jax_wal_inspector.main, [wal_dir, "--limit", "2"], capsys)
    assert got == want and got[0] == 0
    ops = [json.loads(line) for line in got[1].splitlines()]
    assert [o["operation"]["type"] for o in ops] == ["create_field_index", "upsert"]
    for name, pop in (("port", wal_pop), ("jax", jax_wal_pop)):
        shutil.copytree(wal_dir, str(tmp_path / name))
        assert pop.main([str(tmp_path / name)]) == 0
    capsys.readouterr()
    left = [_run(m.main, [str(tmp_path / name)], capsys)
            for m, name in ((wal_inspector, "port"), (jax_wal_inspector, "jax"))]
    assert left[0] == left[1] and "delete" not in left[0][1]


_BLOCKED = r"""
import builtins, contextlib, io, json, sys
sys.modules["jax"] = None
sys.modules["qdrant_tpu"] = None
attempts = []
_import = builtins.__import__
def _recording_import(name, *args, **kwargs):
    if name.split(".")[0] in ("jax", "qdrant_tpu"):
        attempts.append(name)
    return _import(name, *args, **kwargs)
builtins.__import__ = _recording_import
import os
from qdrant_tpu_torch.embedded import QdrantTpu
from qdrant_tpu_torch.tools import segment_inspector, wal_inspector, wal_pop
with QdrantTpu(sys.argv[1]) as db:
    db.create_collection(
        "mv", vectors={"size": 2, "distance": "Dot",
                       "multivector_config": {"comparator": "max_sim"}},
        hnsw_config={"m": 4, "ef_construct": 16, "full_scan_threshold": 10},
        optimizers_config={"indexing_threshold": 20})
    db.upsert("mv", [{"id": i, "vector": [[float(i), 1.0], [1.0, 0.0]]} for i in range(25)])
    assert [h["id"] for h in db.query("mv", query=[[1.0, 0.0]], limit=2)] == [24, 23]
    shard = db.toc.get_collection("mv").shards[0]
    seg_root = os.path.join(shard.path, "segments")
    wal_dir = os.path.join(shard.path, "wal")
buf = io.StringIO()
with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
    rcs = [segment_inspector.main(["--force-cpu", seg_root]), wal_inspector.main([wal_dir]),
           wal_pop.main([wal_dir])]
print(json.dumps({"rcs": rcs, "pooled": "pooled proxy" in buf.getvalue(),
                  "attempts": attempts,
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "qdrant_tpu")
                                   and sys.modules[m])}))
"""


def test_embedded_and_tools_run_with_jax_blocked(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "QDRANT_TPU_FORCE_CPU"}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", QDRANT_TPU_FORCE_CPU="1")
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(tmp_path / "db")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rcs": [0, 0, 0], "pooled": True, "attempts": [], "loaded": []}


def test_segment_inspector_needs_the_card_or_force_cpu(tmp_path):
    """Like the server, the segment inspector runs on the card: without one
    it refuses unless `--force-cpu` asks for the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "QDRANT_TPU_FORCE_CPU"}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "qdrant_tpu_torch.tools.segment_inspector"]
    refused = subprocess.run(cmd + [str(tmp_path)], capture_output=True, text=True,
                             env=env, cwd=ROOT, timeout=120)
    assert refused.returncode == 2 and "no CUDA device" in refused.stderr
    forced = subprocess.run(cmd + ["--force-cpu", str(tmp_path)], capture_output=True,
                            text=True, env=env, cwd=ROOT, timeout=120)
    assert forced.returncode == 1 and "no segments under" in forced.stderr
