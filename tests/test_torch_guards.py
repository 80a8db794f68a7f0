"""Guards on the port's boundaries.

* qdrant_tpu_torch runs with jax and qdrant_tpu made unimportable: a
  subprocess blocks both, serves REST over a TableOfContent on the CPU and
  runs a dense, a graph (`params.hnsw_ef` on a sealed segment), a tiered
  (quantized, on-disk rows), a sparse and a multivector search, and the
  embedded client; no import of either was even attempted, and no
  qdrant_tpu module is loaded afterwards.
* Only the two gRPC modules import `grpc` / `google.protobuf` at module
  level: REST and the device path never need them.
* No source file of the port (nor chip_smoke.py) imports jax or qdrant_tpu.
* The modules copied from qdrant_tpu (the REST / collection shell, and the
  jax-free modules the port shares with the reference unchanged) equal their
  originals once import lines are normalised, so the copies cannot drift
  apart.
"""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_IMPORT = re.compile(r"^\s*(import jax\b|from jax\b)", re.M)
REFERENCE_IMPORT = re.compile(r"^\s*(from|import) qdrant_tpu\b", re.M)

_SUBPROCESS = r"""
import builtins, importlib, importlib.util, json, pkgutil, sys, tempfile, urllib.request
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["qdrant_tpu"] = None  # ... and so does any import of the reference
attempts = []  # ... and is recorded, even where the caller swallows the error
_import = builtins.__import__
def _recording_import(name, *args, **kwargs):
    if name.split(".")[0] in ("jax", "qdrant_tpu"):
        attempts.append(name)
    return _import(name, *args, **kwargs)
builtins.__import__ = _recording_import
import numpy as np
import qdrant_tpu_torch
for m in pkgutil.walk_packages(qdrant_tpu_torch.__path__, "qdrant_tpu_torch."):
    if importlib.util.find_spec(m.name).origin.endswith(".py"):  # not native/*.so
        importlib.import_module(m.name)
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.device import default_device
assert default_device().type == "cpu"
toc = TableOfContent(tempfile.mkdtemp())
srv = RestServer(toc, port=0)
srv.start_background()
def call(method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())["result"]
call("PUT", "/collections/g", {"vectors": {"size": 4, "distance": "Euclid"}})
call("PUT", "/collections/g/points?wait=true", {"points": [
    {"id": i, "vector": [float(i), 0.0, 0.0, 1.0]} for i in range(20)]})
hits = call("POST", "/collections/g/points/search", {"vector": [3.1, 0, 0, 1], "limit": 2})
assert [h["id"] for h in hits] == [3, 4], hits
# a sealed collection: the seal builds its HNSW graph, hnsw_ef searches it
call("PUT", "/collections/h", {"vectors": {"size": 4, "distance": "Euclid"},
     "hnsw_config": {"m": 4, "ef_construct": 16},
     "optimizers_config": {"indexing_threshold": 30}})
call("PUT", "/collections/h/points?wait=true", {"points": [
    {"id": i, "vector": [float(i), 0.0, 0.0, 1.0]} for i in range(40)]})
seg, = [s for s in toc.get_collection("h").shards[0].segments if not s.appendable]
assert seg.hnsw[""].entry >= 0
hits = call("POST", "/collections/h/points/search",
            {"vector": [3.1, 0, 0, 1], "limit": 2, "params": {"hnsw_ef": 16}})
assert [h["id"] for h in hits] == [3, 4], hits
assert seg.hnsw[""].served["level"] == 1
# a tiered collection (codes on the device, f32 rows on disk), sealed
call("PUT", "/collections/t", {"vectors": {"size": 4, "distance": "Dot", "on_disk": True,
     "quantization_config": {"scalar": {"type": "int8"}}},
     "optimizers_config": {"indexing_threshold": 30}})
call("PUT", "/collections/t/points?wait=true", {"points": [
    {"id": i, "vector": [float(i), 1.0, 0.0, 0.0]} for i in range(40)]})
seg, = [s for s in toc.get_collection("t").shards[0].segments if not s.appendable]
assert "" in seg.quantized and seg.dense[""].on_disk
hits = call("POST", "/collections/t/points/search", {"vector": [1.0, 0, 0, 0], "limit": 2})
assert [h["id"] for h in hits] == [39, 38], hits
assert seg.dense[""]._dev is None
# a sparse collection
call("PUT", "/collections/s", {"vectors": {"size": 4, "distance": "Dot"},
     "sparse_vectors": {"text": {}}})
call("PUT", "/collections/s/points?wait=true", {"points": [
    {"id": i, "vector": {"": [1.0, 0, 0, 0], "text": {"indices": [i % 5, 7], "values": [1.0 + i, 0.5]}}}
    for i in range(20)]})
hits = call("POST", "/collections/s/points/query",
            {"query": {"indices": [4], "values": [2.0]}, "using": "text", "limit": 2})["points"]
assert [h["id"] for h in hits] == [19, 14] and hits[0]["score"] == 40.0, hits
# a multivector collection: max-sim over token matrices, then the token
# matrix back by retrieval
call("PUT", "/collections/m", {"vectors": {"colbert": {"size": 4, "distance": "Dot",
     "multivector_config": {"comparator": "max_sim"}}}})
call("PUT", "/collections/m/points?wait=true", {"points": [
    {"id": i, "vector": {"colbert": [[float(i), 0.0, 0.0, 1.0], [0.0, 1.0, 0.0, 0.0]]}}
    for i in range(10)]})
hits = call("POST", "/collections/m/points/query",
            {"query": [[1.0, 0, 0, 0], [0, 0, 0, 1.0]], "using": "colbert", "limit": 2})["points"]
assert [h["id"] for h in hits] == [9, 8] and hits[0]["score"] == 10.0, hits
pts = call("POST", "/collections/m/points", {"ids": [3], "with_vector": True})
assert pts[0]["vector"]["colbert"] == [[3.0, 0.0, 0.0, 1.0], [0.0, 1.0, 0.0, 0.0]], pts
from qdrant_tpu_torch.embedded import QdrantTpu
with QdrantTpu() as db:
    db.create_collection("e", vectors={"size": 4, "distance": "Dot"})
    db.upsert("e", [{"id": 1, "vector": [1.0, 2.0, 3.0, 4.0]}])
    assert db.search("e", [1.0, 0, 0, 0], limit=1)[0]["id"] == 1
call("GET", "/telemetry?details_level=3")
call("GET", "/openapi.json")
srv.shutdown()
toc.close()
print(json.dumps({"attempts": attempts,
                  "loaded": sorted(m for m in sys.modules
                                   if m.split(".")[0] == "qdrant_tpu" and sys.modules[m])}))
"""


def test_port_runs_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": ROOT, "QDRANT_TPU_FORCE_CPU": "1"}
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["attempts"] == []  # not even a swallowed `import jax`
    assert out["loaded"] == []


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "qdrant_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _offenders(pattern):
    out = []
    for path in _port_sources():
        with open(path) as fh:
            if pattern.search(fh.read()):
                out.append(os.path.relpath(path, ROOT))
    return out


def test_no_jax_import_in_port_sources():
    assert not _offenders(JAX_IMPORT)


def test_no_reference_package_import_in_port_sources():
    """`qdrant_tpu_torch` itself does not match: the pattern ends at a word
    boundary after `qdrant_tpu`."""
    assert not _offenders(REFERENCE_IMPORT)
    assert REFERENCE_IMPORT.search("from qdrant_tpu.types import Distance")
    assert REFERENCE_IMPORT.search("    import qdrant_tpu")
    assert not REFERENCE_IMPORT.search("from qdrant_tpu_torch.types import Distance")


GRPC_IMPORT = re.compile(r"^(import grpc\b|from grpc\b|import google\b|from google\b)", re.M)
GRPC_MODULES = {"api/grpc_schema.py", "api/grpc_server.py"}


def test_grpc_imported_only_by_the_grpc_modules():
    """A machine without the grpc package serves REST and the device path:
    no other module of the port imports grpc or protobuf at module level,
    and the entry point imports the gRPC server inside a guard."""
    base = os.path.join(ROOT, "qdrant_tpu_torch")
    found = {os.path.relpath(p, base) for p in _port_sources()
             if p.startswith(base) and GRPC_IMPORT.search(open(p).read())}
    assert found == GRPC_MODULES
    main = open(os.path.join(base, "__main__.py")).read()
    assert "    from .api.grpc_server import make_server" in main


_FROM = re.compile(r"^(\s*)from (\.+)?([\w.]*) import (.*)$")


def _normalised(pkg: str, rel: str):
    """Source lines with every `from X import` resolved to an absolute module
    and stripped of its top-level package name."""
    mod = f"{pkg}.{rel[:-3].replace('/', '.')}"
    parent = mod.split(".")[:-1]
    with open(os.path.join(ROOT, pkg, rel)) as fh:
        lines = fh.read().splitlines()
    out = []
    for line in lines:
        m = _FROM.match(line)
        if m:
            indent, dots, name, rest = m.groups()
            if dots:
                base = parent[: len(parent) - (len(dots) - 1)]
                name = ".".join(base + ([name] if name else []))
            name = re.sub(r"^qdrant_tpu(_torch)?(\.|$)", "", name)
            line = f"{indent}from <pkg>.{name} import {rest}"
        out.append(line)
    return out


COPIED = [
    # the REST / collection shell
    "collection/collection.py",
    "collection/query.py",
    "api/toc.py",
    "api/rest.py",
    "api/openapi.py",
    # modules shared with the reference unchanged
    "api/auth.py",
    "api/grpc_schema.py",
    "api/grpc_server.py",
    "api/issues.py",
    "api/metrics.py",
    "api/webui.py",
    "cluster/__init__.py",
    "cluster/clock.py",
    "cluster/consensus.py",
    "cluster/node.py",
    "cluster/raft.py",
    "cluster/remote.py",
    "cluster/replica_set.py",
    "cluster/transfer.py",
    "collection/formula.py",
    "collection/hash_ring.py",
    "collection/sampling.py",
    "embedded.py",
    "index/payload_index.py",
    "index/postings.py",
    "native/__init__.py",
    "native/wal.cpp",
    "native/gridstore.cpp",
    "settings.py",
    "storage/id_tracker.py",
    "storage/io_tier.py",
    "storage/object_store.py",
    "storage/payload.py",
    "storage/wal.py",
    "tools/__init__.py",
    "tools/wal_pop.py",
    "types.py",
    "utils/bm25.py",
    "utils/budget.py",
    "utils/debug.py",
    "utils/flags.py",
    "utils/hw_counter.py",
    "utils/inference.py",
    "utils/json_path.py",
    "utils/memsize.py",
    "utils/microbatch.py",
    "utils/observability.py",
    "utils/quota.py",
    "utils/rate_limiter.py",
    "utils/text.py",
]


@pytest.mark.parametrize("rel", COPIED)
def test_copied_shell_equals_original(rel):
    assert _normalised("qdrant_tpu_torch", rel) == _normalised("qdrant_tpu", rel)


# modules the port rewrote for torch (not copies), and empty package markers
PORTED = {
    "__init__.py", "__main__.py", "collection/shard.py", "index/hnsw.py", "index/plain.py", "index/sparse.py",
    "ops/distances.py", "ops/hnsw.py", "ops/hnsw_build.py", "ops/hnsw_inline.py",
    "ops/quantization.py", "ops/scan.py", "ops/sparse.py",
    "parallel/__init__.py", "parallel/mesh.py",
    "storage/segment.py", "storage/vectors.py", "tools/segment_inspector.py",
    "tools/wal_inspector.py", "utils/telemetry.py",
}


def test_every_shared_file_is_a_held_copy_or_a_port():
    """A file at the same path in both packages is either held equal to its
    original above or rewritten for torch; none is left unchecked."""
    shared = []
    base = os.path.join(ROOT, "qdrant_tpu_torch")
    for dirpath, _, files in os.walk(base):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), base)
            if f.endswith((".py", ".cpp")) and os.path.exists(os.path.join(ROOT, "qdrant_tpu", rel)):
                shared.append(rel)
    markers = {r for r in shared if r.endswith("__init__.py") and r not in COPIED
               and os.path.getsize(os.path.join(base, r)) == 0}
    assert sorted(set(shared) - markers - PORTED) == sorted(COPIED)


def test_default_device_refuses_silent_cpu(monkeypatch):
    """Without a card the port raises unless the CPU was asked for, by
    force_cpu() or QDRANT_TPU_FORCE_CPU (not "0")."""
    from qdrant_tpu_torch import device

    monkeypatch.setattr(device, "_FORCED", None)  # undo this process's force_cpu()
    monkeypatch.delenv(device.FORCE_CPU_ENV, raising=False)
    monkeypatch.setattr(device.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--force-cpu"):
        device.default_device()
    monkeypatch.setenv(device.FORCE_CPU_ENV, "0")
    with pytest.raises(RuntimeError, match=device.FORCE_CPU_ENV):
        device.default_device()
    monkeypatch.setenv(device.FORCE_CPU_ENV, "1")
    assert device.default_device().type == "cpu"
    monkeypatch.delenv(device.FORCE_CPU_ENV)
    device.force_cpu()
    assert device.default_device().type == "cpu"


def test_server_without_card_refuses_to_start(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "QDRANT_TPU_FORCE_CPU"}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="", QDRANT__TELEMETRY_DISABLED="true")
    proc = subprocess.run(
        [sys.executable, "-m", "qdrant_tpu_torch", "--storage-dir", str(tmp_path),
         "--http-port", "0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "--force-cpu" in proc.stderr
