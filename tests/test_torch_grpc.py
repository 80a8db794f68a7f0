"""gRPC in the port (held copies of the JAX package's gRPC modules over the
port's TableOfContent), in the style of tests/test_grpc.py: a raw channel
and the dynamic message classes are the client.

* A dense search and a `multi_dense` (ColBERT max-sim) query over gRPC give
  the hits REST gives on the same collections, and the hits and scores the
  JAX package's gRPC server gives on the same writes; a multivector written
  over gRPC comes back as its token matrix.
* The API key is refused as in the JAX package.
* `python -m qdrant_tpu_torch --force-cpu` starts the gRPC server beside
  REST and stops it on SIGTERM; with the `grpc` package unimportable it
  serves REST and logs that gRPC did not start.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import grpc
import numpy as np
import pytest

from qdrant_tpu.api.grpc_server import make_server as jax_make_server
from qdrant_tpu.api.rest import RestServer as JaxRestServer
from qdrant_tpu.api.toc import TableOfContent as JaxTableOfContent
from qdrant_tpu_torch.api.grpc_schema import MESSAGES as M
from qdrant_tpu_torch.api.grpc_server import make_server
from qdrant_tpu_torch.api.rest import RestServer
from qdrant_tpu_torch.api.toc import TableOfContent
from qdrant_tpu_torch.device import force_cpu

force_cpu()  # the port on the CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, DM = 4, 8


def unary(channel, method, request, resp_cls, metadata=None):
    fn = channel.unary_unary(
        method,
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=resp_cls.FromString,
    )
    return fn(request, metadata=metadata)


def rest(base, method, path, body=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())["result"]


def _package(toc_cls, rest_cls, make, path, x, docs):
    """Start one package's REST and gRPC servers over a fresh storage and
    write the same collections into it → (handles, channel, REST base)."""
    toc = toc_cls(path)
    srv = rest_cls(toc, port=0)
    srv.start_background()
    server, port = make(toc, port=0)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    base = f"http://127.0.0.1:{srv.port}"
    rest(base, "PUT", "/collections/dense", {"vectors": {"size": D, "distance": "Euclid"}})
    rest(base, "PUT", "/collections/dense/points?wait=true", {"points": [
        {"id": i, "vector": x[i].tolist(), "payload": {"g": i % 3}} for i in range(len(x))]})
    rest(base, "PUT", "/collections/mv", {"vectors": {"colbert": {
        "size": DM, "distance": "Cosine", "multivector_config": {"comparator": "max_sim"}}}})
    up = M["UpsertPoints"](collection_name="mv")
    for i, doc in enumerate(docs):
        p = up.points.add()
        p.id.num = i
        for row in doc:
            p.vectors.vectors.vectors["colbert"].multi_dense.vectors.add().data.extend(
                row.tolist())
    resp = unary(channel, "/qdrant.Points/Upsert", up, M["PointsOperationResponse"])
    assert resp.result.status == 2  # Completed
    return (toc, srv, server), channel, base


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The port and the JAX package, each serving REST and gRPC over the same
    collections written the same way."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((40, D)).astype(np.float32)
    docs = [rng.standard_normal((int(t), DM)).astype(np.float32)
            for t in rng.integers(2, 7, 30)]
    port, channel, base = _package(
        TableOfContent, RestServer, make_server,
        str(tmp_path_factory.mktemp("storage")), x, docs)
    ref, jax_channel, _ = _package(
        JaxTableOfContent, JaxRestServer, jax_make_server,
        str(tmp_path_factory.mktemp("jax_storage")), x, docs)
    yield {"channel": channel, "jax_channel": jax_channel, "base": base, "x": x,
           "docs": docs, "rng": rng}
    for ch, (toc, srv, server) in ((channel, port), (jax_channel, ref)):
        ch.close()
        server.stop(0)
        srv.shutdown()
        toc.close()


def test_dense_search_matches_rest(env):
    ch, base = env["channel"], env["base"]
    for qi in range(3):
        q = env["rng"].standard_normal(D).astype(np.float32)
        want = rest(base, "POST", "/collections/dense/points/search",
                    {"vector": q.tolist(), "limit": 5})
        search = M["SearchPoints"](collection_name="dense", vector=q.tolist(), limit=5)
        got = unary(ch, "/qdrant.Points/Search", search, M["SearchResponse"]).result
        assert [p.id.num for p in got] == [h["id"] for h in want]
        np.testing.assert_allclose([p.score for p in got], [h["score"] for h in want],
                                   rtol=1e-6)
        query = M["QueryPoints"](collection_name="dense", limit=5)
        query.query.nearest.dense.data.extend(q.tolist())
        cond = query.filter.must.add()
        cond.field.key = "g"
        cond.field.match.integer = 1
        got = unary(ch, "/qdrant.Points/Query", query, M["QueryResponse"]).result
        want = rest(base, "POST", "/collections/dense/points/query",
                    {"query": q.tolist(), "limit": 5,
                     "filter": {"must": [{"key": "g", "match": {"value": 1}}]}})["points"]
        assert [p.id.num for p in got] == [h["id"] for h in want]
        assert all(h["id"] % 3 == 1 for h in want)


def test_multi_dense_query_matches_rest(env):
    ch, base, docs = env["channel"], env["base"], env["docs"]
    for qi in (0, 11, 29):
        q = docs[qi][:2] + 0.01
        query = M["QueryPoints"](collection_name="mv", limit=4, using="colbert")
        for row in q:
            query.query.nearest.multi_dense.vectors.add().data.extend(row.tolist())
        got = unary(ch, "/qdrant.Points/Query", query, M["QueryResponse"]).result
        want = rest(base, "POST", "/collections/mv/points/query",
                    {"query": q.tolist(), "using": "colbert", "limit": 4})["points"]
        assert [p.id.num for p in got] == [h["id"] for h in want]
        assert want[0]["id"] == qi
        np.testing.assert_allclose([p.score for p in got], [h["score"] for h in want],
                                   rtol=1e-6)
    get = M["GetPoints"](collection_name="mv")
    get.ids.add().num = 5
    get.with_vectors.enable = True
    rec = unary(ch, "/qdrant.Points/Get", get, M["GetResponse"]).result[0]
    rows = [list(v.data) for v in rec.vectors.vectors.vectors["colbert"].multi_dense.vectors]
    norm = docs[5] / np.linalg.norm(docs[5], axis=1, keepdims=True)
    np.testing.assert_allclose(rows, norm, rtol=1e-6)


def _requests(env):
    """The gRPC requests both packages answer: (method, request, response)."""
    rng = np.random.default_rng(12)
    out = []
    for _ in range(3):
        q = rng.standard_normal(D).astype(np.float32)
        out.append(("/qdrant.Points/Search",
                     M["SearchPoints"](collection_name="dense", vector=q.tolist(), limit=5),
                     M["SearchResponse"]))
        query = M["QueryPoints"](collection_name="dense", limit=5)
        query.query.nearest.dense.data.extend(q.tolist())
        cond = query.filter.must.add()
        cond.field.key = "g"
        cond.field.match.integer = 2
        out.append(("/qdrant.Points/Query", query, M["QueryResponse"]))
    for qi in (0, 11, 29):
        query = M["QueryPoints"](collection_name="mv", limit=4, using="colbert")
        for row in env["docs"][qi][:2] - 0.02:
            query.query.nearest.multi_dense.vectors.add().data.extend(row.tolist())
        out.append(("/qdrant.Points/Query", query, M["QueryResponse"]))
    return out


@pytest.mark.parametrize("kind", ["dense_search", "dense_filtered_query", "multi_dense_query"])
def test_grpc_matches_jax(env, kind):
    picked = {"dense_search": slice(0, 6, 2), "dense_filtered_query": slice(1, 6, 2),
              "multi_dense_query": slice(6, 9)}[kind]
    for method, request, resp_cls in _requests(env)[picked]:
        got = unary(env["channel"], method, request, resp_cls).result
        want = unary(env["jax_channel"], method, request, resp_cls).result
        assert len(got) == len(want) > 0
        assert [p.id.num for p in got] == [p.id.num for p in want]
        np.testing.assert_allclose([p.score for p in got], [p.score for p in want],
                                   rtol=1e-5)


def test_grpc_api_key_refused(tmp_path):
    toc = TableOfContent(str(tmp_path / "sec"))
    server, port = make_server(toc, port=0, api_key="topsecret")
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    try:
        with pytest.raises(grpc.RpcError) as e:
            unary(channel, "/qdrant.Qdrant/HealthCheck", M["HealthCheckRequest"](),
                  M["HealthCheckReply"])
        assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED
        reply = unary(channel, "/qdrant.Qdrant/HealthCheck", M["HealthCheckRequest"](),
                      M["HealthCheckReply"], metadata=(("api-key", "topsecret"),))
        assert reply.version
    finally:
        channel.close()
        server.stop(0)
        toc.close()


# a server process with `grpc` (and protobuf) made unimportable
_NO_GRPC = """
import runpy, sys
sys.modules["grpc"] = None
sys.modules["google.protobuf"] = None
sys.argv = ["qdrant_tpu_torch"] + sys.argv[1:]
runpy.run_module("qdrant_tpu_torch", run_name="__main__", alter_sys=True)
"""


def _serve(tmp_path, block_grpc):
    env = {**os.environ, "PYTHONPATH": ROOT, "QDRANT__TELEMETRY_DISABLED": "true",
           "QDRANT__SERVICE__GRPC_PORT": "0"}
    args = ["--force-cpu", "--storage-dir", str(tmp_path), "--http-port", "0"]
    cmd = ([sys.executable, "-c", _NO_GRPC] if block_grpc
           else [sys.executable, "-m", "qdrant_tpu_torch"]) + args
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    lines = []
    deadline = time.monotonic() + 120
    try:
        while time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            if "gRPC server not started" in line or "gRPC listening" in line:
                http = int(re.search(r"http://[\d.]+:(\d+)", "".join(lines)).group(1))
                grpc_port = re.search(r"gRPC listening on [\d.]+:(\d+)", line)
                return proc, http, grpc_port and int(grpc_port.group(1)), lines
    except BaseException:
        proc.kill()
        raise
    proc.kill()
    raise AssertionError("".join(lines))


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        _, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    return proc.returncode, err


def test_entry_point_serves_grpc_and_stops(tmp_path):
    proc, http, grpc_port, _ = _serve(tmp_path, block_grpc=False)
    assert grpc_port
    channel = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
    try:
        reply = unary(channel, "/qdrant.Qdrant/HealthCheck", M["HealthCheckRequest"](),
                      M["HealthCheckReply"])
        assert reply.version
        assert rest(f"http://127.0.0.1:{http}", "GET", "/collections")["collections"] == []
    finally:
        channel.close()
        rc, err = _stop(proc)
    assert rc == 0, err[-2000:]


def test_entry_point_without_grpc_serves_rest(tmp_path):
    proc, http, grpc_port, lines = _serve(tmp_path, block_grpc=True)
    try:
        assert grpc_port is None and "gRPC server not started" in lines[-1]
        base = f"http://127.0.0.1:{http}"
        rest(base, "PUT", "/collections/c", {"vectors": {"size": 2, "distance": "Dot"}})
        rest(base, "PUT", "/collections/c/points?wait=true",
             {"points": [{"id": 1, "vector": [1.0, 0.0]}]})
        hits = rest(base, "POST", "/collections/c/points/search", {"vector": [1.0, 0.0]})
        assert [h["id"] for h in hits] == [1]
    finally:
        rc, err = _stop(proc)
    assert rc == 0, err[-2000:]
