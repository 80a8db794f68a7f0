"""The port's entry point in cluster mode: `python -m qdrant_tpu_torch
--force-cpu --uri ...` starts a peer, a second one joins it with
`--bootstrap`; both list two peers and serve a replicated write and a search.
The same runs with jax and qdrant_tpu made unimportable."""

import os
import socket
import subprocess
import sys

import pytest

from test_torch_cluster import call, wait_for

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_peer(tmp_path, name, port, bootstrap=None, prefix=()):
    env = {**os.environ, "PYTHONPATH": ROOT, "QDRANT__TELEMETRY_DISABLED": "true",
           "QDRANT__SERVICE__GRPC_PORT": "0", "OMP_NUM_THREADS": "1"}
    env.pop("QDRANT_TPU_FORCE_CPU", None)  # the flag alone asks for the CPU
    args = [*prefix, "--force-cpu", "--storage-dir", str(tmp_path / name),
            "--http-port", str(port), "--uri", f"http://127.0.0.1:{port}"]
    if bootstrap:
        args += ["--bootstrap", f"http://127.0.0.1:{bootstrap}"]
    log = open(tmp_path / f"{name}.log", "w")
    proc = subprocess.Popen(args, env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    proc.log_path = log.name
    return proc


def _logs(procs):
    return {p.log_path: open(p.log_path).read()[-3000:] for p in procs}


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


_BLOCKED = (
    "import builtins, runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['qdrant_tpu'] = None\n"
    "_import = builtins.__import__\n"
    "def _guard(name, *a, **k):\n"
    "    if name.split('.')[0] in ('jax', 'qdrant_tpu'):\n"
    "        raise SystemExit('blocked import attempted: ' + name)\n"
    "    return _import(name, *a, **k)\n"
    "builtins.__import__ = _guard\n"
    "sys.argv = ['qdrant_tpu_torch'] + sys.argv[1:]\n"
    "runpy.run_module('qdrant_tpu_torch', run_name='__main__', alter_sys=True)\n"
)


@pytest.mark.parametrize("blocked", [False, True], ids=["entry_point", "jax_blocked"])
def test_entry_point_forms_a_cluster(tmp_path, blocked):
    """Peer 1 starts alone with --uri, peer 2 joins with --bootstrap; both
    list two peers, and a write through peer 2 is read back through either.
    `jax_blocked` runs both processes with jax and qdrant_tpu unimportable
    (an attempt to import either ends the process)."""
    prefix = ([sys.executable, "-c", _BLOCKED] if blocked
              else [sys.executable, "-m", "qdrant_tpu_torch"])
    p1, p2 = _free_port(), _free_port()
    procs = [_start_peer(tmp_path, "a", p1, prefix=prefix)]
    try:
        assert wait_for(lambda: call(p1, "GET", "/cluster")["raft_info"]["role"] == "leader",
                        step=0.2), _logs(procs)
        procs.append(_start_peer(tmp_path, "b", p2, bootstrap=p1, prefix=prefix))
        assert wait_for(lambda: all(len(call(p, "GET", "/cluster")["peers"]) == 2
                                    for p in (p1, p2)), step=0.2), _logs(procs)
        call(p1, "PUT", "/collections/ep", {"vectors": {"size": 4, "distance": "Euclid"},
                                            "replication_factor": 2})
        assert wait_for(lambda: call(p2, "GET", "/collections/ep")["status"] == "green",
                        step=0.2)
        call(p2, "PUT", "/collections/ep/points?wait=true", {"points": [
            {"id": i, "vector": [float(i), 0.0, 0.0, 1.0]} for i in range(20)]})
        for p in (p1, p2):
            hits = call(p, "POST", "/collections/ep/points/search",
                        {"vector": [3.1, 0, 0, 1], "limit": 2})
            assert [h["id"] for h in hits] == [3, 4]
            assert call(p, "POST", "/collections/ep/points/count", {})["count"] == 20
    finally:
        _stop(procs)
    assert [p.returncode for p in procs] == [0, 0], _logs(procs)


@pytest.mark.parametrize("args,env,message", [
    (["--bootstrap", "http://127.0.0.1:9"], {}, "--bootstrap needs --uri"),
    ([], {"QDRANT__CLUSTER__ENABLED": "true"}, "cluster.enabled needs --uri"),
], ids=["bootstrap_without_uri", "cluster_enabled_without_uri"])
def test_cluster_mode_needs_uri(tmp_path, args, env, message):
    """A peer the others cannot reach is refused with a usage error (the JAX
    entry point serves standalone when `cluster.enabled` lacks `--uri`)."""
    proc = subprocess.run(
        [sys.executable, "-m", "qdrant_tpu_torch", "--force-cpu", "--storage-dir",
         str(tmp_path), *args],
        env={**os.environ, "PYTHONPATH": ROOT, "QDRANT__TELEMETRY_DISABLED": "true", **env},
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2 and message in proc.stderr, proc.stderr[-2000:]
    assert not os.path.exists(tmp_path / "raft")
