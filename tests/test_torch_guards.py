"""Guards on the port's boundaries.

* qdrant_tpu_torch runs with jax made unimportable: a subprocess blocks jax,
  serves REST over a TableOfContent on the CPU and runs a search; no import
  of jax was even attempted, and no qdrant_tpu module that imports jax is
  loaded afterwards.
* No source file of the port imports jax.
* The shell modules copied from qdrant_tpu (shard, collection, query, toc,
  rest, openapi) equal their originals once import lines are normalised, so
  the copies cannot drift apart.
"""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_IMPORT = re.compile(r"^\s*(import jax\b|from jax\b)", re.M)

_SUBPROCESS = r"""
import builtins, importlib, json, pkgutil, sys, tempfile, urllib.request
sys.modules["jax"] = None  # any `import jax` now raises ImportError
attempts = []  # ... and is recorded, even where the caller swallows the error
_import = builtins.__import__
def _recording_import(name, *args, **kwargs):
    if name == "jax" or name.startswith("jax."):
        attempts.append(name)
    return _import(name, *args, **kwargs)
builtins.__import__ = _recording_import
import numpy as np
import qdrant_tpu_torch
for m in pkgutil.walk_packages(qdrant_tpu_torch.__path__, "qdrant_tpu_torch."):
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
call("GET", "/telemetry?details_level=3")
call("GET", "/openapi.json")
srv.shutdown()
toc.close()
print(json.dumps({"attempts": attempts,
                  "loaded": sorted(m for m in sys.modules if m.startswith("qdrant_tpu."))}))
"""


def _jax_modules():
    """qdrant_tpu modules whose source imports jax (the package's own
    __init__ excepted: it swallows a failed jax import)."""
    out = set()
    base = os.path.join(ROOT, "qdrant_tpu")
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py") and f != "__init__.py":
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    if JAX_IMPORT.search(fh.read()):
                        rel = os.path.relpath(path, ROOT)[:-3]
                        out.add(rel.replace(os.sep, "."))
    return out


def test_port_runs_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    import json

    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["attempts"] == []  # not even a swallowed `import jax`
    loaded = set(out["loaded"])
    jax_mods = _jax_modules()
    assert "qdrant_tpu.storage.segment" in jax_mods  # the scan found them
    assert not loaded & jax_mods, sorted(loaded & jax_mods)


def test_no_jax_import_in_port_sources():
    offenders = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "qdrant_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    if JAX_IMPORT.search(fh.read()):
                        offenders.append(os.path.join(dirpath, f))
    assert not offenders


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


@pytest.mark.parametrize(
    "rel",
    [
        "collection/shard.py",
        "collection/collection.py",
        "collection/query.py",
        "api/toc.py",
        "api/rest.py",
        "api/openapi.py",
    ],
)
def test_copied_shell_equals_original(rel):
    assert _normalised("qdrant_tpu_torch", rel) == _normalised("qdrant_tpu", rel)
