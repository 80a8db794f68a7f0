"""Nothing under portbench/ imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port either."""

from __future__ import annotations

import ast
import os

import pytest

from conftest import PKG_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "qdrant_tpu"}


def _sources():
    for dirpath, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and ":" in node.value and "." in node.value.split(":")[0]:
            out.add(node.value.split(":")[0].split(".")[0])  # a span's target
    return out


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, PKG_DIR))
def test_no_jax_import(path):
    assert not (_imported(path) & FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(PKG_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = _imported(os.path.join(ref, f))
            assert not (names & (FORBIDDEN | {"qdrant_tpu_torch", "portbench"})), f


def test_the_guard_compares_whole_names():
    assert "qdrant_tpu_torch" not in FORBIDDEN and "qdrant_tpu" in FORBIDDEN
