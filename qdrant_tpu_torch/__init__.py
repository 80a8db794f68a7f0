"""qdrant-tpu-torch: the PyTorch / CUDA port of the qdrant-tpu engine.

A second package beside `qdrant_tpu` (the JAX reference). It mirrors that
package's module layout; modules whose import chain never reaches jax
(types, settings, WAL, id tracker, payload storage and index, hash ring,
auth, metrics, most of utils) are imported from `qdrant_tpu` rather than
copied. This package imports torch and never jax.

Ported so far: exact dense search through REST on one CUDA device — the
dense branch of Segment, PlainIndex, ScanIndex and the hand-written Hopper
fused-scan kernel (csrc/fused_scan.cu), plus the collection / shard / query
/ REST shell above them.
"""

import os as _os
import sys as _sys


def _import_reference_package() -> None:
    """Import `qdrant_tpu` without loading jax: its __init__ sets up the JAX
    compilation cache (importing jax) unless QDRANT_TPU_JAX_CACHE=0. The
    variable is set only for that import and restored afterwards."""
    if "qdrant_tpu" in _sys.modules:
        return
    prev = _os.environ.get("QDRANT_TPU_JAX_CACHE")
    _os.environ["QDRANT_TPU_JAX_CACHE"] = "0"
    try:
        import qdrant_tpu  # noqa: F401
    finally:
        if prev is None:
            del _os.environ["QDRANT_TPU_JAX_CACHE"]
        else:
            _os.environ["QDRANT_TPU_JAX_CACHE"] = prev


_import_reference_package()
