"""Inspect a segment (or a shard's segments dir): `python -m
qdrant_tpu_torch.tools.segment_inspector [--force-cpu] <segment_dir|segments_root>`
(counterpart of qdrant_tpu/tools/segment_inspector.py; reference:
src/segment_inspector.rs — prints config, counts, index state per segment).
It loads segments on the CUDA device; `--force-cpu` (or
QDRANT_TPU_FORCE_CPU=1) loads them on the CPU, and without a card and
without that request it refuses, as the server does."""

from __future__ import annotations

import os
import sys


def _inspect_one(path: str) -> None:
    from ..storage.segment import Segment

    seg = Segment.load(path)
    print(f"segment: {path}")
    print(f"  version: {seg.version}  appendable: {seg.appendable}")
    print(f"  points: {len(seg)} live / {seg.total_offsets} slots "
          f"({seg.total_offsets - len(seg)} deleted)")
    for name, store in seg.dense.items():
        label = name or "<default>"
        print(f"  dense[{label}]: dim={store.dim} distance={store.distance.value} "
              f"datatype={store.datatype.value}")
        if name in seg.hnsw:
            idx = seg.hnsw[name]
            print(f"    hnsw: m={idx.config.m} ef_construct={idx.config.ef_construct} "
                  f"levels={getattr(idx, 'num_levels', '?')}")
        if name in seg.quantized:
            print(f"    quantized: {type(seg.quantized[name]).__name__}")
    for name in seg.sparse:
        print(f"  sparse[{name or '<default>'}]")
    for name, store in seg.multi.items():
        print(f"  multi[{name or '<default>'}]: dim={store.dim}")
        if name in seg.hnsw_multi:
            print("    hnsw (pooled proxy): built")
    fields = seg.payload_index.indexed_fields()
    if fields:
        print(f"  payload indexes: {', '.join(f'{k}:{v.type.value}' for k, v in fields.items())}")


def main(argv=None) -> int:
    from ..device import default_device, force_cpu

    argv = list(argv if argv is not None else sys.argv[1:])
    if "--force-cpu" in argv:
        argv.remove("--force-cpu")
        force_cpu()
    if not argv:
        print("usage: python -m qdrant_tpu_torch.tools.segment_inspector "
              "[--force-cpu] <dir>", file=sys.stderr)
        return 2
    try:  # no card and no request for the CPU: refuse
        default_device()
    except RuntimeError as exc:
        print(exc, file=sys.stderr)
        return 2
    path = argv[0]
    if os.path.isfile(os.path.join(path, "segment.json")):
        _inspect_one(path)
        return 0
    found = False
    for sub in sorted(os.listdir(path)):
        seg_path = os.path.join(path, sub)
        if os.path.isfile(os.path.join(seg_path, "segment.json")):
            _inspect_one(seg_path)
            found = True
    if not found:
        print(f"no segments under {path}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
