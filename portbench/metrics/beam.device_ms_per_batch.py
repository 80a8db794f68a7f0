"""beam.device_ms_per_batch (ms): device time of the ops launched inside
HnswIndex.search, per call, in the traced sub-window."""

SPANS = {"hnsw.search": ["qdrant_tpu_torch.index.hnsw:HnswIndex.search"]}


def read(ctx):
    tr = ctx.trace or {}
    calls = tr.get("range_calls", {}).get("hnsw.search", 0)
    busy = tr.get("range_device_s", {}).get("hnsw.search", 0.0)
    if not calls or busy <= 0:
        return None
    return busy / calls * 1e3
