"""mesh.merge_ms (ms): device time of the ops launched inside the device
mesh's merge (parallel/mesh.py::_merge: the copies of the per-shard
candidates to the first card and the top-k over them), per call, in the
traced sub-window."""

SPANS = {"mesh.merge": ["qdrant_tpu_torch.parallel.mesh:_merge"]}


def read(ctx):
    tr = ctx.trace or {}
    calls = tr.get("range_calls", {}).get("mesh.merge", 0)
    busy = tr.get("range_device_s", {}).get("mesh.merge", 0.0)
    if not calls or busy <= 0:
        return None
    return busy / calls * 1e3
