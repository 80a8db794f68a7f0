"""batch.rows_per_batch (rows): searches answered per device batch in the
window. Batches are the fused scan's launches (the port's counters, bf16 and
int8 modes) plus the HnswIndex.search calls (a span)."""

SPANS = {"hnsw.search": ["qdrant_tpu_torch.index.hnsw:HnswIndex.search"]}


def snapshot():
    from qdrant_tpu_torch.ops import fused_scan as fs

    return fs.fused_scan_survivors.launches + fs.fused_scan_survivors.launches_int8


def read(ctx):
    t_a, t_b = ctx.span_window
    launches = ctx.snapshots["end"]["batch.rows_per_batch"] - \
        ctx.snapshots["start"]["batch.rows_per_batch"]
    beams = sum(1 for a, b, *_ in ctx.spans.get("hnsw.search", []) if t_a < b <= t_b)
    t = ctx.req["t_recv"]
    answered = int(((t > t_a) & (t <= t_b) & (ctx.req["status"] == 200)).sum())
    if launches + beams == 0:
        return None
    return answered / (launches + beams)
