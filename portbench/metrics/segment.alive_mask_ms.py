"""segment.alive_mask_ms (ms): host time of one Segment.alive_mask call,
spans ending in the window."""

SPANS = {"segment.alive_mask": ["qdrant_tpu_torch.storage.segment:Segment.alive_mask"]}


def read(ctx):
    t_a, t_b = ctx.span_window
    d = [b - a for a, b, *_ in ctx.spans.get("segment.alive_mask", []) if t_a < b <= t_b]
    return sum(d) / len(d) * 1e3 if d else None
