"""rest.handler_ms (ms): the port's own request metrics (api/metrics.py
METRICS, duration sum over count) for POST points/search, over the window.
The span around _Handler.do_POST only names idle gaps in the trace."""

SPANS = {"rest.handler": ["qdrant_tpu_torch.api.rest:_Handler.do_POST"]}
ENDPOINT = "/points/search$"


def snapshot():
    from qdrant_tpu_torch.api.metrics import METRICS

    with METRICS._lock:
        for (method, pattern), total in METRICS.duration_sum.items():
            if method == "POST" and pattern.endswith(ENDPOINT):
                return total, METRICS.duration_count[(method, pattern)]
    return 0.0, 0


def read(ctx):
    (s0, c0), (s1, c1) = ctx.snapshots["start"]["rest.handler_ms"], \
        ctx.snapshots["end"]["rest.handler_ms"]
    if c1 <= c0:
        return None
    return (s1 - s0) / (c1 - c0) * 1e3
