"""latency.p95_ms (ms): the 95th percentile of the client-side latency (send
to answer) of every search answered between the window's two snapshots."""

import numpy as np


def read(ctx):
    t_a, t_b = ctx.span_window
    t = ctx.req["t_recv"]
    ok = (t > t_a) & (t <= t_b) & (ctx.req["status"] == 200)
    if not ok.any():
        return None
    return float(np.percentile((t - ctx.req["t_send"])[ok], 95)) * 1e3
