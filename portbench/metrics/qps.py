"""qps (req/s): searches answered with HTTP 200 in the window, over the
window's wall time: all the work over all the time."""


def read(ctx):
    t0, t1 = ctx.window
    return float(ctx.answered.sum()) / (t1 - t0)
