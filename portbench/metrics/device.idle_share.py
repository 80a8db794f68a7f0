"""device.idle_share (%): share of the traced sub-window in which no kernel,
copy or memset ran on the card."""


def read(ctx):
    tr = ctx.trace or {}
    if not tr.get("trace_window_s") or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["trace_window_s"])
