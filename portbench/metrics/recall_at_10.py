"""recall_at_10 (fraction): over every search answered in the window, the
returned ids found in the reference's exact top-10, over 10 per search."""

import math


def read(ctx):
    v = ctx.numbers["recall_at_10"]
    return None if math.isnan(v) else v
