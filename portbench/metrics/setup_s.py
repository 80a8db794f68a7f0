"""setup_s (s): process start (from /proc) to the first answer of the
window: imports, data, server, load and seal, warm-up."""


def read(ctx):
    return ctx.phases["setup_s"]
