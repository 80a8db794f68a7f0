"""device_gib (GiB): torch.cuda.max_memory_allocated over set-up and window,
counted from the reset after the benchmark's own data was freed, read
before the reference runs."""


def read(ctx):
    if not ctx.memory_peak_bytes:
        return None
    return ctx.memory_peak_bytes / 2**30
