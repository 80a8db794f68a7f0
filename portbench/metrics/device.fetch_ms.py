"""device.fetch_ms (ms): host wait in the port's `device.fetch` spans
(fetch_to_host, the graph search's copy of its beam to the host: where the
serving host waits for the card) per shard batch (`shard.batch` spans), in
the traced sub-window."""

from portbench import program_spans

_TIMELINE = program_spans.Timeline()


def snapshot():
    return _TIMELINE.toggle()


def read(ctx):
    batches = len(program_spans.window_records(ctx, "shard.batch"))
    if not batches:
        return None
    wait = sum(b - a for a, b, *_ in program_spans.window_records(ctx, "device.fetch"))
    return wait / batches * 1e3
