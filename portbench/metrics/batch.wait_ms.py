"""batch.wait_ms (ms): mean queue wait of a search request in the
micro-batcher, from its enqueue to the start of the batch that serves it
(the port's `batch.wait` spans, utils/microbatch.py), over the requests
whose wait ends in the traced sub-window."""

from portbench import program_spans

_TIMELINE = program_spans.Timeline()


def snapshot():
    return _TIMELINE.toggle()


def read(ctx):
    d = [b - a for a, b, *_ in program_spans.window_records(ctx, "batch.wait")]
    return sum(d) / len(d) * 1e3 if d else None
