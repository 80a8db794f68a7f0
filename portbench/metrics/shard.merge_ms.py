"""shard.merge_ms (ms): mean self time of the shard's per-hit Python merge
(the port's `shard.merge` spans: wall less any device call inside), in the
traced sub-window."""

from portbench import program_spans

_TIMELINE = program_spans.Timeline()


def snapshot():
    return _TIMELINE.toggle()


def read(ctx):
    recs = program_spans.window_records(ctx, "shard.merge")
    return sum(info["self"] for _, _, info, _ in recs) / len(recs) * 1e3 if recs else None
