"""segment.alive_mask_cpu_share (%): the serving thread's CPU time over the
wall time of Segment.alive_mask (the port's `segment.alive_mask` spans), in
the traced sub-window. Under 100 the call waited, for the interpreter lock
or for something else."""

from portbench import program_spans

_TIMELINE = program_spans.Timeline()


def snapshot():
    return _TIMELINE.toggle()


def read(ctx):
    recs = program_spans.window_records(ctx, "segment.alive_mask")
    wall = sum(b - a for a, b, *_ in recs)
    if wall <= 0:
        return None
    return 100.0 * sum(info["cpu"] for _, _, info, _ in recs) / wall
