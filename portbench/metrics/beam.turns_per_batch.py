"""beam.turns_per_batch (turns): the graph beam's turns (the port's counter
`beam.turns`) per HnswIndex.search call (`hnsw.search` spans), over the
timeline this reader holds. Every fourth turn reads the beam's stop flag, a
host sync (`beam.flag_reads`)."""

from portbench import program_spans

_TIMELINE = program_spans.Timeline()


def snapshot():
    return _TIMELINE.toggle()


def read(ctx):
    start = ctx.snapshots["start"].get("beam.turns_per_batch")
    end = ctx.snapshots["end"].get("beam.turns_per_batch")
    calls = len(program_spans.records("hnsw.search"))
    if start is None or end is None or not calls:
        return None
    turns = end.get("beam.turns", 0) - start.get("beam.turns", 0)
    return turns / calls if turns > 0 else None
