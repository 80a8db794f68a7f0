"""build.sync_wait_s (s): the part of the graph build in which the host
waited for the device, the port's span path `hnsw.build/build.sync` (the
builder's backpressure syncs every few batches and its final barrier). What
is left of build.graph_s is the host's own time."""

from portbench import program_spans


def read(ctx):
    return program_spans.total("hnsw.build/build.sync")
