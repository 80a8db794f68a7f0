"""mesh.subgraph_build_s (s): wall time of the port's `mesh.subgraph` spans
over the run: ShardedHnswIndex.build's per-shard subgraph builds (the subset
build and the re-basing of its links to the shard's own offsets)."""

from portbench import program_spans


def read(ctx):
    return program_spans.total("mesh.subgraph")
