"""mesh.place_s (s): wall time of the port's `mesh.place` spans over the run
(parallel/mesh.py::placing): laying a sealed segment out on a device mesh,
each ended by a synchronise of every card of the mesh. At the seal of a
mesh cell, the graph's per-shard rows and links and the scan's per-shard
bf16 blocks, biases and f32 rescore rows."""

from portbench import program_spans


def read(ctx):
    return program_spans.total("mesh.place")
