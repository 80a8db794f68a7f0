"""seal.flush_s (s): wall time of the flush that ends the seal, the port's
span path `shard.optimize/shard.swap/shard.flush` (the sealed segment saved
with its graph and fsynced, after the replaced segment's directory is
removed)."""

from portbench import program_spans


def read(ctx):
    return program_spans.total("shard.optimize/shard.swap/shard.flush")
