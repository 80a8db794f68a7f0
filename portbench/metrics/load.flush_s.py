"""load.flush_s (s): wall time of the bulk load's flush, the port's span
path `shard.bulk_ingest/shard.flush` (LocalShard._flush_locked: every
segment's Segment.save and its fsync, then the WAL's ack)."""

from portbench import program_spans


def read(ctx):
    return program_spans.total("shard.bulk_ingest/shard.flush")
