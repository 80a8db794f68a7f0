"""shard.ms_per_batch (ms): host time of one shard batch (Shard.search_dense,
or search_dense_many when the micro-batcher hands over several), spans
ending in the window."""

SPANS = {"shard.batch": ["qdrant_tpu_torch.collection.shard:LocalShard.search_dense",
                         "qdrant_tpu_torch.collection.shard:LocalShard.search_dense_many"]}


def read(ctx):
    t_a, t_b = ctx.span_window
    d = [b - a for a, b, *_ in ctx.spans.get("shard.batch", []) if t_a < b <= t_b]
    return sum(d) / len(d) * 1e3 if d else None
