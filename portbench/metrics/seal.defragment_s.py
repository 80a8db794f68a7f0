"""seal.defragment_s (s): host time in Shard._defragment_into during the
seal (the optimizer's copy of the rows into the new segment)."""

SPANS = {"seal.defragment": ["qdrant_tpu_torch.collection.shard:LocalShard._defragment_into"]}


def read(ctx):
    d = [b - a for a, b, *_ in ctx.spans.get("seal.defragment", [])]
    return sum(d) if d else None
