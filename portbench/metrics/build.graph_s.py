"""build.graph_s (s): time in HnswIndex.build during the seal (the main
graph; these configurations have no payload, so no block subgraphs)."""

SPANS = {"build.graph": ["qdrant_tpu_torch.index.hnsw:HnswIndex.build"]}


def read(ctx):
    d = [b - a for a, b, *_ in ctx.spans.get("build.graph", [])]
    return sum(d) if d else None
