"""index_s (s): Collection.bulk_ingest plus TableOfContent.optimize_all, each
ended by a device synchronise: upload to a sealed, indexed collection."""


def read(ctx):
    return ctx.phases["index_s"]
