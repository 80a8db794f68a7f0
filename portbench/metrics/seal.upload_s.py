"""seal.upload_s (s): wall time of the seal's uploads besides the graph, the
port's spans `segment.scan_block` (the bf16 scan block) and
`segment.quantize` (the encode and the upload of the codes), both inside
Segment.build_indexes."""

from portbench import program_spans


def read(ctx):
    return program_spans.total("segment.scan_block", "segment.quantize")
