"""scan.bf16_roofline (%): the exact scan step's least time (bytes over the
HBM rate, or operations over the peaks: portbench/roofline.py) over the
device time of every op launched inside PlainIndex._scan_search_device (the
bf16 fused scan and merge, the query upload, the f32 rescore and its
top-k), per call, in the traced sub-window. Against the H100 SXM data-sheet
peaks; the run prints the card's power limit."""

from portbench import roofline

SPANS = {"scan.bf16": ["qdrant_tpu_torch.index.plain:PlainIndex._scan_search_device"]}


def _describe(index, q, k, filter_mask=None):
    n = len(index.store)
    return roofline.scan_step("bf16", b=q.shape[0], n=n, d=q.shape[1], k=k,
                              k_fetch=min(max(2 * k, k + 8), n))


DESCRIBE = {"scan.bf16": _describe}


def read(ctx):
    return roofline.span_share(ctx, "scan.bf16")
