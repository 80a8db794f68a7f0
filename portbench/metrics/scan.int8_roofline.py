"""scan.int8_roofline (%): as scan.bf16_roofline, for the quantized branch's
step (Segment._search_sq_kernel: the int8 fused scan over the SQ codes, the
bias and query uploads, the f32 rescore of k_over = min(max(k_over, 128),
1,024) candidates a query and its top-k)."""

from portbench import roofline

SPANS = {"scan.int8": ["qdrant_tpu_torch.storage.segment:Segment._search_sq_kernel"]}


def _describe(segment, quant, store, q, k, k_over, mask, params):
    k_fetch = min(max(k_over, 128), 1024)
    return roofline.scan_step("int8", b=q.shape[0], n=len(store), d=q.shape[1], k=k,
                              k_fetch=k_fetch, rescore=bool(params.quantization_rescore))


DESCRIBE = {"scan.int8": _describe}


def read(ctx):
    return roofline.span_share(ctx, "scan.int8")
