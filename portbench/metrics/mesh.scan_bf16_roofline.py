"""mesh.scan_bf16_roofline (%): one shard's least time for its scan step
(portbench/roofline.py over the shard's n_pad / S stored rows) over the mean
device time per card and call of the ops launched inside
parallel/mesh.py::sharded_scan_rescore outside its merge (the query copies,
the bf16 fused scan and the f32 rescore on every shard), in the traced
sub-window. Against the H100 SXM data-sheet peaks; the run prints the
card's power limit."""

from portbench import roofline

SPANS = {
    "mesh.scan": ["qdrant_tpu_torch.parallel.mesh:sharded_scan_rescore"],
    # its own range, so that the merge's ops are not counted as the scan's
    "mesh.merge": ["qdrant_tpu_torch.parallel.mesh:_merge"],
}


def _describe(mesh, queries, v_bf16, bias, v_f32, blk, k_fetch, k, euclid):
    step = roofline.scan_step("bf16", b=queries.shape[0], n=v_bf16[0].shape[0],
                              d=queries.shape[1], k=min(k, k_fetch), k_fetch=k_fetch)
    return dict(step, cards=len(set(mesh.devices)))


DESCRIBE = {"mesh.scan": _describe}


def read(ctx):
    tr = ctx.trace or {}
    calls = tr.get("range_calls", {}).get("mesh.scan", 0)
    busy = tr.get("range_device_s", {}).get("mesh.scan", 0.0)
    w0, w1 = ctx.profile_window
    infos = [info for a, b, info, _ in ctx.spans.get("mesh.scan", []) if w0 <= a and b <= w1]
    if not calls or busy <= 0 or not infos:
        return None
    bound = sum(i["bound_s"] for i in infos) / len(infos)
    cards = sum(i["cards"] for i in infos) / len(infos)
    return 100.0 * bound / (busy / calls / cards)
