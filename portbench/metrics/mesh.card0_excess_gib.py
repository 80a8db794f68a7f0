"""mesh.card0_excess_gib (GiB): device memory allocated on the first card
less the mean over the other cards (torch.cuda.memory_allocated of each),
at the traced window's start: what the first card of a device mesh holds
beyond its shard (the store's f32 block, the coordinator's merge). None
with fewer than two cards."""


def snapshot():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        return None
    return [torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count())]


def read(ctx):
    per_card = (ctx.snapshots.get("start") or {}).get("mesh.card0_excess_gib")
    if not per_card:
        return None
    return (per_card[0] - sum(per_card[1:]) / (len(per_card) - 1)) / 2**30
