"""The split of the fused scan's walk, on the CPU: the chunk chooser and the
ordered merge of partial winners (qdrant_tpu_torch/ops/fused_scan.py).

On the card each slot's walk over its (block, 128-row group) tiles is cut
into contiguous chunks, every chunk's winners go to a scratch, and a merge
kernel keeps per element the first chunk's winner that no later chunk beats.
Here the partials are built with the plain survivors over each chunk's rows
alone (the bias kept there, NEG_INF elsewhere) and merged with the plain
merge; the result must equal the unsplit plain survivors bit for bit. int8
codes in [-8, 8] make integer scores tie often, so ties cross chunk
boundaries and the earliest row must still win.
"""

import numpy as np
import pytest
import torch

from qdrant_tpu_torch.ops import fused_scan as fs
from qdrant_tpu_torch.device import force_cpu

force_cpu()  # the port on the CPU, with the kernels' plain versions


def _int8_case(seed, b, n_pad, d, euclid):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.integers(-8, 9, (n_pad, d)).astype(np.int8))
    q = torch.from_numpy(rng.integers(-8, 9, (b, d)).astype(np.int8))
    dead = rng.random(n_pad) < 0.1
    live = -rng.integers(0, 8, n_pad).astype(np.float32) if euclid else 0.0
    bias = torch.from_numpy(np.where(dead, fs.NEG_INF, live).astype(np.float32))
    scale_sq = float(np.float32((2.0 if euclid else 1.0) * 0.0123 ** 2))
    return q, v, bias, scale_sq


def _partials_by_hand(q, v, bias, blk, slots, chunks, scale_sq):
    """Chunk c's partial: plain survivors over the rows of chunk c of every
    slot's walk, NEG_INF bias elsewhere (independent of chunk_row_mask)."""
    n_pad = v.shape[0]
    parts_s, parts_i = [], []
    for c in range(chunks):
        keep = torch.zeros(n_pad, dtype=torch.bool)
        for s, tiles in enumerate(fs.slot_tiles(n_pad, blk, slots)):
            lo, hi = fs.chunk_bounds(tiles, chunks)[c]
            for t in range(lo, hi):
                r0 = fs.tile_row0(s, t, blk, slots)
                keep[r0 : r0 + fs.LANES] = True
        ps, pi = fs.fused_scan_survivors_plain(
            q, v, torch.where(keep, bias, fs.NEG_INF), blk, slots, scale_sq)
        parts_s.append(ps)
        parts_i.append(pi)
    return torch.stack(parts_s), torch.stack(parts_i)


SPLITS = [
    # b, n_pad, blk, slots, chunks
    (1, 4096, 128, 4, 3),  # one-group blocks: chunks cut between blocks
    (5, 8192, 128, 4, 7),
    (37, 4096 * 3, 4096, 2, 5),  # cuts inside 4,096-row blocks
    (5, 4096 * 3, 4096, 16, 4),  # more slots than blocks: 13 empty slots
    (8, 4096 * 2, 4096, 2, 32),  # one block per slot, a chunk per group
    (1, 1024, 128, 4, 5),  # more chunks than a slot has tiles: empty chunks
]


@pytest.mark.parametrize("b,n_pad,blk,slots,chunks", SPLITS)
@pytest.mark.parametrize("euclid", [False, True])
def test_int8_merge_of_chunk_partials_equals_unsplit(b, n_pad, blk, slots, chunks, euclid):
    q, v, bias, scale_sq = _int8_case(3, b, n_pad, 128, euclid)
    ws, wi = fs.fused_scan_survivors_plain(q, v, bias, blk, slots, scale_sq)
    part_s, part_i = _partials_by_hand(q, v, bias, blk, slots, chunks, scale_sq)
    ms, mi = fs.merge_survivors_plain(part_s, part_i)
    assert torch.equal(mi, wi)
    assert torch.equal(ms, ws)
    # the module's plain partials are the same, and the CPU wrappers take them
    ks, ki = fs.fused_scan_partials(q, v, bias, blk, slots, scale_sq, chunks)
    assert torch.equal(ks, part_s) and torch.equal(ki, part_i)
    before = fs.merge_survivors.launches
    gs, gi = fs.merge_survivors(ks, ki)
    assert torch.equal(gs, ws) and torch.equal(gi, wi)
    assert fs.merge_survivors.launches == before  # no kernel on the CPU


def test_int8_ties_cross_chunk_boundaries():
    """Most classes of the small-code case tie across chunks, and the
    earliest row wins them: a merge that preferred later chunks would
    differ."""
    b, n_pad, blk, slots, chunks = 5, 8192, 128, 4, 7
    q, v, bias, scale_sq = _int8_case(3, b, n_pad, 128, False)
    part_s, part_i = _partials_by_hand(q, v, bias, blk, slots, chunks, scale_sq)
    ws, wi = fs.fused_scan_survivors_plain(q, v, bias, blk, slots, scale_sq)
    tied_later = (part_s[1:] == ws[None]) & (part_i[1:] != wi[None]) & (part_i[1:] >= 0)
    assert int(tied_later.any(dim=0).sum()) > 0
    later_first = part_s.flip(0), part_i.flip(0)
    ls, li = fs.merge_survivors_plain(*later_first)
    assert torch.equal(ls, ws) and not torch.equal(li, wi)


@pytest.mark.parametrize("b,n_pad,blk,slots,chunks", [(5, 8192, 256, 4, 6), (37, 4096 * 3, 4096, 2, 5)])
def test_bf16_merge_of_chunk_partials_equals_unsplit(b, n_pad, blk, slots, chunks):
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.standard_normal((n_pad, 128)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((b, 128)).astype(np.float32)).to(torch.bfloat16)
    dead = rng.random(n_pad) < 0.2
    bias = torch.from_numpy(np.where(dead, fs.NEG_INF, 0.0).astype(np.float32))
    ws, wi = fs.fused_scan_survivors_plain(q, v, bias, blk, slots)
    part_s, part_i = _partials_by_hand(q, v, bias, blk, slots, chunks, None)
    ms, mi = fs.merge_survivors_plain(part_s, part_i)
    assert torch.equal(mi, wi)
    assert torch.equal(ms, ws)


# ---------------------------------------------------------------------------
# the chooser
# ---------------------------------------------------------------------------

SHAPES = [
    # b, n_pad, blk, slots: the REST launches, B = 256, and edge shapes
    (8, 1_003_520, 4096, 16),  # sift1m / sq dbpedia
    (8, 102_400, 4096, 16),  # glove100 (filtered): 25 blocks
    (256, 1_003_520, 4096, 16),
    (8, 4096 * 3, 4096, 16),  # more slots than blocks
    (1, 4096, 128, 4),
    (37, 65_536, 4096, 16),
    (64, 65_536, 2048, 24),  # a widened grid (large limit)
]


@pytest.mark.parametrize("b,n_pad,blk,slots", SHAPES)
@pytest.mark.parametrize("ctas_per_sm", [1, 2])
def test_split_covers_every_tile_once_in_order(b, n_pad, blk, slots, ctas_per_sm):
    chunks = fs.scan_split(b, n_pad, blk, slots, 132, fs.query_tile(b, 256), ctas_per_sm)
    assert chunks >= 1
    tiles = fs.slot_tiles(n_pad, blk, slots)
    assert sum(tiles) * fs.LANES == n_pad
    for t in tiles:
        bounds = fs.chunk_bounds(t, chunks)
        assert bounds[0][0] == 0 and bounds[-1][1] == t
        assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))  # contiguous, ascending
        if t:
            assert all(hi > lo for lo, hi in bounds)  # no chunk of a non-empty slot is empty
    # every row is scored by exactly one chunk
    mask = fs.chunk_row_mask(n_pad, blk, slots, chunks) if n_pad <= 65_536 else None
    if mask is not None:
        assert torch.equal(mask.sum(dim=0), torch.ones(n_pad, dtype=torch.int64))


@pytest.mark.parametrize("n_pad", [1_003_520, 102_400])
def test_rest_shapes_fill_every_sm(n_pad):
    """At the REST path's launches (a batch of 8, 1M rows or 25 blocks) the
    grid has at least one CTA per SM of an H100 (132), with the two
    resident CTAs per SM the kernel asks for at N <= 32."""
    n_q = fs.query_tile(8, 256)
    chunks = fs.scan_split(8, n_pad, 4096, 16, 132, n_q, 2)
    ctas = 16 * chunks * -(-8 // n_q)
    assert ctas >= 132
    assert ctas <= 132 * 2  # one wave


def test_large_batch_needs_few_chunks():
    n_q = fs.query_tile(256, 1536)
    assert n_q == 64
    assert fs.scan_split(256, 1_003_520, 4096, 16, 132, n_q, 1) == 2
    assert fs.scan_split(256, 1_003_520, 4096, 16, 132, n_q, 2) == 4


@pytest.mark.parametrize("b,row_bytes,n_q,resident", [
    (1, 256, 8, True), (8, 256, 8, True), (9, 256, 32, True), (37, 256, 64, True),
    (256, 1536, 64, True), (256, 3072, 32, True), (8, 3072, 8, True),
    (256, 12288, 8, True),  # int8 D = 12,288: the widest resident tile
    (256, 16384, 64, False), (8, 24576, 8, False),  # bf16 D = 8,192 / 12,288
])
def test_query_tile_fits_the_resident_budget(b, row_bytes, n_q, resident):
    assert fs.query_tile(b, row_bytes) == n_q
    assert fs.queries_resident(row_bytes) == resident
    assert fs.smem_bytes(n_q, row_bytes) <= fs.SMEM_PER_BLOCK


@pytest.mark.parametrize("itemsize", [1, 2])  # int8 codes, bf16
@pytest.mark.parametrize("b", [1, 8, 37, 256])
def test_every_width_up_to_65536_dims_fits_shared_memory(itemsize, b):
    """Qdrant accepts up to 65,536 dimensions; the scan pads D to 128, and
    every padded width must give a launch that fits one CTA's shared memory
    (queries resident up to 96 KB a tile, streamed past it)."""
    for d_pad in range(128, 65_536 + 1, 128):
        row_bytes = d_pad * itemsize
        n_q = fs.query_tile(b, row_bytes)
        assert n_q in fs.QUERY_TILES
        assert fs.smem_bytes(n_q, row_bytes) <= fs.SMEM_PER_BLOCK
        if fs.queries_resident(row_bytes):
            assert n_q * row_bytes <= fs.MAX_QUERY_BYTES
        else:
            assert n_q == next(t for t in fs.QUERY_TILES if t >= min(b, 64))
