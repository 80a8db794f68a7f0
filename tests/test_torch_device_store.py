"""DeviceVectorStore (a sealed store whose truth is a tensor on the device)
in the port, case for case as tests/test_device_store.py holds the JAX one:
sealed, deletions reach the device mask, rows come back through `get_batch`
(or `host_fetch`), the inline table's clip bound is sampled from the data;
and its scan index is built from the full device block: the bf16 block bit
for bit, and the bias within 1e-6, of the index built from the same rows on
the host (which tests/test_torch_state.py holds to the JAX layout).
"""

import numpy as np
import pytest
import torch

from qdrant_tpu_torch.device import force_cpu
from qdrant_tpu_torch.index import plain
from qdrant_tpu_torch.index.hnsw import HnswIndex
from qdrant_tpu_torch.index.plain import PlainIndex
from qdrant_tpu_torch.ops.scan import ScanIndex
from qdrant_tpu_torch.storage.vectors import DenseVectorStore, DeviceVectorStore
from qdrant_tpu_torch.types import Distance, HnswConfig

force_cpu()  # the port on the CPU
torch.set_num_threads(1)  # one graph build below: thousands of tiny ops


def _make_store(rng, n=64, d=8, scale=1.0, distance=Distance.DOT, cap=None):
    data = scale * rng.normal(size=(cap or n, d)).astype(np.float32)
    store = DeviceVectorStore(torch.from_numpy(data), distance, count=n)
    return store, data


def test_device_store_sealed():
    rng = np.random.default_rng(0)
    store, _ = _make_store(rng)
    with pytest.raises(NotImplementedError):
        store.add(np.zeros((1, 8), np.float32))
    with pytest.raises(NotImplementedError):
        store.set(0, np.zeros(8, np.float32))
    with pytest.raises(ValueError):
        DeviceVectorStore(torch.zeros((4, 8)), Distance.DOT, count=5)


def test_device_store_delete_updates_device_mask():
    rng = np.random.default_rng(1)
    store, data = _make_store(rng, n=32, d=8, distance=Distance.EUCLID)
    q = data[5:6]  # query equal to row 5: row 5 is its own top hit (euclid)
    _, ids = PlainIndex(store).search(q, k=1)
    assert ids[0, 0] == 5
    assert store.delete(5)
    # the device mask reflects the deletion without a caller's filter
    _, mask = store.device_block()
    assert not bool(mask[5])
    _, ids = PlainIndex(store).search(q, k=3)
    assert 5 not in ids[0].tolist()
    assert store.deleted_count == 1
    assert not store.delete(5)  # idempotent


def test_device_store_get_batch_roundtrip():
    rng = np.random.default_rng(2)
    store, data = _make_store(rng, n=16, d=4)
    got = store.get_batch(np.asarray([3, 0, 15]))
    np.testing.assert_allclose(got, data[[3, 0, 15]], rtol=1e-6)
    np.testing.assert_array_equal(store.get(7), data[7])
    np.testing.assert_array_equal(store.host_array, data)

    # host_fetch takes precedence when provided
    calls = []

    def fetch(offs):
        calls.append(np.asarray(offs))
        return data[np.asarray(offs)]

    store2 = DeviceVectorStore(torch.from_numpy(data), Distance.DOT, count=16, host_fetch=fetch)
    got2 = store2.get_batch(np.asarray([1, 2]))
    np.testing.assert_allclose(got2, data[[1, 2]], rtol=1e-6)
    assert len(calls) == 1


def test_inline_clip_bound_sampled_from_device_store(monkeypatch):
    """The inline SQ clip bound comes from the data (via get_batch), not
    from the empty inherited host array: data scaled to |v|~50 gives a bound
    far above the 1.0 fallback that would saturate the codes."""
    monkeypatch.setenv("QDRANT_TPU_INLINE", "force")
    rng = np.random.default_rng(3)
    store, _ = _make_store(rng, n=256, d=8, scale=50.0)
    idx = HnswIndex(store, HnswConfig(m=4, ef_construct=16), seed=1)
    idx.build(batch_size=64)
    state = idx._inline_state()
    assert state is not None
    assert state["scale"] * 127.0 > 20.0


@pytest.mark.parametrize("distance", ["Euclid", "Dot"])
def test_scan_index_over_full_block(monkeypatch, distance):
    """The scan index is built from the full device block (no [:count]
    copy): its block bit for bit the one built from the same rows on the
    host, pad rows past `count` invalid through the short mask, and PlainIndex's scan
    path answers as over a DenseVectorStore of the same rows."""
    rng = np.random.default_rng(4)
    store, data = _make_store(rng, n=300, d=24, distance=Distance(distance), cap=384)
    dense = DenseVectorStore(24, Distance(distance))
    dense.add(data[:300])
    for s in (store, dense):
        s.delete(7)
    scan = store.scan_index()
    assert scan.n == 384 and scan is store.scan_index()  # cached until a write
    valid = ~store.deleted_mask
    host = ScanIndex(data, valid_mask=valid, euclid=distance == "Euclid")
    assert torch.equal(scan._v.view(torch.int16), host._v.view(torch.int16))
    # |v|² summed on the device here, by numpy there: last-bit differences
    np.testing.assert_allclose(scan._mask.numpy(), host._mask.numpy(), rtol=1e-6)
    invalid = scan._mask.numpy()[[7, 300, 383]]
    assert (invalid == host._mask.numpy()[383]).all() and invalid[0] < -1e38
    monkeypatch.setattr(plain, "SCAN_THRESHOLD", 128)
    q = rng.normal(size=(3, 24)).astype(np.float32)
    got, want = PlainIndex(store).search(q, 5), PlainIndex(dense).search(q, 5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert 7 not in got[1]
    mem = store.memory_usage_bytes()
    assert mem["device_bytes"] >= data.nbytes


def test_scan_index_over_full_block_on_the_mesh(monkeypatch):
    """With 4 logical devices the store's scan index is sharded: rows padded
    to whole blocks on every shard, the shards views of the one bf16 block,
    the rescore reading the device block itself; PlainIndex answers as over
    a DenseVectorStore of the same rows (itself on the mesh)."""
    from qdrant_tpu_torch import device

    monkeypatch.setattr(device, "_LOGICAL", 4)
    rng = np.random.default_rng(6)
    store, data = _make_store(rng, n=300, d=24, distance=Distance.EUCLID, cap=384)
    dense = DenseVectorStore(24, Distance.EUCLID)
    dense.add(data[:300])
    for s in (store, dense):
        s.delete(7)
    scan = store.scan_index()
    assert scan.mesh.size == 4 and scan.n_pad == 4 * 4096 and len(scan._v) == 4
    assert scan._rows_src is store._dev and scan._rows[0].data_ptr() == store._dev.data_ptr()
    assert len({t.untyped_storage().data_ptr() for t in scan._v}) == 1
    monkeypatch.setattr(plain, "SCAN_THRESHOLD", 128)
    q = rng.normal(size=(3, 24)).astype(np.float32)
    got, want = PlainIndex(store).search(q, 5), PlainIndex(dense).search(q, 5)
    assert dense.scan_index().mesh.size == 4
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert 7 not in got[1]
