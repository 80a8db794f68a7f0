"""Graph faithfulness at a real embedding width: the JAX package's HNSW graph
and the port's, built by the device builder (the card's form, forced on the
CPU as the JAX tests force it) over the same 2,000 clustered 1536-d rows,
reach recall@10 within 0.03 of each other, for Cosine and for Dot (unit
rows, as an embedding collection holds). The clusters are weak (centres at
0.3 of the noise per dimension) and the beam narrow (ef 16), so that recall
sits below 1 and a fault in the build would show; the other graph tests
build at 16-24 dims."""

import numpy as np
import pytest
import torch

from qdrant_tpu_torch.device import force_cpu

from test_torch_hnsw_build import _pair, recall_at_10

force_cpu()
torch.set_num_threads(1)  # thousands of small graph ops beside other test workers

N, D, EF = 2000, 1536, 16


@pytest.mark.parametrize("distance", ["Cosine", "Dot"])
def test_wide_rows_graph_recall_matches_jax(monkeypatch, distance):
    monkeypatch.setenv("QDRANT_TPU_DEVICE_BUILD", "force")
    rng = np.random.default_rng(D)
    centers = (0.3 * rng.standard_normal((64, D))).astype(np.float32)
    x = (centers[rng.integers(0, 64, N)] + rng.standard_normal((N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 64, 32)] + rng.standard_normal((32, D))).astype(np.float32)
    if distance == "Dot":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    jidx, idx = _pair(distance, x)
    jidx.build(batch_size=256)
    idx.build(batch_size=256)
    assert idx.build_stats["device_build"] is True
    xs = idx.store.host_array
    r_jax = recall_at_10(jidx.search(q, 10, ef=EF)[1], xs, q, distance)
    r_port = recall_at_10(idx.search(q, 10, ef=EF)[1], xs, q, distance)
    assert abs(r_port - r_jax) <= 0.03, (r_port, r_jax)
    assert 0.85 <= r_port < 1.0, (r_port, r_jax)
