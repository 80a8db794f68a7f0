"""The plain reference against a numpy brute force, and its TF32 control."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.reference.exact_dense import Exact


def _numpy_topk(x, q, k, distance):
    x64, q64 = x.astype(np.float64), q.astype(np.float64)
    if distance == "Euclid":
        d = np.sqrt(((q64[:, None, :] - x64[None, :, :]) ** 2).sum(-1))
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
    else:
        if distance == "Cosine":
            x64 = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
            q64 = q64 / np.linalg.norm(q64, axis=1, keepdims=True)
        d = q64 @ x64.T
        order = np.argsort(-d, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(d, order, axis=1)


@pytest.mark.parametrize("distance", ["Euclid", "Cosine", "Dot"])
def test_reference_top10_equals_numpy_brute_force(distance):
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 200, size=(3000, 24)).astype(np.float32)
    q = rng.uniform(0, 200, size=(40, 24)).astype(np.float32)
    ref = Exact(x, distance, torch.device("cpu"))
    ids, scores = ref.topk(q, 10)
    want_ids, want_scores = _numpy_topk(x, q, 10, distance)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(scores, want_scores, rtol=1e-12)
    np.testing.assert_allclose(ref.scores(q, ids), want_scores, rtol=1e-12)


def test_reference_blocks_merge_across_row_blocks(monkeypatch):
    from portbench.reference import exact_dense

    monkeypatch.setattr(exact_dense, "ROW_BLOCK", 700)
    monkeypatch.setattr(exact_dense, "QUERY_BLOCK", 16)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    ids, _ = Exact(x, "Euclid", torch.device("cpu")).topk(q, 10)
    np.testing.assert_array_equal(ids, _numpy_topk(x, q, 10, "Euclid")[0])


def test_out_of_range_ids_score_nan():
    x = np.ones((5, 4), dtype=np.float32)
    s = Exact(x, "Dot", torch.device("cpu")).scores(np.ones((1, 4), np.float32),
                                                    np.array([[0, 5, -1]]))
    assert s[0, 0] == 4.0 and np.isnan(s[0, 1]) and np.isnan(s[0, 2])


def test_tf32_control_scores_carry_tf32_error():
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 255, size=(2000, 128)).astype(np.float32)
    q = rng.uniform(0, 255, size=(20, 128)).astype(np.float32)
    ref = Exact(x, "Euclid", torch.device("cpu"))
    ids, scores = ref.topk(q, 10, precision="tf32")
    exact = ref.scores(q, ids)
    assert np.abs(scores - exact).max() / np.abs(exact).max() > 1e-5
