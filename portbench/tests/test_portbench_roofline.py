"""Byte and operation counts of the two scan steps."""

from __future__ import annotations

import pytest

from portbench import roofline


def test_bf16_scan_step_bytes():
    # 1M x 128 euclid, a padded batch of 128 queries, k 10, k_fetch 28
    r = roofline.scan_step("bf16", b=128, n=1_000_000, d=128, k=10, k_fetch=28)
    n_pad = 1_003_520  # 245 blocks of 4,096
    block = n_pad * 128 * 2
    bias = n_pad * 4
    queries = 128 * 128 * 4  # read once, by the scan and the rescore
    gathered = 128 * 28 * 128 * 4
    out = 128 * 10 * 12
    assert r["bytes"] == block + bias + queries + gathered + out
    assert r["bytes_s"] == pytest.approx(r["bytes"] / 3.35e12)
    assert r["ops_s"] == pytest.approx(2 * 128 * n_pad * 128 / 989e12 + 3 * 128 * 28 * 128 / 67e12)
    assert r["bound_s"] == r["bytes_s"]  # bound by bytes


def test_int8_scan_step_bytes():
    # 262,144 x 1536 SQ codes, 128 queries, k 10, 128 rescored a query
    r = roofline.scan_step("int8", b=128, n=262_144, d=1536, k=10, k_fetch=128)
    codes = 262_144 * 1536
    bias = 262_144 * 4
    queries = 128 * 1536 + 128 * 1536 * 4  # int8 codes for the scan, f32 for the rescore
    gathered = 128 * 128 * 1536 * 4
    out = 128 * 10 * 12
    assert r["bytes"] == codes + bias + queries + gathered + out
    assert r["bound_s"] == pytest.approx(r["bytes"] / 3.35e12)
    no_rescore = roofline.scan_step("int8", b=128, n=262_144, d=1536, k=10, k_fetch=128,
                                    rescore=False)
    assert no_rescore["bytes"] == codes + bias + 128 * 1536 + out


def test_padding_of_rows_and_columns():
    assert roofline.padded(1, 100) == (4096, 128)
    assert roofline.padded(4097, 129) == (8192, 256)
