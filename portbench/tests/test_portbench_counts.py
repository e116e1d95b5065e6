"""The yardstick's counted work and peaks, against values worked by hand."""

import math

import pytest

from portbench.lib import peaks, spec

BENCH_DIR = spec.BENCH_DIR


def count(name):
    return spec.count(BENCH_DIR, name)


def test_covariance_count():
    # 12,500,000 x 1,024: n*d = 12.8e9 adds for the mean, n*d*(d+1) = 13.12e12 for the Gram.
    w = count("covariance").work(12_500_000, 1024)
    assert w["flops"] == 12_800_000_000 + 12_800_000_000 * 1025
    assert w["bytes"] == (12_800_000_000 + 1024 * 1024) * 4


def test_lloyd_and_seeding_counts():
    w = count("lloyd").work(20_000_000, 16, 100)
    assert w["flops"] == 2 * 20_000_000 * 100 * 16 == 64e9
    assert w["bytes"] == 4 * (320_000_000 + 1600) + 4 * 1600 + 800 + 4 + 400
    s = count("seeding").work(20_000_000, 16, 100)
    # 2 + ceil(log2 100) = 9 candidates for each of 99 centres, one row of distances for the first.
    assert s["flops"] == 2 * 20_000_000 * 16 * (1 + 99 * 9)


def test_least_seconds_takes_the_larger_bound():
    h100 = peaks.for_device("NVIDIA H100 80GB HBM3")
    assert h100 == {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}
    # The Gram at 1,000,000 x 1,024 is PERF.md's kernel-table bound, 15.666 ms, bound by
    # operations; the column mean adds 1.024e9 more (0.015 ms).
    k1 = count("covariance").work(1_000_000, 1024)
    assert peaks.least_seconds(k1, h100) * 1e3 == pytest.approx(15.666 + 0.0153, abs=1e-3)
    # Seeding's distance rows are bound by bytes: the rows read once per centre,
    # 128 GB at 3.35 TB/s, against 0.571 TFLOP at 67 TFLOP/s.
    s = count("seeding").work(20_000_000, 16, 100)
    assert peaks.least_seconds(s, h100) == pytest.approx(128e9 / 3.35e12)
    assert peaks.for_device("NVIDIA A100-SXM4-80GB") is None


def test_config_fit_counts():
    from types import SimpleNamespace

    ctx = SimpleNamespace(rows=1000, cols=16, config={"estimator": {"params": {"k": 4}}},
                          answers=[{"iters": 2}, {"iters": 4}], count=count)
    want = 2 * 1000 * 16 * (1 + 3 * 4) + 4 * (2 * 1000 * 4 * 16)
    assert count("kmeans_20m_d16_k100").fit_flops(ctx) == want
    ctx = SimpleNamespace(rows=100, cols=8, count=count)
    assert count("pca_12p5m_d1024").fit_flops(ctx) == 100 * 8 + 100 * 8 * 9
    assert math.ceil(math.log2(4)) == 2
