"""Each per-layer reader on a small Chrome trace (``fixtures/trace_fit.json``,
in the layout ``torch.profiler`` exports: host ranges, CUDA runtime and
driver calls and the device operations they launched, linked by
correlation ids), with values worked by hand."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.lib import spec, trace

FIXTURE = Path(__file__).parent / "fixtures" / "trace_fit.json"


@pytest.fixture()
def tr():
    return trace.parse(json.loads(FIXTURE.read_text()))


def ctx(tr, **kw):
    base = dict(trace=tr, traced=1, peaks={"fp32_flops": 67e12, "hbm_bytes": 3.35e12}, rows=1000, cols=16,
                config={"name": "kmeans_20m_d16_k100", "estimator": {"params": {"k": 4}}},
                answers=[{"iters": 2}], traced_answers=[{"iters": 2}], fit_s=0.5,
                count=lambda name: spec.count(spec.BENCH_DIR, name))
    base.update(kw)
    return SimpleNamespace(**base)


def read(name, c):
    return spec.load_module(spec.BENCH_DIR / "layers" / f"{name}.py", "layers").read(c)


def test_parse_attributes_operations_to_their_launching_spans(tr):
    assert tr.window == pytest.approx((1000e-6, 2000e-6))
    by = {op.name: op for op in tr.ops}
    assert by["topk_kernel"].spans == ("kmeans fit",)
    assert by["assign_stats_fused"].spans == ("kmeans lloyd fused", "kmeans fit")  # a driver launch
    assert by["caller_gemm"].launch_tid == 2 and by["caller_gemm"].spans == ("serve pca.transform",)
    assert len(tr.in_window()) == 5


def test_busy_idle_and_breakdown(tr):
    # [1030, 1330] + [1610, 1760] + [1860, 1870] + [1960, 2000] (clipped at the slice's end).
    assert tr.busy_s() == pytest.approx(500e-6)
    assert read("idle_share.fit", ctx(tr)) == pytest.approx(50.0)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["distance_gemm", pytest.approx(200e-6)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps == {"kmeans lloyd fused": pytest.approx(280e-6), "kmeans fit": pytest.approx(130e-6),
                    "serve pca.transform": pytest.approx(90e-6)}


def test_kmeans_fit_readers(tr):
    c = ctx(tr)
    assert read("seeding_ms", c) == pytest.approx(0.310)  # topk 100 + gemm 200 + copy 10 us
    bound = max(2 * 1000 * 4 * 16 / 67e12, (4 * (1000 * 16 + 64) + 4 * 64 + 32 + 4 + 16) / 3.35e12)
    assert read("lloyd_roofline", c) == pytest.approx(100 * 3 * bound / 150e-6)
    flops = 2 * 1000 * 16 * (1 + 3 * 4) + 3 * 2 * 1000 * 4 * 16
    assert read("fit_mfu", c) == pytest.approx(100 * flops / (0.5 * 67e12))


def test_pca_readers_read_nothing_without_their_spans(tr):
    c = ctx(tr, config={"name": "pca_12p5m_d1024", "estimator": {"params": {"k": 16}}})
    assert read("covariance_roofline", c) is None
    assert read("eigh_ms", c) is None
    tr.spans.append(trace.Span("auto eigh", 1, 1.0, 1.0125))
    assert read("eigh_ms", c) == pytest.approx(12.5)
    # A span that opens while the device still runs what was launched before it
    # counts from when that work ends: [1200, 1400] us after the GEMM ending at 1330.
    tr.spans[-1] = trace.Span("auto eigh", 1, 1200e-6, 1400e-6)
    assert read("eigh_ms", c) == pytest.approx(0.070)


def test_no_trace_reads_nothing():
    c = ctx(None, traced=0)
    for name in ("covariance_roofline", "eigh_ms", "seeding_ms", "lloyd_roofline", "idle_share.fit"):
        assert read(name, c) is None
