"""Traces and probes on a CUDA card: the device-memory report, a traced K1
fit against an untraced one, and the profiler session's one-at-a-time
rule.

These tests need the card: they are marked ``cuda`` and skip without one.
They import nothing of JAX, so on a machine with a card and no JAX they
run without the repo's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_observability.py -q
"""

import json

import pytest
import torch

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.observability import events
from spark_rapids_ml_tpu_torch.observability import profiling
from spark_rapids_ml_tpu_torch.observability.report import device_memory_stats
from spark_rapids_ml_tpu_torch.ops.kernels import covariance as k1
from spark_rapids_ml_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    port_device.set_platform("cuda")
    port_device.use_ieee_fp32_matmul()
    yield torch.device("cuda")


def _rows(n=65_536, d=256, seed=0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    scale = torch.linspace(3.0, 0.1, d, device="cuda")
    return torch.randn(n, d, device="cuda", generator=g) * scale


def test_device_memory_stats_agree_with_the_allocator(cuda):
    x = _rows()
    torch.cuda.synchronize()
    stats = device_memory_stats()
    dev = str(torch.cuda.current_device())
    assert stats[dev]["bytes_in_use"] == torch.cuda.memory_allocated()
    assert stats[dev]["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
    assert stats[dev]["peak_bytes_in_use"] >= x.numel() * x.element_size()
    assert stats[dev]["bytes_limit"] == torch.cuda.mem_get_info()[1]
    del x


def test_a_traced_k1_fit_is_bitwise_an_untraced_one(cuda, tmp_path, monkeypatch):
    x = _rows()
    est = PCA().setK(8).setCovarianceBackend("pallas")
    k1.reset_launches()
    plain = est.fit(x)
    untraced_launches = k1.launches
    monkeypatch.setenv(events.TELEMETRY_DIR_ENV, str(tmp_path / "t"))
    events.configure()
    try:
        k1.reset_launches()
        traced = est.fit(x)
        assert k1.launches == untraced_launches >= 1
    finally:
        monkeypatch.delenv(events.TELEMETRY_DIR_ENV)
        events.configure()
    assert torch.equal(torch.as_tensor(traced.pc), torch.as_tensor(plain.pc))
    assert torch.equal(torch.as_tensor(traced.explainedVariance), torch.as_tensor(plain.explainedVariance))
    rep = traced.fit_report()
    assert {"compute cov", "auto eigh"} <= set(rep.stage_totals())
    assert rep.device_memory[str(torch.cuda.current_device())]["peak_bytes_in_use"] >= x.numel() * 4


def test_maybe_profile_inside_an_open_profiler_yields_none(cuda, tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path / "p"))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        assert tracing.profiler_active()
        with profiling.maybe_profile("inside") as d:
            assert d is None
    with profiling.maybe_profile("alone") as d:
        assert d == str(tmp_path / "p")
        with tracing.TraceRange("card stage"):
            (_rows(4096, 64) @ torch.ones(64, 8, device="cuda")).sum().item()
    (trace,) = (tmp_path / "p").glob("alone-*.trace.json")
    doc = json.load(open(trace))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "card stage" in names
    assert any(e.get("cat") == "kernel" for e in doc["traceEvents"])
