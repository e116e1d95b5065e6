"""The readers of the port's host syncs and seeding span (``seeding_syncs``,
``seeding_idle_ms``, ``eigh_syncs``, ``eigh_promoted``, ``syncs_per_fit``,
``sync_idle_share.fit``) on the fixture trace with a seeding span, sync
spans and one more kernel added, and on fake fit reports; values worked
by hand."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

import spark_rapids_ml_tpu_torch.utils.tracing  # noqa: F401  (the port's HostSync, which the readers look for)
from portbench.lib import fit_counters, spec, trace

FIXTURE = Path(__file__).parent / "fixtures" / "trace_fit.json"


def _x(name, tid, ts, dur, cat="user_annotation", corr=None, pid=10):
    e = {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace(sync_end_on_thread_2=1745.0):
    """The fixture's slice [1000, 2000] us plus: a ``kmeans seeding`` span
    [1015, 1400] on the fit's thread, a kernel launched in it at 1350 that
    runs [1380, 1390], a ``sync kmeans.seeding.pick`` span [1320, 1345] on
    the fit's thread and a ``sync eigh.auto.accept`` span on thread 2 from
    1700 to ``sync_end_on_thread_2``. Busy: [1030, 1330], [1380, 1390],
    [1610, 1760], [1860, 1870], [1960, 2000]; idle gaps start at 1000 (30
    us), 1330 (50), 1390 (220), 1760 (100) and 1870 (90): 490 us."""
    doc = json.loads(FIXTURE.read_text())
    doc["traceEvents"] += [
        _x("kmeans seeding", 1, 1015.0, 385.0),
        _x("sync kmeans.seeding.pick", 1, 1320.0, 25.0),
        _x("sync eigh.auto.accept", 2, 1700.0, sync_end_on_thread_2 - 1700.0),
        _x("cudaLaunchKernel", 1, 1350.0, 3.0, cat="cuda_runtime", corr=16),
        _x("index_select_kernel", 7, 1380.0, 10.0, cat="kernel", corr=16, pid=0),
    ]
    return trace.parse(doc)


class _Model:
    def __init__(self, counters):
        self._report = SimpleNamespace(counters=counters)

    def fit_report(self):
        return self._report


KMEANS_FIT = {"sync.kmeans.seeding.neg_inf": 1, "sync.kmeans.seeding.pick": 99,
              "sync.kmeans.seeding.min_d2": 99, "sync.kmeans.lloyd.moved": 2, "ingest.rows": 7}
PCA_ACCEPTED = {"eigh.auto.calls": 1, "eigh.auto.iterations": 3, "sync.eigh.start_basis": 1,
                "sync.eigh.auto.s_prev": 1, "sync.eigh.auto.stagnation": 3, "sync.eigh.ritz": 1,
                "sync.eigh.auto.accept": 1, "sync.pca.trace_ratio": 2}
PCA_PROMOTED = {**PCA_ACCEPTED, "eigh.auto.promoted": 1, "sync.eigh.full": 1}


def ctx(tr, models, traced=2):
    return SimpleNamespace(trace=tr, traced=traced, window=SimpleNamespace(models=models))


def read(name, c):
    return spec.load_module(spec.BENCH_DIR / "layers" / f"{name}.py", "layers").read(c)


def test_seeding_idle_is_the_seeding_interval_less_the_device_work():
    # Interval [1030, 1390] us; busy in it 300 + 10 us; one traced fit's span.
    assert read("seeding_idle_ms", ctx(_trace(), [])) == pytest.approx(0.050)


@pytest.mark.parametrize("end, behind_us", [(1745.0, 150.0), (1735.0, 50.0)])
def test_sync_idle_share_counts_gaps_that_start_in_a_sync_span_or_just_after(end, behind_us):
    # The gap at 1330 starts inside the fit thread's sync span; the one at
    # 1760 starts 15 us after thread 2's span ends (counted), or 25 us after
    # (not counted); the gaps at 1000, 1390 and 1870 start in none.
    assert read("sync_idle_share.fit", ctx(_trace(end), [])) == pytest.approx(100.0 * behind_us / 490.0)


def test_the_counters_are_read_per_traced_fit():
    window = [_Model({"sync.kmeans.seeding.pick": 1000, "sync.eigh.full": 50})]
    kmeans = ctx(_trace(), window + [_Model(KMEANS_FIT), _Model(KMEANS_FIT)])
    assert read("seeding_syncs", kmeans) == 199
    assert read("syncs_per_fit", kmeans) == 201
    assert read("eigh_syncs", kmeans) == 0
    assert read("eigh_promoted", kmeans) is None  # no eigh_auto call to take a share of
    pca = ctx(_trace(), window + [_Model(PCA_ACCEPTED), _Model(PCA_PROMOTED)])
    assert read("eigh_syncs", pca) == pytest.approx((7 + 8) / 2)
    assert read("syncs_per_fit", pca) == pytest.approx((9 + 10) / 2)
    assert read("eigh_promoted", pca) == pytest.approx(50.0)
    assert read("seeding_syncs", pca) == 0


COUNTED = ("seeding_syncs", "eigh_syncs", "eigh_promoted", "syncs_per_fit")


def test_a_port_without_host_syncs_reads_nothing(monkeypatch):
    monkeypatch.setattr(fit_counters, "TRACING", "spark_rapids_ml_tpu_torch.no_such_module")
    c = ctx(_trace(), [_Model({}), _Model({})])
    for name in COUNTED:
        assert read(name, c) is None
    # The parent's trace: no seeding span and no sync span.
    plain = ctx(trace.parse(json.loads(FIXTURE.read_text())), [])
    assert read("seeding_idle_ms", plain) is None
    assert read("sync_idle_share.fit", plain) is None


def test_a_run_without_device_work_reads_nothing():
    no_ops = _trace()
    no_ops.ops.clear()
    for c in (ctx(None, [_Model(KMEANS_FIT)], traced=0), ctx(no_ops, [_Model(KMEANS_FIT)], traced=1)):
        for name in COUNTED + ("seeding_idle_ms", "sync_idle_share.fit"):
            assert read(name, c) is None
