"""Lifecycle × serving in the port, on the CPU: response freshness
attribution, version-pure micro-batches across a live hot swap,
``submit_many``, and the drift-triggered closed-loop refit→swap cycle.

Mirrors the single-process cases of ``tests/test_lifecycle_serving.py``.
Every response carries the ``(name, version)`` that computed it (stamped on
the future by the batcher), and equals that version's prediction, which is
the JAX model's on the same dyadic centres. The closed loop runs in both
packages on the same rows: the same drift ticks fire (PSI within 1e-5
relative: the port's KMeans fits host rows in float32), and the cycles end
alike. The loadgen ``FreshnessTable`` and the router cases
(``RoutingRuntime``) are in ``tests/test_torch_lifecycle_router.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.clustering import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.lifecycle import DriftMonitor, LifecycleController
from spark_rapids_ml_tpu_torch.robustness.faults import disarm
from spark_rapids_ml_tpu_torch.serving import ServingRuntime

D = 6


def dyadic(rng, shape, scale=4):
    return rng.integers(-4 * scale, 4 * scale, size=shape).astype(np.float64) / 4.0


def _km_score(model, x, y):
    centers = np.asarray(model.clusterCenters())
    d = np.linalg.norm(x[:, None, :] - centers[None], axis=2).min(axis=1)
    return -float(d.mean())


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    for name in ("TPUML_LIFECYCLE_DIR", "TPUML_FAULTS", "TPUML_DRIFT_THRESHOLD", "TPUML_DRIFT_MIN_COUNT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUML_RETRY_BASE_DELAY", "0")
    port_device.set_platform("cpu")
    yield
    disarm()
    port_device.set_platform("cuda")


@pytest.fixture
def runtime():
    rt = ServingRuntime(max_delay_ms=1.0)
    try:
        yield rt
    finally:
        rt.close()


def _jax_predict(centers, x):
    from spark_rapids_ml_tpu.models.kmeans import KMeansModel as JaxKMeansModel

    return np.asarray(JaxKMeansModel("j", centers).predict(x))


class TestFreshnessAttribution:
    def test_single_process_future_carries_name_and_version(self, runtime, rng):
        c = dyadic(rng, (3, D))
        runtime.register("fr-km", KMeansModel("fr-km", c), alias="prod")
        x = dyadic(rng, (4, D))
        fut = runtime.submit("fr-km@prod", x)
        out = fut.result(timeout=30)
        assert fut.model_name == "fr-km" and fut.model_version == 1
        np.testing.assert_array_equal(out, _jax_predict(c, x))

    def test_attribution_tracks_the_flip(self, runtime, rng):
        m1 = KMeansModel("fl-km", dyadic(rng, (3, D)))
        m2 = KMeansModel("fl-km", dyadic(rng, (3, D)))
        runtime.register("fl-km", m1, alias="prod")
        f1 = runtime.submit("fl-km@prod", dyadic(rng, (2, D)))
        mv2 = runtime.register("fl-km", m2)
        runtime.set_alias("fl-km", "prod", mv2.version)
        f2 = runtime.submit("fl-km@prod", dyadic(rng, (2, D)))
        f1.result(timeout=30), f2.result(timeout=30)
        assert f1.model_version == 1 and f2.model_version == 2
        assert f1.model_name == f2.model_name == "fl-km"


class TestVersionPureBatches:
    def test_no_mixed_version_batch_across_live_swap(self, runtime, rng):
        """Distinct centres per version make contamination observable:
        every response equals ITS attributed version's prediction (and the
        JAX model's on those centres) for exactly the submitted rows."""
        c1 = dyadic(rng, (3, D))
        m1 = KMeansModel("vp-km", c1)
        m2 = KMeansModel("vp-km", c1 + 100.0)
        runtime.register("vp-km", m1, alias="prod")
        xs = [dyadic(rng, (2, D)) for _ in range(40)]
        futs = []
        for i, x in enumerate(xs):
            if i == 20:
                mv = runtime.register("vp-km", m2)
                runtime.set_alias("vp-km", "prod", mv.version)
            futs.append(runtime.submit("vp-km@prod", x))
        by_version = {1: c1, 2: c1 + 100.0}
        seen = set()
        for x, f in zip(xs, futs):
            out = np.asarray(f.result(timeout=30))
            seen.add(f.model_version)
            np.testing.assert_array_equal(out, _jax_predict(by_version[f.model_version], x))
        assert seen == {1, 2}

    def test_submit_many_is_version_consistent(self, runtime, rng):
        m1 = KMeansModel("vc-km", dyadic(rng, (3, D)))
        runtime.register("vc-km", m1, alias="prod")
        futs = runtime.submit_many("vc-km@prod", [dyadic(rng, (1, D)) for _ in range(10)])
        mv = runtime.register("vc-km", KMeansModel("vc-km", dyadic(rng, (3, D))))
        runtime.set_alias("vc-km", "prod", mv.version)
        for f in futs:
            f.result(timeout=30)
        assert {f.model_version for f in futs} == {1}


def _closed_loop(package, tmp_path, x0):
    """The whole loop in one package: serve → observe → drift fires →
    refit (warm-seeded) → gate → register → warm → flip, with every
    response attributed. Returns what the test compares across packages."""
    if package == "port":
        est, rt_cls, ctrl_cls, dm_cls = KMeans, ServingRuntime, LifecycleController, DriftMonitor
    else:
        from spark_rapids_ml_tpu.clustering import KMeans as est
        from spark_rapids_ml_tpu.lifecycle import DriftMonitor as dm_cls
        from spark_rapids_ml_tpu.lifecycle import LifecycleController as ctrl_cls
        from spark_rapids_ml_tpu.serving import ServingRuntime as rt_cls
    record = {"ticks": [], "versions": []}
    with rt_cls(max_delay_ms=1.0) as rt:
        ctrl = ctrl_cls(est(uid="cl-km").setK(2).setSeed(3), rt, "km", score_fn=_km_score,
                        directory=str(tmp_path / package))
        out0 = ctrl.run_cycle(x0)
        dm = dm_cls("km", threshold=0.25, min_count=200)
        centers = {}

        def serve_and_observe(batch):
            futs = [rt.submit("km@prod", row) for row in batch]
            versions = set()
            for row, f in zip(batch, futs):
                f.result(timeout=30)
                versions.add(f.model_version)
                if f.model_version not in centers:
                    centers[f.model_version] = np.asarray(
                        rt.registry.resolve("km", f.model_version).model.clusterCenters(), dtype=np.float64)
                dm.observe(float(np.linalg.norm(centers[f.model_version] - row, axis=1).min()))
            return versions

        record["versions"].append(serve_and_observe(x0[:220]))
        record["ticks"].append(dm.tick())
        record["versions"].append(serve_and_observe(x0[:220]))
        record["ticks"].append(dm.tick())
        x1 = x0 + 3.0
        record["versions"].append(serve_and_observe(x1[:220]))
        psi = dm.tick()
        record["ticks"].append(psi)
        out1 = ctrl.run_cycle(x1) if psi is not None else None
        dm.rebaseline()
        record["versions"].append(serve_and_observe(x1[:50]))
        record["outcomes"] = [(o.cycle, o.action, o.version) for o in (out0, out1) if o is not None]
        record["scores"] = [(o.candidate_score, o.incumbent_score) for o in (out0, out1) if o is not None]
    return record


class TestDriftTriggeredCycle:
    def test_closed_loop_drift_refit_swap(self, tmp_path, rng):
        x0 = rng.normal(size=(300, D))
        x0[:150] += 4.0
        ours = _closed_loop("port", tmp_path, x0)
        assert ours["versions"] == [{1}, {1}, {1}, {2}]
        assert ours["ticks"][:2] == [None, None] and ours["ticks"][2] > 0.25
        assert ours["outcomes"] == [(0, "flipped", 1), (1, "flipped", 2)]

    def test_closed_loop_equals_the_reference(self, tmp_path, rng):
        """Both packages run the loop on the same rows: the ticks fire
        alike and the cycles end alike. The port's KMeans fits host rows in
        float32, so the drift PSIs and scores agree to 1e-5 relative."""
        x0 = rng.normal(size=(300, D))
        x0[:150] += 4.0
        ours, theirs = _closed_loop("port", tmp_path, x0), _closed_loop("jax", tmp_path, x0)
        assert ours["versions"] == theirs["versions"] and ours["outcomes"] == theirs["outcomes"]
        assert [t is None for t in ours["ticks"]] == [t is None for t in theirs["ticks"]]
        np.testing.assert_allclose(ours["ticks"][2], theirs["ticks"][2], rtol=1e-5)
        for (a, b), (c, e) in zip(ours["scores"], theirs["scores"]):
            np.testing.assert_allclose(a, c, rtol=1e-5)
            assert (b is None) == (e is None) and (b is None or abs(b - e) <= 1e-5 * abs(e))
