"""Lifecycle × the port's routing tier on the CPU: replicated rollback
through the router, response freshness attribution on routed futures,
and the journaled refit→swap controller driving a ``RoutingRuntime``.

Twins of ``tests/test_lifecycle_serving.py::TestRouterRollback`` and of
its ``test_loadgen_freshness_table`` (read here off routed futures), plus
the controller over a router: ``run_cycle`` registers, warms and flips on
every member (the router's zero-shed paths), the routed answers are the
candidate's own predictions bit for bit and the JAX model's on the same
centres and rows (labels exact), and ``watch`` rolls the whole gang back.
The controller's cycle over the router ends as its cycle over the
in-process ``ServingRuntime`` does (same outcomes, scores equal: both
refit on the same rows in the same process).

One 2-member gang on the CPU platform serves the module; distinct model
names keep the tests independent. Every future wait has a timeout.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch.clustering import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.lifecycle import LifecycleController
from spark_rapids_ml_tpu_torch.robustness.faults import disarm
from spark_rapids_ml_tpu_torch.serving import RoutingRuntime, ServingRuntime

D = 6
WAIT = 60.0  # seconds, every future wait


def dyadic(rng, shape, scale=4):
    return rng.integers(-4 * scale, 4 * scale, size=shape).astype(np.float64) / 4.0


def _km_score(model, x, y):
    centers = np.asarray(model.clusterCenters())
    d = np.linalg.norm(x[:, None, :] - centers[None], axis=2).min(axis=1)
    return -float(d.mean())


def _jax_predict(centers, x):
    from spark_rapids_ml_tpu.models.kmeans import KMeansModel as JaxKMeansModel

    return np.asarray(JaxKMeansModel("j", centers).predict(x))


@pytest.fixture(scope="module", autouse=True)
def _cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    for name in ("TPUML_LIFECYCLE_DIR", "TPUML_FAULTS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPUML_RETRY_BASE_DELAY", "0")
    yield
    disarm()


@pytest.fixture(scope="module")
def gang(_cpu_platform):
    rt = RoutingRuntime(workers=2, launch="spawn", max_delay_ms=1.0, connect_timeout=WAIT)
    yield rt
    rt.close()


class TestRouterRollback:
    def test_replicated_rollback_and_attribution(self, gang, rng):
        c = dyadic(rng, (3, D))
        m1, m2 = KMeansModel("rb-km", c), KMeansModel("rb-km", c + 100.0)
        gang.register("rb-km", m1, alias="prod")
        gang.register("rb-km", m2, alias="prod")
        f2 = gang.submit("rb-km@prod", dyadic(rng, (2, D)))
        f2.result(timeout=WAIT)
        assert f2.model_version == 2  # router reply path attribution
        assert gang.rollback("rb-km") == 1
        assert gang.registry.aliases("rb-km") == {"prod": 1}
        for st in gang.member_status():
            assert st["snapshot"]["models"]["rb-km"]["aliases"] == {"prod": 1}
        x = dyadic(rng, (2, D))
        f1 = gang.submit("rb-km@prod", x)
        out = f1.result(timeout=WAIT)
        assert out.tobytes() == np.asarray(m1.predict(x)).tobytes()
        np.testing.assert_array_equal(out, _jax_predict(c, x))
        assert f1.model_version == 1

    def test_rollback_is_zero_shed_under_load(self, gang, rng):
        """Requests in flight across the rollback all succeed: the
        two-phase (warm the target everywhere, flip the router's alias
        last) never sheds or errors a request."""
        c = dyadic(rng, (3, D))
        gang.register("zs-km", KMeansModel("zs-km", c), alias="prod")
        gang.register("zs-km", KMeansModel("zs-km", c + 50.0), alias="prod")
        stop = threading.Event()
        errors, served = [], []

        def pound():
            r = np.random.default_rng(77)
            while not stop.is_set():
                try:
                    f = gang.submit("zs-km@prod", dyadic(r, (1, D)))
                    f.result(timeout=WAIT)
                    served.append(f.model_version)
                except Exception as exc:  # noqa: BLE001 - the assertion IS "none"
                    errors.append(exc)

        threads = [threading.Thread(target=pound) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            v = gang.rollback("zs-km")
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=WAIT)
        assert v == 1 and not errors
        assert len(served) > 0
        assert set(served) <= {1, 2}


def test_loadgen_freshness_table(gang, rng):
    """The reference loadgen's ``FreshnessTable`` reads the port's routed
    futures: every answer names the concrete (model, version)."""
    from tools.tpuml_loadgen import FreshnessTable

    gang.register("lg-km", KMeansModel("lg-km", dyadic(rng, (3, D))), alias="prod")
    table = FreshnessTable()
    futs = [gang.submit("lg-km@prod", dyadic(rng, (1, D))) for _ in range(8)]
    for f in futs:
        f.result(timeout=WAIT)
        table.note(f)
    rows = table.report()
    assert len(rows) == 1
    assert rows[0]["model"] == "lg-km" and rows[0]["version"] == 1
    assert rows[0]["requests"] == 8
    assert rows[0]["last_seen_s"] >= rows[0]["first_seen_s"]


def _cycle_rows(rng):
    x0 = rng.normal(size=(300, D))
    x0[:150] += 4.0
    return x0


class TestControllerOverRouter:
    def test_run_cycle_flips_every_member_and_serves_the_candidate(self, gang, tmp_path, rng):
        """Two cycles over the router: each registers, warms and flips on
        both members; the routed answers are the new incumbent's own
        predictions bit for bit, and the JAX model's on its centres."""
        x0 = _cycle_rows(rng)
        ctrl = LifecycleController(KMeans(uid="rt-cl").setK(2).setSeed(3), gang, "cl-km",
                                   score_fn=_km_score, directory=str(tmp_path))
        out0 = ctrl.run_cycle(x0)
        assert (out0.action, out0.version) == ("flipped", 1)
        out1 = ctrl.run_cycle(x0 + 3.0)
        assert (out1.action, out1.version) == ("flipped", 2)
        assert gang.registry.aliases("cl-km") == {"prod": 2}
        for st in gang.member_status():
            cell = st["snapshot"]["models"]["cl-km"]
            assert cell["versions"] == [1, 2] and cell["aliases"] == {"prod": 2}
        probes = np.round(x0[:40] * 4.0) / 4.0
        futs = gang.submit_many("cl-km@prod", [probes[i:i + 1] for i in range(40)])
        got = np.concatenate([f.result(timeout=WAIT) for f in futs])
        assert {f.model_version for f in futs} == {2}
        assert got.tobytes() == np.asarray(ctrl.model.predict(probes)).tobytes()
        np.testing.assert_array_equal(got, _jax_predict(np.asarray(ctrl.model.clusterCenters()), probes))
        assert sum(m["routed"] for m in gang.snapshot()["members"] if not m["dead"]) > 0

    def test_watch_rolls_the_gang_back(self, gang, tmp_path, rng):
        """A live score far below the gate's triggers the replicated
        rollback: the router and every member serve the previous
        version, and routed answers are its predictions."""
        x0 = _cycle_rows(rng)
        ctrl = LifecycleController(KMeans(uid="rt-watch").setK(2).setSeed(3), gang, "w-km",
                                   score_fn=_km_score, directory=str(tmp_path))
        first = ctrl.run_cycle(x0)
        incumbent = ctrl.model
        second = ctrl.run_cycle(x0 + 3.0)
        assert (first.version, second.version) == (1, 2)
        assert ctrl.watch(second.candidate_score - 1e6) == 1
        assert gang.registry.aliases("w-km") == {"prod": 1}
        for st in gang.member_status():
            assert st["snapshot"]["models"]["w-km"]["aliases"] == {"prod": 1}
        x = np.round(x0[:12] * 4.0) / 4.0
        f = gang.submit("w-km@prod", x)
        assert f.result(timeout=WAIT).tobytes() == np.asarray(incumbent.predict(x)).tobytes()
        assert f.model_version == 1
        assert ctrl.watch(second.candidate_score - 1e6) is None  # one rollback per flip

    def test_a_cycle_over_the_router_ends_as_one_in_process(self, gang, tmp_path, rng):
        x0 = _cycle_rows(rng)
        outcomes = {}
        with ServingRuntime(max_delay_ms=1.0) as rt:
            for key, runtime in (("router", gang), ("in_process", rt)):
                ctrl = LifecycleController(KMeans(uid="eq-km").setK(2).setSeed(3), runtime, f"eq-{key}",
                                           score_fn=_km_score, directory=str(tmp_path / key))
                outcomes[key] = [ctrl.run_cycle(x0), ctrl.run_cycle(x0 + 3.0)]
        ours, theirs = outcomes["router"], outcomes["in_process"]
        assert [(o.cycle, o.action, o.version) for o in ours] == [(o.cycle, o.action, o.version) for o in theirs]
        assert [(o.candidate_score, o.incumbent_score) for o in ours] == [
            (o.candidate_score, o.incumbent_score) for o in theirs]


def test_a_host_refit_folds_where_the_platform_computes(rng):
    """``partial_fit``'s host rows fold on the platform's device: on the
    CPU in host numpy, the moments bitwise the reference's; on ``cuda``
    without a card the refit raises instead of folding on the host (on
    the card they take K1's float64 route: ``chip_smoke.py`` (s) (d))."""
    import torch

    from spark_rapids_ml_tpu.feature import PCA as JaxPCA
    from spark_rapids_ml_tpu_torch.feature import PCA

    x = rng.normal(size=(64, 5))
    ours, theirs = PCA().setK(2).partial_fit(x), JaxPCA().setK(2).partial_fit(x)
    assert ours._moments.gram.tobytes() == theirs._moments.gram.tobytes()
    assert ours._moments.sum.tobytes() == theirs._moments.sum.tobytes()
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refit would fold on it")
    port_device.set_platform("cuda")
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            PCA().setK(2).partial_fit(x)
    finally:
        port_device.set_platform("cpu")
