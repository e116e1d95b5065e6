"""The port's serving runtime (``serving/``) against the JAX package's.

Registry, micro-batcher, admission and ``ServingRuntime`` on the CPU: the
same dyadic rows (integers / 4: every product and sum is exact in
float64, so a row's answer cannot depend on the batch it was coalesced
into) go through the port's runtime and the reference's, on the same
weights, and must agree exactly; so must each runtime answer and the
model's own ``predict`` / ``transform``. Every future waits with a
timeout, and no test sleeps longer than the batcher's delay window
except where a deadline must pass.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models.kmeans import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.models.linear_regression import LinearRegressionModel as JaxLinRegModel
from spark_rapids_ml_tpu.models.logistic_regression import LogisticRegressionModel as JaxLogRegModel
from spark_rapids_ml_tpu.models.pca import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu.observability.events import validate_record
from spark_rapids_ml_tpu.serving import ServingRuntime as JaxServingRuntime
from spark_rapids_ml_tpu.serving.signature import spec_bytes as jax_spec_bytes
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.core import serving as core_serving
from spark_rapids_ml_tpu_torch.models.kmeans import KMeansModel
from spark_rapids_ml_tpu_torch.models.linear_regression import LinearRegressionModel
from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegressionModel
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.observability import events, metrics
from spark_rapids_ml_tpu_torch.serving import (
    AdmissionQueue,
    DeadlineExceeded,
    MicroBatcher,
    ModelRegistry,
    ModelVersion,
    Overloaded,
    ServingRuntime,
    admission,
    runtime_snapshots,
)
from spark_rapids_ml_tpu_torch.serving.signature import spec_bytes
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

D = 8
WAIT = 30.0  # seconds any future may take


def dyadic(rng, shape, scale=4):
    return rng.integers(-4 * scale, 4 * scale, size=shape).astype(np.float64) / 4.0


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    core_serving.clear_program_cache()
    yield
    core_serving.clear_program_cache()
    port_device.set_platform("cuda")


WEIGHTS = {}


def _weights():
    if not WEIGHTS:
        rng = np.random.default_rng(7)
        WEIGHTS.update(centers=dyadic(rng, (4, D)), coef=dyadic(rng, (D,)), w=dyadic(rng, (D, 1)),
                       pc=dyadic(rng, (D, 3)))
    return WEIGHTS


def make_models(pkg: str):
    w = _weights()
    km, lr, lg, pca = ((KMeansModel, LinearRegressionModel, LogisticRegressionModel, PCAModel) if pkg == "port"
                       else (JaxKMeansModel, JaxLinRegModel, JaxLogRegModel, JaxPCAModel))
    return {
        "km": km("srv-km", w["centers"]),
        "lr": lr("srv-lr", w["coef"], 0.25),
        "logreg": lg("srv-logreg", w["w"], np.asarray([0.5]), numClasses=2),
        "pca": pca("srv-pca", w["pc"], np.full(3, 1.0 / 3)),
    }


@pytest.fixture
def models():
    return make_models("port")


@pytest.fixture(scope="module")
def jmodels():
    return make_models("jax")


def leaves(out):
    return [np.asarray(a) for a in (out if isinstance(out, (tuple, list)) else (out,))]


def assert_same(got, want, probs_tol: bool = False):
    """Exactly, except a logistic triple's probabilities against the
    reference's (torch's sigmoid against XLA's) to 1e-10."""
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if probs_tol and len(got) == 3 and i == 1:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
        else:
            np.testing.assert_array_equal(g, w)


def _own_route(model, family, x):
    if family == "pca":
        return model.transform(x)
    if family == "logreg":
        return model._predict_all(x)
    return model.predict(x)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_registry_versioning_aliases_and_retire(models):
    reg = ModelRegistry()
    v1 = reg.register("km", models["km"])
    v2 = reg.register("km", models["km"])
    assert isinstance(v1, ModelVersion) and (v1.version, v2.version) == (1, 2)
    assert reg.resolve("km").version == 2
    reg.set_alias("km", "prod", 1)
    assert reg.resolve("km", "prod").version == 1
    assert reg.resolve("km@prod").version == 1
    assert reg.resolve("km@2").version == 2
    assert reg.resolve("km", 1).version == 1
    reg.retire("km", 2)
    assert reg.resolve("km").version == 1
    assert reg.register("km", models["km"]).version == 3  # a retired number is never reissued
    assert reg.versions("km") == [1, 3] and reg.names() == ["km"]
    for bad in (lambda: reg.resolve("km@canary"), lambda: reg.resolve("km", 2), lambda: reg.resolve("missing"),
                lambda: reg.retire("km", 9), lambda: reg.set_alias("km", "x", 9)):
        with pytest.raises(KeyError):
            bad()
    with pytest.raises(TypeError, match="serving_signature"):
        reg.register("bad", object())


def test_registry_rollback_round_trips(models):
    reg = ModelRegistry()
    for _ in range(3):
        reg.register("km", models["km"])
    reg.set_alias("km", "prod", 1)
    with pytest.raises(KeyError, match="no previous version"):
        reg.rollback("km")
    reg.set_alias("km", "prod", 3)
    assert reg.rollback_target("km") == 1
    assert reg.rollback("km") == 1 and reg.aliases("km") == {"prod": 1}
    assert reg.rollback("km") == 3  # rolling back twice returns
    reg.set_alias("km", "prod", 2)
    reg.retire("km", 3)
    with pytest.raises(KeyError, match="was retired"):
        reg.rollback("km")


def test_registry_load_from_mlwriter_path_and_warm(models, tmp_path):
    path = str(tmp_path / "km_model")
    models["km"].write.overwrite().save(path)
    reg = ModelRegistry()
    mv = reg.load("km", path, KMeansModel, alias="prod", warm_buckets=(5, 64), warm_dtype=np.float64)
    stats = core_serving.program_cache_stats()
    assert stats["compiles"] == 2  # 5 -> bucket 8, 64 -> 64
    assert reg.resolve("km@prod").version == mv.version
    x = dyadic(np.random.default_rng(0), (5, D))
    sig = mv.signature
    out = core_serving.serve_rows(sig.kernel, x, sig.weights, static=sig.static, name=sig.name)
    assert core_serving.program_cache_stats()["compiles"] == 2  # the warmed bucket
    np.testing.assert_array_equal(out, models["km"].predict(x))


def test_registry_loads_a_pipeline_directory_by_path_alone(tmp_path):
    w = _weights()
    pipe = interop.pipeline_model_from_numpy(
        [{"family": "pca", "pc": w["pc"], "explained_variance": np.full(3, 1 / 3)},
         {"family": "linear_regression", "coef": w["coef"][:3], "intercept": 0.5}], uid="pl")
    path = str(tmp_path / "pipe")
    pipe.write.overwrite().save(path)
    with ServingRuntime(max_batch=8, max_delay_ms=1.0) as rt:
        mv = rt.load("pl", path)
        assert type(mv.model).__name__ == "PipelineModel"
        x = dyadic(np.random.default_rng(1), (3, D))
        out = rt.submit("pl", x).result(timeout=WAIT)
    np.testing.assert_array_equal(out, pipe.transform(x))


def test_warm_dtype_float32_warms_the_tensor_route(models):
    """``warm_dtype`` float32 warms the signature's tensor route: a float32
    tensor through the signature then replays a warmed program."""
    reg = ModelRegistry()
    mv = reg.register("pca", models["pca"])
    assert reg.warm("pca", buckets=(1, 3, 9), dtype=torch.float32) == 2
    assert core_serving.program_cache_stats()["compiles"] == 2
    sig = mv.signature
    out = core_serving.serve_rows(sig.kernel, torch.ones((9, D), dtype=torch.float32), sig.weights,
                                  static=sig.static, name=sig.name)
    assert out.dtype == torch.float32
    assert core_serving.program_cache_stats()["compiles"] == 2
    np.testing.assert_array_equal(out.numpy(), models["pca"].transform(torch.ones((9, D), dtype=torch.float32)))


def test_retire_invalidates_device_caches_and_programs():
    rng = np.random.default_rng(3)
    km = KMeansModel("retire-km", dyadic(rng, (4, D)))
    km.predict(dyadic(rng, (3, D)))
    assert km._centers_dev is not None
    reg = ModelRegistry()
    mv = reg.register("km", km, warm_buckets=(1,))
    assert core_serving.program_cache_stats()["size"] == 1
    before = counter_value("serving.device_cache.invalidate")
    reg.retire("km", mv.version)
    assert km._centers_dev is None
    assert counter_value("serving.device_cache.invalidate") > before
    assert core_serving.program_cache_stats()["size"] == 0


def test_registry_snapshot(models):
    reg = ModelRegistry()
    reg.register("km", models["km"], alias="prod")
    reg.register("pca", models["pca"])
    snap = reg.snapshot()
    assert snap["km"] == {"versions": [1], "latest": 1, "aliases": {"prod": 1},
                          "weights_bytes": {1: 4 * D * 8}}
    assert snap["pca"]["weights_bytes"] == {1: D * 3 * 8}


# ---------------------------------------------------------------------------
# micro-batching: coalescing and parity
# ---------------------------------------------------------------------------


def test_coalescing_many_callers_share_one_program(models):
    """16 threads x 16 single rows: >= 4x fewer executions than requests,
    one program run per dispatched batch, every answer the model's."""
    rows = dyadic(np.random.default_rng(11), (256, D))
    rt = ServingRuntime(max_batch=64, max_delay_ms=5.0, start=False)
    rt.register("km", models["km"])
    results, lock = {}, threading.Lock()

    def worker(tid):
        futs = [(tid * 16 + j, rt.submit("km", rows[tid * 16 + j])) for j in range(16)]
        with lock:
            results.update(futs)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    assert rt.queue_depth() == 256
    d0 = counter_value("serving.batch.dispatch")
    s0 = core_serving.program_cache_stats()
    rt.start()
    got = {i: f.result(timeout=WAIT) for i, f in results.items()}
    rt.close()
    dispatches = counter_value("serving.batch.dispatch") - d0
    s1 = core_serving.program_cache_stats()
    programs = (s1["hits"] + s1["misses"]) - (s0["hits"] + s0["misses"])
    assert dispatches * 4 <= 256
    assert programs == dispatches
    expected = models["km"].predict(rows)
    for i, out in got.items():
        assert out.shape == (1,)
        np.testing.assert_array_equal(out, expected[i:i + 1])


@pytest.mark.parametrize("family", ["km", "lr", "logreg", "pca"])
def test_single_family_parity_with_the_reference(models, jmodels, family):
    block = dyadic(np.random.default_rng(21), (6, D))
    with ServingRuntime(max_batch=32, max_delay_ms=2.0) as rt:
        rt.register(family, models[family])
        out = rt.submit(family, block).result(timeout=WAIT)
    with JaxServingRuntime(max_batch=32, max_delay_ms=2.0) as jrt:
        jrt.register(family, jmodels[family])
        want = jrt.submit(family, block).result(timeout=WAIT)
    assert_same(out, want, probs_tol=True)
    assert_same(out, _own_route(models[family], family, block))


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_forest_parity_with_the_reference(kind):
    from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRFC
    from spark_rapids_ml_tpu.regression import RandomForestRegressor as JaxRFR
    from spark_rapids_ml_tpu_torch.ops.trees import Forest

    rng = np.random.default_rng(61)
    x = rng.normal(size=(80, 4))
    if kind == "classifier":
        ref = JaxRFC().setNumTrees(4).setMaxDepth(3).setSeed(0).fit((x, (x[:, 0] + x[:, 1] > 0).astype(float)))
    else:
        ref = JaxRFR().setNumTrees(4).setMaxDepth(3).setSeed(0).fit((x, x[:, 0] - x[:, 1]))
    arrays = {f: np.asarray(getattr(ref._forest, f)) for f in Forest._fields}
    model = (interop.random_forest_classification_model_from_numpy(arrays, 4, 2) if kind == "classifier"
             else interop.random_forest_regression_model_from_numpy(arrays, 4))
    probe = rng.normal(size=(5, 4))
    with ServingRuntime(max_batch=8, max_delay_ms=1.0) as rt:
        rt.register("rf", model)
        out = rt.submit("rf", probe).result(timeout=WAIT)
    with JaxServingRuntime(max_batch=8, max_delay_ms=1.0) as jrt:
        jrt.register("rf", ref)
        want = jrt.submit("rf", probe).result(timeout=WAIT)
    np.testing.assert_array_equal(out, np.asarray(want))
    own = model.predictProbability(probe) if kind == "classifier" else model.predict(probe)
    np.testing.assert_array_equal(out, own)


def test_fused_pipeline_is_one_servable(jmodels):
    from spark_rapids_ml_tpu.pipeline import PipelineModel as JaxPipelineModel

    w = _weights()
    pipe = interop.pipeline_model_from_numpy(
        [{"family": "pca", "pc": w["pc"], "explained_variance": np.full(3, 1 / 3)},
         {"family": "logistic_regression", "weights": w["w"][:3], "intercepts": np.asarray([0.5]),
          "num_classes": 2}], uid="pl")
    jpipe = JaxPipelineModel("pl", [JaxPCAModel("p", w["pc"], np.full(3, 1 / 3)),
                                    JaxLogRegModel("l", w["w"][:3], np.asarray([0.5]), numClasses=2)])
    x = dyadic(np.random.default_rng(22), (32, D))
    with ServingRuntime(max_batch=32, max_delay_ms=1.0) as rt:
        rt.register("pl", pipe, warm_buckets=(32,))
        before = core_serving.program_cache_stats()["compiles"]
        futs = [rt.submit("pl", x) for _ in range(3)]
        outs = [f.result(timeout=WAIT) for f in futs]
        assert core_serving.program_cache_stats()["compiles"] == before  # one program for the chain
    for out in outs:
        np.testing.assert_array_equal(out, pipe.transform(x))
        np.testing.assert_array_equal(out, np.asarray(jpipe.transform(x)))


def test_concurrent_mixed_families_bitwise_parity(models):
    """16 submitter threads over four families, blocks of 1-5 rows, one
    runtime: every answer bitwise the family's own route."""
    families = ["km", "lr", "logreg", "pca"]
    rng = np.random.default_rng(31)
    jobs = [(families[t % 4], dyadic(rng, (1 + (t % 5), D))) for t in range(16)]
    rt = ServingRuntime(max_batch=64, max_delay_ms=5.0)
    for fam in families:
        rt.register(fam, models[fam])
    outs = [None] * len(jobs)

    def worker(i):
        fam, block = jobs[i]
        outs[i] = rt.submit(fam, block).result(timeout=WAIT)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    rt.close()
    assert not any(t.is_alive() for t in threads)
    for (fam, block), out in zip(jobs, outs):
        assert_same(out, _own_route(models[fam], fam, block))


def test_submit_many_resolves_once(models):
    with ServingRuntime(max_batch=16, max_delay_ms=1.0) as rt:
        rt.register("km", models["km"], alias="prod")
        rows = dyadic(np.random.default_rng(23), (5, D))
        futs = rt.submit_many("km@prod", list(rows))
        rt.register("km", KMeansModel("v2", _weights()["centers"] + 64.0), alias="prod")
        got = np.concatenate([f.result(timeout=WAIT) for f in futs])
        assert {f.model_version for f in futs} == {1}
    np.testing.assert_array_equal(got, models["km"].predict(rows))


# ---------------------------------------------------------------------------
# deadlines and admission
# ---------------------------------------------------------------------------


def test_deadline_expiry_is_structured(models):
    rt = ServingRuntime(start=False)
    rt.register("km", models["km"])
    fut = rt.submit("km", np.zeros(D), timeout=0.01)
    time.sleep(0.05)
    c0 = counter_value("serving.deadline.expired")
    rt.start()
    with pytest.raises(DeadlineExceeded) as err:
        fut.result(timeout=WAIT)
    assert err.value.model == "km" and err.value.waited_ms >= 10.0
    assert err.value.deadline_ms == pytest.approx(10.0)
    assert counter_value("serving.deadline.expired") == c0 + 1
    rt.close()
    assert rt.snapshot()["reserved_bytes"] == 0


def test_shed_on_queue_overload(models):
    rt = ServingRuntime(queue_limit=3, start=False)
    rt.register("km", models["km"])
    futs = [rt.submit("km", np.zeros(D)) for _ in range(3)]
    c0 = counter_value("serving.shed.queue")
    with pytest.raises(Overloaded) as err:
        rt.submit("km", np.zeros(D))
    assert err.value.reason == "queue"
    assert err.value.queue_depth == 3 and err.value.queue_limit == 3
    assert err.value.retry_after_ms > 0
    assert counter_value("serving.shed.queue") == c0 + 1
    rt.close()  # drains the three queued requests
    assert all(f.result(timeout=WAIT).shape == (1,) for f in futs)


def test_shed_on_memory_budget_and_release(models, jmodels):
    """A request is priced as the reference prices it (the bucketed input
    and the outputs at that bucket, declared), sheds past the budget, and
    its reservation returns when it completes."""
    # The reference's price on a family whose outputs have the same dtype
    # in both packages (the port's KMeans labels are int64, the
    # reference's int32: each prices its own declared output).
    price = 8 * D * 8 + spec_bytes(models["pca"].serving_signature().output_spec(8, torch.float64))
    assert price == 8 * D * 8 + jax_spec_bytes(
        jmodels["pca"].serving_signature().output_spec(8, np.dtype(np.float64)))
    sig = models["km"].serving_signature()
    one = 8 * D * 8 + spec_bytes(sig.output_spec(8, torch.float64))
    assert one == 8 * D * 8 + 8 * 8
    rt = ServingRuntime(mem_budget=2 * one, queue_limit=100, start=False)
    rt.register("km", models["km"])
    rt.submit("km", np.zeros(D))
    rt.submit("km", np.zeros(D))
    c0 = counter_value("serving.shed.memory")
    with pytest.raises(Overloaded) as err:
        rt.submit("km", np.zeros(D))
    assert err.value.reason == "memory"
    assert err.value.mem_budget == 2 * one and err.value.reserved_bytes == 2 * one
    assert err.value.request_bytes == one
    assert counter_value("serving.shed.memory") == c0 + 1
    rt.start()
    deadline = time.monotonic() + WAIT
    while rt.snapshot()["reserved_bytes"] != 0 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert rt.snapshot()["reserved_bytes"] == 0
    assert rt.submit("km", np.zeros(D)).result(timeout=WAIT) is not None
    rt.close()


def test_submit_validation_errors(models):
    rt = ServingRuntime(start=False)
    rt.register("km", models["km"])
    with pytest.raises(ValueError, match="features"):
        rt.submit("km", np.zeros(D + 1))
    with pytest.raises(ValueError, match="2-D"):
        rt.submit("km", np.zeros((2, 2, 2)))
    with pytest.raises(KeyError):
        rt.submit("nope", np.zeros(D))
    rt.close()
    with pytest.raises(RuntimeError, match="closed"):
        rt.submit("km", np.zeros(D))
    with pytest.raises(RuntimeError, match="closed"):
        rt.start()


def test_close_without_drain_fails_pending(models):
    rt = ServingRuntime(start=False)
    rt.register("km", models["km"])
    futs = [rt.submit("km", np.zeros(D)) for _ in range(4)]
    rt.close(drain=False)
    for f in futs:
        with pytest.raises(RuntimeError, match="closed"):
            f.result(timeout=WAIT)
    assert rt.snapshot()["reserved_bytes"] == 0


def test_close_with_drain_answers_everyone(models):
    rt = ServingRuntime(start=False)
    rt.register("km", models["km"])
    futs = [rt.submit("km", np.zeros((2, D))) for _ in range(5)]
    rt.close(drain=True)
    rt.close()  # idempotent
    for f in futs:
        assert f.result(timeout=WAIT).shape == (2,)
    assert not rt.running


def test_context_manager_closes_with_drain(models):
    with ServingRuntime(max_batch=4, max_delay_ms=1.0) as rt:
        rt.register("km", models["km"])
        fut = rt.submit("km", np.zeros(D))
    assert fut.result(timeout=WAIT).shape == (1,)
    assert rt.snapshot()["closed"] and not rt.running


# ---------------------------------------------------------------------------
# hot swap
# ---------------------------------------------------------------------------


def test_hot_swap_under_load_is_version_atomic(tmp_path):
    rng = np.random.default_rng(41)
    m1 = KMeansModel("swap-v1", dyadic(rng, (4, D)))
    m2 = KMeansModel("swap-v2", dyadic(rng, (4, D)) + 64.0)
    probes = dyadic(rng, (240, D))
    exp1, exp2 = m1.predict(probes), m2.predict(probes)
    log = tmp_path / "swap.jsonl"
    events.configure(str(log))
    try:
        rt = ServingRuntime(max_batch=16, max_delay_ms=2.0)
        v1 = rt.register("km", m1, alias="prod")
        collected, lock = [], threading.Lock()
        started, swapped = threading.Event(), threading.Event()

        def worker(tid):
            local = []
            for j in range(30):
                i = tid * 30 + j
                fut = rt.submit("km@prod", probes[i])
                local.append((i, fut.result(timeout=WAIT), fut.model_version))
                if tid == 0 and j == 4:
                    started.set()  # some answers came from v1
                if tid == 0 and j == 10:
                    swapped.wait(timeout=WAIT)  # the rest come after the swap
            with lock:
                collected.extend(local)

        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        assert started.wait(timeout=WAIT)
        v2 = rt.register("km", m2)
        rt.set_alias("km", "prod", v2.version)
        swapped.set()
        for t in threads:
            t.join(timeout=WAIT)
        rt.close()
    finally:
        events.configure()
    assert not any(t.is_alive() for t in threads)
    assert (v1.version, v2.version) == (1, 2)
    assert len(collected) == 240
    for i, out, version in collected:
        want = exp1 if version == 1 else exp2
        np.testing.assert_array_equal(out, want[i:i + 1])
    assert {version for _, _, version in collected} == {1, 2}
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    serving_recs = [r for r in recs if r["event"] == "serving"]
    admitted = {r["run_id"]: r["version"] for r in serving_recs if r["action"] == "enqueue"}
    assert len(admitted) == 240
    for r in serving_recs:
        if r["action"] == "dispatch":
            assert {admitted[rid] for rid in r["run_ids"]} == {r["version"]}, "mixed-version batch"
        elif r["action"] == "complete":
            assert admitted[r["run_id"]] == r["version"]


# ---------------------------------------------------------------------------
# events, gauges, failures
# ---------------------------------------------------------------------------


def test_every_request_joins_one_run_id_and_one_trace(models, tmp_path):
    log = tmp_path / "serve.jsonl"
    events.configure(str(log))
    try:
        with ServingRuntime(max_batch=8, max_delay_ms=2.0) as rt:
            rt.register("km", models["km"])
            futs = [rt.submit("km", np.zeros(D)) for _ in range(6)]
            for f in futs:
                f.result(timeout=WAIT)
    finally:
        events.configure()
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    for rec in recs:
        assert validate_record(rec) == [], rec
    serving_recs = [r for r in recs if r["event"] == "serving"]
    enq = {r["run_id"]: r for r in serving_recs if r["action"] == "enqueue"}
    done = {r["run_id"]: r for r in serving_recs if r["action"] == "complete"}
    dispatched = [rid for r in serving_recs if r["action"] == "dispatch" for rid in r["run_ids"]]
    assert len(enq) == 6 and set(done) == set(enq) and sorted(dispatched) == sorted(enq)
    for rid, r in done.items():
        assert r["model"] == "km" and "latency_ms" in r
        assert r["trace"] == enq[rid]["trace"] is not None  # the trace crossed to the dispatcher


def test_gauges_and_histograms(models):
    rt = ServingRuntime(max_batch=4, max_delay_ms=1.0, start=False)
    rt.register("km", models["km"])
    for _ in range(3):
        rt.submit("km", np.zeros(D))
    depth = metrics.gauge("serving.queue.depth")
    assert depth.value(runtime=rt.runtime_id) == 3
    assert metrics.gauge("serving.inflight").value(runtime=rt.runtime_id) == 0
    assert any(s["runtime"] == rt.runtime_id and s["queue_depth"] == 3 for s in runtime_snapshots())
    from spark_rapids_ml_tpu_torch.serving.batcher import _latency_hist

    lat0 = _latency_hist().value()["count"]
    rt.close()
    assert _latency_hist().value()["count"] == lat0 + 3
    assert 'serving.queue.depth{runtime="%s"}' % rt.runtime_id not in metrics.default_registry.snapshot()["gauges"]


def test_failing_device_errors_the_batch(models, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("CUDA error: device unavailable")

    monkeypatch.setattr(admission, "serve_rows", broken)
    c0 = counter_value("serving.batch.errors")
    with ServingRuntime(max_batch=8, max_delay_ms=1.0) as rt:
        rt.register("km", models["km"])
        futs = [rt.submit("km", np.zeros(D)) for _ in range(2)]
        for fut in futs:
            with pytest.raises(RuntimeError, match="device unavailable"):
                fut.result(timeout=WAIT)
        assert rt.snapshot()["reserved_bytes"] == 0
    assert counter_value("serving.batch.errors") > c0
    assert counter_value("serving.degraded_batches") == 0


def test_cpu_degrade_is_refused(models, monkeypatch):
    monkeypatch.setenv("TPUML_DEGRADE", "cpu")
    with ServingRuntime(max_batch=8, max_delay_ms=1.0) as rt:
        rt.register("km", models["km"])
        with pytest.raises(NotImplementedError, match="does not fall back to the CPU"):
            rt.submit("km", np.zeros(D)).result(timeout=WAIT)
    monkeypatch.setenv("TPUML_DEGRADE", "sideways")
    with pytest.raises(ValueError, match="TPUML_DEGRADE"):
        admission.execute_with_fallback(models["km"].serving_signature(), np.zeros((1, D)))


def test_admission_queue_and_batcher_alone(models):
    """The queue and the dispatcher without the façade: compatible
    requests coalesce up to max_batch rows, the rest stay queued."""
    queue = AdmissionQueue(limit=10)
    mv = ModelRegistry().register("km", models["km"])
    reqs = [admission.Request(key=("km", 1, D, "float64"), x=np.zeros((3, D)), n=3, version=mv, run_id=f"r{i}")
            for i in range(4)]
    for r in reqs:
        queue.submit(r)
    first = queue.pop_first(timeout=0.0)
    assert first is reqs[0]
    assert queue.drain_compatible(first.key, 4) == [reqs[1]]
    assert queue.depth() == 2
    batcher = MicroBatcher(queue, max_batch=6, max_delay_ms=0.0)
    batcher.start()
    for r in reqs[2:]:
        assert r.future.result(timeout=WAIT).shape == (3,)
    batcher.stop()
    assert not batcher.running and batcher.inflight() == 0


def test_the_distributed_names_are_the_routing_tier():
    """``RoutingRuntime``, ``router_snapshots`` and ``ElasticScaler`` are
    the port's routing tier, exported as the reference exports them."""
    import spark_rapids_ml_tpu.serving as jax_serving
    import spark_rapids_ml_tpu_torch.serving as serving
    from spark_rapids_ml_tpu_torch.serving import elastic, router

    assert serving.RoutingRuntime is router.RoutingRuntime
    assert serving.router_snapshots is router.router_snapshots
    assert serving.ElasticScaler is elastic.ElasticScaler
    assert set(jax_serving.__all__) <= set(serving.__all__)
    assert isinstance(serving.router_snapshots(), list)


def test_stress_many_threads_with_evictions(models, monkeypatch):
    """32 submitting threads (more than the cores), a short interpreter
    switch interval, and an LRU of 2 programs evicting under the
    dispatcher while two families alternate: every answer is its family's,
    every reserved byte is released, and the rows dispatched are the rows
    submitted."""
    import sys

    monkeypatch.setenv("TPUML_SERVING_CACHE_SIZE", "2")
    rng = np.random.default_rng(71)
    jobs = [("km" if t % 2 else "pca", dyadic(rng, (1 + t % 9, D))) for t in range(32)]
    expected = [_own_route(models[fam], fam, block) for fam, block in jobs]
    rows0 = counter_value("serving.batch.rows_total")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rt = ServingRuntime(max_batch=8, max_delay_ms=1.0)
        rt.register("km", models["km"])
        rt.register("pca", models["pca"])
        outs = [None] * len(jobs)

        def worker(i):
            fam, block = jobs[i]
            outs[i] = [rt.submit(fam, block).result(timeout=WAIT) for _ in range(5)]

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        rt.close()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for got, want in zip(outs, expected):
        for out in got:
            assert_same(out, want)
    assert rt.snapshot()["reserved_bytes"] == 0
    assert counter_value("serving.batch.rows_total") - rows0 == 5 * sum(b.shape[0] for _, b in jobs)
    assert core_serving.program_cache_stats()["evictions"] > 0
