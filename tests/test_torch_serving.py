"""The port's bucketed program cache (``core/serving.py``) against the
JAX package's.

On the CPU a program is the eager kernel on the padded bucket, so buckets,
hits, misses, LRU evictions, the capture bound and slicing are exercised
here as on the card (where a program is a CUDA graph:
``tests/test_torch_cuda_serving.py``). Each family's served output is
held against the reference's ``serve_rows`` / ``predict`` on the same
weights (carried across by value or ``interop``): exactly on dyadic rows
(integers / 4, whose products and sums are exact in float64), 1e-10 on
other float64 rows.
"""

import json

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.core import serving as jserving
from spark_rapids_ml_tpu.models.kmeans import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.models.linear_regression import LinearRegressionModel as JaxLinRegModel
from spark_rapids_ml_tpu.models.logistic_regression import LogisticRegressionModel as JaxLogRegModel
from spark_rapids_ml_tpu.models.pca import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu.observability import metrics as jmetrics
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.core import serving
from spark_rapids_ml_tpu_torch.models.kmeans import KMeansModel
from spark_rapids_ml_tpu_torch.models.linear_regression import LinearRegressionModel
from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegressionModel
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.observability import events, metrics
from spark_rapids_ml_tpu_torch.pipeline import PipelineModel
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value

D = 8


def dyadic(rng, shape, scale=4):
    """Integers / 4: every product and sum below is exact in float64."""
    return rng.integers(-4 * scale, 4 * scale, size=shape).astype(np.float64) / 4.0


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    serving.clear_program_cache()
    yield
    serving.clear_program_cache()
    port_device.set_platform("cuda")


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(7)
    return {
        "centers": dyadic(rng, (4, D)),
        "coef": dyadic(rng, (D,)),
        "w": dyadic(rng, (D, 1)),
        "w3": dyadic(rng, (D, 3)),
        "pc": dyadic(rng, (D, 3)),
    }


def port_models(w):
    return {
        "km": KMeansModel("srv-km", w["centers"]),
        "lr": LinearRegressionModel("srv-lr", w["coef"], 0.25),
        "logreg": LogisticRegressionModel("srv-logreg", w["w"], np.asarray([0.5]), numClasses=2),
        "pca": PCAModel("srv-pca", w["pc"], np.full(3, 1.0 / 3)),
    }


def jax_models(w):
    return {
        "km": JaxKMeansModel("srv-km", w["centers"]),
        "lr": JaxLinRegModel("srv-lr", w["coef"], 0.25),
        "logreg": JaxLogRegModel("srv-logreg", w["w"], np.asarray([0.5]), numClasses=2),
        "pca": JaxPCAModel("srv-pca", w["pc"], np.full(3, 1.0 / 3)),
    }


def leaves(out):
    return [np.asarray(a) for a in (out if isinstance(out, tuple) else (out,))]


def assert_same(got, want):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def assert_like_reference(got, want):
    """Labels and dyadic real values exactly; a logistic triple's
    probabilities (torch's sigmoid and softmax against XLA's) to 1e-10."""
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if len(got) == 3 and i == 1:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
        else:
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 8, 9, 100, 1000, 4097, 8192, 65536, 65537])
def test_bucket_rows_is_the_references(n):
    assert serving.bucket_rows(n) == jserving.bucket_rows(n)
    assert serving.MIN_ROW_BUCKET == jserving.MIN_ROW_BUCKET


def test_bucket_rows_rejects_empty():
    for mod in (serving, jserving):
        with pytest.raises(ValueError, match="at least one row"):
            mod.bucket_rows(0)


@pytest.mark.parametrize("value", [None, "128", "1", "0", "many"])
def test_stream_block_rows_reads_like_the_reference(monkeypatch, value):
    if value is not None:
        monkeypatch.setenv("TPUML_SERVE_STREAM_BLOCK", value)

    def outcome(fn):
        try:
            return fn()
        except ValueError as exc:
            return type(exc).__name__, str(exc)

    assert outcome(serving.stream_block_rows) == outcome(jserving.stream_block_rows)


# ---------------------------------------------------------------------------
# the program cache
# ---------------------------------------------------------------------------


def test_compiles_equal_buckets_not_calls(weights):
    model, ref = port_models(weights)["pca"], jax_models(weights)["pca"]
    rng = np.random.default_rng(0)
    sizes = (100, 1000, 8192)
    batches = [dyadic(rng, (n, D)) for n in sizes]
    for x in batches + batches:
        assert_same(model.transform(x), ref.transform(x))
    stats = serving.program_cache_stats()
    assert stats["compiles"] == stats["misses"] == 3
    assert stats["hits"] == 3
    assert stats["size"] == 3 and stats["capacity"] == serving.DEFAULT_CACHE_SIZE


def test_within_bucket_sizes_share_one_program(weights):
    model = port_models(weights)["pca"]
    rng = np.random.default_rng(2)
    for n in (513, 700, 900, 1024):
        model.transform(dyadic(rng, (n, D)))
    assert serving.program_cache_stats()["compiles"] == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tensor_in_tensor_out_at_its_dtype(weights, dtype):
    model, ref = port_models(weights)["pca"], jax_models(weights)["pca"]
    x = dyadic(np.random.default_rng(4), (33, D))
    out = model.transform(torch.tensor(x, dtype=dtype))
    assert isinstance(out, torch.Tensor) and out.dtype == dtype and out.shape == (33, 3)
    np.testing.assert_array_equal(out.double().numpy(), np.asarray(ref.transform(x)))
    before = serving.program_cache_stats()["compiles"]
    model.transform(torch.tensor(np.tile(x, (2, 1))[:40], dtype=dtype))  # bucket 64 again: a hit
    assert serving.program_cache_stats()["compiles"] == before


def test_padding_rows_never_leak(weights):
    model = port_models(weights)["pca"]
    x = dyadic(np.random.default_rng(3), (5, D))  # bucket 8: three padding rows
    out = model.transform(x)
    assert out.shape == (5, 3)
    np.testing.assert_array_equal(out, x @ weights["pc"])


def test_padding_rows_never_leak_under_cosine(weights):
    """Zero padding rows meet the cosine normalization; assignment is
    row-wise, so no padding row reaches a real row's label."""
    rng = np.random.default_rng(5)
    centers = rng.normal(size=(5, D))
    model, ref = KMeansModel("cos", centers), JaxKMeansModel("cos", centers)
    for m in (model, ref):
        m.set(m.distanceMeasure, "cosine")
    x = rng.normal(size=(11, D))  # bucket 16: five padding rows
    np.testing.assert_array_equal(model.predict(x), np.asarray(ref.predict(x)))
    sig = model.serving_signature()
    out = serving.serve_rows(sig.kernel, torch.tensor(x), sig.weights, static=sig.static, name=sig.name)
    assert out.shape == (11,)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref.predict(x)))


def test_lru_bound_and_evictions(weights, monkeypatch):
    monkeypatch.setenv("TPUML_SERVING_CACHE_SIZE", "2")
    model = port_models(weights)["pca"]
    rng = np.random.default_rng(5)
    for n in (8, 100, 1000, 8192):
        model.transform(dyadic(rng, (n, D)))
    stats = serving.program_cache_stats()
    assert stats["size"] == 2 and stats["capacity"] == 2
    assert stats["evictions"] == 2
    assert counter_value("serving.cache.evict") >= 2


def test_evicted_programs_are_closed_and_release_their_weights(weights, monkeypatch):
    monkeypatch.setenv("TPUML_SERVING_CACHE_SIZE", "1")
    model = port_models(weights)["pca"]
    model.transform(np.zeros((3, D)))
    (first,) = list(serving._PROGRAMS.values())
    assert first.weights and not first.closed
    model.transform(np.zeros((30, D)))
    assert first.closed and first.weights == ()
    assert serving.program_cache_stats()["size"] == 1


def test_counters(weights):
    c = {k: counter_value(k) for k in ("serving.cache.miss", "serving.cache.hit", "serving.compile")}
    model = port_models(weights)["km"]
    model.predict(np.zeros((10, D)))
    model.predict(np.zeros((12, D)))
    assert counter_value("serving.cache.miss") - c["serving.cache.miss"] == 1
    assert counter_value("serving.compile") - c["serving.compile"] == 1
    assert counter_value("serving.cache.hit") - c["serving.cache.hit"] == 1
    assert metrics.gauge("serving.cache.size").value() == 1
    hist = metrics.histogram("serving.batch_rows", buckets=metrics.ROW_BUCKETS).value()
    assert hist["count"] >= 2


def test_weights_are_part_of_the_key_by_identity(weights):
    """Two models of the same shapes keep programs of their own: a program
    reads its weights by address on the card."""
    a, b = port_models(weights)["km"], KMeansModel("other", weights["centers"] + 1.0)
    x = np.zeros((4, D))
    a.predict(x)
    b.predict(x)
    stats = serving.program_cache_stats()
    assert stats["compiles"] == 2 and stats["hits"] == 0
    a.predict(x)
    assert serving.program_cache_stats()["hits"] == 1


def test_capture_bound_bypass(weights, monkeypatch):
    monkeypatch.setenv("TPUML_SERVE_STREAM_BLOCK", "64")
    model, ref = port_models(weights)["lr"], jax_models(weights)["lr"]
    x = dyadic(np.random.default_rng(9), (100, D))  # bucket 128 > 64
    before = counter_value("serving.cache.bypass")
    out = model.predict(torch.tensor(x))
    assert counter_value("serving.cache.bypass") - before == 1
    stats = serving.program_cache_stats()
    assert stats["bypass"] == 1 and stats["compiles"] == 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref.predict(x)))


def test_empty_tensor_runs_the_kernel_uncached(weights):
    model = port_models(weights)["pca"]
    out = model.transform(torch.zeros((0, D), dtype=torch.float64))
    assert out.shape == (0, 3)
    assert serving.program_cache_stats()["misses"] == 0


def test_each_serve_call_opens_a_run_scope(weights, tmp_path):
    log = tmp_path / "serve.jsonl"
    events.configure(str(log))
    try:
        model = port_models(weights)["km"]
        model.predict(np.zeros((3, D)))
        with events.run_scope("job", "outer") as outer:
            model.predict(np.zeros((3, D)))
    finally:
        events.configure()
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    from spark_rapids_ml_tpu.observability.events import validate_record

    assert all(validate_record(r) == [] for r in recs)
    runs = {r["run_id"] for r in recs if r["event"] == "serving"}
    assert len(runs) == 2 and outer.run_id in runs
    assert all(r["trace"] for r in recs)


# ---------------------------------------------------------------------------
# streaming and blocks
# ---------------------------------------------------------------------------


def test_stream_matches_batch(weights):
    model, ref = port_models(weights)["pca"], jax_models(weights)["pca"]
    rng = np.random.default_rng(8)
    blocks = [dyadic(rng, (n, D)) for n in (64, 100, 17, 64)]
    outs = list(model.transform(lambda: iter(blocks)))
    assert [o.shape[0] for o in outs] == [64, 100, 17, 64]
    for blk, out in zip(blocks, outs):
        assert_same(out, ref.transform(blk))
    assert serving.program_cache_stats()["compiles"] == 3  # buckets 64, 128, 32


def test_partitioned_host_transform(weights):
    model, ref = port_models(weights)["pca"], jax_models(weights)["pca"]
    rng = np.random.default_rng(9)
    parts = [dyadic(rng, (40, D)), dyadic(rng, (25, D))]
    out = model.transform(parts)
    assert out.shape == (65, 3)
    assert_same(out, ref.transform(np.concatenate(parts)))


@pytest.mark.parametrize("block", [7, 64, 1000])
@pytest.mark.parametrize("family", ["km", "logreg"])
def test_serve_blocks_is_serve_rows(weights, family, block):
    """Row for row, blocks give what one batch gives (the kernels are
    row-wise), tuples concatenated leaf-wise. Labels and dyadic values
    are exact; probabilities may differ in the last bit between buckets
    (torch's CPU sigmoid is vectorized by shape), so they are held to
    1e-10."""
    sig = port_models(weights)[family].serving_signature()
    x = dyadic(np.random.default_rng(10), (300, D))
    whole = serving.serve_rows(sig.kernel, x, sig.weights, static=sig.static, name=sig.name)
    blocks = serving.serve_blocks(sig.kernel, x, sig.weights, static=sig.static, name=sig.name,
                                  device=torch.device("cpu"), block=block)
    assert_like_reference(blocks, whole)
    jsig = jax_models(weights)[family].serving_signature()
    assert_like_reference(blocks, jserving.serve_blocks(jsig.kernel, x, jsig.weights, static=jsig.static,
                                                        name=jsig.name, block=block))


def test_a_host_batch_of_one_block_skips_the_stream(weights, monkeypatch):
    """One block has nothing to overlap: it goes straight through
    ``serve_rows`` (no stream block counted, the same bytes), and gives
    what the streamed blocks give."""
    model = port_models(weights)["km"]
    x = dyadic(np.random.default_rng(53), (100, D))
    c0, h0 = counter_value("serving.stream.blocks"), counter_value("serving.h2d.bytes")
    one = model.predict(x)
    assert counter_value("serving.stream.blocks") == c0
    assert counter_value("serving.h2d.bytes") - h0 == x.nbytes
    monkeypatch.setenv("TPUML_SERVE_STREAM_BLOCK", "64")
    streamed = model.predict(x)
    assert counter_value("serving.stream.blocks") - c0 == 2
    np.testing.assert_array_equal(one, streamed)


def test_serve_blocks_of_no_rows_is_none(weights):
    sig = port_models(weights)["km"].serving_signature()
    assert serving.serve_blocks(sig.kernel, np.zeros((0, D)), sig.weights, name=sig.name,
                                static=sig.static, device=torch.device("cpu")) is None


def test_kmeans_big_host_batch_streams(weights, monkeypatch):
    model, ref = port_models(weights)["km"], jax_models(weights)["km"]
    big = dyadic(np.random.default_rng(51), (1000, D))
    whole = model.predict(big)
    monkeypatch.setenv("TPUML_SERVE_STREAM_BLOCK", "128")
    c0 = counter_value("serving.stream.blocks")
    out = model.predict(big)
    assert counter_value("serving.stream.blocks") - c0 == 8
    np.testing.assert_array_equal(out, whole)
    np.testing.assert_array_equal(out, np.asarray(ref.predict(big)))


def test_logreg_big_host_batch_streams(weights, monkeypatch):
    model, ref = port_models(weights)["logreg"], jax_models(weights)["logreg"]
    big = dyadic(np.random.default_rng(52), (600, D))
    whole = model._predict_all(big)
    monkeypatch.setenv("TPUML_SERVE_STREAM_BLOCK", "100")
    c0 = counter_value("serving.stream.blocks")
    out = model._predict_all(big)
    assert counter_value("serving.stream.blocks") - c0 == 6
    assert_same(out, whole)
    assert_like_reference(out, ref._predict_all(big))


# ---------------------------------------------------------------------------
# every family through the cache
# ---------------------------------------------------------------------------


def _cached_twice(fn, batches):
    """Outputs of two passes over ``batches``; the second compiles nothing."""
    first = [fn(b) for b in batches]
    before = serving.program_cache_stats()["compiles"]
    second = [fn(b) for b in batches]
    assert serving.program_cache_stats()["compiles"] == before
    for a, b in zip(first, second):
        assert_same(a, b)
    return first


@pytest.mark.parametrize("family", ["km", "lr", "pca"])
def test_family_served_through_the_cache(weights, family):
    model, ref = port_models(weights)[family], jax_models(weights)[family]
    rng = np.random.default_rng(11)
    batches = [dyadic(rng, (n, D)) for n in (7, 130)]
    call = (lambda m: m.transform) if family == "pca" else (lambda m: m.predict)
    for x, out in zip(batches, _cached_twice(call(model), batches)):
        assert_same(out, call(ref)(x))


@pytest.mark.parametrize("n_out", [1, 3])
def test_logistic_served_through_the_cache(weights, n_out):
    w = weights["w"] if n_out == 1 else weights["w3"]
    b = np.full(n_out, 0.5)
    model = LogisticRegressionModel("lg", w, b, numClasses=max(2, n_out))
    ref = JaxLogRegModel("lg", w, b, numClasses=max(2, n_out))
    rng = np.random.default_rng(12)
    batches = [dyadic(rng, (n, D)) for n in (9, 200)]
    for x, out in zip(batches, _cached_twice(model._predict_all, batches)):
        assert_like_reference(out, ref._predict_all(x))


def test_logistic_threshold_inside_the_program(weights):
    model = LogisticRegressionModel("th", weights["w"], np.asarray([0.5])).setThreshold(0.9)
    ref = JaxLogRegModel("th", weights["w"], np.asarray([0.5])).setThreshold(0.9)
    q = dyadic(np.random.default_rng(13), (50, D), scale=1)
    np.testing.assert_array_equal(model.predict(q), np.asarray(ref.predict(q)))


def _forests():
    from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRFC
    from spark_rapids_ml_tpu.regression import RandomForestRegressor as JaxRFR

    rng = np.random.default_rng(14)
    x = rng.normal(size=(120, 4))
    y = (x[:, 0] + x[:, 1] > 0).astype(np.float64)
    clf = JaxRFC().setNumTrees(4).setMaxDepth(3).setSeed(0).fit((x, y))
    reg = JaxRFR().setNumTrees(4).setMaxDepth(3).setSeed(0).fit((x, x[:, 0] - x[:, 2]))
    return clf, reg


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_forest_served_through_the_cache(kind):
    from spark_rapids_ml_tpu_torch.ops.trees import Forest

    clf, reg = _forests()
    ref = clf if kind == "classifier" else reg
    arrays = {f: np.asarray(getattr(ref._forest, f)) for f in Forest._fields}
    if kind == "classifier":
        model = interop.random_forest_classification_model_from_numpy(arrays, 4, 2)
        call, jcall = model.predictProbability, ref.predictProbability
    else:
        model = interop.random_forest_regression_model_from_numpy(arrays, 4)
        call, jcall = model.predict, ref.predict
    rng = np.random.default_rng(15)
    batches = [rng.normal(size=(n, 4)) for n in (10, 70)]
    for x, out in zip(batches, _cached_twice(call, batches)):
        np.testing.assert_array_equal(out, np.asarray(jcall(x)))


def test_fused_pipeline_is_one_program_per_bucket(weights):
    """PCA -> logistic on host rows: the composite runs as one program per
    bucket, bit for bit the staged loop, and equal to the reference's
    fused transform."""
    from spark_rapids_ml_tpu.pipeline import PipelineModel as JaxPipelineModel

    w = weights
    stages = [{"family": "pca", "pc": w["pc"], "explained_variance": np.full(3, 1 / 3)},
              {"family": "logistic_regression", "weights": w["w3"][:3], "intercepts": np.full(3, 0.5),
               "num_classes": 3}]
    model = interop.pipeline_model_from_numpy(stages, uid="pl")
    ref = JaxPipelineModel("pl", [JaxPCAModel("p", w["pc"], np.full(3, 1 / 3)),
                                  JaxLogRegModel("l", w["w3"][:3], np.full(3, 0.5), numClasses=3)])
    rng = np.random.default_rng(16)
    batches = [dyadic(rng, (n, D)) for n in (5, 6, 40)]
    outs = _cached_twice(model.transform, batches)
    assert serving.program_cache_stats()["compiles"] == 2  # buckets 8 and 64
    for x, out in zip(batches, outs):
        np.testing.assert_array_equal(out, np.asarray(ref.transform(x)))
        staged = model.stages[1].transform(model.stages[0].transform(x))
        np.testing.assert_array_equal(out, staged)


# ---------------------------------------------------------------------------
# device-weight caches
# ---------------------------------------------------------------------------

CACHE_ATTR = {"km": "_centers_dev", "lr": "_coef_dev", "logreg": "_wb_dev", "pca": "_pc_dev_cache"}


@pytest.mark.parametrize("family", sorted(CACHE_ATTR))
def test_invalidate_drops_a_family_cache_and_its_programs(weights, family):
    model = port_models(weights)[family]
    call = model.transform if family == "pca" else model.predict
    x = dyadic(np.random.default_rng(17), (3, D))
    before = call(x)
    assert getattr(model, CACHE_ATTR[family])
    assert model in list(serving._DEVICE_CACHED_MODELS)
    assert serving.program_cache_stats()["size"] == 1
    c0 = counter_value("serving.device_cache.invalidate")
    assert serving.invalidate_device_caches(model) == 1
    assert not getattr(model, CACHE_ATTR[family])
    assert counter_value("serving.device_cache.invalidate") == c0 + 1
    assert serving.program_cache_stats()["size"] == 0
    assert_same(call(x), before)  # rebuilt from the host truth


def test_invalidate_drops_a_forest_cache():
    """A forest's per-device copies (here one filled in by hand: on the
    CPU the forest is its own copy) go, with the programs that read them."""
    from spark_rapids_ml_tpu_torch.ops.trees import Forest

    clf, _ = _forests()
    arrays = {f: np.asarray(getattr(clf._forest, f)) for f in Forest._fields}
    model = interop.random_forest_classification_model_from_numpy(arrays, 4, 2)
    copy = Forest(*(t.clone() for t in model._forest))
    model._forest_dev["elsewhere"] = copy
    serving.note_device_cache(model)
    sig = model.serving_signature()
    serving.serve_rows(sig.kernel, torch.zeros((3, 4)), (copy,), static=sig.static, name=sig.name)
    assert serving.program_cache_stats()["size"] == 1
    assert serving.invalidate_device_caches(model) == 1
    assert model._forest_dev == {} and serving.program_cache_stats()["size"] == 0


def test_invalidate_recurses_into_pipeline_stages(weights):
    m = port_models(weights)
    pipe = PipelineModel("pl", [m["pca"], KMeansModel("k3", weights["centers"][:, :3])])
    pipe.transform(dyadic(np.random.default_rng(18), (4, D)))
    assert m["pca"]._pc_dev_cache and pipe.stages[1]._centers_dev
    assert serving.invalidate_device_caches(pipe) == 2
    assert not m["pca"]._pc_dev_cache and pipe.stages[1]._centers_dev is None
    assert serving.program_cache_stats()["size"] == 0


def test_clear_program_cache_drops_every_models_device_copies(weights):
    m = port_models(weights)
    x = dyadic(np.random.default_rng(19), (3, D))
    m["km"].predict(x)
    m["lr"].predict(x)
    assert m["km"]._centers_dev is not None and m["lr"]._coef_dev is not None
    serving.clear_program_cache()
    assert m["km"]._centers_dev is None and m["lr"]._coef_dev is None
    assert serving.program_cache_stats() == {**dict.fromkeys(
        ("hits", "misses", "evictions", "compiles", "bypass", "size"), 0), "capacity": 32}
    np.testing.assert_array_equal(m["km"].predict(x), np.asarray(jax_models(weights)["km"].predict(x)))


def test_evict_programs_by_weights(weights):
    m = port_models(weights)
    m["km"].predict(np.zeros((3, D)))
    m["lr"].predict(np.zeros((3, D)))
    assert serving.evict_programs(m["km"].serving_signature().weights) == 1
    assert serving.program_cache_stats()["size"] == 1
    assert serving.evict_programs(()) == 0


def test_reclaim_device_memory_clears_the_cache(weights):
    m = port_models(weights)["km"]
    m.predict(np.zeros((3, D)))
    c0 = counter_value("fit.oom.reclaims")
    serving.reclaim_device_memory(torch.device("cpu"))
    assert counter_value("fit.oom.reclaims") == c0 + 1
    assert m._centers_dev is None and serving.program_cache_stats()["size"] == 0


# ---------------------------------------------------------------------------
# metrics and run scopes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
def test_percentile_from_histogram_is_the_references(q):
    rng = np.random.default_rng(20)
    values = rng.exponential(3.0, size=200)
    ours = metrics.Histogram("h", "", buckets=(0.5, 1, 2.5, 5, 10))
    theirs = jmetrics.Registry().histogram("h", "", buckets=(0.5, 1, 2.5, 5, 10))
    for v in values:
        ours.observe(v)
        theirs.observe(v)
    assert ours.value() == theirs.value()
    assert metrics.percentile_from_histogram(ours.value(), q) == jmetrics.percentile_from_histogram(
        theirs.value(), q)


def test_percentile_of_nothing_is_none():
    empty = metrics.Histogram("e", "", buckets=(1.0,)).value()
    assert metrics.percentile_from_histogram(empty, 0.5) is None


def test_gauge_function_remove_and_kind_clash():
    reg = metrics.Registry()
    g = reg.gauge("depth")
    box = [3]
    g.set_function(lambda: box[0], runtime="a")
    box[0] = 5
    assert g.value(runtime="a") == 5
    assert reg.snapshot()["gauges"] == {'depth{runtime="a"}': 5}
    g.remove(runtime="a")
    assert reg.snapshot()["gauges"] == {}
    reg.counter("c").inc(2, site="x")
    assert reg.snapshot()["counters"] == {'c{site="x"}': 2}
    with pytest.raises(metrics.MetricError, match="is a counter"):
        reg.gauge("c")


def test_text_exposition_names_its_item():
    for fn in (lambda: metrics.default_registry.render_prometheus(),
               lambda: metrics.parse_exposition(""),
               lambda: metrics.dump_snapshot("x.prom")):
        with pytest.raises(NotImplementedError, match=r"ROADMAP A\.9"):
            fn()


def test_run_scope_joins_the_ambient_run_and_roots_a_trace():
    assert events.current_run_id() is None
    with events.run_scope("fit", "outer") as outer:
        trace = events.current_trace()
        assert trace is not None
        with events.run_scope("serve", "inner") as inner:
            assert inner is outer
        assert events.current_run_id() == outer.run_id
    assert events.current_run_id() is None and events.current_trace() is None
    tc = events.begin_trace()
    with events.trace_scope(tc):
        with events.run_scope("serve", "x"):
            assert events.current_trace() is tc
    assert outer.run_id.startswith("fit-")
