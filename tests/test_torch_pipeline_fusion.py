"""The port's pipeline fusion against the JAX package's
(``spark_rapids_ml_tpu_torch/pipeline_fusion/``).

The claims, as the reference's ``tests/test_pipeline_fusion.py`` makes
them, on its 96 × 12 float64 rows:

- FUSED == STAGED, bitwise, for every chain of the reference's ``CHAINS``,
  for a host array and for a tensor (float64 and float32);
- the fused transform of a reference pipeline carried across with
  ``interop`` equals the reference's: labels exact, real values 1e-10;
- PCA→logistic and PCA→linear pipeline fits agree with the reference's
  fits (components 1e-8, logistic weights 1e-7 with equal ``numIter``,
  linear coefficients 1e-10);
- an unfusable chain degrades loudly (one structured
  ``FusionFallbackWarning``) and correctly; strict raises; the off knob
  never fuses; DataFrames keep their column contract;
- ``Pipeline.fit`` and the validators run pipelines on tensors that stay
  on the device, and fit the same models.
"""

import json
import os
import warnings
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLogReg
from spark_rapids_ml_tpu.classification import RandomForestClassifier as JaxRFC
from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.observability.events import validate_record
from spark_rapids_ml_tpu.pipeline import Pipeline as JaxPipeline
from spark_rapids_ml_tpu.pipeline_fusion import fuser as jax_fuser
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinReg
from spark_rapids_ml_tpu.regression import RandomForestRegressor as JaxRFR
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.classification import LogisticRegression, RandomForestClassifier
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.core.data import DataFrame
from spark_rapids_ml_tpu_torch.evaluation import MulticlassClassificationEvaluator
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.observability import events
from spark_rapids_ml_tpu_torch.pipeline import Pipeline, PipelineModel
from spark_rapids_ml_tpu_torch.pipeline_fusion import (
    CompositeSignature,
    FusionFallbackWarning,
    fuse_pipeline_stages,
    fuse_signatures,
    fuser,
)
from spark_rapids_ml_tpu_torch.regression import LinearRegression, RandomForestRegressor
from spark_rapids_ml_tpu_torch.tuning import CrossValidator, ParamGridBuilder, TrainValidationSplit, _device_fold_prep
from spark_rapids_ml_tpu_torch.utils.testing import assert_close
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value
from tests.test_torch_serving_signature import stage_dict

D = 12  # input feature width shared by the chain fixtures


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


@contextmanager
def fusion_off():
    """Force the staged path (the in-test reference for parity checks)."""
    prev = os.environ.get("TPUML_PIPELINE_FUSION")
    os.environ["TPUML_PIPELINE_FUSION"] = "off"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("TPUML_PIPELINE_FUSION", None)
        else:
            os.environ["TPUML_PIPELINE_FUSION"] = prev


@pytest.fixture
def data(rng):
    x = rng.normal(size=(96, D)).astype(np.float64)
    y = (x[:, 0] + x[:, 1] - x[:, 2] > 0).astype(np.int64)
    return x, y


def _chains(pca, kmeans, logreg, linreg, rfc, rfr):
    return {
        "pca-kmeans": lambda: [pca().setK(4), kmeans().setK(3).setSeed(7)],
        "pca-logistic": lambda: [pca().setK(4), logreg().setMaxIter(25)],
        "pca-linreg": lambda: [pca().setK(4), linreg()],
        "pca-rf-classifier": lambda: [pca().setK(4), rfc().setNumTrees(5).setMaxDepth(4).setSeed(3)],
        "pca-rf-regressor": lambda: [pca().setK(4), rfr().setNumTrees(5).setMaxDepth(4).setSeed(3)],
        "pca-pca-kmeans": lambda: [pca().setK(6), pca().setK(3), kmeans().setK(3).setSeed(7)],
    }


CHAINS = _chains(PCA, KMeans, LogisticRegression, LinearRegression, RandomForestClassifier, RandomForestRegressor)
JAX_CHAINS = _chains(JaxPCA, JaxKMeans, JaxLogReg, JaxLinReg, JaxRFC, JaxRFR)
INPUTS = {
    "host": lambda x: x,
    "tensor64": torch.from_numpy,
    "tensor32": lambda x: torch.from_numpy(x.astype(np.float32)),
}


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class TestFusedParity:
    """Fused transform == staged transform, bitwise, per fusable chain."""

    @pytest.mark.parametrize("kind", sorted(INPUTS))
    @pytest.mark.parametrize("chain", sorted(CHAINS), ids=sorted(CHAINS))
    def test_chain_parity(self, chain, kind, data):
        x, y = data
        model = Pipeline(stages=CHAINS[chain]()).fit((x, y))
        xin = INPUTS[kind](x)
        before = counter_value("pipeline.fusion.fused")
        fused = model.transform(xin)
        assert counter_value("pipeline.fusion.fused") == before + 1
        with fusion_off():
            staged = model.transform(xin)
        assert isinstance(fused, torch.Tensor) == (kind != "host")
        np.testing.assert_array_equal(_np(fused), _np(staged))
        assert _np(fused).dtype == _np(staged).dtype
        assert fused.shape[0] == x.shape[0]

    @pytest.mark.parametrize("chain", ["pca-kmeans", "pca-pca-kmeans", "pca-rf-classifier", "pca-rf-regressor",
                                       "pca-logistic", "pca-linreg"])
    def test_carried_reference_pipeline_transforms_as_the_reference(self, chain, data):
        """KMeans and forest draws differ between the packages, so the
        reference's fitted pipeline is carried across: the port's fused
        transform then equals the reference's."""
        x, y = data
        theirs = JaxPipeline(stages=JAX_CHAINS[chain]()).fit((x, y))
        ours = interop.pipeline_model_from_numpy([stage_dict(s) for s in theirs.stages], uid=theirs.uid)
        assert ours.uid == theirs.uid and len(ours.stages) == len(theirs.stages)
        want = np.asarray(theirs.transform(x))
        before = counter_value("pipeline.fusion.fused")
        got = ours.transform(x)
        assert counter_value("pipeline.fusion.fused") == before + 1
        if np.issubdtype(want.dtype, np.integer) or want.dtype == np.float32:
            np.testing.assert_array_equal(got, want)
        else:
            assert_close(chain, got, want, rtol=0, atol=1e-10 * max(1.0, float(np.abs(want).max())))
        np.testing.assert_array_equal(_np(ours.transform(torch.from_numpy(x))), got)

    def test_fused_path_engages(self, data):
        """A plain-array transform fuses, and warns nothing."""
        x, y = data
        model = Pipeline(stages=CHAINS["pca-logistic"]()).fit((x, y))
        before = counter_value("pipeline.fusion.fused")
        fallback = counter_value("pipeline.fusion.fallback")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            model.transform(x)
        assert counter_value("pipeline.fusion.fused") == before + 1
        assert counter_value("pipeline.fusion.fallback") == fallback

    def test_device_array_in_device_array_out(self, data):
        x, y = data
        model = Pipeline(stages=CHAINS["pca-logistic"]()).fit((x, y))
        out = model.transform(torch.from_numpy(x))
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), np.asarray(model.transform(x)))

    def test_serving_signature_is_composite(self, data):
        x, y = data
        model = Pipeline(stages=CHAINS["pca-logistic"]()).fit((x, y))
        sig = model.serving_signature()
        assert isinstance(sig, CompositeSignature)
        assert sig.n_features == D
        assert sig.stage_names == ("pca.transform", "logreg.predict")
        assert sig.name == "fused:pca.transform+logreg.predict"
        assert any(k.startswith("s0_") for k in sig.static)
        assert any(k.startswith("s1_") for k in sig.static)
        theirs = JaxPipeline(stages=JAX_CHAINS["pca-logistic"]()).fit((x, y)).serving_signature()
        assert sorted(sig.static) == sorted(theirs.static)
        spec = sig.output_spec(5, torch.float64)
        real = sig.kernel(torch.from_numpy(x[:5]), *sig.weights, **sig.static)
        assert spec.device.type == "meta"
        assert (tuple(spec.shape), spec.dtype) == (tuple(real.shape), real.dtype)

    def test_composite_kernel_identity_is_stable(self, data):
        """Two signature builds share ONE kernel object, as do two
        pipelines of the same chain shape."""
        x, y = data
        model = Pipeline(stages=CHAINS["pca-logistic"]()).fit((x, y))
        other = Pipeline(stages=CHAINS["pca-logistic"]()).fit((x[:60], y[:60]))
        assert model.serving_signature().kernel is model.serving_signature().kernel
        assert model.serving_signature().kernel is other.serving_signature().kernel
        assert model.serving_signature().kernel.__name__ == "fused_project_kernel__forward_kernel"

    def test_float32_tensor_fit_serves_host_rows_in_float64(self, data):
        """A pipeline fitted on float32 tensors: its logistic stage serves
        tensors at float32 and host rows at float64, and the fused route
        keeps both bit for bit (the signature's ``host_weights``)."""
        x, y = data
        model = Pipeline(stages=CHAINS["pca-logistic"]()).fit(
            (torch.from_numpy(x.astype(np.float32)), torch.from_numpy(y)))
        assert model.stages[1]._w_raw.dtype == torch.float32
        sig = model.serving_signature()
        assert sig.host_weights is not None and sig.host_weights[1][0].dtype == torch.float64
        for xin in (x, x.astype(np.float32), torch.from_numpy(x.astype(np.float32)), torch.from_numpy(x)):
            fused = model.transform(xin)
            with fusion_off():
                staged = model.transform(xin)
            np.testing.assert_array_equal(_np(fused), _np(staged))

    def test_empty_host_input_keeps_the_staged_contract(self, data):
        x, y = data
        for chain in ("pca-logistic", "pca-kmeans", "pca-linreg"):
            model = Pipeline(stages=CHAINS[chain]()).fit((x, y))
            fused = model.transform(x[:0])
            with fusion_off():
                staged = model.transform(x[:0])
            assert fused.shape == staged.shape == (0,) and fused.dtype == staged.dtype, chain

    def test_host_blocks_are_the_staged_routes_blocks(self, data, monkeypatch):
        """Host rows go to the device in the staged routes' blocks: with a
        block of 40 rows, 96 rows are three blocks either way."""
        x, y = data
        model = Pipeline(stages=CHAINS["pca-kmeans"]()).fit((x, y))
        monkeypatch.setenv("TPUML_SERVE_STREAM_BLOCK", "40")
        blocks = counter_value("serving.stream.blocks")
        h2d = counter_value("serving.h2d.bytes")
        fused = model.transform(x)
        assert counter_value("serving.stream.blocks") - blocks == 3
        assert counter_value("serving.h2d.bytes") - h2d == x.nbytes
        with fusion_off():
            staged = model.transform(x)
        assert counter_value("serving.stream.blocks") - blocks == 3 + 6
        np.testing.assert_array_equal(fused, staged)


class TestFallback:
    """Unfusable chains degrade loudly and correctly."""

    class _Opaque:
        """A transformer with no serving_signature()."""

        uid = "opaque-stage"

        def transform(self, x):
            return np.asarray(x) * 1.0

    def test_non_signature_stage_warns_and_matches_staged(self, data):
        x, y = data
        pca = PCA().setK(4).fit(x)
        model = PipelineModel("pm-opaque", [pca, self._Opaque()])
        before = counter_value("pipeline.fusion.fallback")
        with pytest.warns(FusionFallbackWarning) as rec:
            out = np.asarray(model.transform(x))
        assert counter_value("pipeline.fusion.fallback") == before + 1
        w = rec[0].message
        assert w.pipeline == "pm-opaque"
        assert w.stage == 1
        assert "serving_signature" in w.reason
        np.testing.assert_array_equal(out, self._Opaque().transform(pca.transform(x)))

    def test_width_mismatch_warns(self, data):
        x, y = data
        pca = PCA().setK(3).fit(x)  # emits width 3
        lr = LogisticRegression().setMaxIter(5).fit((x[:, :5], y))  # wants 5
        with pytest.warns(FusionFallbackWarning) as rec:
            assert fuse_pipeline_stages([pca, lr], pipeline="pm-width") is None
        assert "width" in rec[0].message.reason
        assert rec[0].message.stage == 0
        with pytest.raises(ValueError, match="emits width 3"):
            fuse_signatures([pca.serving_signature(), lr.serving_signature()])

    def test_non_feeding_stage_warns(self, data):
        x, y = data
        km = KMeans().setK(3).fit(x)
        pca = PCA().setK(1).fit(x[:, :1])
        with pytest.warns(FusionFallbackWarning) as rec:
            assert fuse_pipeline_stages([km, pca], pipeline="pm-labels") is None
        assert "single 2-D feature block" in rec[0].message.reason and rec[0].message.stage == 0
        with pytest.raises(ValueError, match="cannot feed"):
            fuse_signatures([km.serving_signature(), pca.serving_signature()])

    def test_failing_signature_warns(self, data):
        x, _ = data
        model = PipelineModel("pm-unfit", [PCA().setK(4).fit(x), RandomForestRegressor().fit((x[:, :4], x[:, 0]))])
        model.stages[1]._forest = None
        with pytest.warns(FusionFallbackWarning) as rec:
            assert fuse_pipeline_stages(model.stages, pipeline="pm-unfit") is None
        assert "serving_signature() failed" in rec[0].message.reason and rec[0].message.stage == 1

    def test_strict_signature_raises(self, data):
        x, _ = data
        pca = PCA().setK(4).fit(x)
        model = PipelineModel("pm-strict", [pca, self._Opaque()])
        with pytest.raises(TypeError, match="not fusable"):
            model.serving_signature()

    def test_off_knob_never_fuses(self, data, monkeypatch):
        x, y = data
        model = Pipeline(stages=CHAINS["pca-kmeans"]()).fit((x, y))
        monkeypatch.setenv("TPUML_PIPELINE_FUSION", "off")
        before = counter_value("pipeline.fusion.fused")
        model.transform(x)
        assert counter_value("pipeline.fusion.fused") == before

    def test_dataframe_keeps_column_contract(self, rng):
        """DataFrames NEVER take the fused path: each stage appends its
        output column (the Spark contract)."""
        x = rng.normal(size=(40, D))
        df = DataFrame({"features": list(x)})
        model = Pipeline(
            stages=[
                PCA().setK(3).setInputCol("features").setOutputCol("pca"),
                KMeans().setK(3).setFeaturesCol("pca").setSeed(0),
            ]
        ).fit(df)
        before = counter_value("pipeline.fusion.fused")
        out = model.transform(df)
        assert "pca" in out.columns and "prediction" in out.columns
        assert counter_value("pipeline.fusion.fused") == before

    def test_one_stage_and_one_dimensional_inputs_stay_staged(self, data):
        x, y = data
        model = Pipeline(stages=CHAINS["pca-logistic"]()).fit((x, y))
        single = PipelineModel("pm-one", [model.stages[0]])
        before = counter_value("pipeline.fusion.fused")
        np.testing.assert_array_equal(single.transform(x), model.stages[0].transform(x))
        model.transform(torch.from_numpy(x[0]))
        assert counter_value("pipeline.fusion.fused") == before


@pytest.mark.parametrize("name", ["TPUML_PIPELINE_FUSION", "TPUML_PIPELINE_FUSION_FIT"])
@pytest.mark.parametrize("value", [None, "auto", "off", " OFF ", "on"])
def test_fusion_knobs_read_like_the_reference(monkeypatch, name, value):
    if value is not None:
        monkeypatch.setenv(name, value)
    reader = "fusion_mode" if name == "TPUML_PIPELINE_FUSION" else "fusion_fit_enabled"

    def outcome(fn):
        try:
            return ("ok", fn())
        except Exception as exc:  # noqa: BLE001 - the comparison is the point
            return (type(exc).__name__, str(exc))

    assert outcome(getattr(fuser, reader)) == outcome(getattr(jax_fuser, reader))


def test_fusion_records_validate(data, tmp_path):
    x, y = data
    log = tmp_path / "events.jsonl"
    events.configure(str(log))
    try:
        model = Pipeline(stages=CHAINS["pca-logistic"]()).fit((x, y))
        model.transform(x)
        with pytest.warns(FusionFallbackWarning):
            PipelineModel("pm-opaque", [model.stages[0], TestFallback._Opaque()]).transform(x)
    finally:
        events.configure("")
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    actions = [r["action"] for r in recs if r["event"] == "pipeline_fusion"]
    assert actions == ["fit_device_ingest", "fused", "fallback"]
    for rec in recs:
        assert validate_record(rec) == []
        assert events.SCHEMA[rec["event"]] <= set(rec)


class TestFitFusion:
    """Fit-side fusion: datasets on the device through whole pipelines."""

    def test_fit_device_ingest_matches_host_fit(self, data, monkeypatch):
        x, y = data
        pipe = Pipeline(stages=[PCA().setK(4), LogisticRegression().setMaxIter(25)])
        fused_model = pipe.fit((x, y))
        monkeypatch.setenv("TPUML_PIPELINE_FUSION_FIT", "off")
        host_model = pipe.fit((x, y))
        with fusion_off():
            np.testing.assert_array_equal(
                np.asarray(fused_model.transform(x)),
                np.asarray(host_model.transform(x)),
            )

    def test_device_ingest_places_once_in_its_own_dtype(self, data):
        x, y = data
        pipe = Pipeline(stages=[PCA().setK(4), LogisticRegression()])
        xs, ys = pipe._device_ingest((x.astype(np.float32), y))
        assert isinstance(xs, torch.Tensor) and xs.dtype == torch.float32 and ys.dtype == torch.int64
        assert isinstance(pipe._device_ingest(x), torch.Tensor)
        df = DataFrame({"features": list(x)})
        assert pipe._device_ingest(df) is df
        xt = torch.from_numpy(x)
        assert pipe._device_ingest(xt) is xt

    @pytest.mark.parametrize("chain,tol", [("pca-logistic", 1e-7), ("pca-linreg", 1e-10)])
    def test_pipeline_fit_matches_the_reference(self, chain, tol, data):
        x, y = data
        ours = Pipeline(stages=CHAINS[chain]()).fit((x, y))
        theirs = JaxPipeline(stages=JAX_CHAINS[chain]()).fit((x, y))
        assert_close("pc", ours.stages[0].pc, np.asarray(theirs.stages[0].pc), rtol=0, atol=1e-8)
        if chain == "pca-logistic":
            assert ours.stages[1].numIter == theirs.stages[1].numIter
            want = np.asarray(theirs.stages[1].weights)
            assert_close("weights", ours.stages[1].weights, want, rtol=0, atol=tol * np.abs(want).max())
        else:
            want = np.asarray(theirs.stages[1].coefficients)
            assert_close("coefficients", ours.stages[1].coefficients, want, rtol=0, atol=tol * np.abs(want).max())

    def test_pipeline_is_device_foldable(self, data):
        x, y = data
        pipe = Pipeline(stages=[PCA().setK(3), LogisticRegression()])
        assert pipe._device_foldable
        prep = _device_fold_prep((x, y), pipe)
        assert prep is not None
        xs, ys = prep.slice(np.arange(16))
        assert isinstance(xs, torch.Tensor) and isinstance(ys, torch.Tensor)
        np.testing.assert_array_equal(xs.numpy(), x[:16])

    def test_opaque_stage_disables_device_folds(self, data):
        x, y = data
        pipe = Pipeline(stages=[TestFallback._Opaque(), LogisticRegression()])
        assert not pipe._device_foldable
        assert _device_fold_prep((x, y), pipe) is None
        assert not Pipeline()._device_foldable

    def test_cv_over_pipeline_with_inner_grid(self, data):
        """CrossValidator tunes params of INNER pipeline stages on folds
        that stay on the device; Pipeline.copy routes each grid entry to
        the stage that owns it."""
        x, y = data
        pca = PCA().setK(4)
        lr = LogisticRegression().setMaxIter(20)
        pipe = Pipeline(stages=[pca, lr])
        grid = (
            ParamGridBuilder()
            .addGrid(pca.k, [3, 4])
            .addGrid(lr.regParam, [0.0, 0.1])
            .build()
        )
        cvm = (
            CrossValidator()
            .setEstimator(pipe)
            .setEstimatorParamMaps(grid)
            .setEvaluator(MulticlassClassificationEvaluator())
            .setNumFolds(3)
            .fit((x, y))
        )
        assert len(cvm.avgMetrics) == 4
        assert all(np.isfinite(m) for m in cvm.avgMetrics)
        best = cvm.bestModel
        assert isinstance(best, PipelineModel)
        assert best.stages[0].getK() in (3, 4)
        preds = np.asarray(best.transform(x))
        assert (preds == y).mean() > 0.6

    def test_tvs_over_pipeline_with_inner_grid(self, data):
        x, y = data
        pca = PCA().setK(4)
        pipe = Pipeline(stages=[pca, LogisticRegression().setMaxIter(20)])
        grid = ParamGridBuilder().addGrid(pca.k, [2, 4]).build()
        tvm = (
            TrainValidationSplit()
            .setEstimator(pipe)
            .setEstimatorParamMaps(grid)
            .setEvaluator(MulticlassClassificationEvaluator())
            .setTrainRatio(0.75)
            .fit((x, y))
        )
        assert len(tvm.validationMetrics) == 2
        assert isinstance(tvm.bestModel, PipelineModel)

    def test_pipeline_copy_routes_inner_extra(self):
        pca = PCA().setK(4)
        lr = LogisticRegression().setMaxIter(20)
        pipe = Pipeline(stages=[pca, lr])
        clone = pipe.copy({pca.k: 2, lr.regParam: 0.5})
        assert clone.stages[0].getK() == 2
        assert clone.stages[1].getRegParam() == 0.5
        # Originals untouched; stage objects are copies, not aliases.
        assert pca.getK() == 4 and lr.getRegParam() == 0.0
        assert clone.stages[0] is not pca
        assert clone.uid == pipe.uid

    def test_pipeline_model_copy_keeps_stages(self, data):
        x, y = data
        model = Pipeline(stages=CHAINS["pca-kmeans"]()).fit((x, y))
        clone = model.copy()
        assert len(clone.stages) == 2
        np.testing.assert_array_equal(
            np.asarray(clone.transform(x)), np.asarray(model.transform(x))
        )


class TestFuserUnit:
    def test_fuse_empty_chain_warns_none(self):
        with pytest.warns(FusionFallbackWarning):
            assert fuse_pipeline_stages([], pipeline="empty") is None
        with pytest.raises(ValueError, match="empty"):
            fuse_signatures([])

    def test_static_prefix_roundtrip(self):
        from spark_rapids_ml_tpu_torch.pipeline_fusion.fuser import _demux_static

        static = {"s0_precision": "f32", "s1_n_classes": 3, "s1_threshold": 0.5}
        per = _demux_static(static, 2)
        assert per == [{"precision": "f32"}, {"n_classes": 3, "threshold": 0.5}]
        assert per == jax_fuser._demux_static(static, 2)


class TestServingIntegration:
    """A fused pipeline is one versioned servable (the reference's
    ``TestServingIntegration``; its load-by-path case is
    ``tests/test_torch_serving_runtime.py``'s)."""

    def test_register_warm_submit(self, data):
        from spark_rapids_ml_tpu_torch.serving import ServingRuntime

        x, y = data
        model = Pipeline(stages=CHAINS["pca-logistic"]()).fit((x, y))
        rt = ServingRuntime()
        try:
            mv = rt.register("pipe", model, alias="prod", warm_buckets=(8, 32))
            assert isinstance(mv.signature, CompositeSignature)
            out = rt.submit("pipe@prod", x[:20]).result(timeout=60)
            assert np.asarray(out).tobytes() == np.asarray(model.transform(x[:20])).tobytes()
        finally:
            rt.close()

    def test_hot_swap_fused_pipeline_version_pure(self, data):
        """Swap prod from fused v1 to fused v2 under threaded load: every
        answer is bitwise v1's or v2's, and the loadgen's freshness table,
        reading the port's futures, shows v2 serving, first seen no
        earlier than v1."""
        import threading

        from tools.tpuml_loadgen import FreshnessTable

        from spark_rapids_ml_tpu_torch.serving import ServingRuntime

        x, y = data
        m1 = Pipeline(stages=[PCA().setK(4), KMeans().setK(3).setSeed(7)]).fit((x, y))
        m2 = Pipeline(stages=[PCA().setK(5), KMeans().setK(4).setSeed(11)]).fit((x, y))
        exp1, exp2 = np.asarray(m1.transform(x)), np.asarray(m2.transform(x))
        rt = ServingRuntime(max_batch=16, max_delay_ms=2.0)
        fresh, collected, lock = FreshnessTable(), [], threading.Lock()
        try:
            v1 = rt.register("pipe", m1, alias="prod")

            def worker(tid):
                local = []
                for j in range(20):
                    i = (tid * 20 + j) % x.shape[0]
                    fut = rt.submit("pipe@prod", x[i])
                    local.append((i, np.asarray(fut.result(timeout=60))))
                    fresh.note(fut)
                with lock:
                    collected.extend(local)

            threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
            for t in threads:
                t.start()
            v2 = rt.register("pipe", m2)
            rt.set_alias("pipe", "prod", v2.version)
            for t in threads:
                t.join(timeout=120)
        finally:
            rt.close()
        assert len(collected) == 80
        for i, out in collected:
            assert out.tobytes() in (exp1[i:i + 1].tobytes(), exp2[i:i + 1].tobytes()), i
        report = {r["version"]: r for r in fresh.report()}
        assert v2.version in report, "swap target never served"
        if v1.version in report:  # v1 may drain before any completion lands
            assert report[v1.version]["first_seen_s"] <= report[v2.version]["first_seen_s"]
