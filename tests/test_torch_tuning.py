"""The port's ``tuning.py`` against the JAX package's.

The reference's ``tests/test_tuning.py`` cases on the port, then the two
packages side by side on the same seeded rows: ``CrossValidator`` and
``TrainValidationSplit`` over a single family and over a PCA→logistic
pipeline make the same folds (``numpy.random.default_rng(seed)
.permutation``), give ``avgMetrics`` / ``validationMetrics`` within
1e-10 and the same ``bestIndex``; the helpers take tensors and keep them
on their device; validator models saved by either package load in the
other and predict the same, and a Spark-written ``CrossValidatorModel``
loads in the port.
"""

import json
import os

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import tuning as jax_tuning
from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLogReg
from spark_rapids_ml_tpu.evaluation import BinaryClassificationEvaluator as JaxBinary
from spark_rapids_ml_tpu.evaluation import MulticlassClassificationEvaluator as JaxMulticlass
from spark_rapids_ml_tpu.evaluation import RegressionEvaluator as JaxRegression
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.pipeline import Pipeline as JaxPipeline
from spark_rapids_ml_tpu.regression import LinearRegression as JaxLinReg
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.classification import LogisticRegression, RandomForestClassifier
from spark_rapids_ml_tpu_torch.core.data import DataFrame
from spark_rapids_ml_tpu_torch.evaluation import (
    BinaryClassificationEvaluator,
    MulticlassClassificationEvaluator,
    RegressionEvaluator,
)
from spark_rapids_ml_tpu_torch.feature import PCA
from spark_rapids_ml_tpu_torch.pipeline import Pipeline, PipelineModel
from spark_rapids_ml_tpu_torch.regression import LinearRegression, LinearRegressionModel
from spark_rapids_ml_tpu_torch.tuning import (
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
    _device_fold_prep,
    _DeviceFolds,
    _eval_dataset,
    _num_rows,
    _slice_dataset,
)
from spark_rapids_ml_tpu_torch.utils.testing import assert_close
from spark_rapids_ml_tpu_torch.utils.tracing import counter_value
from tests.test_torch_serving_signature import stage_dict

TOL = 1e-10


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _ridge_data(rng, n=120, d=5):
    x = rng.normal(size=(n, d))
    beta = np.arange(1, d + 1, dtype=float)
    y = x @ beta + 0.1 * rng.normal(size=n)
    return x, y


def _class_data(seed=3, n=150, d=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.8 * rng.normal(size=n) > 0).astype(np.int64)
    return x, y


def _close_list(got, want, tol=TOL):
    assert len(got) == len(want)
    assert_close("metrics", np.asarray(got), np.asarray(want), rtol=0, atol=tol)


class TestParamGridBuilder:
    def test_cartesian_product(self):
        lr = LinearRegression()
        grid = (
            ParamGridBuilder()
            .addGrid(lr.regParam, [0.0, 0.1, 1.0])
            .addGrid(lr.fitIntercept, [True, False])
            .build()
        )
        assert len(grid) == 6
        assert {pm[lr.regParam] for pm in grid} == {0.0, 0.1, 1.0}
        jlr = JaxLinReg()
        theirs = (jax_tuning.ParamGridBuilder().addGrid(jlr.regParam, [0.0, 0.1, 1.0])
                  .addGrid(jlr.fitIntercept, [True, False]).build())
        assert [sorted((p.name, v) for p, v in m.items()) for m in grid] == [
            sorted((p.name, v) for p, v in m.items()) for m in theirs]

    def test_base_on(self):
        lr = LinearRegression()
        grid = (
            ParamGridBuilder()
            .baseOn({lr.fitIntercept: False})
            .addGrid(lr.regParam, [0.0, 0.5])
            .build()
        )
        assert len(grid) == 2
        assert all(pm[lr.fitIntercept] is False for pm in grid)
        assert len(ParamGridBuilder().baseOn((lr.regParam, 0.3)).build()) == 1


class TestCrossValidator:
    def test_selects_low_regularization(self, rng):
        x, y = _ridge_data(rng)
        lr = LinearRegression()
        grid = ParamGridBuilder().addGrid(lr.regParam, [0.0, 100.0]).build()
        cv = (
            CrossValidator()
            .setEstimator(lr)
            .setEstimatorParamMaps(grid)
            .setEvaluator(RegressionEvaluator())
            .setNumFolds(3)
            .setSeed(0)
        )
        model = cv.fit((x, y))
        assert model.bestIndex == 0
        assert len(model.avgMetrics) == 2
        assert model.avgMetrics[0] < model.avgMetrics[1]
        preds = model.transform(x)
        assert np.sqrt(np.mean((preds - y) ** 2)) < 0.2
        assert model.getEstimator() is lr and model.getEvaluator() is cv.getEvaluator()
        assert model.getEstimatorParamMaps() == grid and model.getSeed() == 0

    def test_classifier_grid_dataframe(self, rng):
        x = rng.normal(size=(150, 4))
        y = (x[:, 0] + x[:, 1] > 0).astype(float)
        df = DataFrame({"features": list(x), "label": list(y)})
        rf = RandomForestClassifier().setNumTrees(5)
        grid = ParamGridBuilder().addGrid(rf.maxDepth, [1, 4]).build()
        cv = (
            CrossValidator()
            .setEstimator(rf)
            .setEstimatorParamMaps(grid)
            .setEvaluator(MulticlassClassificationEvaluator())
            .setNumFolds(3)
            .setSeed(1)
        )
        model = cv.fit(df)
        # Depth 4 beats a decision stump on a 2-feature interaction.
        assert model.bestIndex == 1
        out = model.transform(df)
        acc = np.mean(np.asarray(out.select("prediction")) == y)
        assert acc > 0.9

    @pytest.mark.parametrize("kind", ["host", "tensor"])
    def test_single_family_matches_the_reference(self, kind, rng):
        x, y = _ridge_data(rng)
        lr, jlr = LinearRegression(), JaxLinReg()
        grid = ParamGridBuilder().addGrid(lr.regParam, [0.0, 1.0, 30.0]).build()
        jgrid = jax_tuning.ParamGridBuilder().addGrid(jlr.regParam, [0.0, 1.0, 30.0]).build()
        data = (x, y) if kind == "host" else (torch.from_numpy(x), torch.from_numpy(y))
        ours = (CrossValidator().setEstimator(lr).setEstimatorParamMaps(grid).setEvaluator(RegressionEvaluator())
                .setNumFolds(4).setSeed(5).fit(data))
        theirs = (jax_tuning.CrossValidator().setEstimator(jlr).setEstimatorParamMaps(jgrid)
                  .setEvaluator(JaxRegression()).setNumFolds(4).setSeed(5).fit((x, y)))
        _close_list(ours.avgMetrics, theirs.avgMetrics)
        assert ours.bestIndex == theirs.bestIndex
        want = np.asarray(theirs.bestModel.coefficients)
        assert_close("best", ours.bestModel.coefficients, want, rtol=0, atol=TOL * np.abs(want).max())

    def test_pipeline_matches_the_reference(self):
        x, y = _class_data()
        pca, lr = PCA().setK(4), LogisticRegression().setMaxIter(20).setTol(0.0)
        jpca, jlr = JaxPCA().setK(4), JaxLogReg().setMaxIter(20).setTol(0.0)
        grid = ParamGridBuilder().addGrid(lr.regParam, [0.001, 0.01, 0.1]).build()
        jgrid = jax_tuning.ParamGridBuilder().addGrid(jlr.regParam, [0.001, 0.01, 0.1]).build()
        ours = (CrossValidator().setEstimator(Pipeline(stages=[pca, lr])).setEstimatorParamMaps(grid)
                .setEvaluator(MulticlassClassificationEvaluator().setMetricName("accuracy")).setNumFolds(3)
                .fit((x, y)))
        theirs = (jax_tuning.CrossValidator().setEstimator(JaxPipeline(stages=[jpca, jlr]))
                  .setEstimatorParamMaps(jgrid).setEvaluator(JaxMulticlass().setMetricName("accuracy"))
                  .setNumFolds(3).fit((x, y)))
        _close_list(ours.avgMetrics, theirs.avgMetrics)
        assert ours.bestIndex == theirs.bestIndex
        assert isinstance(ours.bestModel, PipelineModel)
        np.testing.assert_array_equal(ours.transform(x), np.asarray(theirs.transform(x)))

    def test_device_folds_keep_a_tensor_dataset(self, rng):
        x, y = _ridge_data(rng)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        lr = LinearRegression()
        before = counter_value("tuning.device_folds")
        model = (CrossValidator().setEstimator(lr).setEstimatorParamMaps([{}])
                 .setEvaluator(RegressionEvaluator()).fit((xt, yt)))
        assert counter_value("tuning.device_folds") == before + 1
        assert isinstance(model.bestModel._coef_raw, torch.Tensor)
        prep = _device_fold_prep((xt, yt), lr)
        assert prep.full()[0] is xt and prep.full()[1] is yt

    def test_model_persistence_roundtrip(self, tmp_path, rng):
        x, y = _ridge_data(rng)
        lr = LinearRegression()
        grid = ParamGridBuilder().addGrid(lr.regParam, [0.0, 1.0]).build()
        model = (
            CrossValidator()
            .setEstimator(lr)
            .setEstimatorParamMaps(grid)
            .setEvaluator(RegressionEvaluator())
            .setSeed(0)
            .fit((x, y))
        )
        path = str(tmp_path / "cvm")
        model.save(path)
        loaded = CrossValidatorModel.load(path)
        assert loaded.bestIndex == model.bestIndex
        np.testing.assert_allclose(loaded.avgMetrics, model.avgMetrics)
        np.testing.assert_allclose(loaded.transform(x), model.transform(x), atol=1e-10)
        with pytest.raises(ValueError, match="no bestModel"):
            CrossValidatorModel().save(str(tmp_path / "empty"))

    def test_binary_evaluator_gets_scores_not_labels(self, rng):
        """AUC on a tuple dataset must rank by continuous probabilities."""
        x = rng.normal(size=(200, 4))
        y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=200) > 0).astype(float)
        model = LogisticRegression().setMaxIter(50).fit((x, y))
        ev = BinaryClassificationEvaluator()
        y_out, scores = _eval_dataset(model, (x, y), ev)
        assert len(np.unique(scores)) > 10
        np.testing.assert_array_equal(y_out, y)
        auc_scores = ev.evaluate((y_out, scores))
        auc_labels = ev.evaluate((y, model.predict(x).astype(float)))
        assert auc_scores >= auc_labels
        assert auc_scores > 0.9
        # A tensor's scores stay on its device.
        yt, st = _eval_dataset(model, (torch.from_numpy(x), torch.from_numpy(y)), ev)
        assert isinstance(st, torch.Tensor) and st.dim() == 1
        np.testing.assert_array_equal(st.numpy(), scores)

    def test_binary_evaluator_rejects_scoreless_model(self, rng):
        x, y = _ridge_data(rng)
        model = LinearRegression().fit((x, y))
        with pytest.raises(TypeError, match="predictProbability"):
            _eval_dataset(model, (x, y), BinaryClassificationEvaluator())
        pm = Pipeline(stages=[PCA().setK(2), LinearRegression()]).fit((x, y))
        with pytest.raises(TypeError, match="PipelineModel exposes no predictProbability"):
            _eval_dataset(pm, (x, y), BinaryClassificationEvaluator())

    def test_copy_preserves_mesh(self):
        assert PCA(mesh="sentinel-mesh").copy({}).mesh == "sentinel-mesh"

    def test_validation_errors(self):
        cv = CrossValidator()
        with pytest.raises(ValueError, match="must be set"):
            cv.fit((np.zeros((10, 2)), np.zeros(10)))
        with pytest.raises(ValueError, match="numFolds must be >= 2"):
            CrossValidator().setNumFolds(1)
        lr = LinearRegression()
        cv = (
            CrossValidator()
            .setEstimator(lr)
            .setEstimatorParamMaps([{}])
            .setEvaluator(RegressionEvaluator())
            .setNumFolds(5)
        )
        with pytest.raises(ValueError, match="exceeds number of rows"):
            cv.fit((np.zeros((3, 2)), np.zeros(3)))
        with pytest.raises(ValueError, match="non-empty"):
            CrossValidator().setEstimator(lr).setEvaluator(RegressionEvaluator()).fit((np.zeros((3, 2)), np.zeros(3)))


class TestTrainValidationSplit:
    def test_selects_best(self, rng):
        x, y = _ridge_data(rng)
        lr = LinearRegression()
        grid = ParamGridBuilder().addGrid(lr.regParam, [0.0, 100.0]).build()
        tvs = (
            TrainValidationSplit()
            .setEstimator(lr)
            .setEstimatorParamMaps(grid)
            .setEvaluator(RegressionEvaluator())
            .setTrainRatio(0.7)
            .setSeed(2)
        )
        model = tvs.fit((x, y))
        assert model.bestIndex == 0
        assert len(model.validationMetrics) == 2
        assert model.getOrDefault(model.trainRatio) == 0.7

    def test_ratio_validation(self):
        with pytest.raises(ValueError):
            TrainValidationSplit().setTrainRatio(1.0)
        with pytest.raises(ValueError):
            TrainValidationSplit().setTrainRatio(0.0)
        tvs = (TrainValidationSplit().setEstimator(LinearRegression()).setEstimatorParamMaps([{}])
               .setEvaluator(RegressionEvaluator()).setTrainRatio(0.9))
        with pytest.raises(ValueError, match="empty split"):
            tvs.fit((np.zeros((3, 2)), np.zeros(3)))

    @pytest.mark.parametrize("kind", ["host", "tensor"])
    def test_single_family_binary_auc_matches_the_reference(self, kind):
        x, y = _class_data(seed=4, n=200)
        lr, jlr = LogisticRegression().setMaxIter(20).setTol(0.0), JaxLogReg().setMaxIter(20).setTol(0.0)
        grid = ParamGridBuilder().addGrid(lr.regParam, [0.001, 0.01, 0.1]).build()
        jgrid = jax_tuning.ParamGridBuilder().addGrid(jlr.regParam, [0.001, 0.01, 0.1]).build()
        data = (x, y) if kind == "host" else (torch.from_numpy(x), torch.from_numpy(y))
        ours = (TrainValidationSplit().setEstimator(lr).setEstimatorParamMaps(grid)
                .setEvaluator(BinaryClassificationEvaluator()).setTrainRatio(0.75).fit(data))
        theirs = (jax_tuning.TrainValidationSplit().setEstimator(jlr).setEstimatorParamMaps(jgrid)
                  .setEvaluator(JaxBinary()).setTrainRatio(0.75).fit((x, y)))
        _close_list(ours.validationMetrics, theirs.validationMetrics)
        assert ours.bestIndex == theirs.bestIndex

    def test_pipeline_matches_the_reference(self):
        x, y = _class_data(seed=6)
        pca, lr = PCA().setK(3), LogisticRegression().setMaxIter(20).setTol(0.0)
        jpca, jlr = JaxPCA().setK(3), JaxLogReg().setMaxIter(20).setTol(0.0)
        grid = ParamGridBuilder().addGrid(pca.k, [2, 3, 5]).build()
        jgrid = jax_tuning.ParamGridBuilder().addGrid(jpca.k, [2, 3, 5]).build()
        ours = (TrainValidationSplit().setEstimator(Pipeline(stages=[pca, lr])).setEstimatorParamMaps(grid)
                .setEvaluator(MulticlassClassificationEvaluator()).setSeed(9).fit((x, y)))
        theirs = (jax_tuning.TrainValidationSplit().setEstimator(JaxPipeline(stages=[jpca, jlr]))
                  .setEstimatorParamMaps(jgrid).setEvaluator(JaxMulticlass()).setSeed(9).fit((x, y)))
        _close_list(ours.validationMetrics, theirs.validationMetrics)
        assert ours.bestIndex == theirs.bestIndex


class TestHelpers:
    def test_same_folds_as_the_reference(self, rng):
        x, y = _ridge_data(rng, n=50)
        idx = np.sort(np.random.default_rng(3).permutation(50)[:20])
        ours = _device_fold_prep((x, y), LinearRegression())
        theirs = jax_tuning._device_fold_prep((x, y), JaxLinReg())
        for got, want in zip(ours.slice(idx), theirs.slice(idx)):
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(_slice_dataset((x, y), idx), jax_tuning._slice_dataset((x, y), idx)):
            np.testing.assert_array_equal(got, want)

    def test_tensors_are_counted_and_sliced_on_their_device(self, rng):
        x, y = _ridge_data(rng, n=30)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        assert _num_rows((xt, yt)) == _num_rows((x, y)) == jax_tuning._num_rows((x, y)) == 30
        assert _num_rows(xt) == 30
        idx = np.array([0, 4, 29])
        xs, ys = _slice_dataset((xt, yt), idx)
        assert isinstance(xs, torch.Tensor) and isinstance(ys, torch.Tensor)
        np.testing.assert_array_equal(xs.numpy(), x[idx])
        np.testing.assert_array_equal(_slice_dataset(xt, idx).numpy(), x[idx])
        df = DataFrame({"features": list(x), "label": list(y)})
        assert _num_rows(df) == 30 and _slice_dataset(df, idx).count() == 3

    def test_device_fold_prep_refuses_what_it_cannot_place(self, rng):
        x, y = _ridge_data(rng, n=30)
        lr = LinearRegression()
        assert _device_fold_prep((x, y[:10]), lr) is None
        assert _device_fold_prep((x.astype(object), y), lr) is None
        assert _device_fold_prep([x], lr) is None
        assert _device_fold_prep((x, y), object()) is None
        prep = _device_fold_prep(x, PCA())
        assert isinstance(prep, _DeviceFolds) and prep.y is None
        assert isinstance(prep.slice(np.arange(3)), torch.Tensor)
        assert _device_fold_prep((x, y[:, None]), lr).y.dim() == 1


class TestPersistenceBothWays:
    @pytest.mark.parametrize("validator", ["cv", "tvs"])
    def test_reference_validator_model_loads_in_the_port(self, validator, tmp_path):
        x, y = _class_data()
        jpca, jlr = JaxPCA().setK(3), JaxLogReg().setMaxIter(15)
        grid = jax_tuning.ParamGridBuilder().addGrid(jlr.regParam, [0.0, 0.1]).build()
        klass = jax_tuning.CrossValidator if validator == "cv" else jax_tuning.TrainValidationSplit
        theirs = (klass().setEstimator(JaxPipeline(stages=[jpca, jlr])).setEstimatorParamMaps(grid)
                  .setEvaluator(JaxMulticlass()).fit((x, y)))
        path = str(tmp_path / validator)
        theirs.save(path)
        ours = (CrossValidatorModel if validator == "cv" else TrainValidationSplitModel).load(path)
        assert ours.uid == theirs.uid and ours.bestIndex == theirs.bestIndex
        metrics = "avgMetrics" if validator == "cv" else "validationMetrics"
        assert getattr(ours, metrics) == list(getattr(theirs, metrics))
        assert isinstance(ours.bestModel, PipelineModel)
        np.testing.assert_array_equal(ours.transform(x), np.asarray(theirs.transform(x)))

    @pytest.mark.parametrize("validator", ["cv", "tvs"])
    def test_port_validator_model_loads_in_the_reference(self, validator, tmp_path):
        x, y = _class_data()
        pca, lr = PCA().setK(3), LogisticRegression().setMaxIter(15)
        grid = ParamGridBuilder().addGrid(lr.regParam, [0.0, 0.1]).build()
        klass = CrossValidator if validator == "cv" else TrainValidationSplit
        ours = (klass().setEstimator(Pipeline(stages=[pca, lr])).setEstimatorParamMaps(grid)
                .setEvaluator(MulticlassClassificationEvaluator()).fit((x, y)))
        path = str(tmp_path / validator)
        ours.save(path)
        with open(os.path.join(path, "metadata", "part-00000")) as f:
            assert json.loads(f.readline())["bestModelClass"] == "spark_rapids_ml_tpu.pipeline.PipelineModel"
        jklass = jax_tuning.CrossValidatorModel if validator == "cv" else jax_tuning.TrainValidationSplitModel
        theirs = jklass.load(path)
        assert theirs.bestIndex == ours.bestIndex
        np.testing.assert_array_equal(np.asarray(theirs.transform(x)), ours.transform(x))

    def test_spark_written_cross_validator_model_loads(self, tmp_path, rng):
        """The golden directory of ``tests/test_golden_spark.py``: avgMetrics
        top-level, the winner bare under bestModel/ with only its JVM class."""
        pa = pytest.importorskip("pyarrow")
        from tests.test_golden_spark import (
            _SPARK_MATRIX,
            _SPARK_VECTOR,
            _matrix_struct,
            _vector_struct,
            _write_spark_metadata,
            _write_spark_parquet,
        )

        coef = rng.normal(size=4)
        path = str(tmp_path / "spark_cv")
        os.makedirs(path)
        _write_spark_metadata(path, "org.apache.spark.ml.tuning.CrossValidatorModel",
                              "CrossValidatorModel_golden", {"numFolds": 3})
        meta_file = os.path.join(path, "metadata", "part-00000")
        with open(meta_file) as f:
            meta = json.loads(f.readline())
        meta["avgMetrics"] = [0.81, 0.93, 0.77]
        meta["bestIndex"] = 1
        with open(meta_file, "w") as f:
            f.write(json.dumps(meta) + "\n")
        best = os.path.join(path, "bestModel")
        os.makedirs(best)
        _write_spark_metadata(best, "org.apache.spark.ml.classification.LogisticRegressionModel",
                              "LogisticRegressionModel_best", {"threshold": 0.5})
        schema = pa.schema([("numClasses", pa.int32()), ("numFeatures", pa.int32()),
                            ("interceptVector", _SPARK_VECTOR), ("coefficientMatrix", _SPARK_MATRIX),
                            ("isMultinomial", pa.bool_())])
        _write_spark_parquet(best, schema, [{
            "numClasses": 2, "numFeatures": 4, "interceptVector": _vector_struct([0.25]),
            "coefficientMatrix": _matrix_struct(coef[None, :]), "isMultinomial": False,
        }], "{}")
        model = CrossValidatorModel.load(path)
        assert model.avgMetrics == [0.81, 0.93, 0.77] and model.bestIndex == 1
        x = rng.normal(size=(6, 4))
        p1 = 1.0 / (1.0 + np.exp(-(x @ coef + 0.25)))
        assert_close("probabilities", model.bestModel.predictProbability(x)[:, 1], p1, rtol=0, atol=1e-12)

    def test_interop_wraps_a_carried_best_model(self):
        x, y = _class_data()
        jlr = JaxLogReg().setMaxIter(15)
        grid = jax_tuning.ParamGridBuilder().addGrid(jlr.regParam, [0.0, 0.1]).build()
        theirs = (jax_tuning.CrossValidator().setEstimator(jlr).setEstimatorParamMaps(grid)
                  .setEvaluator(JaxMulticlass()).setSeed(4).fit((x, y)))
        best = interop.pipeline_model_from_numpy([stage_dict(theirs.bestModel)]).stages[0]
        params = {p.name: v for p, v in theirs.extractParamMap().items()}
        ours = interop.cross_validator_model_from_numpy(best, theirs.avgMetrics, theirs.bestIndex,
                                                        uid=theirs.uid, params=params)
        assert ours.uid == theirs.uid and ours.getSeed() == 4 and ours.avgMetrics == list(theirs.avgMetrics)
        np.testing.assert_array_equal(ours.transform(x), np.asarray(theirs.transform(x)))
        tvs = interop.train_validation_split_model_from_numpy(best, [0.5, 0.75], 1)
        assert tvs.validationMetrics == [0.5, 0.75] and tvs.bestIndex == 1
        assert isinstance(tvs.bestModel, type(best)) and not isinstance(best, LinearRegressionModel)
