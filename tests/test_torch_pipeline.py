"""The port's ``pipeline.py`` and its persistence against the JAX package.

The reference's ``tests/test_pipeline.py`` cases on the port (sequential
composition, transformer stages, saves of fitted and unfitted pipelines,
the class-path gate and its escape hatch, with the reference's messages),
then persistence both ways: a ``Pipeline`` and a ``PipelineModel`` saved
by either package load in the other and predict the same (labels exact,
real values 1e-10), and the Spark-written composite directories of
``tests/test_golden_spark.py`` load in the port.
"""

import json
import os

import numpy as np
import pytest

from spark_rapids_ml_tpu.classification import LogisticRegression as JaxLogReg
from spark_rapids_ml_tpu.clustering import KMeans as JaxKMeans
from spark_rapids_ml_tpu.feature import PCA as JaxPCA
from spark_rapids_ml_tpu.pipeline import Pipeline as JaxPipeline
from spark_rapids_ml_tpu.pipeline import PipelineModel as JaxPipelineModel
from spark_rapids_ml_tpu.regression import RandomForestRegressor as JaxRFR
from spark_rapids_ml_tpu_torch import device as port_device
from spark_rapids_ml_tpu_torch import interop
from spark_rapids_ml_tpu_torch.classification import LogisticRegression
from spark_rapids_ml_tpu_torch.clustering import KMeans
from spark_rapids_ml_tpu_torch.core.data import DataFrame
from spark_rapids_ml_tpu_torch.core.persistence import (
    _LOADABLE_PACKAGES,
    _SPARK_CLASS_ALIASES,
    allow_persisted_package,
    persisted_class_path,
    resolve_component_class,
    resolve_persisted_class,
)
from spark_rapids_ml_tpu_torch.feature import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegressionModel
from spark_rapids_ml_tpu_torch.pipeline import Pipeline, PipelineModel
from spark_rapids_ml_tpu_torch.regression import LinearRegression, RandomForestRegressionModel
from spark_rapids_ml_tpu_torch.utils.testing import assert_close
from tests.test_torch_serving_signature import stage_dict

pa = pytest.importorskip("pyarrow")


@pytest.fixture(autouse=True)
def cpu_platform():
    port_device.set_platform("cpu")
    yield
    port_device.set_platform("cuda")


def _clustered_data(rng, n_per=40, d=8):
    centers = np.zeros((3, d))
    centers[0, 0] = 10
    centers[1, 1] = 10
    centers[2, 2] = 10
    x = np.concatenate([rng.normal(size=(n_per, d)) + c for c in centers])
    return x, np.repeat(np.arange(3), n_per)


def _meta(path):
    with open(os.path.join(path, "metadata", "part-00000")) as f:
        return json.loads(f.readline())


class TestPipeline:
    def test_pca_then_kmeans(self, rng):
        x, labels = _clustered_data(rng)
        df = DataFrame({"features": list(x)})
        pipe = Pipeline(
            stages=[
                PCA().setK(3).setInputCol("features").setOutputCol("pca"),
                KMeans().setK(3).setFeaturesCol("pca").setSeed(0),
            ]
        )
        model = pipe.fit(df)
        assert isinstance(model, PipelineModel)
        assert len(model.stages) == 2
        out = model.transform(df)
        assert "pca" in out.columns and "prediction" in out.columns
        preds = np.asarray(out.select("prediction"))
        # Clustering in PCA space must recover the 3 blobs (up to relabeling).
        for c in range(3):
            blok = preds[labels == c]
            assert np.mean(blok == np.bincount(blok).argmax()) > 0.95

    def test_transformer_stage_passthrough(self, rng):
        x, _ = _clustered_data(rng, n_per=20)
        df = DataFrame({"features": list(x)})
        pca_model = PCA().setK(2).setInputCol("features").setOutputCol("pca").fit(df)
        pipe = Pipeline(stages=[pca_model, KMeans().setK(3).setFeaturesCol("pca")])
        model = pipe.fit(df)
        assert model.stages[0] is pca_model
        out = model.transform(df)
        assert "prediction" in out.columns

    def test_bad_stage_type(self):
        with pytest.raises(TypeError, match="neither Estimator nor Transformer"):
            Pipeline(stages=["not a stage"]).fit(None)

    def test_stages_accessors(self):
        stages = [PCA().setK(2)]
        pipe = Pipeline().setStages(stages)
        assert pipe.getStages() == stages and pipe.getStages() is not stages

    def test_unfitted_pipeline_roundtrip(self, tmp_path):
        pipe = Pipeline(
            stages=[
                PCA().setK(2).setInputCol("features").setOutputCol("pca"),
                KMeans().setK(3).setFeaturesCol("pca").setSeed(1),
            ]
        )
        path = str(tmp_path / "pipe_unfitted")
        pipe.save(path)
        loaded = Pipeline.load(path)
        assert len(loaded.stages) == 2
        assert loaded.uid == pipe.uid
        assert loaded.stages[0].getK() == 2
        assert loaded.stages[1].getK() == 3
        assert loaded.stages[1].getFeaturesCol() == "pca"
        assert _meta(path)["stageClasses"] == [
            "spark_rapids_ml_tpu.models.pca.PCA", "spark_rapids_ml_tpu.models.kmeans.KMeans"]

    def test_persistence_roundtrip(self, tmp_path, rng):
        x, _ = _clustered_data(rng, n_per=20)
        df = DataFrame({"features": list(x)})
        model = Pipeline(
            stages=[
                PCA().setK(2).setInputCol("features").setOutputCol("pca"),
                KMeans().setK(3).setFeaturesCol("pca").setSeed(1),
            ]
        ).fit(df)
        path = str(tmp_path / "pipe")
        model.save(path)
        loaded = PipelineModel.load(path)
        assert len(loaded.stages) == 2
        np.testing.assert_array_equal(
            np.asarray(model.transform(df).select("prediction")),
            np.asarray(loaded.transform(df).select("prediction")),
        )
        np.testing.assert_array_equal(loaded.transform(x), model.transform(x))
        with pytest.raises(ValueError, match="metadata class"):
            Pipeline.load(path)

    def test_unpersistable_stage_is_refused(self, tmp_path):
        class Plain:
            uid = "plain-stage"

        with pytest.raises(TypeError, match="not persistable"):
            PipelineModel(None, [Plain()]).save(str(tmp_path / "p"))

    def test_load_rejects_foreign_class(self, tmp_path):
        """Metadata naming a class outside the two packages must not be
        imported (untrusted model dirs as import gadgets), with the
        reference's messages."""
        pipe = Pipeline(stages=[PCA().setK(2)])
        path = str(tmp_path / "pipe_evil")
        pipe.save(path)
        meta_file = tmp_path / "pipe_evil" / "metadata" / "part-00000"
        meta = json.loads(meta_file.read_text())
        meta["stageClasses"] = ["os.system"]
        meta_file.write_text(json.dumps(meta) + "\n")
        with pytest.raises(ValueError, match="refusing to import 'os.system' from model metadata: only classes"):
            Pipeline.load(path)
        with pytest.raises(ValueError, match="refusing to import 'os.system'"):
            JaxPipeline.load(path)
        # A path inside the package that resolves to a re-exported foreign
        # attribute (a numpy module alias) must be rejected too; the
        # reference's path reads as the port's twin.
        for class_path in ("spark_rapids_ml_tpu.tuning.np", "spark_rapids_ml_tpu_torch.tuning.np"):
            meta["stageClasses"] = [class_path]
            meta_file.write_text(json.dumps(meta) + "\n")
            with pytest.raises(ValueError, match="refusing to load"):
                Pipeline.load(path)

    def test_allow_persisted_package_escape_hatch(self):
        """Extension libraries register their root package to make their
        custom stages loadable (the restriction is a default, not a wall)."""
        with pytest.raises(ValueError, match="refusing to import"):
            resolve_persisted_class("collections.OrderedDict")
        allow_persisted_package("collections")
        try:
            import collections

            assert resolve_persisted_class("collections.OrderedDict") is collections.OrderedDict
        finally:
            _LOADABLE_PACKAGES.discard("collections")
        with pytest.raises(ValueError, match="bare top-level"):
            allow_persisted_package("a.b")

    def test_class_paths_map_between_the_packages(self):
        assert persisted_class_path(PCAModel) == "spark_rapids_ml_tpu.models.pca.PCAModel"
        assert persisted_class_path(PipelineModel) == "spark_rapids_ml_tpu.pipeline.PipelineModel"
        assert persisted_class_path(dict) == "builtins.dict"
        assert resolve_persisted_class("spark_rapids_ml_tpu.models.pca.PCAModel") is PCAModel
        assert resolve_persisted_class("spark_rapids_ml_tpu_torch.pipeline.PipelineModel") is PipelineModel
        assert resolve_persisted_class("spark_rapids_ml_tpu.feature.PCAModel") is PCAModel
        from spark_rapids_ml_tpu.core.persistence import _SPARK_CLASS_ALIASES as JAX_ALIASES

        assert set(_SPARK_CLASS_ALIASES) == set(JAX_ALIASES)
        for name, path in _SPARK_CLASS_ALIASES.items():
            assert path.replace("spark_rapids_ml_tpu_torch.", "spark_rapids_ml_tpu.") == JAX_ALIASES[name]
            assert resolve_persisted_class(path).__name__ == name


def _xy(rng, n=120, d=6):
    x = rng.normal(size=(n, d))
    return x, (x[:, 0] - x[:, 2] > 0).astype(np.int64)


class TestPersistenceBothWays:
    def test_reference_pipeline_loads_in_the_port(self, tmp_path):
        path = str(tmp_path / "ref_pipe")
        JaxPipeline(stages=[JaxPCA().setK(3), JaxLogReg().setMaxIter(7).setRegParam(0.2)]).save(path)
        loaded = Pipeline.load(path)
        assert isinstance(loaded.stages[0], PCA) and isinstance(loaded.stages[1], LogisticRegression)
        assert loaded.stages[0].getK() == 3 and loaded.stages[1].getMaxIter() == 7
        assert loaded.stages[1].getRegParam() == 0.2

    def test_port_pipeline_loads_in_the_reference(self, tmp_path):
        path = str(tmp_path / "port_pipe")
        Pipeline(stages=[PCA().setK(3), LogisticRegression().setMaxIter(7)]).save(path)
        loaded = JaxPipeline.load(path)
        assert [type(s).__name__ for s in loaded.stages] == ["PCA", "LogisticRegression"]
        assert loaded.stages[0].getK() == 3 and loaded.stages[1].getMaxIter() == 7

    @pytest.mark.parametrize("chain", ["pca-logistic", "pca-kmeans", "pca-rf-regressor"])
    def test_reference_pipeline_model_loads_in_the_port(self, chain, tmp_path, rng):
        x, y = _xy(rng)
        stages = {
            "pca-logistic": [JaxPCA().setK(3), JaxLogReg().setMaxIter(20)],
            "pca-kmeans": [JaxPCA().setK(3), JaxKMeans().setK(3).setSeed(2)],
            "pca-rf-regressor": [JaxPCA().setK(3), JaxRFR().setNumTrees(3).setMaxDepth(3).setSeed(1)],
        }[chain]
        theirs = JaxPipeline(stages=stages).fit((x, y.astype(np.float64)) if "rf" in chain else (x, y))
        path = str(tmp_path / "ref_model")
        theirs.save(path)
        ours = PipelineModel.load(path)
        assert ours.uid == theirs.uid
        assert [s.uid for s in ours.stages] == [s.uid for s in theirs.stages]
        _same_predictions(np.asarray(ours.transform(x)), np.asarray(theirs.transform(x)))

    def test_port_pipeline_model_loads_in_the_reference(self, tmp_path, rng):
        x, y = _xy(rng)
        ours = Pipeline(stages=[PCA().setK(3), LogisticRegression().setMaxIter(20)]).fit((x, y))
        path = str(tmp_path / "port_model")
        ours.save(path)
        assert _meta(path)["stageClasses"] == [
            "spark_rapids_ml_tpu.models.pca.PCAModel",
            "spark_rapids_ml_tpu.models.logistic_regression.LogisticRegressionModel"]
        theirs = JaxPipelineModel.load(path)
        _same_predictions(np.asarray(theirs.transform(x)), ours.transform(x))
        again = PipelineModel.load(path)
        np.testing.assert_array_equal(again.transform(x), ours.transform(x))

    def test_carried_and_saved_model_reloads_in_both(self, tmp_path, rng):
        x, y = _xy(rng)
        theirs = JaxPipeline(stages=[JaxPCA().setK(3), JaxKMeans().setK(4).setSeed(5)]).fit((x, y))
        ours = interop.pipeline_model_from_numpy([stage_dict(s) for s in theirs.stages], uid=theirs.uid)
        path = str(tmp_path / "carried")
        ours.save(path)
        np.testing.assert_array_equal(np.asarray(JaxPipelineModel.load(path).transform(x)),
                                      np.asarray(theirs.transform(x)))
        with pytest.raises(ValueError, match="unknown family"):
            interop.pipeline_model_from_numpy([{"family": "svm"}])


def _same_predictions(got, want):
    if np.issubdtype(want.dtype, np.integer) or want.dtype == np.float32:
        np.testing.assert_array_equal(got, want)
    else:
        assert_close("predictions", got, want, rtol=0, atol=1e-10 * max(1.0, float(np.abs(want).max())))


class TestSparkGoldenComposites:
    """The Spark-written composite directories of
    ``tests/test_golden_spark.py`` (no python class paths; ``stageUids``
    in ``paramMap``; JVM classes in the components) load in the port."""

    def test_pipeline_model_golden(self, tmp_path, rng):
        from tests.test_golden_spark import TestCompositeGoldenLayouts, _write_spark_metadata

        golden = TestCompositeGoldenLayouts()
        pc = rng.normal(size=(5, 2))
        ev = np.array([0.7, 0.2])
        coef = rng.normal(size=2)
        path = str(tmp_path / "spark_pipeline")
        os.makedirs(path)
        uids = ["PCAModel_stage0", "LinearRegressionModel_stage1"]
        _write_spark_metadata(path, "org.apache.spark.ml.PipelineModel", "PipelineModel_golden",
                              {"stageUids": uids})
        golden._golden_pca_stage(os.path.join(path, "stages", f"0_{uids[0]}"), pc, ev, uid=uids[0])
        golden._golden_linreg_stage(os.path.join(path, "stages", f"1_{uids[1]}"), coef, 1.5, uid=uids[1])

        model = PipelineModel.load(path)
        assert [type(s).__name__ for s in model.stages] == ["PCAModel", "LinearRegressionModel"]
        x = rng.normal(size=(8, 5))
        out = np.asarray(model.transform(x))
        np.testing.assert_allclose(out, x @ pc @ coef + 1.5, atol=1e-10)
        assert resolve_component_class(os.path.join(path, "stages", f"0_{uids[0]}")) is PCAModel

    def test_pipeline_model_roundtrip_ours(self, tmp_path, rng):
        x = rng.normal(size=(60, 5))
        pca_model = PCA().setK(3).fit(x)
        y = np.asarray(pca_model.transform(x)) @ rng.normal(size=3) + 2.0
        lr_model = LinearRegression().fit((np.asarray(pca_model.transform(x)), y))
        model = PipelineModel(None, [pca_model, lr_model])
        path = str(tmp_path / "ours_pipeline")
        model.write.overwrite().save(path)
        meta = _meta(path)
        assert meta["stageUids"] == [s.uid for s in model.stages]
        assert len(meta["stageClasses"]) == 2
        loaded = PipelineModel.load(path)
        np.testing.assert_allclose(np.asarray(loaded.transform(x)), np.asarray(model.transform(x)), atol=1e-12)

    def test_unknown_jvm_component_is_refused(self, tmp_path):
        from tests.test_golden_spark import _write_spark_metadata

        path = str(tmp_path / "svm")
        os.makedirs(path)
        _write_spark_metadata(path, "org.apache.spark.ml.classification.LinearSVCModel", "svm", {})
        with pytest.raises(ValueError, match="no loader for Spark class"):
            resolve_component_class(path)

    def test_component_written_by_either_package_resolves(self, tmp_path, rng):
        x = rng.normal(size=(40, 4))
        path = str(tmp_path / "rf")
        from spark_rapids_ml_tpu_torch.regression import RandomForestRegressor

        RandomForestRegressor().setNumTrees(2).setMaxDepth(2).fit((x, x[:, 0])).save(path)
        assert resolve_component_class(path) is RandomForestRegressionModel
        path = str(tmp_path / "lr")
        JaxLogReg().setMaxIter(3).fit((x, (x[:, 0] > 0).astype(np.int64))).save(path)
        assert resolve_component_class(path) is LogisticRegressionModel
        path = str(tmp_path / "est")
        PCA().setK(2).save(path)
        assert resolve_component_class(path) is PCA
