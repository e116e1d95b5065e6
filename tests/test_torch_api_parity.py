"""API parity both ways: every public method of a ported estimator, model,
evaluator, pipeline, tuning, lifecycle or routing-tier class exists on its
reference twin (the port adds none the reference lacks), and every public
method of the reference class exists on its port twin, except
``fit_report``, which waits for the observability item (ROADMAP A.9,
step 5). ``partial_fit`` is ported
(``lifecycle/partial_fit.py``)."""

import inspect

import pytest

import spark_rapids_ml_tpu.classification as jax_classification
import spark_rapids_ml_tpu.clustering as jax_clustering
import spark_rapids_ml_tpu.evaluation as jax_evaluation
import spark_rapids_ml_tpu.feature as jax_feature
import spark_rapids_ml_tpu.lifecycle as jax_lifecycle
import spark_rapids_ml_tpu.manifold as jax_manifold
import spark_rapids_ml_tpu.neighbors as jax_neighbors
import spark_rapids_ml_tpu.pipeline as jax_pipeline
import spark_rapids_ml_tpu.regression as jax_regression
import spark_rapids_ml_tpu.serving as jax_serving
import spark_rapids_ml_tpu.tuning as jax_tuning
import spark_rapids_ml_tpu_torch.classification as classification
import spark_rapids_ml_tpu_torch.clustering as clustering
import spark_rapids_ml_tpu_torch.evaluation as evaluation
import spark_rapids_ml_tpu_torch.feature as feature
import spark_rapids_ml_tpu_torch.lifecycle as lifecycle
import spark_rapids_ml_tpu_torch.manifold as manifold
import spark_rapids_ml_tpu_torch.neighbors as neighbors
import spark_rapids_ml_tpu_torch.pipeline as pipeline
import spark_rapids_ml_tpu_torch.regression as regression
import spark_rapids_ml_tpu_torch.serving as serving
import spark_rapids_ml_tpu_torch.tuning as tuning

PAIRS = {
    "PCA": (feature, jax_feature),
    "PCAModel": (feature, jax_feature),
    "KMeans": (clustering, jax_clustering),
    "KMeansModel": (clustering, jax_clustering),
    "DBSCAN": (clustering, jax_clustering),
    "DBSCANModel": (clustering, jax_clustering),
    "UMAP": (manifold, jax_manifold),
    "UMAPModel": (manifold, jax_manifold),
    "LinearRegression": (regression, jax_regression),
    "LinearRegressionModel": (regression, jax_regression),
    "RandomForestRegressor": (regression, jax_regression),
    "RandomForestRegressionModel": (regression, jax_regression),
    "LogisticRegression": (classification, jax_classification),
    "LogisticRegressionModel": (classification, jax_classification),
    "RandomForestClassifier": (classification, jax_classification),
    "RandomForestClassificationModel": (classification, jax_classification),
    "NearestNeighbors": (neighbors, jax_neighbors),
    "NearestNeighborsModel": (neighbors, jax_neighbors),
    "ApproximateNearestNeighbors": (neighbors, jax_neighbors),
    "ApproximateNearestNeighborsModel": (neighbors, jax_neighbors),
    "RegressionEvaluator": (evaluation, jax_evaluation),
    "MulticlassClassificationEvaluator": (evaluation, jax_evaluation),
    "BinaryClassificationEvaluator": (evaluation, jax_evaluation),
    "Pipeline": (pipeline, jax_pipeline),
    "PipelineModel": (pipeline, jax_pipeline),
    "ParamGridBuilder": (tuning, jax_tuning),
    "CrossValidator": (tuning, jax_tuning),
    "CrossValidatorModel": (tuning, jax_tuning),
    "TrainValidationSplit": (tuning, jax_tuning),
    "TrainValidationSplitModel": (tuning, jax_tuning),
    "CycleJournal": (lifecycle, jax_lifecycle),
    "DriftMonitor": (lifecycle, jax_lifecycle),
    "LifecycleController": (lifecycle, jax_lifecycle),
    "RoutingRuntime": (serving, jax_serving),
    "ElasticScaler": (serving, jax_serving),
}


def _public_methods(cls) -> set:
    return {name for name, value in inspect.getmembers(cls)
            if not name.startswith("_") and (inspect.isfunction(value) or inspect.ismethod(value))}


@pytest.mark.parametrize("name", list(PAIRS))
def test_the_port_adds_no_public_method(name):
    port_module, jax_module = PAIRS[name]
    ours, theirs = getattr(port_module, name), getattr(jax_module, name)
    extra = _public_methods(ours) - _public_methods(theirs)
    assert not extra, f"{name} has public methods the reference lacks: {sorted(extra)}"
    assert _public_methods(ours), name


@pytest.mark.parametrize("name", list(PAIRS))
def test_the_port_has_every_reference_method(name):
    port_module, jax_module = PAIRS[name]
    ours, theirs = getattr(port_module, name), getattr(jax_module, name)
    missing = _public_methods(theirs) - _public_methods(ours)
    assert not missing, f"{name} lacks the reference's public methods {sorted(missing)}"
