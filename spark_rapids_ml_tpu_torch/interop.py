"""Carrying fitted weights from the JAX package into this one.

:func:`pca_model_from_numpy`, :func:`kmeans_model_from_numpy`,
:func:`umap_model_from_numpy`, :func:`linear_regression_model_from_numpy`,
:func:`logistic_regression_model_from_numpy`,
:func:`nearest_neighbors_model_from_numpy`,
:func:`approximate_nearest_neighbors_model_from_numpy`,
:func:`dbscan_model_from_numpy`,
:func:`random_forest_classification_model_from_numpy` and
:func:`random_forest_regression_model_from_numpy` build a port model
from the reference model's arrays and param map, handed over as numpy and
a plain dict — so both packages compute the same transform or prediction
without this package importing the other. :func:`pipeline_model_from_numpy`
builds a ``PipelineModel`` from one such description per stage, and
:func:`cross_validator_model_from_numpy` /
:func:`train_validation_split_model_from_numpy` wrap a carried-across
best model with the reference validator's metrics. The IVF quantizer's draws
cannot be reproduced here, so the ANN model also takes the reference's
index arrays: both packages then probe the same lists.
:func:`shifted_moments_from_numpy` carries a reference ``ShiftedMoments``
(its numpy fields) across, and ``pca_model_from_numpy(..., moments=...)``
puts it on the model as its ``_moments``, so a PCA ``partial_fit`` started
in the JAX package continues here. The second route
is persistence: a model saved by either package loads in the other
(``PCAModel.load``, ``KMeansModel.load``, ``UMAPModel.load``,
``LinearRegressionModel.load``, ``LogisticRegressionModel.load``,
``NearestNeighborsModel.load``, ``ApproximateNearestNeighborsModel.load``,
``DBSCANModel.load``, ``RandomForestClassificationModel.load``,
``RandomForestRegressionModel.load``, ``PipelineModel.load``,
``CrossValidatorModel.load``, ``TrainValidationSplitModel.load``; the ANN
index is rebuilt from the seed there).

Typical use, in code that has both packages::

    ref = reference_pca.fit(x)                    # the JAX model
    params = {p.name: v for p, v in ref.extractParamMap().items()}
    model = pca_model_from_numpy(ref.pc, ref.explainedVariance,
                                 uid=ref.uid, params=params)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.core.moments import ShiftedMoments
from spark_rapids_ml_tpu_torch.models.approximate_nearest_neighbors import ApproximateNearestNeighborsModel
from spark_rapids_ml_tpu_torch.models.dbscan import DBSCANModel
from spark_rapids_ml_tpu_torch.models.kmeans import KMeansModel
from spark_rapids_ml_tpu_torch.models.linear_regression import LinearRegressionModel
from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegressionModel
from spark_rapids_ml_tpu_torch.models.nearest_neighbors import NearestNeighborsModel
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.models.random_forest import RandomForestClassificationModel, RandomForestRegressionModel
from spark_rapids_ml_tpu_torch.models.umap import UMAPModel
from spark_rapids_ml_tpu_torch.pipeline import PipelineModel
from spark_rapids_ml_tpu_torch.tuning import CrossValidatorModel, TrainValidationSplitModel


def pca_model_from_numpy(
    pc,
    explained_variance,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
    moments: Optional[ShiftedMoments] = None,
) -> PCAModel:
    """A port ``PCAModel`` holding ``pc`` (d, k) and ``explained_variance``
    (k,) as float64, with every param of ``params`` that the model has
    set on it (reference-only params such as ``deployMode`` are skipped),
    and ``moments`` (from :func:`shifted_moments_from_numpy`) as the
    streaming moments a ``partial_fit`` continues from."""
    pc = np.asarray(pc, dtype=np.float64)
    ev = np.asarray(explained_variance, dtype=np.float64)
    if pc.ndim != 2 or ev.shape != (pc.shape[1],):
        raise ValueError(
            f"pc must be (d, k) and explained_variance (k,), got {pc.shape} and {ev.shape}"
        )
    if moments is not None and moments.n_cols != pc.shape[0]:
        raise ValueError(f"moments have {moments.n_cols} columns, pc has {pc.shape[0]} rows")
    model = _with_params(PCAModel(uid, pc, ev), params)
    if moments is not None:
        model._moments = moments
    return model


def shifted_moments_from_numpy(n_rows: int, shift, sum, gram) -> ShiftedMoments:
    """The port's ``ShiftedMoments`` with the reference's fields: ``n_rows``
    rows seen, ``shift`` (d,) (None before the first row), ``sum`` (d,) and
    ``gram`` (d, d), copied as float64."""
    gram = np.array(gram, dtype=np.float64)
    if gram.ndim != 2 or gram.shape[0] != gram.shape[1]:
        raise ValueError(f"gram must be (d, d), got {gram.shape}")
    d = gram.shape[0]
    mom = ShiftedMoments(d)
    mom.n_rows = int(n_rows)
    mom.shift = None if shift is None else np.array(shift, dtype=np.float64).reshape(d)
    mom.sum = np.array(sum, dtype=np.float64).reshape(d)
    mom.gram = gram
    return mom


def kmeans_model_from_numpy(
    centers,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
    training_cost: float = float("nan"),
    num_iter: int = 0,
) -> KMeansModel:
    """A port ``KMeansModel`` holding ``centers`` (k, d) as float64, with
    the reference model's ``trainingCost``, ``numIter`` and every param of
    ``params`` that the model has."""
    centers = np.asarray(centers, dtype=np.float64)
    if centers.ndim != 2:
        raise ValueError(f"centers must be (k, d), got {centers.shape}")
    model = KMeansModel(uid, centers, trainingCost=float(training_cost), numIter=int(num_iter))
    return _with_params(model, params)


def umap_model_from_numpy(
    embedding,
    train_data,
    a: float,
    b: float,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
) -> UMAPModel:
    """A port ``UMAPModel`` holding the reference model's ``embedding``
    (n, dim) and ``trainData`` (n, d) as float64, its fitted curve ``a``,
    ``b`` and every param of ``params`` that the model has."""
    embedding = np.asarray(embedding, dtype=np.float64)
    train_data = np.asarray(train_data, dtype=np.float64)
    if embedding.ndim != 2 or train_data.ndim != 2 or embedding.shape[0] != train_data.shape[0]:
        raise ValueError(
            f"embedding must be (n, dim) and train_data (n, d), got {embedding.shape} and {train_data.shape}"
        )
    return _with_params(UMAPModel(uid, embedding, train_data, a=float(a), b=float(b)), params)


def linear_regression_model_from_numpy(
    coef,
    intercept: float,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
) -> LinearRegressionModel:
    """A port ``LinearRegressionModel`` holding ``coef`` (d,) as float64 and
    ``intercept``, with every param of ``params`` that the model has."""
    coef = np.asarray(coef, dtype=np.float64)
    if coef.ndim != 1:
        raise ValueError(f"coef must be (d,), got {coef.shape}")
    return _with_params(LinearRegressionModel(uid, coef, float(intercept)), params)


def logistic_regression_model_from_numpy(
    weights,
    intercepts,
    num_classes: int,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
    num_iter: int = 0,
) -> LogisticRegressionModel:
    """A port ``LogisticRegressionModel`` holding the reference model's
    ``weights`` (d, c) and ``intercepts`` (c,) as float64 (c = 1 for the
    binomial sigmoid column), its ``numClasses``, ``numIter`` and every
    param of ``params`` that the model has."""
    weights = np.asarray(weights, dtype=np.float64)
    intercepts = np.asarray(intercepts, dtype=np.float64)
    if weights.ndim != 2 or intercepts.shape != (weights.shape[1],):
        raise ValueError(
            f"weights must be (d, c) and intercepts (c,), got {weights.shape} and {intercepts.shape}"
        )
    model = LogisticRegressionModel(uid, weights, intercepts, numClasses=int(num_classes), numIter=int(num_iter))
    return _with_params(model, params)


def nearest_neighbors_model_from_numpy(
    items,
    ids=None,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
) -> NearestNeighborsModel:
    """A port ``NearestNeighborsModel`` indexing the reference model's
    ``items`` (n, d) (and its ``ids``), with every param of ``params`` that
    the model has."""
    items = _matrix(items, "items")
    return _with_params(NearestNeighborsModel(uid, items, _ids(ids, items)), params)


_INDEX_FIELDS = {
    "ivfflat": ("centroids", "lists", "list_mask", "list_ids"),
    "ivfpq": ("centroids", "codebooks", "codes", "list_mask", "list_ids"),
}


def approximate_nearest_neighbors_model_from_numpy(
    items,
    ids=None,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
    index: Optional[Dict[str, Any]] = None,
) -> ApproximateNearestNeighborsModel:
    """A port ``ApproximateNearestNeighborsModel`` over the reference
    model's ``items`` (n, d) and ``ids``, with every param of ``params``
    that the model has. ``index`` carries the reference's built index as
    numpy: ``centroids``, ``lists``, ``list_mask`` and ``list_ids`` for
    ``ivfflat``; ``centroids``, ``codebooks``, ``codes``, ``list_mask`` and
    ``list_ids`` for ``ivfpq``. Without it the port builds its own index
    at the first ``kneighbors``."""
    items = _matrix(items, "items")
    model = _with_params(ApproximateNearestNeighborsModel(uid, items, _ids(ids, items)), params)
    if index is not None:
        from spark_rapids_ml_tpu_torch.ops.ann import IVFIndex, IVFPQIndex

        is_pq = "codes" in index
        fields = _INDEX_FIELDS["ivfpq" if is_pq else "ivfflat"]
        missing = [f for f in fields if f not in index]
        if missing:
            raise ValueError(f"index lacks {missing}")
        tensors = {f: torch.from_numpy(np.array(index[f])) for f in fields}
        tensors["list_ids"] = tensors["list_ids"].to(torch.int32)
        if is_pq:
            tensors["codes"] = tensors["codes"].to(torch.uint8)
        model._index = (IVFPQIndex if is_pq else IVFIndex)(**tensors)
    return model


def dbscan_model_from_numpy(
    fitted,
    labels,
    core_mask,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
) -> DBSCANModel:
    """A port ``DBSCANModel`` holding the reference model's ``fitted`` rows
    (n, d) as float64, its ``labels_`` (n,) and ``core_mask_`` (n,), with
    every param of ``params`` that the model has."""
    fitted = _matrix(np.asarray(fitted, dtype=np.float64), "fitted")
    labels = np.asarray(labels)
    core_mask = np.asarray(core_mask)
    if labels.shape != (fitted.shape[0],) or core_mask.shape != labels.shape:
        raise ValueError(
            f"labels and core_mask must be ({fitted.shape[0]},), got {labels.shape} and {core_mask.shape}"
        )
    return _with_params(DBSCANModel(uid, fitted, labels, core_mask), params)


_FOREST_DTYPES = {
    "feature": np.int32, "threshold": np.float32, "is_leaf": bool, "leaf_value": np.float32,
    "node_weight": np.float32, "node_gain": np.float32, "node_impurity": np.float32,
}


def _forest(forest_arrays: Dict[str, Any]):
    """The reference's ``Forest`` fields (a dict, or the NamedTuple's
    ``_asdict()``) as the port's CPU tensors in their dtypes."""
    from spark_rapids_ml_tpu_torch.ops.trees import Forest

    missing = [f for f in Forest._fields if f not in forest_arrays]
    if missing:
        raise ValueError(f"forest_arrays lacks {missing}")
    return Forest(*(torch.from_numpy(np.array(forest_arrays[f], dtype=_FOREST_DTYPES[f]))
                    for f in Forest._fields))


def random_forest_classification_model_from_numpy(
    forest_arrays: Dict[str, Any],
    numFeatures: int,
    numClasses: int,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
) -> RandomForestClassificationModel:
    """A port ``RandomForestClassificationModel`` over the reference
    model's forest arrays (``{field: array}`` for every ``Forest`` field),
    its ``numFeatures`` and ``numClasses``, with every param of ``params``
    that the model has."""
    model = RandomForestClassificationModel(uid, _forest(forest_arrays), numFeatures=int(numFeatures),
                                            numClasses=int(numClasses))
    return _with_params(model, params)


def random_forest_regression_model_from_numpy(
    forest_arrays: Dict[str, Any],
    numFeatures: int,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
) -> RandomForestRegressionModel:
    """A port ``RandomForestRegressionModel`` over the reference model's
    forest arrays and ``numFeatures``, with every param of ``params`` that
    the model has."""
    model = RandomForestRegressionModel(uid, _forest(forest_arrays), numFeatures=int(numFeatures))
    return _with_params(model, params)


#: ``pipeline_model_from_numpy``'s family names -> the helper that builds
#: that family's model from the stage's other keys.
STAGE_FAMILIES = {
    "pca": pca_model_from_numpy,
    "kmeans": kmeans_model_from_numpy,
    "linear_regression": linear_regression_model_from_numpy,
    "logistic_regression": logistic_regression_model_from_numpy,
    "random_forest_classification": random_forest_classification_model_from_numpy,
    "random_forest_regression": random_forest_regression_model_from_numpy,
    "umap": umap_model_from_numpy,
    "nearest_neighbors": nearest_neighbors_model_from_numpy,
    "approximate_nearest_neighbors": approximate_nearest_neighbors_model_from_numpy,
    "dbscan": dbscan_model_from_numpy,
}


def pipeline_model_from_numpy(stages, uid: Optional[str] = None) -> PipelineModel:
    """A port ``PipelineModel`` from one dict per fitted stage of the
    reference pipeline: ``{"family": name, **keyword arguments}``, where
    ``name`` is a key of :data:`STAGE_FAMILIES` and the other keys are
    that family's helper's arguments (arrays, ``uid``, ``params``), e.g.
    ``{"family": "pca", "pc": ref.pc, "explained_variance":
    ref.explainedVariance, "uid": ref.uid}``."""
    models = []
    for i, stage in enumerate(stages):
        stage = dict(stage)
        family = stage.pop("family", None)
        if family not in STAGE_FAMILIES:
            raise ValueError(f"stage {i}: unknown family {family!r}; known: {sorted(STAGE_FAMILIES)}")
        models.append(STAGE_FAMILIES[family](**stage))
    return PipelineModel(uid, models)


def cross_validator_model_from_numpy(
    best_model,
    avg_metrics,
    best_index: int,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
) -> CrossValidatorModel:
    """A port ``CrossValidatorModel`` around ``best_model`` (a port model
    carried across, e.g. by :func:`pipeline_model_from_numpy`), with the
    reference model's ``avgMetrics``, ``bestIndex`` and params."""
    model = CrossValidatorModel(uid, best_model, avgMetrics=[float(m) for m in avg_metrics],
                                bestIndex=int(best_index))
    return _with_params(model, params)


def train_validation_split_model_from_numpy(
    best_model,
    validation_metrics,
    best_index: int,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
) -> TrainValidationSplitModel:
    """A port ``TrainValidationSplitModel`` around ``best_model``, with
    the reference model's ``validationMetrics``, ``bestIndex`` and
    params."""
    model = TrainValidationSplitModel(uid, best_model,
                                      validationMetrics=[float(m) for m in validation_metrics],
                                      bestIndex=int(best_index))
    return _with_params(model, params)


def _matrix(x, what: str) -> np.ndarray:
    x = np.asarray(x)
    if x.ndim != 2:
        raise ValueError(f"{what} must be (n, d), got {x.shape}")
    return x


def _ids(ids, items: np.ndarray) -> Optional[np.ndarray]:
    if ids is None:
        return None
    ids = np.asarray(ids)
    if ids.shape != (items.shape[0],):
        raise ValueError(f"ids must be ({items.shape[0]},), got {ids.shape}")
    return ids


def _with_params(model, params: Optional[Dict[str, Any]]):
    for name, value in (params or {}).items():
        if model.hasParam(name):
            model.set(model.getParam(name), value)
    return model
