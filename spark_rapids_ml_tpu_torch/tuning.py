"""Hyperparameter tuning — parity with ``org.apache.spark.ml.tuning``.

Port of the reference's ``tuning.py``: ``ParamGridBuilder`` /
``CrossValidator`` / ``TrainValidationSplit`` over this package's
estimators. Fold orchestration is host-side (control flow over whole
fits, the analogue of Spark's host-side loop over param maps); each inner
``fit`` runs on the card. Folds come from the same
``numpy.random.default_rng(seed).permutation`` as the reference's, so the
two packages make the same folds.

A plain host array or ``(X, y)`` pair for an estimator that consumes
tensors in place (``_device_foldable``) is placed on the device once, and
each fold's slices are an ``index_select`` there (:class:`_DeviceFolds`);
a dataset that is already a tensor stays where it lives. Every helper
takes tensors as well as host arrays: rows are counted, sliced and
scored where they live.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import DataFrame, is_device_array
from spark_rapids_ml_tpu_torch.core.estimator import Estimator, Model
from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
from spark_rapids_ml_tpu_torch.core.params import Param, Params, toFloat, toInt
from spark_rapids_ml_tpu_torch.core.persistence import (
    load_metadata,
    persisted_class_path,
    resolve_component_class,
    resolve_persisted_class,
    save_metadata,
)
from spark_rapids_ml_tpu_torch.evaluation import BinaryClassificationEvaluator, Evaluator
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter


def _save_best_model(owner, path: str, class_name: str, extra: dict) -> None:
    best = owner.bestModel
    if best is None:
        raise ValueError("cannot save a validator model with no bestModel")
    extra = dict(extra)
    extra["bestModelClass"] = persisted_class_path(type(best))
    save_metadata(owner, path, class_name=class_name, extra_metadata=extra)
    best.save(os.path.join(path, "bestModel"))


def _load_best_model(path: str, expected_class: str):
    """(metadata, bestModel) — ``bestModelClass`` when a writer of either
    package recorded it; an upstream-Spark directory has no such key, so
    the bestModel subdirectory's own metadata class (a JVM name) picks
    the loader instead (``resolve_component_class``)."""
    metadata = load_metadata(path, expected_class=expected_class)
    best_path = os.path.join(path, "bestModel")
    class_path = metadata.get("bestModelClass")
    if class_path:
        klass = resolve_persisted_class(class_path)
    else:
        klass = resolve_component_class(best_path)
    return metadata, klass.load(best_path)


class ParamGridBuilder:
    """Cartesian product of param -> values grids (Spark's builder API)."""

    def __init__(self):
        self._grid: Dict[Param, Sequence[Any]] = {}

    def addGrid(self, param: Param, values: Sequence[Any]) -> "ParamGridBuilder":
        self._grid[param] = list(values)
        return self

    def baseOn(self, *args) -> "ParamGridBuilder":
        pairs = args[0].items() if len(args) == 1 and isinstance(args[0], dict) else args
        for param, value in pairs:
            self._grid[param] = [value]
        return self

    def build(self) -> List[Dict[Param, Any]]:
        maps: List[Dict[Param, Any]] = [{}]
        for param, values in self._grid.items():
            maps = [{**m, param: v} for m in maps for v in values]
        return maps


def _index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """Row indices as an int64 tensor on ``device``."""
    return torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(device)


def _take(a: torch.Tensor, idx) -> torch.Tensor:
    """Rows ``idx`` (host indices or an index tensor) of a tensor,
    gathered on its device."""
    ii = idx.to(a.device) if isinstance(idx, torch.Tensor) else _index(idx, a.device)
    return torch.index_select(a, 0, ii)


class _DeviceFolds:
    """Tuning data placed on the device ONCE for the whole grid search.

    Each fold's train and validation slices are an ``index_select`` on
    the data's device, made once per fold and consumed in place by every
    param map's ``estimator.copy(pm).fit(train)`` through the families'
    tensor routes: grid × folds host copies of the same rows become one
    placement. Same values, same fold assignment. A dataset that already
    was a tensor is used where it lives (counter ``tuning.device_folds``
    counts the datasets prepared this way).
    """

    def __init__(self, x, y=None):
        self.x = x
        self.y = y
        bump_counter("tuning.device_folds")

    def slice(self, idx: np.ndarray):
        ii = _index(idx, self.x.device)  # one copy of the indices for x and y
        xs = _take(self.x, ii)
        if self.y is None:
            return xs
        return (xs, _take(self.y, ii))

    def full(self):
        return self.x if self.y is None else (self.x, self.y)


def _device_fold_prep(dataset: Any, estimator) -> Optional[_DeviceFolds]:
    """Fold preparation on the device, when the estimator's fit consumes
    tensors in place (the ``_device_foldable`` families and pipelines of
    them) and the dataset is a plain numeric array, a tensor, or an
    ``(X, y)`` pair of them. Anything else — DataFrames, pandas, custom
    estimators — keeps the host slicing path."""
    if not getattr(estimator, "_device_foldable", False):
        return None

    def _place(a, ndim):
        """One placement on the device (tensors stay put), in the array's
        own dtype; None if the value isn't a plain numeric array of the
        expected rank."""
        if is_device_array(a):
            a = a.reshape(-1) if ndim == 1 and a.dim() != 1 else a
            return a if a.dim() == ndim else None
        try:
            host = np.asarray(a)
        except Exception:  # ragged / object containers
            return None
        if ndim == 1:
            host = host.ravel()
        if host.ndim != ndim or not np.issubdtype(host.dtype, np.number):
            return None
        return torch.from_numpy(np.ascontiguousarray(host)).to(_device.resolve_device())

    if isinstance(dataset, tuple) and len(dataset) == 2:
        x, y = _place(dataset[0], 2), _place(dataset[1], 1)
        if x is not None and y is not None and x.shape[0] == y.shape[0]:
            return _DeviceFolds(x, y)
        return None
    if isinstance(dataset, np.ndarray) or is_device_array(dataset):
        x = _place(dataset, 2)
        return _DeviceFolds(x) if x is not None else None
    return None


def _slice_dataset(dataset: Any, idx: np.ndarray) -> Any:
    """Row-subset any supported dataset container by integer indices; a
    tensor is sliced on its device."""
    if isinstance(dataset, tuple) and len(dataset) == 2:
        return tuple(_take(a, idx) if is_device_array(a) else np.asarray(a)[idx] for a in dataset)
    if is_device_array(dataset):
        return _take(dataset, idx)
    if isinstance(dataset, DataFrame):
        return DataFrame(
            {name: [dataset.select(name)[i] for i in idx] for name in dataset.columns}
        )
    try:
        import pandas as pd

        if isinstance(dataset, pd.DataFrame):
            return dataset.iloc[idx].reset_index(drop=True)
    except ImportError:  # pragma: no cover
        pass
    return np.asarray(dataset)[idx]


def _num_rows(dataset: Any) -> int:
    if isinstance(dataset, tuple) and len(dataset) == 2:
        y = dataset[1]
        return int(y.shape[0]) if is_device_array(y) else len(np.asarray(y))
    if isinstance(dataset, DataFrame):
        return dataset.count()
    return len(dataset)


def _eval_dataset(model: Model, val: Any, evaluator: Evaluator) -> Any:
    """Transform the validation subset and hand the result to the evaluator.

    Tuple datasets have no named columns, so the transform output is paired
    with the held-out labels directly. Score-based evaluators (AUC) must see
    continuous scores, not hard class labels — for those the model's
    ``predictProbability`` positive-class column stands in for the
    ``rawPredictionCol`` column a named-column dataset would carry. A
    tensor's scores stay on its device, where the evaluator scores them.
    """
    if isinstance(val, tuple):
        x_val, y_val = val
        if isinstance(evaluator, BinaryClassificationEvaluator):
            if not hasattr(model, "predictProbability"):
                raise TypeError(
                    f"{type(evaluator).__name__} ranks by continuous scores, "
                    f"but {type(model).__name__} exposes no predictProbability; "
                    "pass a named-column dataset so rawPredictionCol applies"
                )
            probs = model.predictProbability(x_val)
            if not is_device_array(probs):
                probs = to_host(probs)
            scores = probs[:, -1] if probs.ndim == 2 else probs
            return (y_val, scores)
        preds = model.transform(x_val)
        return (y_val, preds)
    return model.transform(val)


class _ValidatorParams(Params):
    seed = Param("_", "seed", "random seed", toInt)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self.estimator: Optional[Estimator] = None
        self.estimatorParamMaps: List[Dict[Param, Any]] = []
        self.evaluator: Optional[Evaluator] = None
        self._setDefault(seed=0)

    def setEstimator(self, value: Estimator):
        self.estimator = value
        return self

    def getEstimator(self) -> Estimator:
        return self.estimator

    def setEstimatorParamMaps(self, value: List[Dict[Param, Any]]):
        self.estimatorParamMaps = list(value)
        return self

    def getEstimatorParamMaps(self) -> List[Dict[Param, Any]]:
        return self.estimatorParamMaps

    def setEvaluator(self, value: Evaluator):
        self.evaluator = value
        return self

    def getEvaluator(self) -> Evaluator:
        return self.evaluator

    def setSeed(self, value: int):
        self.set(self.seed, value)
        return self

    def getSeed(self) -> int:
        return self.getOrDefault(self.seed)

    def _check(self):
        if self.estimator is None or self.evaluator is None:
            raise ValueError("estimator and evaluator must be set")
        if not self.estimatorParamMaps:
            raise ValueError("estimatorParamMaps must be a non-empty list")


class CrossValidator(_ValidatorParams, Estimator):
    """k-fold cross validation over a param grid; refits the winner on the
    full dataset (Spark semantics: metrics averaged per grid cell,
    best = extremum under ``evaluator.isLargerBetter``)."""

    numFolds = Param("_", "numFolds", "number of folds", toInt)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(numFolds=3)

    def setNumFolds(self, value: int):
        if value < 2:
            raise ValueError(f"numFolds must be >= 2, got {value}")
        self.set(self.numFolds, value)
        return self

    def getNumFolds(self) -> int:
        return self.getOrDefault(self.numFolds)

    def fit(self, dataset: Any) -> "CrossValidatorModel":
        self._check()
        n = _num_rows(dataset)
        k = self.getNumFolds()
        if n < k:
            raise ValueError(f"numFolds={k} exceeds number of rows {n}")
        rng = np.random.default_rng(self.getSeed())
        perm = rng.permutation(n)
        folds = np.array_split(perm, k)

        maps = self.getEstimatorParamMaps()
        metrics = np.zeros((len(maps), k))
        prep = _device_fold_prep(dataset, self.estimator)
        for fold_i, val_idx in enumerate(folds):
            train_idx = np.concatenate(
                [f for j, f in enumerate(folds) if j != fold_i]
            )
            # Each fold's (train, val) is prepared ONCE — on the device
            # when the family takes tensors — and reused by every
            # param-map fit below.
            if prep is not None:
                train = prep.slice(np.sort(train_idx))
                val = prep.slice(np.sort(val_idx))
            else:
                train = _slice_dataset(dataset, np.sort(train_idx))
                val = _slice_dataset(dataset, np.sort(val_idx))
            for map_i, pm in enumerate(maps):
                model = self.estimator.copy(pm).fit(train)
                metrics[map_i, fold_i] = self.evaluator.evaluate(
                    _eval_dataset(model, val, self.evaluator)
                )

        avg = metrics.mean(axis=1)
        best_i = int(np.argmax(avg) if self.evaluator.isLargerBetter() else np.argmin(avg))
        best_model = self.estimator.copy(maps[best_i]).fit(
            prep.full() if prep is not None else dataset
        )
        cv_model = CrossValidatorModel(
            self.uid, best_model, avgMetrics=avg.tolist(), bestIndex=best_i
        )
        cv_model.estimator = self.estimator
        cv_model.estimatorParamMaps = maps
        cv_model.evaluator = self.evaluator
        return self._copyValues(cv_model)


class CrossValidatorModel(_ValidatorParams, Model):
    """Wraps the winning refitted model; ``avgMetrics[i]`` aligns with
    ``estimatorParamMaps[i]``."""

    numFolds = CrossValidator.numFolds

    def __init__(
        self,
        uid: Optional[str] = None,
        bestModel: Optional[Model] = None,
        avgMetrics: Optional[List[float]] = None,
        bestIndex: int = 0,
    ):
        super().__init__(uid)
        self._setDefault(numFolds=3)
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics or []
        self.bestIndex = bestIndex

    def transform(self, dataset: Any) -> Any:
        return self.bestModel.transform(dataset)

    def _save_impl(self, path: str) -> None:
        _save_best_model(
            self,
            path,
            "org.apache.spark.ml.tuning.CrossValidatorModel",
            {"avgMetrics": list(self.avgMetrics), "bestIndex": self.bestIndex},
        )

    @classmethod
    def _load_impl(cls, path: str) -> "CrossValidatorModel":
        metadata, best = _load_best_model(path, "CrossValidatorModel")
        return cls(
            metadata["uid"],
            best,
            avgMetrics=list(metadata.get("avgMetrics", [])),
            bestIndex=int(metadata.get("bestIndex", 0)),
        )


class TrainValidationSplit(_ValidatorParams, Estimator):
    """Single random train/validation split over a param grid."""

    trainRatio = Param("_", "trainRatio", "fraction of rows used for training", toFloat)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(trainRatio=0.75)

    def setTrainRatio(self, value: float):
        if not 0 < value < 1:
            raise ValueError(f"trainRatio must be in (0, 1), got {value}")
        self.set(self.trainRatio, value)
        return self

    def getTrainRatio(self) -> float:
        return self.getOrDefault(self.trainRatio)

    def fit(self, dataset: Any) -> "TrainValidationSplitModel":
        self._check()
        n = _num_rows(dataset)
        n_train = int(round(n * self.getTrainRatio()))
        if n_train < 1 or n_train >= n:
            raise ValueError(
                f"trainRatio={self.getTrainRatio()} leaves an empty split for {n} rows"
            )
        rng = np.random.default_rng(self.getSeed())
        perm = rng.permutation(n)
        # The single split is prepared ONCE — on the device when the
        # family takes tensors — and reused by every param-map fit.
        prep = _device_fold_prep(dataset, self.estimator)
        if prep is not None:
            train = prep.slice(np.sort(perm[:n_train]))
            val = prep.slice(np.sort(perm[n_train:]))
        else:
            train = _slice_dataset(dataset, np.sort(perm[:n_train]))
            val = _slice_dataset(dataset, np.sort(perm[n_train:]))

        maps = self.getEstimatorParamMaps()
        metrics = []
        for pm in maps:
            model = self.estimator.copy(pm).fit(train)
            metrics.append(
                self.evaluator.evaluate(_eval_dataset(model, val, self.evaluator))
            )
        arr = np.asarray(metrics)
        best_i = int(np.argmax(arr) if self.evaluator.isLargerBetter() else np.argmin(arr))
        best_model = self.estimator.copy(maps[best_i]).fit(
            prep.full() if prep is not None else dataset
        )
        tvs_model = TrainValidationSplitModel(
            self.uid, best_model, validationMetrics=metrics, bestIndex=best_i
        )
        tvs_model.estimator = self.estimator
        tvs_model.estimatorParamMaps = maps
        tvs_model.evaluator = self.evaluator
        return self._copyValues(tvs_model)


class TrainValidationSplitModel(_ValidatorParams, Model):
    trainRatio = TrainValidationSplit.trainRatio

    def __init__(
        self,
        uid: Optional[str] = None,
        bestModel: Optional[Model] = None,
        validationMetrics: Optional[List[float]] = None,
        bestIndex: int = 0,
    ):
        super().__init__(uid)
        self._setDefault(trainRatio=0.75)
        self.bestModel = bestModel
        self.validationMetrics = validationMetrics or []
        self.bestIndex = bestIndex

    def transform(self, dataset: Any) -> Any:
        return self.bestModel.transform(dataset)

    def _save_impl(self, path: str) -> None:
        _save_best_model(
            self,
            path,
            "org.apache.spark.ml.tuning.TrainValidationSplitModel",
            {
                "validationMetrics": list(self.validationMetrics),
                "bestIndex": self.bestIndex,
            },
        )

    @classmethod
    def _load_impl(cls, path: str) -> "TrainValidationSplitModel":
        metadata, best = _load_best_model(path, "TrainValidationSplitModel")
        return cls(
            metadata["uid"],
            best,
            validationMetrics=list(metadata.get("validationMetrics", [])),
            bestIndex=int(metadata.get("bestIndex", 0)),
        )


__all__ = [
    "ParamGridBuilder",
    "CrossValidator",
    "CrossValidatorModel",
    "TrainValidationSplit",
    "TrainValidationSplitModel",
]
