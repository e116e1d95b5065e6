"""Evaluators — port of the reference's ``evaluation.py``, parity with
``org.apache.spark.ml.evaluation``.

``evaluate`` takes the DataFrame shim or a pandas frame carrying the
evaluator's columns, or a plain ``(y_true, y_pred)`` tuple. Two routes:

  - host: numpy float64 on the collected columns (named-column
    containers, and small host tuples);
  - device (``ops/metrics.py``): a tuple with a ``torch.Tensor`` in it
    computes where the tensor lives; a host tuple of at least
    :data:`_DEVICE_THRESHOLD` rows goes to the platform's device.

x64: the reference keeps a large float64 host pair on the host when x64
is off (the device would round it to float32). Tier-1 runs the reference
with x64 on, and the port always has float64, so the port follows the
x64-on behaviour: a large host pair goes to the device in its own dtype,
float64 included. The same rule picks the AUC sort: packed keys for
float32 scores, the stable sort otherwise.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import DataFrame, extract_column, is_device_array
from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
from spark_rapids_ml_tpu_torch.core.params import Param, Params, toString
from spark_rapids_ml_tpu_torch.ops.metrics import (
    binary_auc_device,
    multiclass_metrics_device,
    regression_metrics_device,
)

_trapezoid = getattr(np, "trapezoid", None) or np.trapz

#: Host tuples of at least this many rows score on the device.
_DEVICE_THRESHOLD = 1_000_000


def _device_pair(dataset) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """A ``(y, scores)`` tuple that should score on the device, as flat
    tensors on one device; else None."""
    if not (isinstance(dataset, tuple) and len(dataset) == 2):
        return None
    y, p = dataset
    on_device = is_device_array(y) or is_device_array(p)
    big = getattr(y, "shape", [0])[0] >= _DEVICE_THRESHOLD
    if not (on_device or big):
        return None
    if on_device:
        dev = (y if is_device_array(y) else p).device
        _device.device_of(y if is_device_array(y) else p)
    else:
        dev = _device.resolve_device()

    def place(a):
        t = a if is_device_array(a) else torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
        return t.reshape(-1).to(dev)

    return place(y), place(p)


def _multiclass_gate_probe(y: torch.Tensor, p: torch.Tensor):
    """``(integral, min, max)`` of both columns in one stacked readback,
    at a dtype at least as wide as float32."""
    dt = torch.promote_types(torch.promote_types(y.dtype, p.dtype), torch.float32)
    y, p = y.to(dt), p.to(dt)
    integral = torch.logical_and(torch.all(y == torch.round(y)), torch.all(p == torch.round(p)))
    lo = torch.minimum(torch.min(y), torch.min(p))
    hi = torch.maximum(torch.max(y), torch.max(p))
    return torch.stack([integral.to(dt), lo, hi]).tolist()


def _column(dataset: Any, name: str) -> np.ndarray:
    """Named-column lookup, for containers that HAVE named columns — a bare
    array reaching an evaluator is a caller bug."""
    is_frame = isinstance(dataset, DataFrame)
    if not is_frame:
        try:
            import pandas as pd

            is_frame = isinstance(dataset, pd.DataFrame)
        except ImportError:  # pragma: no cover
            pass
    if not is_frame:
        raise TypeError(f"cannot extract column {name!r} from {type(dataset).__name__}")
    return np.asarray(extract_column(dataset, name), dtype=object)


def _pair(dataset: Any, label_col: str, pred_col: str) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(dataset, tuple) and len(dataset) == 2:
        y, p = dataset
        return to_host(y, np.float64).ravel(), to_host(p, np.float64).ravel()
    y = np.asarray(_column(dataset, label_col).tolist(), dtype=np.float64)
    p = np.asarray(_column(dataset, pred_col).tolist(), dtype=np.float64)
    return y.ravel(), p.ravel()


class Evaluator(Params):
    """Base: ``evaluate(dataset) -> float`` and ``isLargerBetter()``."""

    def evaluate(self, dataset: Any) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True


class RegressionEvaluator(Evaluator):
    """metricName: rmse (default) | mse | mae | r2."""

    metricName = Param("_", "metricName", "rmse|mse|mae|r2", toString)
    labelCol = Param("_", "labelCol", "label column name", toString)
    predictionCol = Param("_", "predictionCol", "prediction column name", toString)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(metricName="rmse", labelCol="label", predictionCol="prediction")

    def setMetricName(self, v: str):
        if v not in ("rmse", "mse", "mae", "r2"):
            raise ValueError(f"metricName must be rmse|mse|mae|r2, got {v!r}")
        return self.set(self.metricName, v)

    def setLabelCol(self, v: str):
        return self.set(self.labelCol, v)

    def setPredictionCol(self, v: str):
        return self.set(self.predictionCol, v)

    def getMetricName(self) -> str:
        return self.getOrDefault(self.metricName)

    def isLargerBetter(self) -> bool:
        return self.getMetricName() == "r2"

    def evaluate(self, dataset: Any) -> float:
        dev = _device_pair(dataset)
        if dev is not None:
            y, p = dev
            dt = torch.promote_types(y.dtype, p.dtype)
            values = torch.stack(regression_metrics_device(y.to(dt), p.to(dt))).tolist()
            return float(dict(zip(("rmse", "mse", "mae", "r2"), values))[self.getMetricName()])
        y, p = _pair(dataset, self.getOrDefault(self.labelCol), self.getOrDefault(self.predictionCol))
        err = y - p
        metric = self.getMetricName()
        if metric == "rmse":
            return float(np.sqrt(np.mean(err ** 2)))
        if metric == "mse":
            return float(np.mean(err ** 2))
        if metric == "mae":
            return float(np.mean(np.abs(err)))
        ss_res = float(np.sum(err ** 2))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0


class MulticlassClassificationEvaluator(Evaluator):
    """metricName: f1 (default, as in Spark) | accuracy | weightedPrecision
    | weightedRecall."""

    metricName = Param("_", "metricName", "accuracy|f1|weightedPrecision|weightedRecall", toString)
    labelCol = Param("_", "labelCol", "label column name", toString)
    predictionCol = Param("_", "predictionCol", "prediction column name", toString)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(metricName="f1", labelCol="label", predictionCol="prediction")

    def setMetricName(self, v: str):
        if v not in ("accuracy", "f1", "weightedPrecision", "weightedRecall"):
            raise ValueError(f"unknown metricName {v!r}")
        return self.set(self.metricName, v)

    def setLabelCol(self, v: str):
        return self.set(self.labelCol, v)

    def setPredictionCol(self, v: str):
        return self.set(self.predictionCol, v)

    def getMetricName(self) -> str:
        return self.getOrDefault(self.metricName)

    def evaluate(self, dataset: Any) -> float:
        dev = _device_pair(dataset)
        if dev is not None:
            y_d, p_d = dev
            # The bincount needs small non-negative integer labels; anything
            # else takes the host route with the original columns.
            integral, lo, hi = _multiclass_gate_probe(y_d, p_d)
            if integral and lo >= 0 and hi < 4096:
                return multiclass_metrics_device(y_d, p_d, int(hi) + 1)[self.getMetricName()]
        y, p = _pair(dataset, self.getOrDefault(self.labelCol), self.getOrDefault(self.predictionCol))
        metric = self.getMetricName()
        if metric == "accuracy":
            return float(np.mean(y == p))
        classes, counts = np.unique(y, return_counts=True)
        weights = counts / counts.sum()
        precisions, recalls, f1s = [], [], []
        for c in classes:
            tp = np.sum((p == c) & (y == c))
            fp = np.sum((p == c) & (y != c))
            fn = np.sum((p != c) & (y == c))
            prec = tp / (tp + fp) if tp + fp > 0 else 0.0
            rec = tp / (tp + fn) if tp + fn > 0 else 0.0
            precisions.append(prec)
            recalls.append(rec)
            f1s.append(2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0)
        if metric == "weightedPrecision":
            return float(np.dot(weights, precisions))
        if metric == "weightedRecall":
            return float(np.dot(weights, recalls))
        return float(np.dot(weights, f1s))


class BinaryClassificationEvaluator(Evaluator):
    """metricName: areaUnderROC (default) | areaUnderPR. The score of a
    row comes from ``rawPredictionCol``: the positive-class (last)
    component of a vector-valued column, or the value itself."""

    metricName = Param("_", "metricName", "areaUnderROC|areaUnderPR", toString)
    labelCol = Param("_", "labelCol", "label column name", toString)
    rawPredictionCol = Param("_", "rawPredictionCol", "score column name", toString)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(metricName="areaUnderROC", labelCol="label", rawPredictionCol="rawPrediction")

    def setMetricName(self, v: str):
        if v not in ("areaUnderROC", "areaUnderPR"):
            raise ValueError(f"unknown metricName {v!r}")
        return self.set(self.metricName, v)

    def setLabelCol(self, v: str):
        return self.set(self.labelCol, v)

    def setRawPredictionCol(self, v: str):
        return self.set(self.rawPredictionCol, v)

    def getMetricName(self) -> str:
        return self.getOrDefault(self.metricName)

    def _scores(self, dataset: Any) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(dataset, tuple) and len(dataset) == 2:
            y, s = dataset
            return to_host(y, np.float64).ravel(), to_host(s, np.float64).ravel()
        y = np.asarray(_column(dataset, self.getOrDefault(self.labelCol)).tolist(), dtype=np.float64).ravel()
        raw = _column(dataset, self.getOrDefault(self.rawPredictionCol))
        if np.ndim(raw[0]) >= 1:  # vector-valued: positive class = last component
            s = np.asarray([np.asarray(r, dtype=np.float64)[-1] for r in raw])
        else:
            s = np.asarray(raw.tolist(), dtype=np.float64)
        return y, s

    def evaluate(self, dataset: Any) -> float:
        dev = _device_pair(dataset)
        if dev is not None:
            return float(binary_auc_device(*dev, metric=self.getMetricName()))
        y, s = self._scores(dataset)
        order = np.argsort(-s, kind="stable")
        y_sorted = y[order]
        s_sorted = s[order]
        n_pos = float(np.sum(y_sorted == 1))
        n_neg = float(len(y_sorted) - n_pos)
        if n_pos == 0 or n_neg == 0:
            return 0.0
        tp = np.cumsum(y_sorted == 1)
        fp = np.cumsum(y_sorted == 0)
        # One curve point per distinct threshold; the trapezoid then runs
        # diagonally through ties, whatever their row order.
        distinct = np.concatenate([s_sorted[1:] != s_sorted[:-1], [True]])
        tp = tp[distinct]
        fp = fp[distinct]
        if self.getMetricName() == "areaUnderROC":
            tpr = np.concatenate([[0.0], tp / n_pos])
            fpr = np.concatenate([[0.0], fp / n_neg])
            return float(_trapezoid(tpr, fpr))
        precision = np.concatenate([[1.0], tp / np.maximum(tp + fp, 1)])
        recall = np.concatenate([[0.0], tp / n_pos])
        return float(_trapezoid(precision, recall))


__all__ = [
    "Evaluator",
    "RegressionEvaluator",
    "BinaryClassificationEvaluator",
    "MulticlassClassificationEvaluator",
]
