"""DBSCAN estimator/model — port of the reference's ``models/dbscan.py``.

Param surface of the cuML/spark-rapids-ml estimator, with the reference's
defaults: ``eps`` (0.5), ``minSamples`` (5, cuML's ``min_samples``),
``metric`` ("euclidean"), ``featuresCol``, ``predictionCol``.

DBSCAN is transductive: ``fit`` clusters the training rows and the model
carries their labels (``labels_``), the core mask (``core_mask_``) and the
rows. ``transform`` on the fitted rows returns those labels; on new rows
each point takes the cluster of its nearest core point within eps
(:func:`ops.knn.knn_sq_euclidean` with k = 1 against the core rows), else
noise (-1). A model saved by either package loads in the other.

Compute dtype: host input computes in **float64** on
:func:`device.resolve_device`, the reference's x64 behaviour, and a
tensor computes where it lives in its own floating dtype. This departs on
purpose from ``core/ingest.py::default_dtype`` (float32): the eps test
compares ‖q‖² − 2q·x + ‖x‖² with eps², a cancellation that float32 rounds
across the cut once the rows lie far from the origin. Labels and the core
mask come back to the host (numpy), as in the reference.

With a mesh (``DBSCAN(mesh=...)``, ``setMesh``, or ``setDeployMode("gang")``
at a world of one) the fit runs :func:`ops.dbscan.dbscan_labels_sharded`:
the query rows split over the data axis, the point set whole on every
position; labels and the core mask are the single-device fit's.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import DataFrame, extract_features, is_device_array
from spark_rapids_ml_tpu_torch.core.estimator import Estimator, Model
from spark_rapids_ml_tpu_torch.core.ingest import matrix_like
from spark_rapids_ml_tpu_torch.core.lazy_state import LazyHostState, to_host
from spark_rapids_ml_tpu_torch.core.params import Param, Params, gt, toFloat, toInt, toString
from spark_rapids_ml_tpu_torch.core.persistence import (
    MLReadable,
    get_and_set_params,
    load_metadata,
    load_rows,
    save_metadata,
    save_rows,
)
from spark_rapids_ml_tpu_torch.ops.dbscan import dbscan_labels, dbscan_labels_sharded, relabel_consecutive
from spark_rapids_ml_tpu_torch.ops.knn import knn_sq_euclidean
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange


def _rows_on_device(x: Any) -> torch.Tensor:
    """A tensor where it lives (an integral one as float64 there); host
    rows as float64 on :func:`device.resolve_device`."""
    if is_device_array(x):
        _device.device_of(x)
        return x if x.is_floating_point() else x.to(torch.float64)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float64)).to(_device.resolve_device())


class _DBSCANParams(Params):
    eps = Param("_", "eps", "neighborhood radius", lambda v: gt(0.0)(toFloat(v)))
    minSamples = Param(
        "_", "minSamples", "min points (incl. self) within eps for a core point",
        lambda v: gt(0)(toInt(v)),
    )
    metric = Param("_", "metric", "distance metric (euclidean)", toString)
    featuresCol = Param("_", "featuresCol", "features column name", toString)
    predictionCol = Param("_", "predictionCol", "prediction column name", toString)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(
            eps=0.5,
            minSamples=5,
            metric="euclidean",
            featuresCol="features",
            predictionCol="prediction",
        )

    def getEps(self) -> float:
        return self.getOrDefault(self.eps)

    def getMinSamples(self) -> int:
        return self.getOrDefault(self.minSamples)

    def getMetric(self) -> str:
        return self.getOrDefault(self.metric)

    def getFeaturesCol(self) -> str:
        return self.getOrDefault(self.featuresCol)

    def getPredictionCol(self) -> str:
        return self.getOrDefault(self.predictionCol)


class DBSCAN(_DBSCANParams, Estimator, MLReadable):
    """``DBSCAN().setEps(0.3).setMinSamples(10).fit(x)``."""

    def __init__(self, uid: Optional[str] = None, mesh=None):
        super().__init__(uid)
        self.setMesh(mesh)

    def setEps(self, value: float) -> "DBSCAN":
        self.set(self.eps, value)
        return self

    def setMinSamples(self, value: int) -> "DBSCAN":
        self.set(self.minSamples, value)
        return self

    def setMetric(self, value: str) -> "DBSCAN":
        if value != "euclidean":
            raise ValueError(f"only 'euclidean' is supported, got {value!r}")
        self.set(self.metric, value)
        return self

    def setFeaturesCol(self, value: str) -> "DBSCAN":
        self.set(self.featuresCol, value)
        return self

    def setPredictionCol(self, value: str) -> "DBSCAN":
        self.set(self.predictionCol, value)
        return self

    def setMesh(self, mesh) -> "DBSCAN":
        self.mesh = mesh
        return self

    def fit(self, dataset: Any) -> "DBSCANModel":
        """Cluster the rows: a tensor where it lives, host rows in float64
        on the platform's device; over the mesh when one is set. Overrides
        ``fit`` (not ``_fit``), as the reference does, so a gang fit
        (``deployMode="gang"``) joins the gang here."""
        if self.getDeployMode() == "gang":
            self._join_gang()
        x = matrix_like(extract_features(dataset, self.getFeaturesCol()))
        xd = _rows_on_device(x)
        with TraceRange("dbscan fit", TraceColor.RED):
            if self.mesh is not None:
                labels, core = dbscan_labels_sharded(self.mesh, xd, self.getEps(), self.getMinSamples())
            else:
                labels, core = dbscan_labels(xd, self.getEps(), self.getMinSamples())
        model = DBSCANModel(
            self.uid,
            fitted=xd if is_device_array(x) else x,
            labels=relabel_consecutive(to_host(labels)),
            core_mask=to_host(core),
        )
        return self._copyValues(model)


class DBSCANModel(_DBSCANParams, Model, LazyHostState):
    """Fitted DBSCAN: the training rows, their labels and the core mask.
    Rows fitted from a tensor stay where they live; the host view
    ``fitted`` (float64) converts lazily, and pickling keeps host state."""

    _lazy_host_fields = {"_fitted_raw": ("_fitted_np", np.float64)}

    def __init__(
        self,
        uid: Optional[str] = None,
        fitted: Any = None,
        labels: Optional[np.ndarray] = None,
        core_mask: Optional[np.ndarray] = None,
    ):
        super().__init__(uid)
        self._fitted_raw = (
            fitted if fitted is None or is_device_array(fitted) else np.asarray(fitted, dtype=np.float64)
        )
        self._fitted_np: Optional[np.ndarray] = None
        self.labels_ = None if labels is None else np.asarray(labels, dtype=np.int32)
        self.core_mask_ = None if core_mask is None else np.asarray(core_mask, dtype=bool)

    @property
    def fitted(self) -> Optional[np.ndarray]:
        return self._lazy_host_view("_fitted_raw")

    @property
    def core_sample_indices_(self) -> np.ndarray:
        """Indices of the core points (cuML's ``core_sample_indices_``)."""
        return np.flatnonzero(self.core_mask_)

    def copy(self, extra=None) -> "DBSCANModel":
        that = DBSCANModel(self.uid, self._fitted_raw, self.labels_, self.core_mask_)
        return self._copyValues(that, extra)

    def _predict_new(self, x: Any) -> np.ndarray:
        """Out of sample: the cluster of the nearest core point within eps.
        Only the core rows of a host-fitted model go to the device."""
        core_idx = self.core_sample_indices_
        if core_idx.size == 0:
            return np.full(x.shape[0], -1, dtype=np.int32)
        xq = _rows_on_device(x)
        raw = self._fitted_raw
        if is_device_array(raw):
            cores = raw[torch.from_numpy(core_idx).to(raw.device)].to(xq.device)
        else:
            cores = torch.from_numpy(np.ascontiguousarray(raw[core_idx])).to(xq.device)
        d, i = knn_sq_euclidean(xq.to(cores.dtype), cores, k=1)
        d = to_host(d)[:, 0]
        i = to_host(i)[:, 0]
        out = self.labels_[core_idx[i]]
        return np.where(d <= self.getEps() ** 2, out, -1).astype(np.int32)

    def _is_fitted_rows(self, x: Any) -> bool:
        fitted = self._fitted_raw
        if fitted is None or tuple(x.shape) != tuple(fitted.shape):
            return False
        if x is fitted:
            return True
        if is_device_array(x) and is_device_array(fitted) and x.device == fitted.device:
            common = torch.promote_types(x.dtype, fitted.dtype)
            return bool(torch.equal(x.to(common), fitted.to(common)))
        return bool(np.array_equal(to_host(x), to_host(fitted)))

    def transform(self, dataset: Any) -> Any:
        x = matrix_like(extract_features(dataset, self.getFeaturesCol()))
        if self._is_fitted_rows(x):
            pred = self.labels_
        else:
            with TraceRange("dbscan transform", TraceColor.GREEN):
                pred = self._predict_new(x)
        if isinstance(dataset, DataFrame):
            return dataset.withColumn(self.getPredictionCol(), list(pred))
        try:
            import pandas as pd
        except ImportError:  # pragma: no cover
            return pred
        if isinstance(dataset, pd.DataFrame):
            out = dataset.copy()
            out[self.getPredictionCol()] = list(pred)
            return out
        return pred

    # --- persistence ---

    def _save_impl(self, path: str) -> None:
        save_metadata(self, path, class_name="com.nvidia.spark.ml.clustering.DBSCANModel")
        save_rows(
            path,
            {
                "row": ("vector", [r for r in self.fitted.astype(np.float64)]),
                "label": ("scalar", [int(v) for v in self.labels_]),
                "core": ("scalar", [bool(v) for v in self.core_mask_]),
            },
        )

    @classmethod
    def _load_impl(cls, path: str) -> "DBSCANModel":
        metadata = load_metadata(path, expected_class="DBSCANModel")
        rows = load_rows(path)
        model = cls(
            metadata["uid"],
            fitted=np.stack(rows["row"]).astype(np.float64),
            labels=np.asarray(rows["label"], dtype=np.int32),
            core_mask=np.asarray(rows["core"], dtype=bool),
        )
        get_and_set_params(model, metadata)
        return model
