"""NearestNeighbors estimator/model — port of the reference's
``models/nearest_neighbors.py``: exact brute-force kNN.

Param surface of the RAPIDS Spark-ML ``NearestNeighbors``: ``k``,
``inputCol``, ``idCol``, ``metric`` (``euclidean`` | ``sqeuclidean`` |
``cosine``). ``fit`` indexes the item set; ``kneighbors(queries)`` returns
(distances, indices), and ``kneighbors_ids`` maps the indices through
``idCol``. A model saved by either package loads in the other.

A tensor is indexed where it lives; a host item set is kept on the host
and copied once to the device its queries compute on. Queries compute in
the port's dtype (``core/ingest.default_dtype``): a host query block in
float32, a tensor in its own float32 or float64 (the reference casts both
sides to float64 under x64). Host queries go to
:func:`device.resolve_device` and come back as numpy; tensor queries
compute where they live and come back as tensors there. Indices are
int32.

A re-iterable stream (an iterator factory or a block reader) becomes a
streamed index: each ``kneighbors`` streams the blocks through
:func:`ops.knn.knn_host_streamed`, so the item count is bounded by the
source, not by device memory. Such a model neither pickles nor saves.

With a mesh (``NearestNeighbors(mesh=...)`` or ``setMesh`` on the
model) the first ``kneighbors`` places the items over the mesh's data axis
in the queries' dtype (:func:`ops.knn.shard_items`, cosine rows
normalized first) and keeps that upload, keyed by metric and dtype;
every search runs :func:`ops.knn.knn_sharded` on it, which returns the
single-device search's neighbours. In a gang (``setDeployMode("gang")``
or a ``global_mesh()``) every process fits the whole item matrix and
passes the same queries, as in the reference (not checked); each holds
its own positions' shards and every rank returns the same neighbours. A
streamed index refuses a mesh.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import (
    DataFrame,
    extract_features,
    is_device_array,
    is_reiterable_stream,
    is_streaming_source,
    iter_stream_blocks,
)
from spark_rapids_ml_tpu_torch.core.estimator import Estimator, Model
from spark_rapids_ml_tpu_torch.core.ingest import default_dtype, matrix_like, numpy_dtype
from spark_rapids_ml_tpu_torch.core.lazy_state import LazyHostState, to_host
from spark_rapids_ml_tpu_torch.core.params import Param, Params, gt, toInt, toString
from spark_rapids_ml_tpu_torch.core.persistence import (
    MLReadable,
    get_and_set_params,
    load_metadata,
    load_rows,
    save_metadata,
    save_rows,
)
from spark_rapids_ml_tpu_torch.ops.knn import METRICS, knn, knn_host_streamed, knn_sharded, shard_items
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

ONE_SHOT_MESSAGE = (
    "a streamed {what} index needs a RE-ITERABLE source (a zero-arg iterator "
    "factory or a block reader with .iter_blocks()), not a one-shot generator"
)
STREAM_MESH_MESSAGE = (
    "streamed indexes are single-device; use host partitions + a mesh for "
    "the sharded index"
)
STREAM_PICKLE_MESSAGE = (
    "a streamed-index model does not pickle (its items live in the external "
    "source); broadcast/persist the source instead"
)
STREAM_SAVE_MESSAGE = (
    "a streamed-index model does not persist (its items live in the external "
    "source); persist the source instead"
)


def extract_ids(dataset: Any, id_col: Optional[str]) -> Optional[np.ndarray]:
    """The ``idCol`` column of a DataFrame shim or pandas frame, or None
    when no id column is set; a set ``idCol`` the dataset lacks raises
    rather than leaving positional indices to pass for ids."""
    if id_col is None:
        return None
    if isinstance(dataset, DataFrame):
        if id_col in dataset.columns:
            return np.asarray(dataset.select(id_col))
    else:
        try:
            import pandas as pd
        except ImportError:  # pragma: no cover
            pd = None
        if pd is not None and isinstance(dataset, pd.DataFrame) and id_col in dataset.columns:
            return dataset[id_col].to_numpy()
    raise ValueError(f"idCol={id_col!r} set, but the dataset has no such column")


def query_rows(queries: Any, input_col: str, id_col: Optional[str]) -> Tuple[torch.Tensor, bool]:
    """``(queries as a tensor on their compute device, whether the caller
    passed a tensor)``: a tensor keeps its device and its float32 or
    float64 dtype; a host input goes to :func:`device.resolve_device` in
    :func:`core.ingest.default_dtype`."""
    q_in = matrix_like(extract_features(queries, input_col, drop=id_col))
    if is_device_array(q_in):
        q = q_in if q_in.dtype in (torch.float32, torch.float64) else q_in.to(default_dtype())
        _device.device_of(q)
        return q, True
    dtype = default_dtype()
    host = np.ascontiguousarray(q_in, dtype=numpy_dtype(dtype))
    return torch.from_numpy(host).to(_device.resolve_device()), False


def results_out(d: torch.Tensor, idx: torch.Tensor, device_q: bool):
    """Tensor queries get tensors back; host queries get numpy."""
    if device_q:
        return d, idx
    return d.cpu().numpy(), idx.cpu().numpy()


class _NearestNeighborsParams(Params):
    k = Param("_", "k", "number of neighbors", lambda v: gt(0)(toInt(v)))
    inputCol = Param("_", "inputCol", "features column name", toString)
    idCol = Param("_", "idCol", "optional row-id column name", toString)
    metric = Param("_", "metric", "euclidean, sqeuclidean, or cosine", toString)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(k=5, inputCol="features", metric="euclidean")

    def getK(self) -> int:
        return self.getOrDefault(self.k)

    def getInputCol(self) -> str:
        return self.getOrDefault(self.inputCol)

    def getIdCol(self) -> Optional[str]:
        return self.getOrDefault(self.idCol) if self.isDefined(self.idCol) else None

    def getMetric(self) -> str:
        return self.getOrDefault(self.metric)


class NearestNeighbors(_NearestNeighborsParams, Estimator, MLReadable):
    """``NearestNeighbors().setK(8).fit(items).kneighbors(queries)``."""

    def __init__(self, uid: Optional[str] = None, mesh=None):
        super().__init__(uid)
        self.mesh = mesh

    def setK(self, value: int) -> "NearestNeighbors":
        self.set(self.k, value)
        return self

    def setInputCol(self, value: str) -> "NearestNeighbors":
        self.set(self.inputCol, value)
        return self

    def setIdCol(self, value: str) -> "NearestNeighbors":
        self.set(self.idCol, value)
        return self

    def setMetric(self, value: str) -> "NearestNeighbors":
        if value not in METRICS:
            raise ValueError(f"metric must be euclidean/sqeuclidean/cosine, got {value!r}")
        self.set(self.metric, value)
        return self

    def setMesh(self, mesh) -> "NearestNeighbors":
        self.mesh = mesh
        return self

    def _fit(self, dataset: Any) -> "NearestNeighborsModel":
        """Index the item set: a tensor in place, host data as a float64
        host matrix; a re-iterable stream as a streamed index."""
        if is_streaming_source(dataset):
            if not is_reiterable_stream(dataset):
                raise ValueError(ONE_SHOT_MESSAGE.format(what="kNN"))
            if self.mesh is not None:
                raise ValueError(STREAM_MESH_MESSAGE)
            return self._copyValues(NearestNeighborsModel(self.uid, items_stream=dataset))
        id_col = self.getIdCol()
        items = matrix_like(extract_features(dataset, self.getInputCol(), drop=id_col))
        ids = extract_ids(dataset, id_col)
        if self.getK() > items.shape[0]:
            raise ValueError(f"k={self.getK()} exceeds item count {items.shape[0]}")
        return self._copyValues(NearestNeighborsModel(self.uid, items, ids, mesh=self.mesh))


class NearestNeighborsModel(_NearestNeighborsParams, Model, LazyHostState):
    """Indexed item set; ``kneighbors`` runs the blocked distance GEMM."""

    _lazy_host_fields = {"_items_raw": ("_items_np", None)}
    _pickle_clear = ("_items_dev", "_sharded")

    def __init__(
        self,
        uid: Optional[str] = None,
        items: Any = None,
        ids: Optional[np.ndarray] = None,
        mesh=None,
        items_stream=None,
    ):
        super().__init__(uid)
        self._items_raw = items if items is None or is_device_array(items) else np.asarray(items)
        self._items_np: Optional[np.ndarray] = None
        self.ids = None if ids is None else np.asarray(ids)
        self.mesh = mesh
        self._items_dev = None  # (device, dtype, tensor): the host items' copy
        self._sharded = None  # ((metric, dtype), (item blocks, mask blocks)) on the mesh
        self._items_stream = items_stream

    def __getstate__(self):
        if self._items_stream is not None:
            raise ValueError(STREAM_PICKLE_MESSAGE)
        return super().__getstate__()

    @property
    def items(self) -> Optional[np.ndarray]:
        return self._lazy_host_view("_items_raw")

    def setMesh(self, mesh) -> "NearestNeighborsModel":
        self.mesh = mesh
        self._sharded = None
        return self

    def _items_on(self, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """The items where the queries compute, in their dtype: a fitted
        tensor converted in place, host items copied once and cached."""
        raw = self._items_raw
        if is_device_array(raw):
            return raw.to(device=device, dtype=dtype)
        cached = self._items_dev
        if cached is None or cached[0] != device or cached[1] != dtype:
            host = np.ascontiguousarray(raw, dtype=numpy_dtype(dtype))
            cached = (device, dtype, torch.from_numpy(host).to(device))
            self._items_dev = cached
        return cached[2]

    def kneighbors(self, queries: Any, k: Optional[int] = None) -> Tuple[Any, Any]:
        """(distances (nq, k), indices (nq, k) int32): row positions in the
        fitted item set (``kneighbors_ids`` maps them through idCol)."""
        if self._items_stream is not None:
            return self._kneighbors_streamed(queries, k)
        if self._items_raw is None:
            raise RuntimeError("model has no indexed items")
        n_items = int(self._items_raw.shape[0])
        k = self.getK() if k is None else k
        if not 1 <= k <= n_items:
            raise ValueError(f"k must be in [1, {n_items}], got {k}")
        q, device_q = query_rows(queries, self.getInputCol(), self.getIdCol())
        metric = self.getMetric()
        with TraceRange("knn", TraceColor.PURPLE):
            if self.mesh is not None:
                xs, mask = self._sharded_items(metric, q.dtype)
                d, idx = knn_sharded(q, xs, mask, self.mesh, k=k, metric=metric)
            else:
                d, idx = knn(q, self._items_on(q.device, q.dtype), k=k, metric=metric)
        return results_out(d, idx, device_q)

    def _sharded_items(self, metric: str, dtype: torch.dtype):
        """The items over the mesh in the queries' dtype, placed once per
        metric and dtype (cosine rows are normalized in the upload)."""
        key = (metric, dtype)
        if self._sharded is None or self._sharded[0] != key:
            raw = self._items_raw
            src = raw if is_device_array(raw) else np.asarray(raw)
            self._sharded = (key, shard_items(src, self.mesh, metric=metric, dtype=dtype))
        return self._sharded[1]

    def _kneighbors_streamed(self, queries: Any, k: Optional[int]):
        """One pass over the streamed item blocks with a running top-k;
        k is checked against the streamed count."""
        k = self.getK() if k is None else k
        q, device_q = query_rows(queries, self.getInputCol(), self.getIdCol())
        with TraceRange("knn streamed", TraceColor.PURPLE):
            d, idx = knn_host_streamed(q, iter_stream_blocks(self._items_stream), k=k, metric=self.getMetric())
        return results_out(d, idx, device_q)

    def kneighbors_ids(self, queries: Any, k: Optional[int] = None):
        """(distances, ids): the indices mapped through the fitted idCol
        (host ids)."""
        d, idx = self.kneighbors(queries, k)
        if self.ids is None:
            return d, idx
        return d, self.ids[to_host(idx)]

    def transform(self, dataset: Any) -> Any:
        """Append the ``knn_indices`` and ``knn_distances`` columns to a
        DataFrame shim or pandas frame; anything else gets (d, idx)."""
        d, idx = self.kneighbors(dataset)
        return with_neighbour_columns(dataset, d, idx, "knn")

    def _save_impl(self, path: str) -> None:
        if self._items_stream is not None:
            raise ValueError(STREAM_SAVE_MESSAGE)
        save_metadata(
            self,
            path,
            class_name="com.nvidia.rapids.ml.NearestNeighborsModel",
            extra_metadata={"hasIds": self.ids is not None},
        )
        save_rows(path, item_columns(self.items, self.ids))

    @classmethod
    def _load_impl(cls, path: str) -> "NearestNeighborsModel":
        metadata = load_metadata(path, expected_class="NearestNeighborsModel")
        items, ids = load_items(path, metadata)
        model = cls(metadata["uid"], items, ids)
        get_and_set_params(model, metadata)
        return model


def with_neighbour_columns(dataset: Any, d, idx, prefix: str) -> Any:
    """``<prefix>_indices`` and ``<prefix>_distances`` appended to a
    DataFrame shim or a pandas frame (a copy); other inputs get (d, idx)."""
    if isinstance(dataset, DataFrame):
        out = dataset.withColumn(f"{prefix}_indices", list(idx))
        return out.withColumn(f"{prefix}_distances", list(d))
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover
        return d, idx
    if isinstance(dataset, pd.DataFrame):
        out = dataset.copy()
        out[f"{prefix}_indices"] = list(to_host(idx))
        out[f"{prefix}_distances"] = list(to_host(d))
        return out
    return d, idx


def item_columns(items: np.ndarray, ids: Optional[np.ndarray]) -> dict:
    """The saved data of a neighbour model: one ``item`` row per item,
    and its ``id`` where the model has ids."""
    cols = {"item": ("vector", [r for r in items])}
    if ids is not None:
        cols["id"] = ("scalar", ids.tolist())
    return cols


def load_items(path: str, metadata: dict):
    rows = load_rows(path)
    items = np.stack(rows["item"])
    ids = np.asarray(rows["id"]) if metadata.get("hasIds") else None
    return items, ids
