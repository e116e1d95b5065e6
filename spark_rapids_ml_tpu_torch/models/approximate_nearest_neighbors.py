"""ApproximateNearestNeighbors estimator/model — port of the reference's
``models/approximate_nearest_neighbors.py``.

Param surface of the RAPIDS Spark-ML ``ApproximateNearestNeighbors``:
``k``, ``algorithm`` (``ivfflat``, the default, | ``ivfpq`` | ``brute`` |
``brute_approx``), ``algoParams`` (``nlist``, ``nprobe``, ``kmeans_iters``,
``M``, ``n_bits``, ``pq_iters``, ``refine_ratio``), ``metric``,
``inputCol``, ``idCol``, ``seed``. The inverted lists are
``ops/ann.py``'s dense tensors; ``brute`` is the exact search of
``ops/knn.py``, and so is ``brute_approx`` on every device of the port
(ROADMAP C). ``cosine`` L2-normalizes items and queries and halves the
squared euclidean distance.

Defaults as in the reference: ``nlist`` ≈ √n, ``nprobe`` = nlist / 8,
``M`` ≈ d / 4 nudged down to a divisor of d (an explicit ``M`` must
divide d). ``ivfpq`` with ``refine_ratio`` r > 1 fetches k·r candidates
by the quantized distance and re-ranks them exactly
(:func:`_refine_exact`).

Items and queries as in ``NearestNeighbors``: a tensor stays where it
lives (an IVF build copies it to the host once, for the list packing),
host items are kept on the host; queries compute in float32 for host
input and in their own float32 or float64 for a tensor, on their device,
and come back as numpy or tensors. A port-built index lives where it was
built and is cast to the queries' device and dtype once. Because the
quantizer's draws differ from JAX's, a port-built index is not the
reference's for the same seed; ``interop.approximate_nearest_neighbors_model_from_numpy``
carries the reference's index across.

A re-iterable stream becomes a streamed brute index (``brute`` /
``brute_approx`` only), which neither pickles nor saves. Persistence
saves the items (and ids); the index is rebuilt from ``seed`` at the first
``kneighbors`` after a load.

With a mesh (``ApproximateNearestNeighbors(mesh=...)`` or ``setMesh`` on
the model) the IVF build shards its rows over the data axis
(``ops/ann.py``), an IVF search splits the queries over it
(:func:`ops.ann.ann_search_sharded`), and ``brute`` / ``brute_approx``
search the items placed over it once (:func:`ops.knn.shard_items`,
:func:`ops.knn.knn_sharded`), ``refine_ratio`` re-ranking as on one
device. In a gang every process fits the whole item matrix and passes the
same queries (the reference's contract, not checked): ``brute`` and
``brute_approx`` run there and every rank returns the same neighbours;
the IVF build and the mesh IVF search raise ``NotImplementedError``,
because the reference's own IVF routes fail in a gang (``ops/ann.py``).
A streamed index refuses a mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import (
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
    save_metadata,
    save_rows,
)
from spark_rapids_ml_tpu_torch.models.nearest_neighbors import (
    ONE_SHOT_MESSAGE,
    STREAM_MESH_MESSAGE,
    STREAM_PICKLE_MESSAGE,
    STREAM_SAVE_MESSAGE,
    extract_ids,
    item_columns,
    load_items,
    query_rows,
    results_out,
    with_neighbour_columns,
)
from spark_rapids_ml_tpu_torch.ops.ann import (
    IVFIndex,
    IVFPQIndex,
    ann_search_sharded,
    build_ivf_index,
    build_ivfpq_index,
    dispatch_search,
    index_to,
)
from spark_rapids_ml_tpu_torch.ops.knn import (
    METRICS,
    _smallest_k,
    knn,
    knn_host_streamed,
    knn_sharded,
    shard_items,
    unit_rows,
)
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

_ALGORITHMS = ("ivfflat", "ivfpq", "brute", "brute_approx")
_ALGO_PARAMS = {"nlist", "nprobe", "kmeans_iters", "M", "n_bits", "pq_iters", "refine_ratio"}


def _refine_exact(q: torch.Tensor, items: torch.Tensor, cand_idx: torch.Tensor, k: int,
                  block_q: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank candidates by their exact squared distances, ``block_q``
    queries at a time (a (Bq, k', d) gather each). -1 slots stay at +inf.
    Returns ascending (d2 (nq, k), idx (nq, k)), ties to the lower
    candidate position."""
    out_d, out_i = [], []
    for s in range(0, int(q.shape[0]), block_q):
        qb, cb = q[s:s + block_q], cand_idx[s:s + block_q]
        diff = qb[:, None, :] - items[torch.clamp_min(cb, 0).long()]
        d2 = torch.sum(diff * diff, dim=2)
        d2 = torch.where(cb >= 0, d2, torch.full_like(d2, float("inf")))
        pos = _smallest_k(d2, k)
        out_d.append(torch.gather(d2, 1, pos))
        out_i.append(torch.gather(cb, 1, pos))
    return torch.cat(out_d), torch.cat(out_i)


class _ANNParams(Params):
    k = Param("_", "k", "number of neighbors", lambda v: gt(0)(toInt(v)))
    algorithm = Param("_", "algorithm", "ivfflat | ivfpq | brute | brute_approx", toString)
    algoParams = Param(
        "_", "algoParams", "algorithm tuning dict, e.g. {'nlist': 50, 'nprobe': 20}",
        lambda v: dict(v) if v is not None else {},
    )
    metric = Param("_", "metric", "euclidean, sqeuclidean, or cosine", toString)
    inputCol = Param("_", "inputCol", "features column name", toString)
    idCol = Param("_", "idCol", "optional row-id column name", toString)
    seed = Param("_", "seed", "quantizer random seed", toInt)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(
            k=5, algorithm="ivfflat", algoParams={}, metric="euclidean",
            inputCol="features", seed=0,
        )

    def getK(self) -> int:
        return self.getOrDefault(self.k)

    def getAlgorithm(self) -> str:
        return self.getOrDefault(self.algorithm)

    def getAlgoParams(self) -> Dict[str, Any]:
        return self.getOrDefault(self.algoParams)

    def getMetric(self) -> str:
        return self.getOrDefault(self.metric)

    def getInputCol(self) -> str:
        return self.getOrDefault(self.inputCol)

    def getIdCol(self) -> Optional[str]:
        return self.getOrDefault(self.idCol) if self.isDefined(self.idCol) else None

    def getSeed(self) -> int:
        return self.getOrDefault(self.seed)


class ApproximateNearestNeighbors(_ANNParams, Estimator, MLReadable):
    """``ApproximateNearestNeighbors().setK(8).setAlgoParams({"nlist": 64,
    "nprobe": 8}).fit(items).kneighbors(queries)``."""

    def __init__(self, uid: Optional[str] = None, mesh=None):
        super().__init__(uid)
        self.mesh = mesh

    def setMesh(self, mesh) -> "ApproximateNearestNeighbors":
        self.mesh = mesh
        return self

    def setK(self, value: int) -> "ApproximateNearestNeighbors":
        self.set(self.k, value)
        return self

    def setAlgorithm(self, value: str) -> "ApproximateNearestNeighbors":
        if value not in _ALGORITHMS:
            raise ValueError(f"algorithm must be one of {_ALGORITHMS}, got {value!r}")
        self.set(self.algorithm, value)
        return self

    def setAlgoParams(self, value: Dict[str, Any]) -> "ApproximateNearestNeighbors":
        unknown = set(value) - _ALGO_PARAMS
        if unknown:
            raise ValueError(f"unknown algoParams {sorted(unknown)}; known: {sorted(_ALGO_PARAMS)}")
        self.set(self.algoParams, value)
        return self

    def setMetric(self, value: str) -> "ApproximateNearestNeighbors":
        if value not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}, got {value!r}")
        self.set(self.metric, value)
        return self

    def setInputCol(self, value: str) -> "ApproximateNearestNeighbors":
        self.set(self.inputCol, value)
        return self

    def setIdCol(self, value: str) -> "ApproximateNearestNeighbors":
        self.set(self.idCol, value)
        return self

    def setSeed(self, value: int) -> "ApproximateNearestNeighbors":
        self.set(self.seed, value)
        return self

    def _fit(self, dataset: Any) -> "ApproximateNearestNeighborsModel":
        """Index the item set (the IVF algorithms build their index here);
        a re-iterable stream becomes a streamed brute index."""
        if is_streaming_source(dataset):
            if not is_reiterable_stream(dataset):
                raise ValueError(ONE_SHOT_MESSAGE.format(what="ANN"))
            if self.getAlgorithm() not in ("brute", "brute_approx"):
                raise ValueError(
                    "streamed indexes support brute/brute_approx only — "
                    "inverted lists are resident structures (use ivfpq "
                    "for compressed residency)"
                )
            if self.mesh is not None:
                raise ValueError(STREAM_MESH_MESSAGE)
            return self._copyValues(ApproximateNearestNeighborsModel(self.uid, items_stream=dataset))
        id_col = self.getIdCol()
        items = matrix_like(extract_features(dataset, self.getInputCol(), drop=id_col))
        ids = extract_ids(dataset, id_col)
        if self.getK() > items.shape[0]:
            raise ValueError(f"k={self.getK()} exceeds item count {items.shape[0]}")
        model = self._copyValues(ApproximateNearestNeighborsModel(self.uid, items, ids, mesh=self.mesh))
        if model.getAlgorithm() in ("ivfflat", "ivfpq"):
            with TraceRange("ann build index", TraceColor.YELLOW):
                model._build_index()
        return model


class ApproximateNearestNeighborsModel(_ANNParams, Model, LazyHostState):
    """Indexed item set; ``kneighbors`` probes the IVF lists (or runs the
    exact search for the brute algorithms)."""

    _lazy_host_fields = {"_items_raw": ("_items_np", None)}
    _pickle_clear = ("_items_dev", "_index", "_index_cast", "_sharded_brute")

    def __init__(
        self,
        uid: Optional[str] = None,
        items: Any = None,
        ids: Optional[np.ndarray] = None,
        mesh=None,
        items_stream=None,
    ):
        super().__init__(uid)
        self.mesh = mesh
        self._items_stream = items_stream
        self._items_raw = items if items is None or is_device_array(items) else np.asarray(items)
        self._items_np: Optional[np.ndarray] = None
        self.ids = None if ids is None else np.asarray(ids)
        self._index: Optional[IVFIndex | IVFPQIndex] = None
        self._index_cast = None  # (device, dtype, index) for the queries' device
        self._items_dev = None  # (device, dtype, items) for the exact searches
        self._sharded_brute = None  # (dtype, (item blocks, mask blocks)) on the mesh

    def __getstate__(self):
        if self._items_stream is not None:
            raise ValueError(STREAM_PICKLE_MESSAGE)
        return super().__getstate__()

    @property
    def items(self) -> Optional[np.ndarray]:
        return self._lazy_host_view("_items_raw")

    def setMesh(self, mesh) -> "ApproximateNearestNeighborsModel":
        self.mesh = mesh
        self._sharded_brute = None
        return self

    def _effective_nlist(self) -> int:
        n = int(self._items_raw.shape[0])
        nlist = self.getAlgoParams().get("nlist")
        if nlist is None:
            nlist = max(1, int(np.sqrt(n)))
        return min(int(nlist), n)

    def _effective_nprobe(self, n_lists: int) -> int:
        nprobe = self.getAlgoParams().get("nprobe")
        if nprobe is None:
            nprobe = max(1, n_lists // 8)
        return min(int(nprobe), n_lists)

    def _effective_m(self, d: int) -> int:
        m = self.getAlgoParams().get("M")
        if m is not None:
            # An explicit M must divide d: build_ivfpq_index raises for it.
            return int(m)
        m = max(1, d // 4)
        while m > 1 and d % m != 0:
            m -= 1
        return m

    def _build_items(self) -> torch.Tensor:
        """The items the index is built from: a tensor where it lives, in
        its float32 or float64; host items in float32 on
        :func:`device.resolve_device`. Normalized under cosine."""
        raw = self._items_raw
        if is_device_array(raw):
            items = raw if raw.dtype in (torch.float32, torch.float64) else raw.to(default_dtype())
        else:
            host = np.ascontiguousarray(raw, dtype=numpy_dtype(default_dtype()))
            items = torch.from_numpy(host).to(_device.resolve_device())
        return unit_rows(items) if self.getMetric() == "cosine" else items

    def _build_index(self) -> None:
        params = self.getAlgoParams()
        items = self._build_items()
        common = dict(
            n_lists=self._effective_nlist(),
            seed=self.getSeed(),
            kmeans_iters=int(params.get("kmeans_iters", 10)),
        )
        if self.getAlgorithm() == "ivfpq":
            self._index = build_ivfpq_index(
                items,
                m_subspaces=self._effective_m(int(items.shape[1])),
                n_bits=int(params.get("n_bits", 8)),
                pq_iters=int(params.get("pq_iters", 10)),
                mesh=self.mesh,
                **common,
            )
        else:
            self._index = build_ivf_index(items, mesh=self.mesh, **common)
        self._index_cast = None

    def _index_on(self, device: torch.device, dtype: torch.dtype):
        """The index on the queries' device in their dtype, cast once."""
        if self._index is None:
            self._build_index()
        if self._index.centroids.device == device and self._index.centroids.dtype == dtype:
            return self._index
        cached = self._index_cast
        if cached is None or cached[0] != device or cached[1] != dtype:
            cached = (device, dtype, index_to(self._index, device, dtype))
            self._index_cast = cached
        return cached[2]

    def _search_items_on(self, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """The (normalized) items for the exact searches, on the queries'
        device in their dtype, made once."""
        cached = self._items_dev
        if cached is None or cached[0] != device or cached[1] != dtype:
            raw = self._items_raw
            if is_device_array(raw):
                items = raw.to(device=device, dtype=dtype)
            else:
                items = torch.from_numpy(np.ascontiguousarray(raw, dtype=numpy_dtype(dtype))).to(device)
            if self.getMetric() == "cosine":
                items = unit_rows(items)
            cached = (device, dtype, items)
            self._items_dev = cached
        return cached[2]

    def kneighbors(self, queries: Any, k: Optional[int] = None) -> Tuple[Any, Any]:
        """(distances (nq, k), indices (nq, k) int32) under the metric.
        When the probed lists hold fewer than k items the unfilled slots
        are (inf, -1); raise nprobe or nlist to avoid them."""
        if self._items_stream is not None:
            return self._kneighbors_streamed(queries, k)
        if self._items_raw is None:
            raise RuntimeError("model has no indexed items")
        n_items = int(self._items_raw.shape[0])
        k = self.getK() if k is None else k
        if not 1 <= k <= n_items:
            raise ValueError(f"k must be in [1, {n_items}], got {k}")
        metric = self.getMetric()
        q, device_q = query_rows(queries, self.getInputCol(), self.getIdCol())
        if metric == "cosine":
            q = unit_rows(q)
        with TraceRange("ann search", TraceColor.PURPLE):
            approx = self.getAlgorithm() == "brute_approx"
            if self.getAlgorithm() in ("brute", "brute_approx") and self.mesh is not None:
                xs, mask = self._sharded_search_items(q.dtype)
                d2, idx = knn_sharded(q, xs, mask, self.mesh, k=k, approx=approx)
            elif self.getAlgorithm() in ("brute", "brute_approx"):
                d2, idx = knn(q, self._search_items_on(q.device, q.dtype), k=k, metric="sqeuclidean",
                              approx=approx)
            else:
                index = self._index_on(q.device, q.dtype)
                n_probe = self._effective_nprobe(index.n_lists)
                if self.mesh is not None:
                    def search(ix, qs, kk, npr):
                        return ann_search_sharded(self.mesh, ix, qs, kk, npr)
                else:
                    search = dispatch_search(index)
                if isinstance(index, IVFPQIndex):
                    # Over-fetch by the quantized distance, then re-rank the
                    # shortlist exactly (FAISS IndexRefineFlat, cuML refine_ratio).
                    ratio = int(self.getAlgoParams().get("refine_ratio", 1))
                    k_fetch = min(max(k * max(ratio, 1), k), n_items)
                    d2, idx = search(index, q, k_fetch, n_probe)
                    if k_fetch > k:
                        d2, idx = _refine_exact(q, self._search_items_on(q.device, q.dtype), idx, k)
                else:
                    d2, idx = search(index, q, k, n_probe)
        if metric == "euclidean":
            d2 = torch.sqrt(d2)
        elif metric == "cosine":
            d2 = d2 / 2.0
        return results_out(d2, idx, device_q)

    def _sharded_search_items(self, dtype: torch.dtype):
        """The (normalized) search items over the mesh in the queries'
        dtype, placed once per dtype."""
        if self._sharded_brute is None or self._sharded_brute[0] != dtype:
            raw = self._items_raw
            src = raw if is_device_array(raw) else np.asarray(raw)
            metric = "cosine" if self.getMetric() == "cosine" else "sqeuclidean"
            self._sharded_brute = (dtype, shard_items(src, self.mesh, metric=metric, dtype=dtype))
        return self._sharded_brute[1]

    def _kneighbors_streamed(self, queries: Any, k: Optional[int]):
        """One pass over the streamed item blocks with a running top-k."""
        k = self.getK() if k is None else k
        metric = self.getMetric()
        q, device_q = query_rows(queries, self.getInputCol(), self.getIdCol())
        with TraceRange("ann streamed search", TraceColor.PURPLE):
            d, idx = knn_host_streamed(
                q, iter_stream_blocks(self._items_stream), k=k,
                metric="cosine" if metric == "cosine" else "sqeuclidean",
                approx=self.getAlgorithm() == "brute_approx",
            )
            if metric == "euclidean":
                d = torch.sqrt(d)
        return results_out(d, idx, device_q)

    def kneighbors_ids(self, queries: Any, k: Optional[int] = None):
        """(distances, ids) mapped through the fitted idCol; -1 slots stay -1."""
        d, idx = self.kneighbors(queries, k)
        if self.ids is None:
            return d, idx
        idx = to_host(idx)
        return d, np.where(idx >= 0, self.ids[np.clip(idx, 0, None)], -1)

    def transform(self, dataset: Any) -> Any:
        """Append the ``ann_indices`` and ``ann_distances`` columns to a
        DataFrame shim or pandas frame; anything else gets (d, idx)."""
        d, idx = self.kneighbors(dataset)
        return with_neighbour_columns(dataset, d, idx, "ann")

    def _save_impl(self, path: str) -> None:
        if self._items_stream is not None:
            raise ValueError(STREAM_SAVE_MESSAGE)
        save_metadata(
            self,
            path,
            class_name="com.nvidia.rapids.ml.ApproximateNearestNeighborsModel",
            extra_metadata={"hasIds": self.ids is not None},
        )
        save_rows(path, item_columns(self.items, self.ids))

    @classmethod
    def _load_impl(cls, path: str) -> "ApproximateNearestNeighborsModel":
        metadata = load_metadata(path, expected_class="ApproximateNearestNeighborsModel")
        items, ids = load_items(path, metadata)
        model = cls(metadata["uid"], items, ids)
        get_and_set_params(model, metadata)
        # The index is rebuilt at the first kneighbors, from the saved seed.
        return model
