"""KMeans estimator/model — port of the reference's ``models/kmeans.py``.

Param surface of ``org.apache.spark.ml.clustering.KMeans``, name for name
and with the reference's defaults: ``k``, ``initMode`` ("k-means||" or
"random"), ``maxIter``, ``tol``, ``seed``, ``distanceMeasure``
("euclidean" | "cosine"), ``featuresCol``, ``predictionCol``,
``weightCol``, ``precision``, ``backend``. A model saved by either
package loads in the other (Spark's one-row-per-cluster layout).

``backend``: ``"xla"`` runs Lloyd in plain torch (``ops/kmeans.py``);
``"fused"`` runs it on the hand-written kernels K2 (``assign_stats_fused``)
or, for small d and k, K3 (``assign_stats_packed``); ``"auto"`` takes the
kernels where the reference would on a TPU — a CUDA tensor, float32, no
``weightCol``, ``fused_feasible`` and ``n·k ≥ _FUSED_AUTO_WORK`` — and
``"xla"`` otherwise. An explicit ``"fused"`` on a CPU tensor runs the
kernels' plain versions (the reference's ``interpret=True``).

"k-means||" is greedy k-means++ on the device, seeded from a
``torch.Generator`` (``seed``): it matches the reference in distribution,
not in bits.

A streaming source (an iterator factory or a block reader: Lloyd makes a
pass per iteration, so a one-shot generator is refused) fits at constant
memory on the ``xla`` route, whatever ``backend`` says, as in the
reference: seeding runs on a one-pass reservoir of max(4096, 4k) rows,
then :func:`~spark_rapids_ml_tpu_torch.ops.kmeans.lloyd_streaming` in
float32.

A host input passes the fit memory guard (``core/membudget.py``): over
budget it reroutes to the streaming fit through a ``HostArrayBlockReader``
(bit-identical to an explicit one), and so does a device OOM mid-fit;
``weightCol`` and ``backend="fused"`` cannot stream, so they raise
``FitMemoryError`` instead.

Left out until their ROADMAP items: a mesh (A.7d) and
``serving_signature`` (A.7e) raise ``NotImplementedError``; the
checkpointed Lloyd (A.7b) is switched on by knobs the port does not read
yet, so no fit reaches it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import (
    DataFrame,
    extract_features,
    extract_weights,
    is_device_array,
    is_reiterable_stream,
    is_streaming_source,
    iter_stream_blocks,
    peek_stream_width,
)
from spark_rapids_ml_tpu_torch.core import membudget
from spark_rapids_ml_tpu_torch.core.estimator import Estimator, Model
from spark_rapids_ml_tpu_torch.core.ingest import default_dtype, matrix_like, numpy_dtype, prepare_rows
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
from spark_rapids_ml_tpu_torch.core.serving import DEFAULT_STREAM_BLOCK, serve_rows, serve_stream
from spark_rapids_ml_tpu_torch.ops.kernels.kmeans import fused_feasible, lloyd_fused, packed_feasible
from spark_rapids_ml_tpu_torch.ops.kmeans import (
    assign_clusters,
    kmeans_plusplus_init,
    lloyd,
    lloyd_streaming,
    normalize_rows,
    random_init,
    reservoir_sample_rows,
)
from spark_rapids_ml_tpu_torch.ops.precision import pallas_precision, resolve_policy, validate_mode
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

MESH_ITEM = "the mesh route of KMeans is not ported yet: ROADMAP A.7d"
SERVING_SIGNATURE_ITEM = "serving_signature is not ported yet: ROADMAP A.7e (with the serving slice)"


def _assign_kernel(x, centers, *, cosine: bool, precision: str = "highest"):
    """Serving kernel: nearest-center labels; centers follow the batch
    dtype and, under cosine, both sides are unit-normalized."""
    centers = centers.to(x.dtype)
    if cosine:
        x = normalize_rows(x)
        centers = normalize_rows(centers)
    labels, _ = assign_clusters(x, centers, precision=precision)
    return labels


class _KMeansParams(Params):
    k = Param("_", "k", "number of clusters", lambda v: gt(1)(toInt(v)))
    initMode = Param("_", "initMode", "initialization: k-means|| or random", toString)
    maxIter = Param("_", "maxIter", "maximum Lloyd iterations", toInt)
    tol = Param("_", "tol", "center-movement convergence tolerance", toFloat)
    seed = Param("_", "seed", "random seed", toInt)
    distanceMeasure = Param("_", "distanceMeasure", "euclidean or cosine", toString)
    featuresCol = Param("_", "featuresCol", "features column name", toString)
    predictionCol = Param("_", "predictionCol", "prediction column name", toString)
    weightCol = Param("_", "weightCol", "per-row weight column name", toString)
    precision = Param(
        "_", "precision",
        "matmul precision of the Lloyd products: highest/f32 (IEEE fp32, the "
        "default) | high/bf16x3 (3-pass bf16 split) | default/bf16 (1 bf16 pass)",
        toString,
    )
    backend = Param(
        "_", "backend",
        "Lloyd kernel: auto | fused (CUDA kernels K2/K3, no (n, k) temporaries) "
        "| xla (plain torch)",
        toString,
    )

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(
            k=2,
            initMode="k-means||",
            maxIter=20,
            tol=1e-4,
            seed=0,
            distanceMeasure="euclidean",
            featuresCol="features",
            predictionCol="prediction",
            precision="highest",
            backend="auto",
        )

    def getK(self) -> int:
        return self.getOrDefault(self.k)

    def getInitMode(self) -> str:
        return self.getOrDefault(self.initMode)

    def getMaxIter(self) -> int:
        return self.getOrDefault(self.maxIter)

    def getTol(self) -> float:
        return self.getOrDefault(self.tol)

    def getSeed(self) -> int:
        return self.getOrDefault(self.seed)

    def getDistanceMeasure(self) -> str:
        return self.getOrDefault(self.distanceMeasure)

    def getFeaturesCol(self) -> str:
        return self.getOrDefault(self.featuresCol)

    def getPredictionCol(self) -> str:
        return self.getOrDefault(self.predictionCol)

    def getWeightCol(self) -> Optional[str]:
        return self.getOrDefault(self.weightCol) if self.isDefined(self.weightCol) else None

    def getPrecision(self) -> str:
        return self.getOrDefault(self.precision)

    def getBackend(self) -> str:
        return self.getOrDefault(self.backend)


class KMeans(_KMeansParams, Estimator, MLReadable):
    """``KMeans().setK(8).fit(x)`` — Lloyd on the card."""

    def __init__(self, uid: Optional[str] = None, mesh=None):
        super().__init__(uid)
        self.mesh = mesh

    def setK(self, value: int) -> "KMeans":
        self.set(self.k, value)
        return self

    def setInitMode(self, value: str) -> "KMeans":
        if value not in ("k-means||", "random"):
            raise ValueError(f"initMode must be 'k-means||' or 'random', got {value!r}")
        self.set(self.initMode, value)
        return self

    def setMaxIter(self, value: int) -> "KMeans":
        self.set(self.maxIter, value)
        return self

    def setTol(self, value: float) -> "KMeans":
        self.set(self.tol, value)
        return self

    def setSeed(self, value: int) -> "KMeans":
        self.set(self.seed, value)
        return self

    def setDistanceMeasure(self, value: str) -> "KMeans":
        if value not in ("euclidean", "cosine"):
            raise ValueError(f"distanceMeasure must be 'euclidean' or 'cosine', got {value!r}")
        self.set(self.distanceMeasure, value)
        return self

    def setFeaturesCol(self, value: str) -> "KMeans":
        self.set(self.featuresCol, value)
        return self

    def setPredictionCol(self, value: str) -> "KMeans":
        self.set(self.predictionCol, value)
        return self

    def setWeightCol(self, value: str) -> "KMeans":
        self.set(self.weightCol, value)
        return self

    def setMesh(self, mesh) -> "KMeans":
        self.mesh = mesh
        return self

    def setPrecision(self, value: str) -> "KMeans":
        self.set(self.precision, validate_mode(value))
        return self

    def setBackend(self, value: str) -> "KMeans":
        """``"fused"`` computes in float32 (the kernels' type): an explicit
        request casts float64 input down; ``"auto"`` never does."""
        if value not in ("auto", "fused", "xla"):
            raise ValueError(f"backend must be auto/fused/xla, got {value!r}")
        self.set(self.backend, value)
        return self

    def setInitialModel(self, value) -> "KMeans":
        """Warm start from a model's centers (or a raw (k, d) array or
        tensor) instead of seeding; ``k`` must match at fit time."""
        centers = value.clusterCenters() if hasattr(value, "clusterCenters") else value
        centers = to_host(centers, np.float64)
        if centers.ndim != 2:
            raise ValueError("initial model/centers must be a (k, d) matrix")
        self._initial_centers = centers
        return self

    _initial_centers = None
    _copy_attrs = ("_initial_centers",)

    def _fit(self, dataset: Any) -> "KMeansModel":
        rows = extract_features(dataset, self.getFeaturesCol())
        w_host = extract_weights(dataset, self.getWeightCol())
        if is_streaming_source(rows):
            return self._fit_streaming(rows)
        if self.mesh is not None:
            raise NotImplementedError(MESH_ITEM)
        # Over budget, the input reroutes to the _fit_streaming an explicit
        # reader takes (bit-identical); a device OOM mid-fit takes the same
        # exit.
        return membudget.fit_within_budget(
            "kmeans", rows, lambda: self._fit_in_memory(rows, w_host), self._fit_streaming,
            can_stream=w_host is None and self.getBackend() != "fused",
            why_cannot_stream="the streaming KMeans path supports neither "
                              "weightCol nor backend='fused'",
            ledger_families=("kmeans",),
        )

    # Seeding reservoir of a streaming fit: large enough that k-means++ on
    # the sample seeds like k-means++ on the data.
    _STREAM_SAMPLE_CAP = 4096

    def _fit_streaming(self, rows) -> "KMeansModel":
        """A re-iterable block source: one data pass per Lloyd iteration at
        O(block + k·d) memory, seeded by k-means++ (or random) on a
        one-pass reservoir, or warm-started from the initial model."""
        if not is_reiterable_stream(rows):
            raise ValueError(
                "KMeans is multi-pass: a streaming fit needs a RE-ITERABLE "
                "source (a zero-arg iterator factory or a block reader with "
                ".iter_blocks()), not a one-shot generator"
            )
        if self.mesh is not None:
            raise ValueError(
                "streaming KMeans is single-device; pass host partitions "
                "for a mesh fit"
            )
        k = self.getK()
        cosine = self.getDistanceMeasure() == "cosine"
        dtype = default_dtype()
        device = _device.resolve_device()
        with TraceRange("kmeans stream fit", TraceColor.CYAN):
            if self._initial_centers is not None:
                # No sampling pass: check the width against one peeked block.
                if self._initial_centers.shape[0] != k:
                    raise ValueError(
                        f"initial model has {self._initial_centers.shape[0]} centers but k={k}"
                    )
                width = peek_stream_width(rows)
                if self._initial_centers.shape[1] != width:
                    raise ValueError(
                        f"initial centers have {self._initial_centers.shape[1]} features "
                        f"but the data has {width}"
                    )
                init = torch.tensor(self._initial_centers, dtype=dtype, device=device)
                if cosine:
                    init = normalize_rows(init)
            else:
                cap = max(self._STREAM_SAMPLE_CAP, 4 * k)
                sample, n_seen = reservoir_sample_rows(
                    iter_stream_blocks(rows), cap, self.getSeed(), dtype=numpy_dtype(dtype)
                )
                if k > n_seen:
                    raise ValueError(f"k={k} exceeds number of rows {n_seen}")
                xs = torch.from_numpy(sample).to(device)
                if cosine:
                    xs = normalize_rows(xs)
                mask = torch.ones(xs.shape[0], dtype=xs.dtype, device=device)
                gen = torch.Generator(device=device)
                gen.manual_seed(self.getSeed())
                if self.getInitMode() == "random":
                    init = random_init(xs, mask, gen, k)
                else:
                    init = kmeans_plusplus_init(xs, mask, gen, k)
            with TraceRange("kmeans lloyd stream", TraceColor.PURPLE):
                centers, cost, n_iter = lloyd_streaming(
                    lambda: iter_stream_blocks(rows),
                    init,
                    max_iter=self.getMaxIter(),
                    tol=self.getTol(),
                    precision=self._train_precision(),
                    cosine=cosine,
                    dtype=dtype,
                )
        model = KMeansModel(self.uid, centers, trainingCost=cost, numIter=n_iter)
        return self._copyValues(model)

    def _train_precision(self) -> str:
        """An explicit ``setPrecision`` wins, then ``TPUML_PRECISION_KMEANS``,
        then ``TPUML_PRECISION``, then the param's default (``highest``)."""
        requested = self.getPrecision() if self.isSet(self.precision) else None
        return resolve_policy("kmeans", requested, default=self.getPrecision())

    def _fit_in_memory(self, rows: Any, w_host) -> "KMeansModel":
        k = self.getK()
        cosine = self.getDistanceMeasure() == "cosine"
        precision = self._train_precision()
        with TraceRange("kmeans fit", TraceColor.CYAN):
            xs, mask, n, d = prepare_rows(rows, weights=w_host)
            if k > n:
                raise ValueError(f"k={k} exceeds number of rows {n}")
            if cosine:
                xs = normalize_rows(xs) * (mask > 0).to(xs.dtype)[:, None]
            gen = torch.Generator(device=xs.device)
            gen.manual_seed(self.getSeed())
            if self._initial_centers is not None:
                if self._initial_centers.shape[0] != k:
                    raise ValueError(
                        f"initial model has {self._initial_centers.shape[0]} centers but k={k}"
                    )
                if self._initial_centers.shape[1] != d:
                    raise ValueError(
                        f"initial centers have {self._initial_centers.shape[1]} features "
                        f"but the data has {d}"
                    )
                init = torch.tensor(self._initial_centers, dtype=xs.dtype, device=xs.device)
                if cosine:
                    init = normalize_rows(init)
            elif self.getInitMode() == "random":
                init = random_init(xs, mask, gen, k)
            else:
                init = kmeans_plusplus_init(xs, mask, gen, k)
            backend = self._resolve_backend(
                w_host, n * k, d=d, k=k, dtype=xs.dtype, device=xs.device
            )
            if backend == "fused":
                with TraceRange("kmeans lloyd fused", TraceColor.PURPLE):
                    centers, cost, n_iter = lloyd_fused(
                        xs.to(torch.float32).contiguous(),
                        init,
                        max_iter=self.getMaxIter(),
                        tol=self.getTol(),
                        precision=pallas_precision(precision),
                        cosine=cosine,
                        packed=packed_feasible(d, k),
                    )
            else:
                with TraceRange("kmeans lloyd", TraceColor.PURPLE):
                    centers, cost, n_iter = lloyd(
                        xs, mask, init, max_iter=self.getMaxIter(), tol=self.getTol(),
                        cosine=cosine, precision=precision,
                    )
        model = KMeansModel(self.uid, centers, trainingCost=cost, numIter=n_iter)
        return self._copyValues(model)

    #: Below this n·k the whole fit is small either way; the reference keeps
    #: such fits on its ``xla`` route, and so does the port.
    _FUSED_AUTO_WORK = 1 << 22

    def _resolve_backend(self, w_host, work: int, d: int = 1, k: int = 2, dtype=None,
                         device: Optional[torch.device] = None) -> str:
        """Pick the Lloyd route. "fused" needs uniform row weights and one
        device; an explicit request that cannot be honoured raises. "auto"
        takes the kernels for a large float32 fit on a CUDA tensor."""
        requested = self.getBackend()
        blockers = []
        if self.mesh is not None:
            blockers.append("a mesh")
        if w_host is not None:
            blockers.append("weightCol")
        if not fused_feasible(d, k):
            blockers.append(f"d={d} x k={k} (shared-memory residents exceed a block's 227 KB)")
        if requested == "fused":
            if blockers:
                raise ValueError("backend='fused' does not support " + ", ".join(blockers))
            return "fused"
        if dtype is not None and dtype != torch.float32:
            blockers.append(f"{dtype} input")
        if requested == "xla" or blockers:
            return "xla"
        if device is None or device.type != "cuda":
            return "xla"
        return "fused" if work >= self._FUSED_AUTO_WORK else "xla"


class KMeansModel(_KMeansParams, Model, LazyHostState):
    """Fitted model: ``clusterCenters()`` (k, d), prediction via
    ``predict``/``transform``. Fitted state may be tensors from a device
    fit; the host float64 views convert lazily."""

    _lazy_host_fields = {"_centers_raw": ("_centers_np", np.float64)}
    _pickle_clear = ("_centers_dev",)

    def __init__(
        self,
        uid: Optional[str] = None,
        clusterCenters=None,
        trainingCost=float("nan"),
        numIter=0,
    ):
        super().__init__(uid)
        self._centers_raw = clusterCenters
        self._centers_np: Optional[np.ndarray] = None
        self._centers_dev: Optional[dict] = None
        self._cost_raw = trainingCost
        self._iter_raw = numIter

    def __getstate__(self):
        state = super().__getstate__()
        state["_cost_raw"] = self.trainingCost
        state["_iter_raw"] = self.numIter
        return state

    @property
    def trainingCost(self) -> float:
        if not isinstance(self._cost_raw, float):
            self._cost_raw = float(self._cost_raw)
        return self._cost_raw

    @property
    def numIter(self) -> int:
        if not isinstance(self._iter_raw, int):
            self._iter_raw = int(self._iter_raw)
        return self._iter_raw

    def clusterCenters(self) -> Optional[np.ndarray]:
        return self._lazy_host_view("_centers_raw")

    def setFeaturesCol(self, value: str) -> "KMeansModel":
        self.set(self.featuresCol, value)
        return self

    def setPredictionCol(self, value: str) -> "KMeansModel":
        self.set(self.predictionCol, value)
        return self

    def _centers_on(self, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """Centers at ``dtype`` on ``device``, cached per (device, dtype);
        free when the fit left them there already."""
        raw = self._centers_raw
        if isinstance(raw, torch.Tensor) and raw.device == device and raw.dtype == dtype:
            return raw
        if self._centers_dev is None:
            self._centers_dev = {}
        key = (str(device), str(dtype))
        if key not in self._centers_dev:
            src = raw if isinstance(raw, torch.Tensor) else torch.tensor(self.clusterCenters())
            self._centers_dev[key] = src.to(device=device, dtype=dtype)
        return self._centers_dev[key]

    def _serving_precision(self) -> str:
        requested = self.getPrecision() if self.isSet(self.precision) else None
        return resolve_policy("serving", requested)

    def predict(self, x):
        """Nearest-center labels. A tensor is served where it lives and
        gets a tensor back; host input goes to the device block by block
        (float64) and comes back as numpy."""
        if self._centers_raw is None:
            raise RuntimeError("model has no cluster centers")
        x = matrix_like(x)
        static = {
            "cosine": self.getDistanceMeasure() == "cosine",
            "precision": self._serving_precision(),
        }
        if is_device_array(x):
            device = _device.device_of(x)
            return serve_rows(
                _assign_kernel, x, (self._centers_on(device, x.dtype),),
                static=static, name="kmeans.predict",
            )
        device = _device.resolve_device()
        blocks = [x[i:i + DEFAULT_STREAM_BLOCK] for i in range(0, x.shape[0], DEFAULT_STREAM_BLOCK)]
        outs = list(
            serve_stream(
                _assign_kernel, blocks, (self._centers_on(device, torch.float64),),
                static=static, name="kmeans.predict", device=device, dtype=torch.float64,
            )
        )
        return np.concatenate(outs) if outs else np.zeros((0,), dtype=np.int64)

    def serving_signature(self):
        raise NotImplementedError(SERVING_SIGNATURE_ITEM)

    def transform(self, dataset: Any) -> Any:
        rows = extract_features(dataset, self.getFeaturesCol())
        labels = self.predict(rows)
        if isinstance(dataset, DataFrame):
            return dataset.withColumn(self.getPredictionCol(), list(to_host(labels)))
        try:
            import pandas as pd
        except ImportError:  # pragma: no cover
            return labels
        if isinstance(dataset, pd.DataFrame):
            out = dataset.copy()
            out[self.getPredictionCol()] = to_host(labels)
            return out
        return labels

    def copy(self, extra=None) -> "KMeansModel":
        """Model.copy preserves fitted state (Spark's Model.copy contract)."""
        that = KMeansModel(self.uid, self._centers_raw, self._cost_raw, self._iter_raw)
        return self._copyValues(that, extra)

    def computeCost(self, x) -> float:
        """Sum of squared distances to the nearest center (Spark's
        computeCost), computed where a tensor lives, else on the device."""
        xj = matrix_like(x)
        if is_device_array(xj):
            device = _device.device_of(xj)
        else:
            device = _device.resolve_device()
            xj = torch.from_numpy(xj).to(device)
        centers = self._centers_on(device, xj.dtype)
        if self.getDistanceMeasure() == "cosine":
            xj = normalize_rows(xj)
            centers = normalize_rows(centers)
        _, d2 = assign_clusters(xj, centers)
        return float(torch.sum(d2))

    # Persistence: Spark's KMeansModel layout, one ClusterData row per
    # cluster, (clusterIdx: int, clusterCenter: VectorUDT).

    def _save_impl(self, path: str) -> None:
        centers = self.clusterCenters()
        save_metadata(
            self,
            path,
            class_name="org.apache.spark.ml.clustering.KMeansModel",
            extra_metadata={"trainingCost": self.trainingCost, "numIter": self.numIter},
        )
        save_rows(
            path,
            {
                "clusterIdx": ("scalar", list(range(len(centers)))),
                "clusterCenter": ("vector", [c for c in centers]),
            },
        )

    @classmethod
    def _load_impl(cls, path: str) -> "KMeansModel":
        metadata = load_metadata(path, expected_class="KMeansModel")
        rows = load_rows(path)
        order = np.argsort(np.asarray(rows["clusterIdx"]))
        centers = np.stack([np.asarray(rows["clusterCenter"][i], dtype=np.float64) for i in order])
        model = cls(
            metadata["uid"],
            centers,
            trainingCost=metadata.get("trainingCost", float("nan")),
            numIter=metadata.get("numIter", 0),
        )
        get_and_set_params(model, metadata)
        return model
