"""UMAP estimator/model — port of the reference's ``models/umap.py``.

The reference's 15 params, name for name and with its defaults and
validation: ``nNeighbors``, ``nComponents``, ``metric`` ("euclidean" |
"cosine"), ``nEpochs`` (0 = auto: 500 up to 10,000 rows, else 200),
``learningRate``, ``init`` ("spectral" | "random"), ``minDist``,
``spread``, ``negativeSampleRate``, ``negativePoolSize`` (256: one shared
pool of negatives per epoch; 0: per-edge draws), ``repulsionStrength``,
``seed``, ``featuresCol``, ``outputCol``, ``buildAlgo`` ("brute" |
"brute_approx", both exact here: ``ops/knn.py``).

Fit: the exact kNN graph (:mod:`ops.knn`), the fuzzy simplicial set,
spectral init up to 8,192 rows (random in the ±10 box above, or the
``setInitEmbedding`` layout), then the synchronous-epoch SGD
(:mod:`ops.umap`). The tail side of every epoch runs on kernel K4
(:mod:`ops.kernels.umap`) when ``plan_feasible`` holds and
``TPUML_UMAP_SCATTER`` asks for it: ``auto`` (default) on a CUDA layout,
``pallas`` on any layout (K4's plain version on a CPU tensor, as the
reference interprets its kernel there); otherwise, and always with
``xla``, through ``index_add_``. ``transform``
places new points by membership-weighted interpolation of their
training neighbours, then refines them with epochs against the fixed
training layout (no tail update, so no K4 launch).

Random numbers come from ``torch.Generator``s seeded by ``seed`` (fit)
and ``seed + 1`` (transform): the reference's results are matched in
distribution, not bit for bit. A host input passes the fit memory guard
(``core/membudget.py``) priced in float32; UMAP has no streaming fit, so
over budget is a ``FitMemoryError``; a mesh fit passes unpriced, as in the
reference.

With a mesh (``UMAP(mesh=...)``) both heavy stages shard over its data
axis: the kNN graph (:func:`ops.knn.knn_sharded` over the rows placed by
:func:`ops.knn.shard_items`, k + 1 neighbours) and the layout SGD
(:func:`ops.umap.optimize_layout_sharded`, one delta sum an epoch). K4
stays off a mesh, as the reference keeps its tail kernel off one. The
draws are the single-device fit's, so a pooled mesh fit equals the
single-device ``index_add_`` fit up to the order of its sums. In a gang
(``setDeployMode("gang")`` or a ``global_mesh()``) every process fits the
whole matrix with the same seed, as in the reference (not checked): the
graph, the init and the pooled draws are the same on every rank, each
rank runs its own positions' shards, and every rank returns the same
embedding.

With ``TPUML_CHECKPOINT_UMAP=1`` on top of the global checkpoint knobs, a
single-device fit runs its layout segmented
(:func:`ops.umap.optimize_layout_resumable`, on the same tail route, K4
included), snapshots the layout and the generator's state after every
segment and resumes mid-schedule, bitwise the uninterrupted fit; the graph
and the init are recomputed on resume. A mesh layout is not checkpointed,
as in the reference.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import DataFrame, extract_features, is_device_array
from spark_rapids_ml_tpu_torch.core import membudget
from spark_rapids_ml_tpu_torch.core.estimator import Estimator, Model
from spark_rapids_ml_tpu_torch.core.ingest import matrix_like
from spark_rapids_ml_tpu_torch.core.lazy_state import LazyHostState, to_host
from spark_rapids_ml_tpu_torch.core.params import Param, Params, toFloat, toInt, toString
from spark_rapids_ml_tpu_torch.core.persistence import (
    MLReadable,
    get_and_set_params,
    load_data,
    load_metadata,
    save_data,
    save_metadata,
)
from spark_rapids_ml_tpu_torch.ops.kernels.umap import build_tail_plan, plan_feasible
from spark_rapids_ml_tpu_torch.ops.knn import knn, knn_sharded, shard_items
from spark_rapids_ml_tpu_torch.ops.umap import (
    FuzzyGraph,
    find_ab_params,
    fuzzy_simplicial_set,
    optimize_layout,
    optimize_layout_resumable,
    optimize_layout_sharded,
    smooth_knn_dist,
    spectral_init,
)
from spark_rapids_ml_tpu_torch.robustness.checkpoint import umap_opt_in
from spark_rapids_ml_tpu_torch.utils.envknobs import env_choice
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

_SPECTRAL_CAP = 8192  # a dense-Laplacian eigh above this would dominate the fit


class _UMAPParams(Params):
    nNeighbors = Param("_", "nNeighbors", "local neighborhood size", toInt)
    nComponents = Param("_", "nComponents", "embedding dimension", toInt)
    metric = Param("_", "metric", "distance metric", toString)
    nEpochs = Param("_", "nEpochs", "optimization epochs (0 = auto)", toInt)
    learningRate = Param("_", "learningRate", "initial SGD step", toFloat)
    init = Param("_", "init", "spectral or random", toString)
    minDist = Param("_", "minDist", "minimum embedded distance", toFloat)
    spread = Param("_", "spread", "embedded scale", toFloat)
    negativeSampleRate = Param("_", "negativeSampleRate", "negatives per edge", toInt)
    negativePoolSize = Param(
        "_", "negativePoolSize",
        "shared negative pool per epoch (0 = per-edge sampling)", toInt,
    )
    repulsionStrength = Param("_", "repulsionStrength", "repulsion weight", toFloat)
    seed = Param("_", "seed", "random seed", toInt)
    featuresCol = Param("_", "featuresCol", "features column name", toString)
    outputCol = Param("_", "outputCol", "embedding column name", toString)
    buildAlgo = Param(
        "_", "buildAlgo",
        "kNN graph build: brute (exact) | brute_approx (exact on the card too)",
        toString,
    )

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(
            nNeighbors=15,
            nComponents=2,
            metric="euclidean",
            nEpochs=0,
            learningRate=1.0,
            init="spectral",
            minDist=0.1,
            spread=1.0,
            negativeSampleRate=5,
            negativePoolSize=256,
            repulsionStrength=1.0,
            seed=0,
            featuresCol="features",
            outputCol="embedding",
            buildAlgo="brute",
        )

    def getBuildAlgo(self) -> str:
        return self.getOrDefault(self.buildAlgo)

    def getNNeighbors(self) -> int:
        return self.getOrDefault(self.nNeighbors)

    def getNComponents(self) -> int:
        return self.getOrDefault(self.nComponents)

    def getMetric(self) -> str:
        return self.getOrDefault(self.metric)

    def getNEpochs(self) -> int:
        return self.getOrDefault(self.nEpochs)

    def getLearningRate(self) -> float:
        return self.getOrDefault(self.learningRate)

    def getInit(self) -> str:
        return self.getOrDefault(self.init)

    def getMinDist(self) -> float:
        return self.getOrDefault(self.minDist)

    def getSpread(self) -> float:
        return self.getOrDefault(self.spread)

    def getNegativeSampleRate(self) -> int:
        return self.getOrDefault(self.negativeSampleRate)

    def getNegativePoolSize(self) -> int:
        return self.getOrDefault(self.negativePoolSize)

    def getRepulsionStrength(self) -> float:
        return self.getOrDefault(self.repulsionStrength)

    def getSeed(self) -> int:
        return self.getOrDefault(self.seed)

    def getFeaturesCol(self) -> str:
        return self.getOrDefault(self.featuresCol)

    def getOutputCol(self) -> str:
        return self.getOrDefault(self.outputCol)

    def _chain(self, param, value):
        self.set(param, value)
        return self

    def setNNeighbors(self, v: int):
        if v < 2:
            raise ValueError(f"nNeighbors must be >= 2, got {v}")
        return self._chain(self.nNeighbors, v)

    def setNComponents(self, v: int):
        if v < 1:
            raise ValueError(f"nComponents must be >= 1, got {v}")
        return self._chain(self.nComponents, v)

    def setMetric(self, v: str):
        if v not in ("euclidean", "cosine"):
            raise ValueError(f"metric must be euclidean or cosine, got {v!r}")
        return self._chain(self.metric, v)

    def setNEpochs(self, v: int):
        return self._chain(self.nEpochs, v)

    def setLearningRate(self, v: float):
        return self._chain(self.learningRate, v)

    def setInit(self, v: str):
        if v not in ("spectral", "random"):
            raise ValueError(f"init must be spectral or random, got {v!r}")
        return self._chain(self.init, v)

    def setMinDist(self, v: float):
        return self._chain(self.minDist, v)

    def setSpread(self, v: float):
        return self._chain(self.spread, v)

    def setNegativeSampleRate(self, v: int):
        return self._chain(self.negativeSampleRate, v)

    def setNegativePoolSize(self, v: int):
        """Per-epoch shared negative pool: repulsion is scored against one
        pool of ``v`` uniform draws with dense (n, v) algebra, an
        importance-weighted equivalent of per-edge sampling
        (:func:`ops.umap.optimize_layout`); ``0`` samples per edge."""
        if v < 0:
            raise ValueError(f"negativePoolSize must be >= 0, got {v}")
        return self._chain(self.negativePoolSize, v)

    def setRepulsionStrength(self, v: float):
        return self._chain(self.repulsionStrength, v)

    def setSeed(self, v: int):
        return self._chain(self.seed, v)

    def setFeaturesCol(self, v: str):
        return self._chain(self.featuresCol, v)

    def setOutputCol(self, v: str):
        return self._chain(self.outputCol, v)

    def setBuildAlgo(self, v: str):
        """``"brute_approx"`` asks for the reference's hardware approximate
        top-k; the card has none, so the graph is exact either way."""
        if v not in ("brute", "brute_approx"):
            raise ValueError(f"buildAlgo must be brute|brute_approx, got {v!r}")
        return self._chain(self.buildAlgo, v)

    def _auto_epochs(self, n: int) -> int:
        epochs = self.getNEpochs()
        if epochs > 0:
            return epochs
        return 500 if n <= 10_000 else 200


def _knn_excluding_self(x: torch.Tensor, k: int, metric: str, mesh=None, approx: bool = False):
    """kNN of x against itself with the self match removed: the self
    column (wherever ties put it) is pushed to +inf and the k + 1 window
    re-sorted stably, as the reference's ``jnp.argsort`` does. With a
    mesh the rows are placed over it as the item set and searched by
    :func:`ops.knn.knn_sharded`."""
    if mesh is not None:
        items, item_mask = shard_items(x, mesh, metric=metric)
        d, idx = knn_sharded(x, items, item_mask, mesh, k + 1, metric=metric, approx=approx)
    else:
        d, idx = knn(x, x, k + 1, metric=metric, approx=approx)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    d = torch.where(idx == rows, torch.full_like(d, float("inf")), d)
    order = torch.argsort(d, dim=1, stable=True)
    d = torch.gather(d, 1, order)[:, :k]
    idx = torch.gather(idx, 1, order)[:, :k]
    return d, idx


def _rows_f32(x_in, device: Optional[torch.device] = None) -> torch.Tensor:
    """float32 rows on ``device``: a tensor where it lives unless a device
    is named, host rows on the resolved device (raises on "cuda" without
    a card)."""
    if is_device_array(x_in):
        x = x_in.to(dtype=torch.float32, device=device or x_in.device)
        _device.device_of(x)
        return x.contiguous()
    dev = device or _device.resolve_device()
    return torch.from_numpy(np.ascontiguousarray(x_in, dtype=np.float32)).to(dev)


class UMAP(_UMAPParams, Estimator, MLReadable):
    """``UMAP().setNNeighbors(15).setNComponents(2).fit(x)``."""

    def __init__(self, uid: Optional[str] = None, mesh=None):
        super().__init__(uid)
        self.mesh = mesh

    def setMesh(self, mesh) -> "UMAP":
        self.mesh = mesh
        return self

    _init_embedding = None
    _copy_attrs = ("_init_embedding",)  # survives Params.copy (tuning grids)

    def setInitEmbedding(self, value) -> "UMAP":
        """Warm start: begin the epoch SGD from an (n, nComponents) layout,
        e.g. a previous model's ``embedding``, instead of spectral/random
        init (umap-learn's ``init=array``)."""
        arr = to_host(value, np.float32)
        if arr.ndim != 2:
            raise ValueError("init embedding must be an (n, nComponents) matrix")
        self._init_embedding = arr
        return self

    def _fit(self, dataset: Any) -> "UMAPModel":
        rows = extract_features(dataset, self.getFeaturesCol())
        # The kNN graph and the epoch SGD need the whole matrix on the
        # device: no streaming rung, so over budget is a FitMemoryError up
        # front instead of an OOM inside the copy.
        membudget.fit_memory_guard(
            "umap", rows, can_stream=False,
            why_cannot_stream="UMAP has no streaming fit (the kNN graph "
                              "and epoch SGD need the full matrix resident)",
            mesh=self.mesh, dtype=np.float32, ledger_families=("umap",),
        )
        device_in = is_device_array(rows)
        x_in = matrix_like(rows)
        n = int(x_in.shape[0])
        k = min(self.getNNeighbors(), n - 1)
        if n < 3:
            raise ValueError(f"UMAP needs at least 3 rows, got {n}")
        dim = self.getNComponents()
        a, b = find_ab_params(self.getSpread(), self.getMinDist())

        with TraceRange("umap fit", TraceColor.PURPLE):
            x = _rows_f32(x_in)
            gen = torch.Generator(device=x.device)
            gen.manual_seed(self.getSeed())
            with TraceRange("umap graph", TraceColor.BLUE):
                dists, idx = _knn_excluding_self(
                    x, k, self.getMetric(), self.mesh, approx=self.getBuildAlgo() == "brute_approx"
                )
                graph = fuzzy_simplicial_set(idx, dists)
                # The tail route (TPUML_UMAP_SCATTER): "auto" takes K4 over a
                # per-fit tail sort on a CUDA layout and index_add_
                # elsewhere; "pallas" takes K4's wrapper wherever the plan is
                # feasible (its plain version on a CPU tensor); "xla" takes
                # index_add_. A mesh fit keeps its own scatter.
                scatter = env_choice("TPUML_UMAP_SCATTER", ("auto", "pallas", "xla"), "auto")
                want_k4 = scatter == "pallas" or (scatter == "auto" and x.device.type == "cuda")
                tail_plan = None
                if want_k4 and self.mesh is None and plan_feasible(n, k, dim):
                    tail_plan = build_tail_plan(graph.indices, n, dim)
            if self._init_embedding is not None:
                if self._init_embedding.shape != (n, dim):
                    raise ValueError(
                        f"init embedding shape {self._init_embedding.shape} != ({n}, {dim})"
                    )
                emb0 = torch.from_numpy(self._init_embedding).to(x.device)
            elif self.getInit() == "spectral" and n <= _SPECTRAL_CAP:
                emb0 = spectral_init(graph, n, dim, gen)
            else:
                emb0 = 10.0 * (2.0 * torch.rand((n, dim), generator=gen, device=x.device) - 1.0)
            layout = dict(
                n_epochs=self._auto_epochs(n),
                neg_rate=self.getNegativeSampleRate(),
                neg_pool=self.getNegativePoolSize(),
                learning_rate=self.getLearningRate(),
                repulsion=self.getRepulsionStrength(),
                a=a,
                b=b,
            )
            with TraceRange("umap layout", TraceColor.PURPLE):
                if self.mesh is not None:
                    emb = optimize_layout_sharded(self.mesh, emb0.to(torch.float32), graph, gen,
                                                  seed=self.getSeed(), **layout).to(x.device)
                else:
                    # Checkpointing is opt-in (TPUML_CHECKPOINT_UMAP=1) and
                    # single-device, as in the reference: only the epoch
                    # SGD segments; the graph and init recompute on resume.
                    ckpt = self._fit_checkpointer("umap.layout", data=(x, emb0)) if umap_opt_in() else None
                    if ckpt is not None:
                        emb = optimize_layout_resumable(emb0.to(torch.float32), graph, gen, ckpt,
                                                        tail_plan=tail_plan, **layout)
                    else:
                        emb = optimize_layout(emb0.to(torch.float32), graph, gen, tail_plan=tail_plan, **layout)

        # Device fits keep the layout and the train rows where they lie;
        # the model's host float64 views convert lazily.
        model = UMAPModel(
            self.uid,
            embedding=emb if device_in else to_host(emb, np.float64),
            trainData=x_in if device_in else np.asarray(x_in, dtype=np.float64),
            a=a,
            b=b,
        )
        return self._copyValues(model)


class UMAPModel(_UMAPParams, Model, LazyHostState):
    """Fitted model: ``embedding`` (n, dim); ``transform`` embeds new points
    against the frozen training layout."""

    _lazy_host_fields = {
        "_emb_raw": ("_emb_np", np.float64),
        "_train_raw": ("_train_np", np.float64),
    }

    def __init__(
        self,
        uid: Optional[str] = None,
        embedding=None,
        trainData=None,
        a: float = 1.577,
        b: float = 0.895,
    ):
        super().__init__(uid)
        self._emb_raw = embedding
        self._train_raw = trainData
        self._emb_np: Optional[np.ndarray] = None
        self._train_np: Optional[np.ndarray] = None
        self.a = a
        self.b = b

    @property
    def embedding(self) -> Optional[np.ndarray]:
        return self._lazy_host_view("_emb_raw")

    @property
    def trainData(self) -> Optional[np.ndarray]:
        return self._lazy_host_view("_train_raw")

    def copy(self, extra=None) -> "UMAPModel":
        that = UMAPModel(self.uid, self._emb_raw, self._train_raw, self.a, self.b)
        return self._copyValues(that, extra)

    def transform(self, dataset: Any) -> Any:
        rows = extract_features(dataset, self.getFeaturesCol())
        emb = self._embed_new(matrix_like(rows))
        if isinstance(dataset, DataFrame):
            return dataset.withColumn(self.getOutputCol(), [e for e in to_host(emb)])
        try:
            import pandas as pd
        except ImportError:  # pragma: no cover
            return emb
        if isinstance(dataset, pd.DataFrame):
            out = dataset.copy()
            out[self.getOutputCol()] = list(to_host(emb))
            return out
        return emb

    def _embed_new(self, x_in):
        device_in = is_device_array(x_in)
        x = _rows_f32(x_in)
        n_train = int(self._train_raw.shape[0])
        k = min(self.getNNeighbors(), n_train)
        train = _rows_f32(self._train_raw if is_device_array(self._train_raw) else self.trainData, x.device)
        train_emb = _rows_f32(self._emb_raw if is_device_array(self._emb_raw) else self.embedding, x.device)

        with TraceRange("umap transform", TraceColor.PURPLE):
            dists, idx = knn(x, train, k, metric=self.getMetric())
            sigmas, rhos = smooth_knn_dist(dists, float(k))
            w = torch.exp(-torch.clamp_min(dists - rhos[:, None], 0.0) / sigmas[:, None])
            w = w / torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1e-12)
            init = torch.einsum("qk,qkd->qd", w, train_emb[idx.long()])
            graph = FuzzyGraph(idx.to(torch.int32), w.to(torch.float32), sigmas, rhos)
            gen = torch.Generator(device=x.device)
            gen.manual_seed(self.getSeed() + 1)
            emb = optimize_layout(
                init,
                graph,
                gen,
                n_epochs=max(1, self._auto_epochs(n_train) // 3),
                neg_rate=self.getNegativeSampleRate(),
                neg_pool=self.getNegativePoolSize(),
                learning_rate=self.getLearningRate(),
                repulsion=self.getRepulsionStrength(),
                a=self.a,
                b=self.b,
                move_other=False,
                target=train_emb,
            )
        # Tensor queries get a tensor back; host queries keep the numpy
        # float64 contract.
        return emb if device_in else to_host(emb, np.float64)

    def _save_impl(self, path: str) -> None:
        save_metadata(
            self,
            path,
            class_name="com.nvidia.rapids.ml.UMAPModel",
            extra_metadata={"a": self.a, "b": self.b},
        )
        save_data(
            path,
            {
                "embedding": ("matrix", self.embedding),
                "trainData": ("matrix", self.trainData),
            },
        )

    @classmethod
    def _load_impl(cls, path: str) -> "UMAPModel":
        metadata = load_metadata(path, expected_class="UMAPModel")
        data = load_data(path)
        model = cls(
            metadata["uid"],
            embedding=np.asarray(data["embedding"]),
            trainData=np.asarray(data["trainData"]),
            a=metadata.get("a", 1.577),
            b=metadata.get("b", 0.895),
        )
        get_and_set_params(model, metadata)
        return model
