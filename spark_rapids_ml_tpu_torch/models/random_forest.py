"""RandomForestClassifier / RandomForestRegressor — port of the reference's
``models/random_forest.py``.

Param surface of Spark's ``RandomForestClassifier`` and
``RandomForestRegressor``, with Spark's defaults: ``numTrees`` (20),
``maxDepth`` (5), ``maxBins`` (32), ``minInstancesPerNode``,
``minInfoGain``, ``subsamplingRate``, ``featureSubsetStrategy`` ("auto"),
``impurity`` (gini / variance), ``bootstrap``, ``seed``, and the column
params (``weightCol`` too). All trees grow together, level by level, with
one-hot histogram GEMMs (``ops/trees.py``).

A tensor pair fits where it lives (features cast to float32 there); host
input is placed as float32 on :func:`device.resolve_device`. The fit
draws its bootstrap weights and each level's feature-subset uniforms
from one ``torch.Generator`` on the fit's device, seeded with ``seed``:
deterministic, but not the reference's threefry draws. With
``bootstrap=False``, ``subsamplingRate=1`` and
``featureSubsetStrategy="all"`` nothing is drawn, and the two packages
grow the same trees. ``setNumClasses`` declares the class count, so a
tensor fit reads no label back (an undeclared count costs one readback).
The regressor centres its labels before the ``[1, y, y²]`` stats and adds
the mean back to the leaves.

Models save in Spark's ``EnsembleModelReadWrite`` layout (``metadata``,
``treesMetadata``, and ``data`` as ``(treeID, nodeData)`` rows in Spark's
NodeData schema), so either package, and Spark, loads the other's saves.

The fit has no streaming route: over the fit memory budget
(``core/membudget.py``) a host input raises ``FitMemoryError``; a mesh fit
passes unpriced, as in the reference. With a mesh (``mesh=``, ``setMesh``,
or ``setDeployMode("gang")``) the fit quantizes, bins and draws as on one
device and grows over the mesh (:func:`ops.trees.grow_forest_sharded`, one
histogram sum a level): a classification forest is bitwise the
single-device one. In a gang every process fits the whole matrix with the
same seed, as in the reference (not checked), and every rank holds the
same forest. The per-device
copies of the forest are
registered with ``core/serving`` (``note_device_cache``), which drops
them when the model retires from a serving registry.

Both models predict through the reference's serving kernels,
:func:`_proba_kernel` and :func:`_reg_kernel`, and declare them in
``serving_signature()`` for the pipeline fuser (the classifier with
:func:`_select_argmax` as its transform-on-array contract).
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import DataFrame, extract_features, extract_weights, is_device_array
from spark_rapids_ml_tpu_torch.core.estimator import Estimator, Model
from spark_rapids_ml_tpu_torch.core.ingest import matrix_like, validate_int_labels
from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
from spark_rapids_ml_tpu_torch.core.membudget import fit_memory_guard
from spark_rapids_ml_tpu_torch.core.params import Param, Params, toBoolean, toFloat, toInt, toString
from spark_rapids_ml_tpu_torch.core.persistence import (
    MLReadable,
    get_and_set_params,
    load_metadata,
    load_rows,
    save_metadata,
)
from spark_rapids_ml_tpu_torch.core.serving import note_device_cache, serve_blocks, serve_rows, to_numpy, upload_block
from spark_rapids_ml_tpu_torch.models.linear_regression import _extract_xy
from spark_rapids_ml_tpu_torch.ops.trees import (
    Forest,
    bin_features,
    feature_importances,
    fit_forest_fused,
    forest_predict_proba,
    forest_predict_reg,
    grow_forest_sharded,
    quantize_features,
    sample_weights,
)
from spark_rapids_ml_tpu_torch.observability import costs as _costs
from spark_rapids_ml_tpu_torch.serving.signature import ServingSignature, spec
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange


def _proba_kernel(x, forest, *, depth: int):
    """Serving kernel: (n, C) mean leaf class distributions. Trees route
    in float32 (the forests' training dtype)."""
    return forest_predict_proba(x.to(torch.float32), forest, depth)


def _reg_kernel(x, forest, *, depth: int):
    """Serving kernel: (n,) mean leaf values."""
    return forest_predict_reg(x.to(torch.float32), forest, depth)


def _forest_cost(rows, d, dtype, weights, static):
    """A forest's routing work: one comparison per row, tree and level;
    the rows and the routing tensors (feature, threshold, is_leaf,
    leaf_value) read once, the float32 (rows, S) means written once."""
    forest = weights[0]
    trees = int(forest.feature.shape[0])
    width = int(forest.leaf_value.shape[-1])
    routing = sum(t.numel() * t.element_size()
                  for t in (forest.feature, forest.threshold, forest.is_leaf, forest.leaf_value))
    return {"flops": float(rows * trees * int(static["depth"])), "transcendentals": 0.0,
            "bytes_accessed": float(rows * d * 4 + routing + 4 * rows * width)}


_costs.register_cost(_proba_kernel, _forest_cost)
_costs.register_cost(_reg_kernel, _forest_cost)


def _select_argmax(outs):
    """Transform-on-array contract for the fuser: the classifier's
    ``transform`` of a plain array yields argmax labels, not the class
    distribution."""
    probs = outs[0] if isinstance(outs, tuple) else outs
    return torch.argmax(probs, dim=1)


def resolve_feature_subset(strategy: str, d: int, n_trees: int, classification: bool) -> int:
    """Spark's featureSubsetStrategy -> number of features per split."""
    s = strategy.lower()
    if s == "auto":
        if n_trees == 1:
            return d
        return (
            max(1, int(math.ceil(math.sqrt(d))))
            if classification
            else max(1, int(math.ceil(d / 3.0)))
        )
    if s == "all":
        return d
    if s == "sqrt":
        return max(1, int(math.ceil(math.sqrt(d))))
    if s == "log2":
        return max(1, int(math.ceil(math.log2(max(d, 2)))))
    if s == "onethird":
        return max(1, int(math.ceil(d / 3.0)))
    # Spark's grammar: an all-digits string is a count in [1, d]; anything
    # with a decimal point is a fraction in (0, 1] ("1.0" is every feature).
    try:
        count = int(strategy)
    except ValueError:
        count = None
    if count is not None:
        if count < 1:
            raise ValueError(f"featureSubsetStrategy integer must be >= 1, got {strategy!r}")
        return min(d, count)
    try:
        v = float(strategy)
    except ValueError:
        raise ValueError(f"unknown featureSubsetStrategy {strategy!r}")
    if 0 < v <= 1:
        return max(1, int(math.ceil(v * d)))
    raise ValueError(f"unknown featureSubsetStrategy {strategy!r}")


class _RandomForestParams(Params):
    numTrees = Param("_", "numTrees", "number of trees", toInt)
    maxDepth = Param("_", "maxDepth", "maximum tree depth", toInt)
    maxBins = Param("_", "maxBins", "max histogram bins per feature", toInt)
    minInstancesPerNode = Param("_", "minInstancesPerNode", "min instances each child must have", toInt)
    minInfoGain = Param("_", "minInfoGain", "min info gain for a split", toFloat)
    subsamplingRate = Param("_", "subsamplingRate", "row sampling rate per tree", toFloat)
    featureSubsetStrategy = Param("_", "featureSubsetStrategy", "features considered per split", toString)
    impurity = Param("_", "impurity", "split criterion", toString)
    bootstrap = Param("_", "bootstrap", "sample with replacement", toBoolean)
    seed = Param("_", "seed", "random seed", toInt)
    featuresCol = Param("_", "featuresCol", "features column name", toString)
    labelCol = Param("_", "labelCol", "label column name", toString)
    predictionCol = Param("_", "predictionCol", "prediction column name", toString)
    weightCol = Param("_", "weightCol", "per-row weight column name", toString)

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(
            numTrees=20,
            maxDepth=5,
            maxBins=32,
            minInstancesPerNode=1,
            minInfoGain=0.0,
            subsamplingRate=1.0,
            featureSubsetStrategy="auto",
            bootstrap=True,
            seed=0,
            featuresCol="features",
            labelCol="label",
            predictionCol="prediction",
        )

    def getNumTrees(self) -> int:
        return self.getOrDefault(self.numTrees)

    def getMaxDepth(self) -> int:
        return self.getOrDefault(self.maxDepth)

    def getMaxBins(self) -> int:
        return self.getOrDefault(self.maxBins)

    def getMinInstancesPerNode(self) -> int:
        return self.getOrDefault(self.minInstancesPerNode)

    def getMinInfoGain(self) -> float:
        return self.getOrDefault(self.minInfoGain)

    def getSubsamplingRate(self) -> float:
        return self.getOrDefault(self.subsamplingRate)

    def getFeatureSubsetStrategy(self) -> str:
        return self.getOrDefault(self.featureSubsetStrategy)

    def getImpurity(self) -> str:
        return self.getOrDefault(self.impurity)

    def getBootstrap(self) -> bool:
        return self.getOrDefault(self.bootstrap)

    def getSeed(self) -> int:
        return self.getOrDefault(self.seed)

    def getFeaturesCol(self) -> str:
        return self.getOrDefault(self.featuresCol)

    def getLabelCol(self) -> str:
        return self.getOrDefault(self.labelCol)

    def getPredictionCol(self) -> str:
        return self.getOrDefault(self.predictionCol)

    def getWeightCol(self) -> Optional[str]:
        return self.getOrDefault(self.weightCol) if self.isDefined(self.weightCol) else None

    # Chainable setters shared by estimators and models.
    def _chain(self, param, value):
        self.set(param, value)
        return self

    def setNumTrees(self, v: int):
        if v < 1:
            raise ValueError(f"numTrees must be >= 1, got {v}")
        return self._chain(self.numTrees, v)

    def setMaxDepth(self, v: int):
        if not 0 <= v <= 14:
            raise ValueError(f"maxDepth must be in [0, 14], got {v}")
        return self._chain(self.maxDepth, v)

    def setMaxBins(self, v: int):
        if v < 2:
            raise ValueError(f"maxBins must be >= 2, got {v}")
        return self._chain(self.maxBins, v)

    def setMinInstancesPerNode(self, v: int):
        if v < 1:
            raise ValueError(f"minInstancesPerNode must be >= 1, got {v}")
        return self._chain(self.minInstancesPerNode, v)

    def setMinInfoGain(self, v: float):
        return self._chain(self.minInfoGain, v)

    def setSubsamplingRate(self, v: float):
        if not 0 < v <= 1:
            raise ValueError(f"subsamplingRate must be in (0, 1], got {v}")
        return self._chain(self.subsamplingRate, v)

    def setFeatureSubsetStrategy(self, v: str):
        return self._chain(self.featureSubsetStrategy, v)

    def setBootstrap(self, v: bool):
        return self._chain(self.bootstrap, v)

    def setSeed(self, v: int):
        return self._chain(self.seed, v)

    def setFeaturesCol(self, v: str):
        return self._chain(self.featuresCol, v)

    def setLabelCol(self, v: str):
        return self._chain(self.labelCol, v)

    def setPredictionCol(self, v: str):
        return self._chain(self.predictionCol, v)

    def setWeightCol(self, v: str):
        return self._chain(self.weightCol, v)


def _hist_exact_in_bf16(row_stats, sample_w: torch.Tensor) -> bool:
    """True when every histogram operand ``sample_weight · stat`` is an
    integer of at most 256, so the bf16 product of the ``default``
    histogram is exact (an integer weightCol of 129 drawn 3 times would
    not be). A tensor's check is one scalar readback; host stats are
    checked on the host and the weights with one readback."""
    if is_device_array(row_stats):
        if row_stats.numel() == 0:
            return False
        rs = row_stats.to(torch.float32)
        w = sample_w.to(rs.device)
        exact = (torch.all(rs == torch.round(rs)) & torch.all(w == torch.round(w))
                 & (torch.max(torch.abs(rs)) * torch.max(w) <= 256.0))
        return bool(exact)
    rs = np.asarray(row_stats, dtype=np.float32)
    if rs.size == 0 or not np.array_equal(rs, np.rint(rs)):
        return False
    integral, w_max = torch.stack([torch.all(sample_w == torch.round(sample_w)).to(torch.float32),
                                   torch.max(sample_w)]).tolist()
    return bool(integral) and float(np.abs(rs).max()) * w_max <= 256.0


def _on_device(a: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """A tensor as float32 where it lives (or on ``device``); host data
    as float32 on ``device`` or :func:`device.resolve_device`."""
    if is_device_array(a):
        return a.to(device=device, dtype=torch.float32)
    host = np.ascontiguousarray(a, dtype=np.float32)
    return torch.from_numpy(host).to(device if device is not None else _device.resolve_device())


def _forest_draws(seed: int, device: torch.device) -> torch.Generator:
    """The fit's generator: its bootstrap weights, then each level's
    feature-subset uniforms, in that order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _fit_forest(params: _RandomForestParams, x, row_stats, impurity: str, classification: bool,
                stats_integral: bool = False, mesh=None) -> Forest:
    """The shared fit: the memory guard, the draws, then quantize, bin and
    grow (:func:`ops.trees.fit_forest_fused`), over ``mesh`` when one is
    given (:func:`ops.trees.grow_forest_sharded`; the draws, edges and bins
    are the single-device fit's)."""
    n, d = int(x.shape[0]), int(x.shape[1])
    fit_memory_guard(
        "random_forest", x, can_stream=False,
        why_cannot_stream="RandomForest has no streaming fit (histogram growth needs the binned matrix resident)",
        mesh=mesh, dtype=np.float32, ledger_families=("rf",),
        extra_bytes=0 if is_device_array(row_stats) else np.asarray(row_stats).size * 4,
    )
    n_bins = min(params.getMaxBins(), max(2, n))
    m = resolve_feature_subset(params.getFeatureSubsetStrategy(), d, params.getNumTrees(), classification)
    xd = _on_device(x)
    _device.device_of(xd)
    gen = _forest_draws(params.getSeed(), xd.device)
    w = sample_weights(gen, params.getNumTrees(), n, params.getSubsamplingRate(), params.getBootstrap())
    # stats_integral: a plain one-hot (no weightCol), whose products with
    # the 256-clamped integer weights are exact in bf16 by construction.
    exact = classification and (stats_integral or _hist_exact_in_bf16(row_stats, w))
    grow = dict(
        max_depth=params.getMaxDepth(), n_bins=n_bins, impurity=impurity, feat_subset=m,
        min_instances=params.getMinInstancesPerNode(), min_info_gain=params.getMinInfoGain(),
        exact_counts=exact,
    )
    rs = _on_device(row_stats, xd.device)
    if mesh is not None:
        edges = quantize_features(xd, n_bins)
        return grow_forest_sharded(mesh, bin_features(xd, edges), rs, w, edges.to(torch.float32),
                                   generator=gen, **grow)
    return fit_forest_fused(xd, rs, w, generator=gen, **grow)


def _forest_depth(forest: Forest) -> int:
    """max_depth from the heap size: N = 2^(D+1) - 1."""
    return int(math.log2(int(forest.feature.shape[1]) + 1)) - 1


class _ForestModel(_RandomForestParams, Model):
    """State shared by the two forest models: the forest (tensors where
    the fit ran, CPU after a load or unpickling), one copy of it per
    device that predicts, and the rows' placement."""

    def __init__(self, uid: Optional[str] = None, forest: Optional[Forest] = None, numFeatures: int = 0):
        super().__init__(uid)
        self._forest = forest
        self._forest_dev: dict = {}
        self.numFeatures = numFeatures

    def __getstate__(self):
        # Pickles carry the forest on the host, never live device buffers.
        state = super().__getstate__()
        if self._forest is not None:
            state["_forest"] = Forest(*(t.cpu() for t in self._forest))
        state["_forest_dev"] = {}
        return state

    @property
    def featureImportances(self) -> np.ndarray:
        return feature_importances(self._forest, self.numFeatures)

    def _forest_on(self, device: torch.device) -> Forest:
        forest = self._forest
        if forest.feature.device == device:
            return forest
        key = str(device)
        if key not in self._forest_dev:
            self._forest_dev[key] = Forest(*(t.to(device) for t in forest))
            note_device_cache(self)
        return self._forest_dev[key]

    def _serve(self, kernel, x, name: str):
        """The serving ``kernel`` on the rows as float32, through the
        bucketed program cache: a tensor where it lives (the result stays
        there), host rows on the platform's device in float32 blocks
        (``serve_blocks``; the result comes back as numpy)."""
        if self._forest is None:
            raise RuntimeError("model has no fitted forest")
        rows = matrix_like(x)
        static = {"depth": _forest_depth(self._forest)}
        if is_device_array(rows):
            xd = _on_device(rows)
            return serve_rows(kernel, xd, (self._forest_on(xd.device),), name=name, static=static)
        device = _device.resolve_device()
        if rows.shape[0] == 0:
            _, xd = upload_block(rows, device, dtype=torch.float32)
            return to_numpy(serve_rows(kernel, xd, (self._forest_on(device),), name=name, static=static))
        return serve_blocks(kernel, rows, (self._forest_on(device),), name=name, static=static,
                            device=device, dtype=torch.float32, host_dtype=np.float32)

    def _signature(self, kernel, name: str, output_spec, select=None) -> ServingSignature:
        """Shared ``serving_signature()`` body of the two forest models:
        the forest on the platform's device, its depth static."""
        if self._forest is None:
            raise RuntimeError("model has no fitted forest")
        return ServingSignature(
            kernel=kernel,
            weights=(self._forest_on(_device.resolve_device()),),
            static={"depth": _forest_depth(self._forest)},
            name=name,
            n_features=int(self.numFeatures),
            output_spec=output_spec,
            select=select,
        )


class RandomForestClassifier(_RandomForestParams, Estimator, MLReadable):
    """``RandomForestClassifier().setNumTrees(20).fit((X, y))``."""

    # Consumes tensors in place, so tuning loops may feed fold slices
    # that stay on the device (tuning._device_fold_prep).
    _device_foldable = True

    probabilityCol = Param("_", "probabilityCol", "probability column name", toString)
    rawPredictionCol = Param("_", "rawPredictionCol", "raw prediction column name", toString)

    # Fit-time hint, not a Param (the model's ``numClasses`` is a plain
    # attribute of the same name); survives Params.copy.
    _declared_num_classes = 0
    _copy_attrs = ("_declared_num_classes",)

    def __init__(self, uid: Optional[str] = None, mesh=None):
        super().__init__(uid)
        self.setMesh(mesh)
        self._setDefault(impurity="gini", probabilityCol="probability", rawPredictionCol="rawPrediction")

    def setMesh(self, mesh) -> "RandomForestClassifier":
        self.mesh = mesh
        return self

    def getProbabilityCol(self) -> str:
        return self.getOrDefault(self.probabilityCol)

    def getRawPredictionCol(self) -> str:
        return self.getOrDefault(self.rawPredictionCol)

    def getNumClasses(self) -> int:
        return self._declared_num_classes

    def setNumClasses(self, v: int):
        """Declare the class count up front, as Spark's label metadata
        does; a tensor fit then reads no label back. A wrong declaration
        is the caller's contract violation. 0 restores inference."""
        if v != 0 and v < 2:
            raise ValueError(f"numClasses must be 0 (infer) or >= 2, got {v}")
        self._declared_num_classes = int(v)
        return self

    def setProbabilityCol(self, v: str):
        return self._chain(self.probabilityCol, v)

    def setRawPredictionCol(self, v: str):
        return self._chain(self.rawPredictionCol, v)

    def setImpurity(self, v: str):
        if v not in ("gini", "entropy"):
            raise ValueError(f"impurity must be gini or entropy, got {v!r}")
        return self._chain(self.impurity, v)

    def _fit(self, dataset: Any) -> "RandomForestClassificationModel":
        x, y = _extract_xy(dataset, self.getFeaturesCol(), self.getLabelCol())
        declared = self.getNumClasses()
        if declared:
            if is_device_array(y):
                y_int = y.reshape(-1).to(torch.int64)  # trusted: no readback
            else:
                y_int, _ = validate_int_labels(y)
            n_classes = declared
        else:
            y_int, n_classes = validate_int_labels(y)
            n_classes = max(n_classes, 2)
        w = extract_weights(dataset, self.getWeightCol())
        if is_device_array(y_int):
            classes = torch.arange(n_classes, device=y_int.device)
            row_stats = (y_int[:, None] == classes[None, :]).to(torch.float32)
            if w is not None:
                row_stats = row_stats * torch.from_numpy(w).to(device=y_int.device, dtype=torch.float32)[:, None]
        else:
            row_stats = np.zeros((y_int.shape[0], n_classes), dtype=np.float32)
            row_stats[np.arange(y_int.shape[0]), y_int] = 1.0
            if w is not None:
                row_stats *= w[:, None].astype(np.float32)
        with TraceRange("rf-classifier fit", TraceColor.GREEN):
            forest = _fit_forest(self, x, row_stats, self.getImpurity(), True, stats_integral=w is None,
                                 mesh=self.mesh)
        model = RandomForestClassificationModel(self.uid, forest, numFeatures=int(x.shape[1]), numClasses=n_classes)
        return self._copyValues(model)


class RandomForestClassificationModel(_ForestModel):
    probabilityCol = RandomForestClassifier.probabilityCol
    rawPredictionCol = RandomForestClassifier.rawPredictionCol

    def __init__(self, uid: Optional[str] = None, forest: Optional[Forest] = None,
                 numFeatures: int = 0, numClasses: int = 0):
        super().__init__(uid, forest, numFeatures)
        self._setDefault(impurity="gini", probabilityCol="probability", rawPredictionCol="rawPrediction")
        self.numClasses = numClasses

    def getProbabilityCol(self) -> str:
        return self.getOrDefault(self.probabilityCol)

    @property
    def totalNumNodes(self) -> int:
        """Reachable nodes: the splits and the leaves that carry weight."""
        leaf = to_host(self._forest.is_leaf)
        feat = to_host(self._forest.feature)
        w = to_host(self._forest.node_weight)
        return int(np.sum((feat >= 0) | (leaf & (w > 0))))

    def predictProbability(self, x):
        """(n, C) mean of the trees' leaf class distributions."""
        return self._serve(_proba_kernel, x, "rf.predictProbability")

    def serving_signature(self) -> ServingSignature:
        """The serving contract: the probability kernel, the forest, the
        (n, C) float32 distribution spec, and :func:`_select_argmax`."""
        n_classes = int(self.numClasses)
        return self._signature(_proba_kernel, "rf.predictProbability",
                               lambda n, dtype: spec((n, n_classes), torch.float32), select=_select_argmax)

    def predict(self, x):
        probs = self.predictProbability(x)
        if is_device_array(probs):
            return torch.argmax(probs, dim=1)
        return np.argmax(probs, axis=1)

    def predictRaw(self, x):
        """Spark's rawPrediction: the vote mass, the mean distribution
        times the tree count."""
        return self.predictProbability(x) * int(self._forest.feature.shape[0])

    def transform(self, dataset: Any) -> Any:
        rows = extract_features(dataset, self.getFeaturesCol(), drop=self.getLabelCol())
        probs = to_host(self.predictProbability(rows))
        preds = np.argmax(probs, axis=1)
        raws = probs * int(self._forest.feature.shape[0])
        if isinstance(dataset, DataFrame):
            out = dataset.withColumn(self.getPredictionCol(), list(preds.astype(float)))
            out = out.withColumn(self.getProbabilityCol(), [p for p in probs])
            return out.withColumn(self.getOrDefault(self.rawPredictionCol), [r for r in raws])
        try:
            import pandas as pd
        except ImportError:  # pragma: no cover
            return preds
        if isinstance(dataset, pd.DataFrame):
            out = dataset.copy()
            out[self.getPredictionCol()] = preds.astype(float)
            out[self.getProbabilityCol()] = list(probs)
            out[self.getOrDefault(self.rawPredictionCol)] = list(raws)
            return out
        return preds

    def _save_impl(self, path: str) -> None:
        _save_forest_model(
            self, path, "org.apache.spark.ml.classification.RandomForestClassificationModel",
            {"numFeatures": self.numFeatures, "numClasses": self.numClasses},
        )

    @classmethod
    def _load_impl(cls, path: str) -> "RandomForestClassificationModel":
        metadata, forest = _load_forest_model(path, "RandomForestClassificationModel")
        model = cls(metadata["uid"], forest, numFeatures=metadata.get("numFeatures", 0),
                    numClasses=metadata.get("numClasses", 0))
        get_and_set_params(model, metadata)
        return model


class RandomForestRegressor(_RandomForestParams, Estimator, MLReadable):
    """``RandomForestRegressor().setNumTrees(20).fit((X, y))``."""

    # Consumes tensors in place, so tuning loops may feed fold slices
    # that stay on the device (tuning._device_fold_prep).
    _device_foldable = True

    def __init__(self, uid: Optional[str] = None, mesh=None):
        super().__init__(uid)
        self.setMesh(mesh)
        self._setDefault(impurity="variance")

    def setMesh(self, mesh) -> "RandomForestRegressor":
        self.mesh = mesh
        return self

    def setImpurity(self, v: str):
        if v != "variance":
            raise ValueError(f"regression impurity must be variance, got {v!r}")
        return self._chain(self.impurity, v)

    def _fit(self, dataset: Any) -> "RandomForestRegressionModel":
        x, y = _extract_xy(dataset, self.getFeaturesCol(), self.getLabelCol())
        # Stats [1, y, y²] give the weighted variance. Labels are centred
        # first: E[y²] − mean² in float32 would cancel the variance away
        # when |mean(y)| >> std(y); gains are shift-invariant, and the mean
        # goes back onto the leaves.
        w = extract_weights(dataset, self.getWeightCol())
        if is_device_array(y):
            yj = y.reshape(-1).to(torch.float32)
            wj = None if w is None else torch.from_numpy(w).to(device=yj.device, dtype=torch.float32)
            y_mean = float(torch.sum(yj * wj) / torch.sum(wj) if wj is not None else torch.mean(yj))
            yc = yj - y_mean
            row_stats = torch.stack([torch.ones_like(yc), yc, yc * yc], dim=1)
            if wj is not None:
                row_stats = row_stats * wj[:, None]
        else:
            y_mean = (
                float(np.average(y, weights=w)) if w is not None
                else (float(np.mean(y)) if y.size else 0.0)
            )
            yc = y - y_mean
            row_stats = np.stack([np.ones_like(yc), yc, yc * yc], axis=1)
            if w is not None:
                row_stats *= w[:, None]
        with TraceRange("rf-regressor fit", TraceColor.GREEN):
            forest = _fit_forest(self, x, row_stats, "variance", False, mesh=self.mesh)
        forest = forest._replace(leaf_value=forest.leaf_value + y_mean)
        model = RandomForestRegressionModel(self.uid, forest, numFeatures=int(x.shape[1]))
        return self._copyValues(model)


class RandomForestRegressionModel(_ForestModel):
    def __init__(self, uid: Optional[str] = None, forest: Optional[Forest] = None, numFeatures: int = 0):
        super().__init__(uid, forest, numFeatures)
        self._setDefault(impurity="variance")

    def predict(self, x):
        """(n,) mean of the trees' leaf means."""
        return self._serve(_reg_kernel, x, "rf.predict")

    def serving_signature(self) -> ServingSignature:
        """The serving contract: the regression kernel, the forest, and
        the (n,) float32 prediction spec."""
        return self._signature(_reg_kernel, "rf.predict", lambda n, dtype: spec((n,), torch.float32))

    def transform(self, dataset: Any) -> Any:
        rows = extract_features(dataset, self.getFeaturesCol(), drop=self.getLabelCol())
        preds = self.predict(rows)
        if isinstance(dataset, DataFrame):
            return dataset.withColumn(self.getPredictionCol(), list(to_host(preds)))
        try:
            import pandas as pd
        except ImportError:  # pragma: no cover
            return preds
        if isinstance(dataset, pd.DataFrame):
            out = dataset.copy()
            out[self.getPredictionCol()] = to_host(preds)
            return out
        return preds

    def _save_impl(self, path: str) -> None:
        _save_forest_model(
            self, path, "org.apache.spark.ml.regression.RandomForestRegressionModel",
            {"numFeatures": self.numFeatures},
        )

    @classmethod
    def _load_impl(cls, path: str) -> "RandomForestRegressionModel":
        metadata, forest = _load_forest_model(path, "RandomForestRegressionModel")
        model = cls(metadata["uid"], forest, numFeatures=metadata.get("numFeatures", 0))
        get_and_set_params(model, metadata)
        return model


# --- Spark NodeData persistence -------------------------------------------


def _spark_nodedata_type():
    """Arrow type of Spark's NodeData struct (``DecisionTreeModelReadWrite``,
    Spark 3.x, with ``rawCount``)."""
    import pyarrow as pa

    split_t = pa.struct(
        [
            ("featureIndex", pa.int32()),
            ("leftCategoriesOrThreshold", pa.list_(pa.float64())),
            ("numCategories", pa.int32()),
        ]
    )
    return pa.struct(
        [
            ("id", pa.int32()),
            ("prediction", pa.float64()),
            ("impurity", pa.float64()),
            ("impurityStats", pa.list_(pa.float64())),
            ("rawCount", pa.int64()),
            ("gain", pa.float64()),
            ("leftChild", pa.int32()),
            ("rightChild", pa.int32()),
            ("split", split_t),
        ]
    )


def _tree_to_nodedata(f: Forest, t: int, classification: bool) -> list:
    """One tree's heap arrays (host numpy) as Spark NodeData dicts in
    preorder ids (root 0, then the left subtree). Classification
    ``impurityStats`` are the class counts (distribution × node weight);
    regression's are Spark's [count, sum, sumSq], sumSq rebuilt from the
    node's impurity. Leaves carry Spark's sentinels (gain -1, children -1,
    split (-1, [], -1)). ``rawCount`` is ``round(node_weight)``: the
    weighted count, the row count only without ``weightCol``."""
    feature = np.asarray(f.feature[t])
    thr = np.asarray(f.threshold[t], dtype=np.float64)
    leaf = np.asarray(f.is_leaf[t])
    lv = np.asarray(f.leaf_value[t], dtype=np.float64)
    w = np.asarray(f.node_weight[t], dtype=np.float64)
    gain = np.asarray(f.node_gain[t], dtype=np.float64)
    imp = np.asarray(f.node_impurity[t], dtype=np.float64)
    rows: list = []

    def walk(g: int) -> int:
        my = len(rows)
        rows.append(None)
        is_split = (not leaf[g]) and feature[g] >= 0
        if classification:
            stats = (lv[g] * w[g]).tolist()
            pred = float(np.argmax(lv[g]))
        else:
            mean = float(lv[g, 0])
            stats = [w[g], mean * w[g], (imp[g] + mean * mean) * w[g]]
            pred = mean
        node = {
            "id": my,
            "prediction": pred,
            "impurity": float(imp[g]),
            "impurityStats": stats,
            "rawCount": int(round(w[g])),
            "gain": float(gain[g]) if is_split else -1.0,
            "leftChild": -1,
            "rightChild": -1,
            "split": {
                "featureIndex": int(feature[g]) if is_split else -1,
                "leftCategoriesOrThreshold": [float(thr[g])] if is_split else [],
                "numCategories": -1,
            },
        }
        rows[my] = node
        if is_split:
            node["leftChild"] = walk(2 * g + 1)
            node["rightChild"] = walk(2 * g + 2)
        return my

    walk(0)
    return rows


def _save_forest_model(model: _ForestModel, path: str, class_name: str, extra: dict) -> None:
    """Spark's ``EnsembleModelReadWrite`` layout: ``metadata/`` (with
    numFeatures, numClasses, numTrees), ``treesMetadata/`` (treeID, the
    tree's metadata JSON, weight 1.0) and ``data/`` as (treeID, nodeData)
    rows. Without pyarrow, ``data/part-00000.npz`` holds the heap arrays."""
    from spark_rapids_ml_tpu_torch.core.persistence import _HAS_ARROW

    f = Forest(*(to_host(t) for t in model._forest))
    T = int(f.feature.shape[0])
    classification = "Classification" in class_name
    extra = dict(extra)
    extra.setdefault("numTrees", T)
    save_metadata(model, path, class_name=class_name, extra_metadata=extra)

    if not _HAS_ARROW:  # pragma: no cover - the test image has pyarrow
        data_dir = os.path.join(path, "data")
        os.makedirs(data_dir, exist_ok=True)
        np.savez(os.path.join(data_dir, "part-00000.npz"), **f._asdict())
        return

    import pyarrow as pa
    import pyarrow.parquet as pq

    node_t = _spark_nodedata_type()
    tree_ids, nodes = [], []
    for t in range(T):
        for nd in _tree_to_nodedata(f, t, classification):
            tree_ids.append(t)
            nodes.append(nd)
    data_dir = os.path.join(path, "data")
    os.makedirs(data_dir, exist_ok=True)
    table = pa.Table.from_arrays(
        [pa.array(tree_ids, type=pa.int32()), pa.array(nodes, type=node_t)],
        schema=pa.schema([("treeID", pa.int32()), ("nodeData", node_t)]),
    )
    pq.write_table(table, os.path.join(data_dir, "part-00000.parquet"))
    open(os.path.join(data_dir, "_SUCCESS"), "w").close()

    tree_class = (
        "org.apache.spark.ml.classification.DecisionTreeClassificationModel" if classification
        else "org.apache.spark.ml.regression.DecisionTreeRegressionModel"
    )
    tm_dir = os.path.join(path, "treesMetadata")
    os.makedirs(tm_dir, exist_ok=True)
    tm = pa.Table.from_arrays(
        [
            pa.array(list(range(T)), type=pa.int32()),
            pa.array([json.dumps({"class": tree_class, "uid": f"dtc_{model.uid}_{t}", "paramMap": {}})
                      for t in range(T)], type=pa.string()),
            pa.array([1.0] * T, type=pa.float64()),
        ],
        schema=pa.schema([("treeID", pa.int32()), ("metadata", pa.string()), ("weights", pa.float64())]),
    )
    pq.write_table(tm, os.path.join(tm_dir, "part-00000.parquet"))
    open(os.path.join(tm_dir, "_SUCCESS"), "w").close()


def _forest_from_nodedata(per_tree: list, classification: bool) -> Forest:
    """Spark (treeID, nodeData) rows, one {id: node} dict per tree, as
    heap-indexed CPU tensors. Ids are arbitrary (children are explicit),
    so the walk from each root assigns heap slots; the heap depth is the
    deepest tree's."""

    def node_depth(nodes, nid):
        nd = nodes[nid]
        if nd["leftChild"] < 0:
            return 0
        return 1 + max(node_depth(nodes, nd["leftChild"]), node_depth(nodes, nd["rightChild"]))

    roots = []
    for nodes in per_tree:
        child_ids = set()
        for nd in nodes.values():
            if nd["leftChild"] >= 0:
                child_ids.add(nd["leftChild"])
                child_ids.add(nd["rightChild"])
        roots.append(next(i for i in nodes if i not in child_ids))

    depth = max(node_depth(nodes, r) for nodes, r in zip(per_tree, roots))
    if depth > 20:
        raise ValueError(f"forest depth {depth} exceeds the supported 20")
    T = len(per_tree)
    N = 2 ** (depth + 1) - 1
    s_out = (
        max(len(nd["impurityStats"]) for nodes in per_tree for nd in nodes.values())
        if classification else 1
    )
    feature = np.full((T, N), -1, dtype=np.int32)
    threshold = np.zeros((T, N), dtype=np.float32)
    is_leaf = np.zeros((T, N), dtype=bool)
    leaf_value = np.zeros((T, N, s_out), dtype=np.float32)
    node_weight = np.zeros((T, N), dtype=np.float32)
    node_gain = np.zeros((T, N), dtype=np.float32)
    node_imp = np.zeros((T, N), dtype=np.float32)

    def place(t, nodes, nid, g):
        nd = nodes[nid]
        stats = np.asarray(nd["impurityStats"], dtype=np.float64)
        if classification:
            wsum = float(stats.sum())
            node_weight[t, g] = wsum
            leaf_value[t, g, : stats.size] = stats / wsum if wsum > 0 else 1.0 / stats.size
        else:
            node_weight[t, g] = float(stats[0]) if stats.size else 0.0
            leaf_value[t, g, 0] = nd["prediction"]
        node_imp[t, g] = nd["impurity"]
        if nd["leftChild"] >= 0:
            feature[t, g] = nd["split"]["featureIndex"]
            threshold[t, g] = nd["split"]["leftCategoriesOrThreshold"][0]
            node_gain[t, g] = max(float(nd["gain"]), 0.0)
            place(t, nodes, nd["leftChild"], 2 * g + 1)
            place(t, nodes, nd["rightChild"], 2 * g + 2)
        else:
            is_leaf[t, g] = True

    for t, (nodes, r) in enumerate(zip(per_tree, roots)):
        place(t, nodes, r, 0)
    return Forest(*(torch.from_numpy(a) for a in
                    (feature, threshold, is_leaf, leaf_value, node_weight, node_gain, node_imp)))


def _load_forest_model(path: str, expected_class: str):
    metadata = load_metadata(path, expected_class=expected_class)
    rows = load_rows(path)
    classification = "Classification" in expected_class
    if "nodeData" in rows:
        by_tree: dict = {}
        for tid, nd in zip(rows["treeID"], rows["nodeData"]):
            by_tree.setdefault(int(tid), {})[int(nd["id"])] = nd
        return metadata, _forest_from_nodedata([by_tree[t] for t in sorted(by_tree)], classification)
    if "nodeID" in rows:
        # The reference's directories from before its Spark-schema layout:
        # one row per heap slot of flattened scalar columns, no impurity
        # (loaded as 0; only the NodeData writer reads it).
        tree_id = np.asarray(rows["treeID"])
        node_id = np.asarray(rows["nodeID"])
        T = int(tree_id.max()) + 1
        N = int(node_id.max()) + 1
        order = np.argsort(tree_id * N + node_id)

        def grid(name, dtype):
            return torch.from_numpy(np.asarray(rows[name])[order].reshape(T, N).astype(dtype))

        leaf_value = np.stack([rows["leafValue"][i] for i in order]).reshape(T, N, -1)
        forest = Forest(
            grid("feature", np.int32), grid("threshold", np.float32), grid("isLeaf", bool),
            torch.from_numpy(leaf_value.astype(np.float32)), grid("nodeWeight", np.float32),
            grid("nodeGain", np.float32), torch.zeros((T, N), dtype=torch.float32),
        )
        return metadata, forest
    # The npz written without pyarrow: the raw heap arrays.
    return metadata, Forest(*(torch.from_numpy(np.asarray(rows[k])) for k in Forest._fields))
