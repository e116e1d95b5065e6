"""LogisticRegression estimator/model — port of the reference's
``models/logistic_regression.py``.

Param surface of ``org.apache.spark.ml.classification.LogisticRegression``:
``featuresCol``, ``labelCol``, ``predictionCol``, ``probabilityCol``,
``rawPredictionCol``, ``maxIter``, ``regParam``, ``elasticNetParam`` (0:
L-BFGS; > 0 with ``regParam`` > 0: FISTA), ``tol``, ``fitIntercept``,
``standardization``, ``family`` ("auto" | "binomial" | "multinomial"),
``threshold``, ``weightCol``, ``precision``. The binomial model exposes
``coefficients`` (d,) and ``intercept``; every model ``coefficientMatrix``
(c, d) and ``interceptVector``. A model saved by either package loads in
the other (Spark's data row).

Routes, as in the reference: a tensor pair fits where it lives, in its own
dtype; host data goes to the platform's device in float64 (the reference's
x64 behaviour); ``(source, y)`` with a re-iterable streaming source runs
the multi-pass streaming fit (float64 on the device, scipy's L-BFGS-B on
the host). ``LogisticRegression(fused=...)`` picks the one-sweep objective
(True) or the two-sweep autograd one (False); not given, the
``TPUML_LOGISTIC_FUSED`` knob decides (default 1, fused), as in the
reference.

A host ``(X, y)`` passes the fit memory guard (``core/membudget.py``):
over budget it reroutes through a ``HostArrayBlockReader`` to the
streaming fit (bit-identical to an explicit reader), and so does a device
OOM mid-fit; ``weightCol``, elastic net and warm starts cannot stream, so
they raise ``FitMemoryError`` instead.

``LogisticRegressionModel.serving_signature()`` declares the forward
kernel ``predict`` runs, with :func:`_select_labels` as its
transform-on-array contract, for the pipeline fuser.

With a mesh (``LogisticRegression(mesh=make_mesh(...))``, or
``setDeployMode("gang")`` in a gang) the objective is summed per data
shard and over the data axis (``ops/logistic.py``); a gang agrees on the
class count first (``allgather_host_max``). A streaming source refuses a
mesh.

With ``TPUML_CHECKPOINT_DIR`` set and ``TPUML_CHECKPOINT_EVERY`` positive,
the in-memory L-BFGS fit (one device or a mesh) runs segmented
(``ops/logistic.fit_logistic_resumable``), snapshots the host optimizer
state after every segment and resumes mid-solve, bitwise the monolithic
fit. The elastic net (FISTA) and the streaming fit are not checkpointed,
as in the reference.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import DataFrame, as_matrix, extract_weights, is_device_array
from spark_rapids_ml_tpu_torch.core.data import is_reiterable_stream, is_streaming_source
from spark_rapids_ml_tpu_torch.core import membudget
from spark_rapids_ml_tpu_torch.core.estimator import Estimator, Model
from spark_rapids_ml_tpu_torch.core.ingest import matrix_like, prepare_labels, prepare_rows, validate_int_labels
from spark_rapids_ml_tpu_torch.core.lazy_state import LazyHostState, to_host
from spark_rapids_ml_tpu_torch.core.params import Param, Params, toBoolean, toFloat, toInt, toString
from spark_rapids_ml_tpu_torch.core.persistence import (
    MLReadable,
    get_and_set_params,
    load_data,
    load_metadata,
    save_data,
    save_metadata,
)
from spark_rapids_ml_tpu_torch.core.serving import note_device_cache, serve_blocks, serve_rows
from spark_rapids_ml_tpu_torch.models.linear_regression import _extract_xy, _streaming_blocks
from spark_rapids_ml_tpu_torch.ops.logistic import (
    classification_metrics,
    fit_logistic,
    fit_logistic_elastic_net,
    fit_logistic_resumable,
    fit_logistic_streaming,
    predict_logistic,
    streaming_label_feature_stats,
)
from spark_rapids_ml_tpu_torch.ops.precision import resolve_policy, validate_mode
from spark_rapids_ml_tpu_torch.parallel.collectives import process_count
from spark_rapids_ml_tpu_torch.parallel.distributed import allgather_host_max
from spark_rapids_ml_tpu_torch.observability import costs as _costs
from spark_rapids_ml_tpu_torch.serving.signature import ServingSignature, spec
from spark_rapids_ml_tpu_torch.utils.envknobs import env_choice
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange



def _forward_kernel(x, w, b, *, n_classes: int = 0, threshold: float, precision: str = "highest"):
    """Serving kernel: one forward pass → (labels, probabilities, raw
    margins); the batch follows the weights' dtype, and binomial labels
    honour the threshold. ``n_classes`` is the model's class count, static
    as in the reference's kernel (the weights' width decides the link)."""
    labels, probs, raw = predict_logistic(x.to(w.dtype), w, b, n_classes=n_classes, precision=precision)
    if w.shape[1] == 1 and threshold != 0.5:
        labels = (probs[:, 1] > threshold).to(torch.int32)
    return labels, probs, raw


def _forward_cost(rows, d, dtype, weights, static):
    """The forward pass's work: one (rows, d) · (d, c) GEMM for the
    margins, one exponential per margin; the weights and intercepts read
    once, int32 labels and two (rows, max(2, c)) blocks written once."""
    w = weights[0]
    c = int(w.shape[1])
    item = w.element_size()
    out = _costs.gemm_cost(rows, d, c, item)
    n_out = max(2, c)
    out["transcendentals"] = float(rows * c)
    out["bytes_accessed"] = float((rows * d + d * c + c) * item + 4 * rows + 2 * rows * n_out * item)
    return out


_costs.register_cost(_forward_kernel, _forward_cost)


def _select_labels(outs):
    """Transform-on-array contract for the fuser: a pipeline ending in a
    classifier yields the labels of the (labels, probabilities, raw)
    triple, as ``transform`` of a plain array does."""
    labels, _probs, _raw = outs
    return labels


class _LogisticRegressionParams(Params):
    featuresCol = Param("_", "featuresCol", "features column name", toString)
    labelCol = Param("_", "labelCol", "label column name", toString)
    predictionCol = Param("_", "predictionCol", "prediction column name", toString)
    probabilityCol = Param("_", "probabilityCol", "class probabilities column", toString)
    rawPredictionCol = Param("_", "rawPredictionCol", "raw logits column", toString)
    maxIter = Param("_", "maxIter", "maximum L-BFGS iterations", toInt)
    regParam = Param("_", "regParam", "L2 regularization strength", toFloat)
    elasticNetParam = Param("_", "elasticNetParam", "L1/L2 mixing (0 = pure L2)", toFloat)
    tol = Param("_", "tol", "gradient-norm convergence tolerance", toFloat)
    fitIntercept = Param("_", "fitIntercept", "whether to fit an intercept", toBoolean)
    standardization = Param("_", "standardization", "optimize in standardized feature space", toBoolean)
    family = Param("_", "family", "auto, binomial, or multinomial", toString)
    threshold = Param("_", "threshold", "binary decision threshold", toFloat)
    weightCol = Param("_", "weightCol", "per-row weight column name", toString)
    precision = Param(
        "_", "precision",
        "matmul precision of the sweeps: highest/f32 (default) | high/bf16x3 | default/bf16",
        toString,
    )

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(
            featuresCol="features",
            labelCol="label",
            predictionCol="prediction",
            probabilityCol="probability",
            rawPredictionCol="rawPrediction",
            maxIter=100,
            regParam=0.0,
            elasticNetParam=0.0,
            tol=1e-6,
            fitIntercept=True,
            standardization=True,
            family="auto",
            threshold=0.5,
            precision="highest",
        )

    def getFeaturesCol(self) -> str:
        return self.getOrDefault(self.featuresCol)

    def getLabelCol(self) -> str:
        return self.getOrDefault(self.labelCol)

    def getPredictionCol(self) -> str:
        return self.getOrDefault(self.predictionCol)

    def getProbabilityCol(self) -> str:
        return self.getOrDefault(self.probabilityCol)

    def getRawPredictionCol(self) -> str:
        return self.getOrDefault(self.rawPredictionCol)

    def getMaxIter(self) -> int:
        return self.getOrDefault(self.maxIter)

    def getRegParam(self) -> float:
        return self.getOrDefault(self.regParam)

    def getElasticNetParam(self) -> float:
        return self.getOrDefault(self.elasticNetParam)

    def getTol(self) -> float:
        return self.getOrDefault(self.tol)

    def getFitIntercept(self) -> bool:
        return self.getOrDefault(self.fitIntercept)

    def getStandardization(self) -> bool:
        return self.getOrDefault(self.standardization)

    def getFamily(self) -> str:
        return self.getOrDefault(self.family)

    def getThreshold(self) -> float:
        return self.getOrDefault(self.threshold)

    def getPrecision(self) -> str:
        return self.getOrDefault(self.precision)

    def getWeightCol(self) -> Optional[str]:
        return self.getOrDefault(self.weightCol) if self.isDefined(self.weightCol) else None


def _resolve_family(family: str, n_classes: int):
    """``(family, n_classes)`` as the reference resolves them: ``auto`` is
    binomial up to 2 labels; binomial refuses more."""
    if family == "auto":
        family = "binomial" if n_classes <= 2 else "multinomial"
    if family == "binomial" and n_classes > 2:
        raise ValueError(f"binomial family with {n_classes} labels")
    return family, max(n_classes, 2)


class LogisticRegression(_LogisticRegressionParams, Estimator, MLReadable):
    """``LogisticRegression().setRegParam(0.1).fit((X, y))``."""

    # Consumes tensors in place, so tuning loops may feed fold slices
    # that stay on the device (tuning._device_fold_prep).
    _device_foldable = True

    def __init__(self, uid: Optional[str] = None, mesh=None, fused: Optional[bool] = None):
        super().__init__(uid)
        self.mesh = mesh
        self.fused = fused

    def _use_fused(self) -> bool:
        """The ``fused`` argument when given, else ``TPUML_LOGISTIC_FUSED``
        (default 1: the one-sweep objective)."""
        if self.fused is not None:
            return bool(self.fused)
        return env_choice("TPUML_LOGISTIC_FUSED", ("0", "1"), "1") == "1"

    def setFeaturesCol(self, value: str) -> "LogisticRegression":
        return self.set(self.featuresCol, value)

    def setLabelCol(self, value: str) -> "LogisticRegression":
        return self.set(self.labelCol, value)

    def setPredictionCol(self, value: str) -> "LogisticRegression":
        return self.set(self.predictionCol, value)

    def setProbabilityCol(self, value: str) -> "LogisticRegression":
        return self.set(self.probabilityCol, value)

    def setRawPredictionCol(self, value: str) -> "LogisticRegression":
        return self.set(self.rawPredictionCol, value)

    def setMaxIter(self, value: int) -> "LogisticRegression":
        return self.set(self.maxIter, value)

    def setRegParam(self, value: float) -> "LogisticRegression":
        if value < 0:
            raise ValueError(f"regParam must be >= 0, got {value}")
        return self.set(self.regParam, value)

    def setElasticNetParam(self, value: float) -> "LogisticRegression":
        if not 0.0 <= value <= 1.0:
            raise ValueError(f"elasticNetParam must be in [0, 1], got {value}")
        return self.set(self.elasticNetParam, value)

    def setTol(self, value: float) -> "LogisticRegression":
        return self.set(self.tol, value)

    def setFitIntercept(self, value: bool) -> "LogisticRegression":
        return self.set(self.fitIntercept, value)

    def setStandardization(self, value: bool) -> "LogisticRegression":
        return self.set(self.standardization, value)

    def setFamily(self, value: str) -> "LogisticRegression":
        if value not in ("auto", "binomial", "multinomial"):
            raise ValueError(f"family must be auto/binomial/multinomial, got {value!r}")
        return self.set(self.family, value)

    def setThreshold(self, value: float) -> "LogisticRegression":
        return self.set(self.threshold, value)

    def setPrecision(self, value: str) -> "LogisticRegression":
        return self.set(self.precision, validate_mode(value))

    def setWeightCol(self, value: str) -> "LogisticRegression":
        return self.set(self.weightCol, value)

    def setMesh(self, mesh) -> "LogisticRegression":
        self.mesh = mesh
        return self

    _initial_weights = None  # (weights (d, c), intercepts (c,)) warm start
    _copy_attrs = ("_initial_weights", "fused")

    def setInitialModel(self, value) -> "LogisticRegression":
        """Warm-start L-BFGS from a model's solution (the L2 /
        unregularized path)."""
        w = to_host(value.weights, np.float64)
        b = to_host(value.intercepts, np.float64)
        if w.ndim != 2 or b.ndim != 1 or w.shape[1] != b.shape[0]:
            raise ValueError("initial model must carry (d, c) weights and (c,) intercepts")
        self._initial_weights = (w, b)
        return self

    def _train_precision(self) -> str:
        requested = self.getPrecision() if self.isSet(self.precision) else None
        return resolve_policy("logistic", requested, default=self.getPrecision())

    def _fit(self, dataset: Any) -> "LogisticRegressionModel":
        if isinstance(dataset, tuple) and len(dataset) == 2 and is_streaming_source(dataset[0]):
            if self.mesh is not None:
                raise ValueError(
                    "streaming LogisticRegression is single-device; pass host "
                    "partitions for a mesh fit"
                )
            return self._fit_streaming(dataset)
        x_in, y_in = _extract_xy(dataset, self.getFeaturesCol(), self.getLabelCol())
        w_host = extract_weights(dataset, self.getWeightCol())
        # Over budget, the input reroutes to the (reader, y) streaming fit an
        # explicit reader takes (bit-identical); a device OOM mid-fit takes
        # the same exit.
        return membudget.fit_within_budget(
            "logistic", x_in, lambda: self._fit_in_memory(x_in, y_in, w_host),
            lambda reader: self._fit((reader, y_in)),
            can_stream=(
                w_host is None
                and not (self.getElasticNetParam() > 0.0 and self.getRegParam() > 0.0)
                and self._initial_weights is None
            ),
            why_cannot_stream="the streaming path supports neither "
                              "weightCol, elastic net, nor warm starts",
            mesh=self.mesh, dtype=torch.float64, ledger_families=("logistic",),
        )

    def _fit_in_memory(self, x_in, y_in, w_host) -> "LogisticRegressionModel":
        # Tensor labels validate where they live: one readback.
        y_int, n_classes = validate_int_labels(y_in)
        if self.mesh is not None and process_count() > 1:
            # Each member counted classes from its own labels; the class
            # count sets the objective's shapes, so the gang agrees on it.
            n_classes = allgather_host_max(n_classes)
        family, n_classes = _resolve_family(self.getFamily(), n_classes)
        with TraceRange("logreg fit", TraceColor.YELLOW):
            xs, mask, n, d = prepare_rows(x_in, mesh=self.mesh, dtype=torch.float64, weights=w_host)
            if self.mesh is not None:
                ys = prepare_labels(y_int, n, dtype=torch.int64, rows=xs)
            else:
                ys = prepare_labels(y_int, n, n_true=n, dtype=torch.int64, device=xs.device)
            multinomial = family == "multinomial"
            common = dict(
                n_classes=n_classes,
                fit_intercept=self.getFitIntercept(),
                standardization=self.getStandardization(),
                max_iter=self.getMaxIter(),
                tol=self.getTol(),
                multinomial=multinomial,
                fused=self._use_fused(),
                precision=self._train_precision(),
            )
            enet = self.getElasticNetParam()
            if enet == 0.0 or self.getRegParam() == 0.0:
                init_w = init_b = None
                if self._initial_weights is not None:
                    init_w, init_b = self._initial_weights
                    c_expect = n_classes if (multinomial or n_classes > 2) else 1
                    if init_w.shape != (d, c_expect):
                        raise ValueError(
                            f"initial model weights {init_w.shape} != expected ({d}, {c_expect})"
                        )
                # Preemption tolerance: the TPUML_CHECKPOINT_* knobs route the
                # solve through the segmented solver (robustness/checkpoint.py).
                # A mesh fit's fingerprint is of its real rows at the true
                # width, so any mesh shape resumes the same snapshot.
                data = (([xs.local_rows(i) for i in range(len(xs.blocks))], ys, xs.masks)
                        if self.mesh is not None else (xs, ys, mask))
                ckpt = self._fit_checkpointer("logistic.lbfgs", data=data)
                if ckpt is not None:
                    result = fit_logistic_resumable(xs, ys, mask, ckpt, reg_param=self.getRegParam(),
                                                    init_w=init_w, init_b=init_b, **common)
                else:
                    result = fit_logistic(xs, ys, mask, reg_param=self.getRegParam(),
                                          init_w=init_w, init_b=init_b, **common)
            else:
                if self._initial_weights is not None:
                    raise ValueError(
                        "setInitialModel warm start applies to the L-BFGS "
                        "path (elasticNetParam 0 or regParam 0)"
                    )
                result = fit_logistic_elastic_net(xs, ys, mask, reg_param=self.getRegParam(),
                                                  elastic_net_param=enet, **common)
        model = LogisticRegressionModel(self.uid, result.weights, result.intercepts,
                                        numClasses=n_classes, numIter=result.n_iter)
        return self._copyValues(model)

    def _fit_streaming(self, dataset) -> "LogisticRegressionModel":
        """A re-iterable ``(source, y)``: one host pass for the feature
        moments and the labels, then one device pass per objective
        evaluation (:func:`fit_logistic_streaming`)."""
        if not is_reiterable_stream(dataset[0]):
            raise ValueError(
                "LogisticRegression is multi-pass: a streaming fit needs a "
                "RE-ITERABLE source (a zero-arg iterator factory or a block "
                "reader with .iter_blocks()), not a one-shot generator"
            )
        if self.getWeightCol() is not None:
            raise TypeError(
                "weightCol requires a dataset with named columns; streaming "
                "block sources carry no columns"
            )
        if self.getElasticNetParam() > 0.0 and self.getRegParam() > 0.0:
            raise ValueError(
                "streaming elastic net is not supported (FISTA needs the "
                "in-memory design); use elasticNetParam=0 or materialize"
            )
        if self._initial_weights is not None:
            raise ValueError("setInitialModel warm start is not supported for streaming fits yet")
        n, mean, sigma, y_max, y_int_ok = streaming_label_feature_stats(_streaming_blocks(dataset))
        if not y_int_ok:
            raise ValueError("labels must be integers in [0, numClasses)")
        family, n_classes = _resolve_family(self.getFamily(), y_max + 1)
        with TraceRange("logreg stream fit", TraceColor.YELLOW):
            result = fit_logistic_streaming(
                lambda: _streaming_blocks(dataset),
                n_classes,
                n=n,
                mean=mean,
                sigma=sigma,
                reg_param=self.getRegParam(),
                fit_intercept=self.getFitIntercept(),
                standardization=self.getStandardization(),
                max_iter=self.getMaxIter(),
                tol=self.getTol(),
                multinomial=family == "multinomial",
                fused=self._use_fused(),
                precision=self._train_precision(),
            )
        model = LogisticRegressionModel(self.uid, result.weights, result.intercepts,
                                        numClasses=n_classes, numIter=result.n_iter)
        return self._copyValues(model)


class LogisticRegressionModel(_LogisticRegressionParams, Model, LazyHostState):
    """Fitted model. ``weights``: (d, 1) sigmoid column or (d, c) softmax
    matrix; ``intercepts``: (1,) or (c,). Fitted state may be tensors from
    a fit on the card; the host float64 views convert lazily."""

    _lazy_host_fields = {"_w_raw": ("_w_np", np.float64), "_b_raw": ("_b_np", np.float64)}
    _pickle_clear = ("_wb_dev",)

    def __init__(self, uid: Optional[str] = None, weights=None, intercepts=None, numClasses: int = 2,
                 numIter: int = 0):
        super().__init__(uid)
        self._w_raw = weights
        self._b_raw = intercepts
        self._w_np: Optional[np.ndarray] = None
        self._b_np: Optional[np.ndarray] = None
        self._wb_dev: Optional[dict] = None
        self.numClasses = numClasses
        self._iter_raw = numIter

    def __getstate__(self):
        state = super().__getstate__()
        state["_iter_raw"] = self.numIter
        return state

    @property
    def weights(self) -> Optional[np.ndarray]:
        return self._lazy_host_view("_w_raw")

    @property
    def intercepts(self) -> Optional[np.ndarray]:
        return self._lazy_host_view("_b_raw")

    @property
    def numIter(self) -> int:
        if not isinstance(self._iter_raw, int):
            self._iter_raw = int(self._iter_raw)
        return self._iter_raw

    def setFeaturesCol(self, value: str) -> "LogisticRegressionModel":
        return self.set(self.featuresCol, value)

    def setPredictionCol(self, value: str) -> "LogisticRegressionModel":
        return self.set(self.predictionCol, value)

    def setProbabilityCol(self, value: str) -> "LogisticRegressionModel":
        return self.set(self.probabilityCol, value)

    def setRawPredictionCol(self, value: str) -> "LogisticRegressionModel":
        return self.set(self.rawPredictionCol, value)

    def setThreshold(self, value: float) -> "LogisticRegressionModel":
        return self.set(self.threshold, value)

    def copy(self, extra=None) -> "LogisticRegressionModel":
        that = LogisticRegressionModel(self.uid, self._w_raw, self._b_raw, self.numClasses, self._iter_raw)
        return self._copyValues(that, extra)

    @property
    def coefficients(self) -> np.ndarray:
        """Binomial coefficient vector (d,); multinomial raises, as in Spark."""
        if self.weights.shape[1] != 1:
            raise AttributeError("multinomial model: use coefficientMatrix")
        return self.weights[:, 0]

    @property
    def intercept(self) -> float:
        if self.intercepts.shape[0] != 1:
            raise AttributeError("multinomial model: use interceptVector")
        return float(self.intercepts[0])

    @property
    def coefficientMatrix(self) -> np.ndarray:
        """Spark's orientation: (1, d) binomial, (numClasses, d) multinomial."""
        return self.weights.T

    @property
    def interceptVector(self) -> np.ndarray:
        return self.intercepts.copy()

    def predict(self, x):
        return self._predict_all(x)[0]

    def predictProbability(self, x):
        return self._predict_all(x)[1]

    def predictRaw(self, x):
        """Raw margins (Spark's rawPrediction): [−z, z] binomial, the
        logits multinomial — not probabilities."""
        return self._predict_all(x)[2]

    def _serving_precision(self) -> str:
        requested = self.getPrecision() if self.isSet(self.precision) else None
        return resolve_policy("serving", requested)

    def _wb_on(self, device: torch.device, dtype: torch.dtype):
        """(weights, intercepts) at ``dtype`` on ``device``, cached and
        registered with ``core/serving``."""
        if self._wb_dev is None:
            self._wb_dev = {}
        key = (str(device), str(dtype))
        if key not in self._wb_dev:
            w = self._w_raw if isinstance(self._w_raw, torch.Tensor) else torch.tensor(self.weights)
            b = self._b_raw if isinstance(self._b_raw, torch.Tensor) else torch.tensor(self.intercepts)
            self._wb_dev[key] = (w.to(device=device, dtype=dtype), b.to(device=device, dtype=dtype))
            note_device_cache(self)
        return self._wb_dev[key]

    def _predict_all(self, x):
        """One forward pass: ``(labels, probabilities, raw margins)``,
        through the bucketed program cache. A tensor is served where it
        lives, at the fitted weights' dtype, and gets tensors back; host
        input goes to the device in float64 blocks (``serve_blocks``) and
        comes back as numpy."""
        if self._w_raw is None:
            raise RuntimeError("model has no weights")
        static = self._serving_static()
        x = matrix_like(x)
        if is_device_array(x):
            w, b = self._wb_on(_device.device_of(x), self._fitted_dtype())
            return serve_rows(_forward_kernel, x, (w, b), static=static, name="logreg.predict")
        device = _device.resolve_device()
        w, b = self._wb_on(device, torch.float64)
        out = serve_blocks(_forward_kernel, x, (w, b), static=static, name="logreg.predict",
                           device=device, host_dtype=np.float64)
        if out is None:
            k = max(2, w.shape[1])
            return (np.zeros((0,), np.int32), np.zeros((0, k)), np.zeros((0, k)))
        return tuple(out)

    def _fitted_dtype(self) -> torch.dtype:
        return self._w_raw.dtype if isinstance(self._w_raw, torch.Tensor) else torch.float64

    def _serving_static(self) -> dict:
        return {
            "n_classes": int(self.numClasses),
            "threshold": float(self.getThreshold()),
            "precision": self._serving_precision(),
        }

    def serving_signature(self) -> ServingSignature:
        """The serving contract: the forward kernel ``predict`` runs, the
        (weights, intercepts) pair at the fitted dtype on the platform's
        device (the tensor route's), the float64 pair as ``host_weights``
        where the fit was not float64 (the host route's), the (labels,
        probabilities, raw margins) specs, and :func:`_select_labels`."""
        if self._w_raw is None:
            raise RuntimeError("model has no weights")
        device = _device.resolve_device()
        fitted = self._fitted_dtype()
        w, b = self._wb_on(device, fitted)
        n_out = max(2, int(w.shape[1]))
        return ServingSignature(
            kernel=_forward_kernel,
            weights=(w, b),
            static=self._serving_static(),
            name="logreg.predict",
            n_features=int(w.shape[0]),
            output_spec=lambda n, dtype: (
                spec((n,), torch.int32), spec((n, n_out), w.dtype), spec((n, n_out), w.dtype),
            ),
            select=_select_labels,
            host_weights=None if fitted == torch.float64 else self._wb_on(device, torch.float64),
        )

    def transform(self, dataset: Any) -> Any:
        if isinstance(dataset, DataFrame):
            labels, probs, raw = (to_host(a) for a in self._predict_all(as_matrix(dataset.select(self.getFeaturesCol()))))
            out = dataset.withColumn(self.getRawPredictionCol(), list(raw))
            out = out.withColumn(self.getProbabilityCol(), list(probs))
            return out.withColumn(self.getPredictionCol(), list(labels))
        try:
            import pandas as pd
        except ImportError:  # pragma: no cover
            pd = None
        if pd is not None and isinstance(dataset, pd.DataFrame):
            if self.getFeaturesCol() in dataset.columns:
                x = as_matrix(dataset[self.getFeaturesCol()].tolist())
            else:
                cols = [c for c in dataset.columns if c != self.getLabelCol()]
                x = dataset[cols].to_numpy(dtype=np.float64)
            labels, probs, raw = (to_host(a) for a in self._predict_all(x))
            out = dataset.copy()
            out[self.getRawPredictionCol()] = list(raw)
            out[self.getProbabilityCol()] = list(probs)
            out[self.getPredictionCol()] = labels
            return out
        return self.predict(dataset)

    def evaluate(self, dataset: Any) -> dict:
        """Summary metrics: accuracy and error rate on a labeled dataset,
        computed where the predictions are."""
        x, y = _extract_xy(dataset, self.getFeaturesCol(), self.getLabelCol())
        pred = self.predict(x)
        pred = pred if isinstance(pred, torch.Tensor) else torch.from_numpy(pred)
        y_t = y.reshape(-1) if isinstance(y, torch.Tensor) else torch.from_numpy(np.asarray(y))
        y_t = y_t.to(device=pred.device, dtype=torch.int32)
        mask = torch.ones(y_t.shape[0], dtype=torch.float64, device=pred.device)
        acc, err = torch.stack(classification_metrics(y_t, pred.to(torch.int32), mask)).tolist()
        return {"accuracy": acc, "errorRate": err}

    def _save_impl(self, path: str) -> None:
        save_metadata(
            self,
            path,
            class_name="org.apache.spark.ml.classification.LogisticRegressionModel",
            extra_metadata={"numClasses": self.numClasses, "numIter": self.numIter},
        )
        # Spark LogisticRegressionModel's data row: numClasses, numFeatures,
        # interceptVector, coefficientMatrix ((1, d) binomial / (C, d)
        # multinomial), isMultinomial.
        save_data(
            path,
            {
                "numClasses": ("scalar", int(self.numClasses)),
                "numFeatures": ("scalar", int(self.weights.shape[0])),
                "interceptVector": ("vector", self.intercepts),
                "coefficientMatrix": ("matrix", self.coefficientMatrix),
                "isMultinomial": ("scalar", bool(self.intercepts.shape[0] > 1)),
            },
        )

    @classmethod
    def _load_impl(cls, path: str) -> "LogisticRegressionModel":
        metadata = load_metadata(path, expected_class="LogisticRegressionModel")
        data = load_data(path)
        if "coefficientMatrix" in data:
            weights = np.asarray(data["coefficientMatrix"], dtype=np.float64).T  # (d, 1|C)
            intercepts = np.asarray(data["interceptVector"], dtype=np.float64)
            n_classes = int(data.get("numClasses", metadata.get("numClasses", 2)))
        else:  # directories written before the Spark-schema alignment
            weights = np.asarray(data["weights"], dtype=np.float64)
            intercepts = np.asarray(data["intercepts"], dtype=np.float64)
            n_classes = metadata.get("numClasses", 2)
        model = cls(metadata["uid"], weights, intercepts, numClasses=n_classes,
                    numIter=metadata.get("numIter", 0))
        get_and_set_params(model, metadata)
        return model
