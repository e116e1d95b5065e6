"""LinearRegression estimator/model — port of the reference's
``models/linear_regression.py``.

Param surface of ``org.apache.spark.ml.regression.LinearRegression``:
``featuresCol``, ``labelCol``, ``predictionCol``, ``fitIntercept``,
``regParam``, ``elasticNetParam`` (0: the exact normal-equation solve;
> 0 with ``regParam`` > 0: FISTA on the same statistics, which
``solver="normal"`` rejects as Spark does), ``standardization``,
``solver``, ``weightCol``, ``precision``.

Routes, as in the reference: a tensor pair fits where it lives, in its
own dtype; host data goes to the platform's device in float64 (the
reference's x64 behaviour); ``(blocks, y)`` — a list of 2-D blocks, a
factory, a block reader or a one-shot generator — accumulates the
statistics one block at a time (``normal_eq_stats_streaming``, float64).
``precision="dd"`` computes the moments in native float64 on the card
and solves them on the host in float64 (``solve_normal_host``); it takes
host input only, as the reference's does. ``"auto"`` resolves to
``"highest"``: the card has float64, so nothing routes to ``dd`` quietly.
``setInitialModel`` warm-starts FISTA.

A host ``(X, y)`` passes the fit memory guard (``core/membudget.py``):
over budget it reroutes through a ``HostArrayBlockReader`` to the
streaming statistics (bit-identical to an explicit reader), and so does a
device OOM mid-fit; ``weightCol`` cannot stream, so it raises
``FitMemoryError`` instead.

Left out until their ROADMAP items: a mesh (A.9, item 8d) and
``serving_signature`` (A.8, item 17) raise ``NotImplementedError``; the
resumable FISTA (A.9, robustness) is switched on by knobs the port does
not read yet, so no fit reaches it.
"""

from __future__ import annotations

from itertools import zip_longest
from typing import Any, Optional

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import device as _device
from spark_rapids_ml_tpu_torch.core.data import (
    DataFrame,
    as_matrix,
    dense_block,
    extract_weights,
    is_device_array,
    is_streaming_source,
    iter_stream_blocks,
)
from spark_rapids_ml_tpu_torch.core import membudget
from spark_rapids_ml_tpu_torch.core.estimator import Estimator, Model
from spark_rapids_ml_tpu_torch.core.ingest import matrix_like, prepare_labels, prepare_rows
from spark_rapids_ml_tpu_torch.core.lazy_state import LazyHostState, to_host
from spark_rapids_ml_tpu_torch.core.params import Param, Params, toBoolean, toFloat, toString
from spark_rapids_ml_tpu_torch.core.persistence import (
    MLReadable,
    get_and_set_params,
    load_data,
    load_metadata,
    save_data,
    save_metadata,
)
from spark_rapids_ml_tpu_torch.core.serving import DEFAULT_STREAM_BLOCK, serve_rows, serve_stream
from spark_rapids_ml_tpu_torch.ops.linalg import resolve_precision, validate_precision
from spark_rapids_ml_tpu_torch.ops.linear import (
    normal_eq_stats,
    normal_eq_stats_streaming,
    predict_linear,
    regression_metrics,
    solve_elastic_net,
    solve_normal,
    solve_normal_host,
)
from spark_rapids_ml_tpu_torch.ops.precision import resolve_policy
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange

MESH_ITEM = "the mesh route of LinearRegression is not ported yet: ROADMAP A.9 (item 8d)"
SERVING_SIGNATURE_ITEM = "serving_signature is not ported yet: ROADMAP A.8 (item 17, with the serving slice)"


def _predict_kernel(x, coef, intercept, *, precision: str = "highest"):
    """Serving kernel: X·coef + b, the coefficients at the batch dtype."""
    return predict_linear(x, coef.to(x.dtype), intercept.to(x.dtype), precision=precision)


class _LinearRegressionParams(Params):
    featuresCol = Param("_", "featuresCol", "features column name", toString)
    labelCol = Param("_", "labelCol", "label column name", toString)
    predictionCol = Param("_", "predictionCol", "prediction column name", toString)
    fitIntercept = Param("_", "fitIntercept", "whether to fit an intercept", toBoolean)
    regParam = Param("_", "regParam", "L2 regularization strength", toFloat)
    elasticNetParam = Param("_", "elasticNetParam", "L1/L2 mixing (0 = pure L2)", toFloat)
    standardization = Param("_", "standardization", "penalize standardized coefficients", toBoolean)
    solver = Param("_", "solver", "normal or auto", toString)
    weightCol = Param("_", "weightCol", "per-row weight column name", toString)
    precision = Param(
        "_", "precision",
        "auto | default | high | highest | dd (float64 moments, host float64 solve)",
        toString,
    )

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid)
        self._setDefault(
            featuresCol="features",
            labelCol="label",
            predictionCol="prediction",
            fitIntercept=True,
            regParam=0.0,
            elasticNetParam=0.0,
            standardization=True,
            solver="auto",
            precision="auto",
        )

    def getFeaturesCol(self) -> str:
        return self.getOrDefault(self.featuresCol)

    def getLabelCol(self) -> str:
        return self.getOrDefault(self.labelCol)

    def getPredictionCol(self) -> str:
        return self.getOrDefault(self.predictionCol)

    def getFitIntercept(self) -> bool:
        return self.getOrDefault(self.fitIntercept)

    def getRegParam(self) -> float:
        return self.getOrDefault(self.regParam)

    def getElasticNetParam(self) -> float:
        return self.getOrDefault(self.elasticNetParam)

    def getStandardization(self) -> bool:
        return self.getOrDefault(self.standardization)

    def getSolver(self) -> str:
        return self.getOrDefault(self.solver)

    def getWeightCol(self) -> Optional[str]:
        return self.getOrDefault(self.weightCol) if self.isDefined(self.weightCol) else None

    def getPrecision(self) -> str:
        return self.getOrDefault(self.precision)


class LinearRegression(_LinearRegressionParams, Estimator, MLReadable):
    """OLS / ridge by the normal equations, elastic net by FISTA:
    ``LinearRegression().setRegParam(0.1).fit((X, y))``; the input is
    ``(X, y)``, a DataFrame shim or a pandas frame with feature and label
    columns, or ``(blocks, y)`` for a streaming fit."""

    def __init__(self, uid: Optional[str] = None, mesh=None):
        super().__init__(uid)
        self.mesh = mesh

    def setFeaturesCol(self, value: str) -> "LinearRegression":
        return self.set(self.featuresCol, value)

    def setLabelCol(self, value: str) -> "LinearRegression":
        return self.set(self.labelCol, value)

    def setPredictionCol(self, value: str) -> "LinearRegression":
        return self.set(self.predictionCol, value)

    def setFitIntercept(self, value: bool) -> "LinearRegression":
        return self.set(self.fitIntercept, value)

    def setRegParam(self, value: float) -> "LinearRegression":
        if value < 0:
            raise ValueError(f"regParam must be >= 0, got {value}")
        return self.set(self.regParam, value)

    def setElasticNetParam(self, value: float) -> "LinearRegression":
        if not 0.0 <= value <= 1.0:
            raise ValueError(f"elasticNetParam must be in [0, 1], got {value}")
        return self.set(self.elasticNetParam, value)

    def setStandardization(self, value: bool) -> "LinearRegression":
        return self.set(self.standardization, value)

    def setSolver(self, value: str) -> "LinearRegression":
        if value not in ("normal", "auto"):
            raise ValueError(f"solver must be 'normal' or 'auto', got {value!r}")
        return self.set(self.solver, value)

    def setWeightCol(self, value: str) -> "LinearRegression":
        return self.set(self.weightCol, value)

    def setPrecision(self, value: str) -> "LinearRegression":
        """GEMM precision of the statistics; ``"dd"`` computes them in
        float64 and solves on the host in float64."""
        return self.set(self.precision, validate_precision(value))

    def setMesh(self, mesh) -> "LinearRegression":
        self.mesh = mesh
        return self

    _initial_coef = None  # (d,) FISTA warm start, original space
    _copy_attrs = ("_initial_coef",)

    def setInitialModel(self, value) -> "LinearRegression":
        """Warm-start FISTA from a model's coefficients (or a raw ``(d,)``
        array). The exact normal-equation solve has no iteration to seed
        and rejects it at fit time."""
        coef = value.coefficients if hasattr(value, "coefficients") else value
        coef = to_host(coef, np.float64)
        if coef.ndim != 1:
            raise ValueError("initial model/coefficients must be a (d,) vector")
        self._initial_coef = coef
        return self

    def _uses_fista(self) -> bool:
        return self.getElasticNetParam() > 0.0 and self.getRegParam() > 0.0

    def _resolved_precision(self) -> str:
        """The GEMM mode of this fit: an explicit ``setPrecision`` wins,
        ``"auto"`` is ``"highest"``; an explicit ``"dd"`` refuses the
        combinations that have no ``dd`` route, as the reference does."""
        explicit = self.getPrecision() if self.isSet(self.precision) else None
        resolved = resolve_precision(resolve_policy("linear", explicit, default=self.getPrecision()))
        if resolved != "dd":
            return resolved
        blockers = []
        if self.getWeightCol() is not None:
            blockers.append("weightCol")
        if self._uses_fista():
            blockers.append("elastic net (FISTA)")
        if blockers:
            raise ValueError("precision='dd' does not support " + ", ".join(blockers))
        return "dd"

    def _fit_dd(self, block_pairs) -> "LinearRegressionModel":
        """Float64 moments on the device, solved on the host in float64."""
        with TraceRange("linreg dd fit", TraceColor.DARK_GREEN):
            xtx, xty, x_sum, y_sum, _, count = normal_eq_stats_streaming(
                block_pairs, dtype=torch.float64, precision="highest"
            )
            coef, intercept = solve_normal_host(
                xtx, xty, x_sum, y_sum, count,
                reg_param=self.getRegParam(),
                fit_intercept=self.getFitIntercept(),
                standardization=self.getStandardization(),
            )
        return self._copyValues(LinearRegressionModel(self.uid, np.asarray(coef, dtype=np.float64), float(intercept)))

    def _fit(self, dataset: Any) -> "LinearRegressionModel":
        if self.getElasticNetParam() > 0.0 and self.getSolver() == "normal":
            raise ValueError(
                "solver='normal' supports only L2 (elasticNetParam must "
                "be 0); use solver='auto' for elastic net"
            )
        if self.mesh is not None:
            raise NotImplementedError(MESH_ITEM)
        streaming = _streaming_blocks(dataset) if self.getWeightCol() is None else None
        if streaming is not None:
            prec = self._resolved_precision()
            if prec == "dd":
                return self._fit_dd(streaming)
            with TraceRange("linreg fit", TraceColor.DARK_GREEN):
                stats = normal_eq_stats_streaming(streaming, dtype=torch.float64, precision=prec)
                coef, intercept = self._solve_from_stats(stats, stats[0].shape[0])
            return self._copyValues(LinearRegressionModel(self.uid, coef, intercept))
        x_in, y_in = _extract_xy(dataset, self.getFeaturesCol(), self.getLabelCol())
        w_host = extract_weights(dataset, self.getWeightCol())
        prec = self._resolved_precision()
        # Over budget, the input reroutes through a block reader into the
        # streaming statistics branch above (bit-identical to an explicit
        # reader); a device OOM mid-fit takes the same exit.
        return membudget.fit_within_budget(
            "linear", x_in, lambda: self._fit_in_memory(x_in, y_in, w_host, prec),
            lambda reader: self._fit((reader, y_in)),
            can_stream=w_host is None,
            why_cannot_stream="the streaming path does not support weightCol",
            dtype=torch.float64, ledger_families=("linear", "linreg"),
        )

    def _fit_in_memory(self, x_in, y_in, w_host, prec: str) -> "LinearRegressionModel":
        if prec == "dd":
            if is_device_array(x_in):
                raise ValueError(
                    "precision='dd' does not support device-array input "
                    "(the float64 route consumes the host source)"
                )
            return self._fit_dd([(x_in, y_in)])
        with TraceRange("linreg fit", TraceColor.DARK_GREEN):
            xs, mask, n, d = prepare_rows(x_in, dtype=torch.float64, weights=w_host)
            ys = prepare_labels(y_in, n, n_true=n, dtype=xs.dtype, device=xs.device)
            stats = normal_eq_stats(xs, ys, None if w_host is None else mask.to(xs.dtype), precision=prec)
            coef, intercept = self._solve_from_stats(stats, d)
        # Solve outputs stay where they are; the host views convert lazily.
        return self._copyValues(LinearRegressionModel(self.uid, coef, intercept))

    def _solve_from_stats(self, stats, d: int):
        """The one home of the exact-vs-proximal routing, shared by the
        in-memory and streaming fits."""
        xtx, xty, x_sum, y_sum, _yty, count = stats
        init_coef = self._initial_coef
        if init_coef is not None and init_coef.shape[0] != d:
            raise ValueError(
                f"initial model has {init_coef.shape[0]} coefficients, data has {d} features"
            )
        common = dict(fit_intercept=self.getFitIntercept(), standardization=self.getStandardization())
        if not self._uses_fista():
            if init_coef is not None:
                raise ValueError(
                    "setInitialModel warm start applies to the elastic-net "
                    "(FISTA) path (elasticNetParam > 0 and regParam > 0); "
                    "the exact normal-equation solve has no iteration to seed"
                )
            return solve_normal(xtx, xty, x_sum, y_sum, count, reg_param=self.getRegParam(), **common)
        coef, intercept, _ = solve_elastic_net(
            xtx, xty, x_sum, y_sum, count,
            reg_param=self.getRegParam(),
            elastic_net_param=self.getElasticNetParam(),
            init_coef=init_coef,
            **common,
        )
        return coef, intercept


def _streaming_blocks(dataset):
    """The streaming input form: ``(X, y)`` where X is a list of 2-D blocks
    (dense or scipy-sparse) or a streaming source (a factory, a block
    reader, a generator). Returns an iterator of ``(X_block, y_block)``
    pairs, or None when the input is not block-shaped.

    A single ``y`` is sliced along the block boundaries and must match the
    total row count exactly; a list of per-block label arrays must have
    one entry per block — both mismatches raise."""
    from spark_rapids_ml_tpu_torch.core.data import _is_block

    if not (isinstance(dataset, tuple) and len(dataset) == 2):
        return None
    x, y = dataset
    if isinstance(x, (list, tuple)) and x and _is_block(x[0]):
        blocks = iter(x)
    elif is_streaming_source(x):
        blocks = iter_stream_blocks(x)
    else:
        return None

    def pairs():
        if isinstance(y, (list, tuple)):
            sentinel = object()
            for xb, yb in zip_longest(blocks, y, fillvalue=sentinel):
                if xb is sentinel or yb is sentinel:
                    raise ValueError(
                        "streaming fit: X blocks and per-block label lists have different lengths"
                    )
                yield dense_block(xb), yb
            return
        y_arr = to_host(y).ravel()
        start = 0
        for xb in blocks:
            xb = dense_block(xb)
            yb = y_arr[start:start + xb.shape[0]]
            # Check the slice here: the one-ahead accumulator prepares pair
            # k+1 before it consumes pair k, so a short tail must fail when
            # it is produced.
            if yb.shape[0] != xb.shape[0]:
                raise ValueError(
                    f"block rows mismatch: X block has {xb.shape[0]} rows "
                    f"but only {yb.shape[0]} labels remain"
                )
            yield xb, yb
            start += xb.shape[0]
        if start != y_arr.shape[0]:
            raise ValueError(f"streaming fit: blocks supplied {start} rows but y has {y_arr.shape[0]}")

    return pairs()


def _extract_xy(dataset: Any, features_col: str, label_col: str):
    """``(X, y)`` from a tuple, the DataFrame shim or pandas. A tensor X
    stays where it lives, with its tensor y; host y is float64 numpy."""
    if isinstance(dataset, tuple) and len(dataset) == 2:
        x, y = dataset
        if is_device_array(x):
            if is_device_array(y):
                return x, y
            return x, np.asarray(y, dtype=np.float64).ravel()
        return as_matrix(x), to_host(y, np.float64).ravel()
    if isinstance(dataset, DataFrame):
        x = as_matrix(dataset.select(features_col))
        y = np.asarray(dataset.select(label_col), dtype=np.float64).ravel()
        return x, y
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover
        pd = None
    if pd is not None and isinstance(dataset, pd.DataFrame):
        if features_col in dataset.columns:
            x = as_matrix(dataset[features_col].tolist())
        else:
            x = dataset.drop(columns=[label_col]).to_numpy(dtype=np.float64)
        return x, dataset[label_col].to_numpy(dtype=np.float64)
    raise TypeError(
        "dataset must be (X, y), a DataFrame with features/label columns, or a pandas DataFrame"
    )


class LinearRegressionModel(_LinearRegressionParams, Model, LazyHostState):
    """Fitted model: ``coefficients`` (d,) and ``intercept``. Fitted state
    may be tensors from a fit on the card; the host float64 views convert
    lazily and pickling keeps host state only."""

    _lazy_host_fields = {"_coef_raw": ("_coef_np", np.float64)}
    _pickle_clear = ("_coef_dev",)

    def __init__(self, uid: Optional[str] = None, coefficients=None, intercept=0.0):
        super().__init__(uid)
        self._coef_raw = coefficients
        self._coef_np: Optional[np.ndarray] = None
        self._coef_dev: Optional[dict] = None
        self._intercept_raw = intercept

    def __getstate__(self):
        state = super().__getstate__()
        state["_intercept_raw"] = self.intercept
        return state

    @property
    def coefficients(self) -> Optional[np.ndarray]:
        return self._lazy_host_view("_coef_raw")

    @property
    def intercept(self) -> float:
        if not isinstance(self._intercept_raw, float):
            self._intercept_raw = float(self._intercept_raw)
        return self._intercept_raw

    def setFeaturesCol(self, value: str) -> "LinearRegressionModel":
        return self.set(self.featuresCol, value)

    def setPredictionCol(self, value: str) -> "LinearRegressionModel":
        return self.set(self.predictionCol, value)

    def copy(self, extra=None) -> "LinearRegressionModel":
        """Model.copy preserves fitted state (Spark's Model.copy contract)."""
        that = LinearRegressionModel(self.uid, self._coef_raw, self._intercept_raw)
        return self._copyValues(that, extra)

    def _serving_precision(self) -> str:
        """An explicit estimator ``setPrecision`` carries into the model
        (``auto`` and ``dd`` serve at ``highest``)."""
        requested = self.getPrecision() if self.isSet(self.precision) else None
        if requested in ("auto", "dd"):
            requested = "highest"
        return resolve_policy("serving", requested)

    def _coef_on(self, device: torch.device, dtype: torch.dtype):
        """``(coefficients, intercept)`` at ``dtype`` on ``device``, cached."""
        if self._coef_dev is None:
            self._coef_dev = {}
        key = (str(device), str(dtype))
        if key not in self._coef_dev:
            raw = self._coef_raw if isinstance(self._coef_raw, torch.Tensor) else torch.tensor(self.coefficients)
            b = self._intercept_raw
            b = b if isinstance(b, torch.Tensor) else torch.tensor(float(b), dtype=torch.float64)
            self._coef_dev[key] = (raw.to(device=device, dtype=dtype), b.to(device=device, dtype=dtype))
        return self._coef_dev[key]

    def predict(self, x):
        """X·coef + b. A tensor is served where it lives and gets a tensor
        back; host input goes to the device block by block in float64 and
        comes back as numpy."""
        if self._coef_raw is None:
            raise RuntimeError("model has no coefficients")
        x = matrix_like(x)
        static = {"precision": self._serving_precision()}
        if is_device_array(x):
            return serve_rows(
                _predict_kernel, x, self._coef_on(_device.device_of(x), x.dtype),
                static=static, name="linreg.predict",
            )
        device = _device.resolve_device()
        blocks = [x[i:i + DEFAULT_STREAM_BLOCK] for i in range(0, x.shape[0], DEFAULT_STREAM_BLOCK)]
        outs = list(serve_stream(
            _predict_kernel, blocks, self._coef_on(device, torch.float64),
            static=static, name="linreg.predict", device=device, dtype=torch.float64,
        ))
        return np.concatenate(outs) if outs else np.zeros((0,), dtype=np.float64)

    def serving_signature(self):
        raise NotImplementedError(SERVING_SIGNATURE_ITEM)

    def transform(self, dataset: Any) -> Any:
        if isinstance(dataset, DataFrame):
            pred = to_host(self.predict(dataset.select(self.getFeaturesCol())))
            return dataset.withColumn(self.getPredictionCol(), list(pred))
        try:
            import pandas as pd
        except ImportError:  # pragma: no cover
            pd = None
        if pd is not None and isinstance(dataset, pd.DataFrame):
            if self.getFeaturesCol() in dataset.columns:
                pred = self.predict(dataset[self.getFeaturesCol()].tolist())
            else:
                cols = [c for c in dataset.columns if c != self.getLabelCol()]
                pred = self.predict(dataset[cols].to_numpy(dtype=np.float64))
            out = dataset.copy()
            out[self.getPredictionCol()] = to_host(pred)
            return out
        return self.predict(dataset[0] if isinstance(dataset, tuple) else dataset)

    def evaluate(self, dataset: Any) -> dict:
        """RegressionSummary analogue: mse / rmse / mae / r2 on a labeled
        dataset, computed where the predictions are."""
        x, y = _extract_xy(dataset, self.getFeaturesCol(), self.getLabelCol())
        pred = self.predict(x)
        pred = pred if isinstance(pred, torch.Tensor) else torch.from_numpy(pred)
        y_t = y.reshape(-1) if isinstance(y, torch.Tensor) else torch.from_numpy(np.asarray(y))
        y_t = y_t.to(device=pred.device, dtype=pred.dtype)
        mask = torch.ones(y_t.shape[0], dtype=pred.dtype, device=pred.device)
        mse, rmse, mae, r2 = torch.stack(regression_metrics(y_t, pred, mask)).tolist()
        return {"meanSquaredError": mse, "rootMeanSquaredError": rmse, "meanAbsoluteError": mae, "r2": r2}

    def _save_impl(self, path: str) -> None:
        save_metadata(self, path, class_name="org.apache.spark.ml.regression.LinearRegressionModel")
        save_data(
            path,
            {
                "coefficients": ("vector", self.coefficients),
                "intercept": ("scalar", float(self.intercept)),
            },
        )

    @classmethod
    def _load_impl(cls, path: str) -> "LinearRegressionModel":
        metadata = load_metadata(path, expected_class="LinearRegressionModel")
        data = load_data(path)
        model = cls(metadata["uid"], np.asarray(data["coefficients"], dtype=np.float64), float(data["intercept"]))
        get_and_set_params(model, metadata)
        return model
