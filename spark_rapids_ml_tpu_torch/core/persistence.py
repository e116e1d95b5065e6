"""Model/estimator persistence, format-compatible with Spark ML.

Port of the reference's ``core/persistence.py``: ``<path>/metadata/part-00000``
is one JSON line (class, timestamp, sparkVersion, uid, paramMap,
defaultParamMap, plus a model's extra keys) and ``<path>/data`` a parquet
table in Spark's MatrixUDT/VectorUDT struct encoding — one row
(:func:`save_data`) or one row per entity (:func:`save_rows`, a KMeans
model's clusters) — so a model saved by either package loads in the other. Without ``pyarrow`` the data goes to
``<path>/data/part-00000.npz`` instead (the reference's fallback), which
this package reads back.

Composite writers (``Pipeline``, the validators) record their
components' classes as import paths. :func:`persisted_class_path` writes
the reference's twin path for this package's own classes, and
:func:`resolve_persisted_class` reads a ``spark_rapids_ml_tpu.<module>``
path as its ``spark_rapids_ml_tpu_torch.<module>`` twin (a rewrite of the
string: the JAX package is never imported), so a directory written by
either package loads in the other. Other roots are refused unless
registered with :func:`allow_persisted_package`; directories written by
upstream Spark name JVM classes, which :func:`resolve_component_class`
maps through :data:`_SPARK_CLASS_ALIASES`.

``MLWriter.save`` is atomic at the directory level, as the reference's:
the model is written to a hidden temp sibling and ``os.replace``d into
place once complete, under the shared retry policy (``persistence.write``,
a fault site in :func:`save_data` / :func:`save_rows`), so a failed
overwrite keeps the previous model and a save killed midway is invisible
to ``load``. :func:`atomic_file_write` is the single-file twin that the
checkpoint snapshots use.

Matrix UDT struct: (type: int8 [1=dense], numRows, numCols, colPtrs,
rowIndices, values: float64[], isTransposed). Vector UDT struct:
(type: int8 [1=dense], size, indices, values).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, Optional, Type

import numpy as np

try:
    import pyarrow as pa
    import pyarrow.parquet as pq

    _HAS_ARROW = True
except ImportError:  # pragma: no cover - the card's image has no pyarrow
    _HAS_ARROW = False

from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.robustness.faults import fault_point
from spark_rapids_ml_tpu_torch.robustness.retry import default_policy
from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter
from spark_rapids_ml_tpu_torch.version import __version__


def atomic_file_write(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically: a hidden temp sibling on the
    same filesystem, fsync, then ``os.replace``. A writer killed at any
    point leaves the previous file or a temp sibling no reader looks at,
    never a truncated ``path`` (the checkpoint snapshots'
    writer, ``robustness/checkpoint.py``)."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    tmp = os.path.join(parent, f".{os.path.basename(path)}.tmp-write-{uuid.uuid4().hex[:12]}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:  # pragma: no cover - best-effort cleanup
                pass


def _matrix_struct(m: np.ndarray) -> dict:
    """Encode a dense column-major matrix as Spark's MatrixUDT struct."""
    m = np.asarray(m, dtype=np.float64)
    return {
        "type": 1,
        "numRows": int(m.shape[0]),
        "numCols": int(m.shape[1]),
        "colPtrs": None,
        "rowIndices": None,
        "values": np.asfortranarray(m).ravel(order="F").tolist(),
        "isTransposed": False,
    }


def _vector_struct(v: np.ndarray) -> dict:
    v = np.asarray(v, dtype=np.float64)
    return {"type": 1, "size": int(v.shape[0]), "indices": None, "values": v.tolist()}


def matrix_from_struct(s: dict) -> np.ndarray:
    values = np.asarray(s["values"], dtype=np.float64)
    n_rows, n_cols = int(s["numRows"]), int(s["numCols"])
    if s.get("isTransposed"):
        return values.reshape(n_rows, n_cols)  # row-major storage
    return values.reshape(n_cols, n_rows).T  # column-major storage


def vector_from_struct(s: dict) -> np.ndarray:
    if s["type"] == 0:  # sparse
        out = np.zeros(int(s["size"]), dtype=np.float64)
        out[np.asarray(s["indices"], dtype=np.int64)] = np.asarray(s["values"])
        return out
    return np.asarray(s["values"], dtype=np.float64)


def _arrow_types():
    matrix = pa.struct(
        [
            ("type", pa.int8()),
            ("numRows", pa.int32()),
            ("numCols", pa.int32()),
            ("colPtrs", pa.list_(pa.int32())),
            ("rowIndices", pa.list_(pa.int32())),
            ("values", pa.list_(pa.float64())),
            ("isTransposed", pa.bool_()),
        ]
    )
    vector = pa.struct(
        [
            ("type", pa.int8()),
            ("size", pa.int32()),
            ("indices", pa.list_(pa.int32())),
            ("values", pa.list_(pa.float64())),
        ]
    )
    return matrix, vector


def save_metadata(
    instance,
    path: str,
    extra_metadata: Optional[Dict[str, Any]] = None,
    class_name: Optional[str] = None,
) -> None:
    """DefaultParamsWriter.saveMetadata equivalent; ``extra_metadata``
    (e.g. a KMeans model's ``trainingCost``) joins the top-level keys."""
    meta_dir = os.path.join(path, "metadata")
    os.makedirs(meta_dir, exist_ok=True)
    metadata = {
        "class": class_name or f"{type(instance).__module__}.{type(instance).__name__}",
        "timestamp": int(time.time() * 1000),
        "sparkVersion": f"spark-rapids-ml-tpu-torch/{__version__}",
        "uid": instance.uid,
        "paramMap": {p.name: v for p, v in instance._paramMap.items()},
        "defaultParamMap": {p.name: v for p, v in instance._defaultParamMap.items()},
    }
    if extra_metadata:
        metadata.update(extra_metadata)
    with open(os.path.join(meta_dir, "part-00000"), "w") as f:
        f.write(json.dumps(metadata, separators=(",", ":")) + "\n")
    open(os.path.join(meta_dir, "_SUCCESS"), "w").close()


def load_metadata(path: str, expected_class: Optional[str] = None) -> Dict[str, Any]:
    """DefaultParamsReader.loadMetadata equivalent."""
    parts = sorted(glob.glob(os.path.join(path, "metadata", "part-*")))
    if not parts:
        raise FileNotFoundError(f"no metadata under {path}")
    with open(parts[0]) as f:
        metadata = json.loads(f.readline())
    if expected_class is not None:
        cls = metadata.get("class", "")
        # Accept both this package's class path and the JVM class path.
        if not (cls.endswith(expected_class) or expected_class.endswith(cls.rsplit(".", 1)[-1])):
            raise ValueError(f"metadata class {cls!r} != expected {expected_class!r}")
    return metadata


def get_and_set_params(instance, metadata: Dict[str, Any]) -> None:
    """metadata.getAndSetParams equivalent: names the instance lacks are
    skipped (a reference estimator-only param such as ``deployMode``)."""
    for name, value in metadata.get("defaultParamMap", {}).items():
        if instance.hasParam(name):
            param = instance.getParam(name)
            instance._defaultParamMap[param] = param.type_converter(value)
    for name, value in metadata.get("paramMap", {}).items():
        if instance.hasParam(name):
            instance.set(instance.getParam(name), value)


#: This package's root, and the reference's, whose paths map onto it.
PORT_ROOT = "spark_rapids_ml_tpu_torch"
REFERENCE_ROOT = "spark_rapids_ml_tpu"

# Root packages whose classes on-disk metadata may name. User libraries
# with custom pipeline stages opt in via allow_persisted_package().
_LOADABLE_PACKAGES = {PORT_ROOT}


def allow_persisted_package(package_root: str) -> None:
    """Opt a root package into model-directory loading.

    Custom Estimator/Model/Transformer classes defined outside this package
    round-trip through Pipeline/CrossValidator persistence only after their
    root package is registered here — loading is restricted by default
    because model directories are data and may be untrusted.
    """
    if not package_root or "." in package_root:
        raise ValueError(
            f"package root must be a bare top-level name, got {package_root!r}"
        )
    _LOADABLE_PACKAGES.add(package_root)


def persisted_class_path(klass: type) -> str:
    """The import path a composite writer records for ``klass``: the
    reference's twin path for a class of this package, so the reference
    loads the directory too; any other class's own path."""
    module = klass.__module__
    root, dot, rest = module.partition(".")
    if root == PORT_ROOT:
        module = REFERENCE_ROOT + dot + rest
    return f"{module}.{klass.__qualname__}"


def _port_path(class_path: str) -> str:
    """``spark_rapids_ml_tpu.<rest>`` as ``spark_rapids_ml_tpu_torch.<rest>``;
    any other path unchanged."""
    root, dot, rest = class_path.partition(".")
    return PORT_ROOT + dot + rest if root == REFERENCE_ROOT and dot else class_path


def resolve_persisted_class(class_path: str):
    """Import the class named in on-disk metadata, restricted to registered
    packages (this one, and the reference's paths read as this package's
    twins): model directories are data, and letting them name arbitrary
    modules would turn ``load`` into an import-side-effect gadget. See
    :func:`allow_persisted_package` for extending to user stage libraries."""
    module_name, _, class_name = _port_path(class_path).rpartition(".")
    root = module_name.split(".", 1)[0]
    if root not in _LOADABLE_PACKAGES:
        raise ValueError(
            f"refusing to import {class_path!r} from model metadata: only "
            f"classes under {sorted(_LOADABLE_PACKAGES | {REFERENCE_ROOT})} are loadable "
            "(register yours via allow_persisted_package)"
        )
    import importlib

    obj = getattr(importlib.import_module(module_name), class_name, None)
    # The attribute itself must be a class DEFINED in a registered package —
    # modules re-export numpy etc., whose `.load` is not a model loader.
    if not (
        isinstance(obj, type)
        and getattr(obj, "__module__", "").split(".", 1)[0] in _LOADABLE_PACKAGES
    ):
        raise ValueError(
            f"refusing to load {class_path!r} from model metadata: not a "
            "class from a registered package"
        )
    return obj


#: Spark JVM class simple names -> this package's import paths, for
#: loading directories written by upstream Spark: its metadata names JVM
#: classes (org.apache.spark.ml.feature.PCAModel) and its composite
#: writers (Pipeline, CrossValidator) record no python import path at
#: all — the nested component's own metadata "class" is the only type
#: information on disk.
_SPARK_CLASS_ALIASES: Dict[str, str] = {
    "PCA": f"{PORT_ROOT}.feature.PCA",
    "PCAModel": f"{PORT_ROOT}.feature.PCAModel",
    "KMeans": f"{PORT_ROOT}.clustering.KMeans",
    "KMeansModel": f"{PORT_ROOT}.clustering.KMeansModel",
    "LogisticRegression": f"{PORT_ROOT}.classification.LogisticRegression",
    "LogisticRegressionModel": f"{PORT_ROOT}.classification.LogisticRegressionModel",
    "LinearRegression": f"{PORT_ROOT}.regression.LinearRegression",
    "LinearRegressionModel": f"{PORT_ROOT}.regression.LinearRegressionModel",
    "RandomForestClassifier": f"{PORT_ROOT}.classification.RandomForestClassifier",
    "RandomForestClassificationModel": f"{PORT_ROOT}.classification.RandomForestClassificationModel",
    "RandomForestRegressor": f"{PORT_ROOT}.regression.RandomForestRegressor",
    "RandomForestRegressionModel": f"{PORT_ROOT}.regression.RandomForestRegressionModel",
    "Pipeline": f"{PORT_ROOT}.pipeline.Pipeline",
    "PipelineModel": f"{PORT_ROOT}.pipeline.PipelineModel",
    "CrossValidatorModel": f"{PORT_ROOT}.tuning.CrossValidatorModel",
    "TrainValidationSplitModel": f"{PORT_ROOT}.tuning.TrainValidationSplitModel",
}


def resolve_component_class(path: str):
    """The loader class for a NESTED model directory (a pipeline stage,
    a validator's ``bestModel``) whose owner recorded no python import
    path — i.e. a directory written by upstream Spark. Reads the
    component's own metadata ``class`` and maps the JVM simple name via
    :data:`_SPARK_CLASS_ALIASES`; python class paths (either package's
    writes) still resolve through the registered-package gate."""
    metadata = load_metadata(path)
    class_path = metadata.get("class", "")
    root = class_path.split(".", 1)[0]
    if root in _LOADABLE_PACKAGES or root == REFERENCE_ROOT:
        return resolve_persisted_class(class_path)
    simple = class_path.rsplit(".", 1)[-1]
    alias = _SPARK_CLASS_ALIASES.get(simple)
    if alias is None:
        raise ValueError(
            f"no loader for Spark class {class_path!r} (component at "
            f"{path}): known aliases are {sorted(_SPARK_CLASS_ALIASES)}"
        )
    return resolve_persisted_class(alias)


def save_data(path: str, columns: Dict[str, tuple]) -> None:
    """Write ``<path>/data`` as one-row single-partition parquet (or
    ``.npz`` without pyarrow). ``columns`` maps name ->
    ("matrix"|"vector"|"scalar", value)."""
    _write_data(
        path,
        {name: (kind, [value]) for name, (kind, value) in columns.items()},
        {name: value for name, (kind, value) in columns.items()},
    )


def save_rows(path: str, columns: Dict[str, tuple]) -> None:
    """Write ``<path>/data`` as a multi-row parquet table (or ``.npz``
    without pyarrow). ``columns`` maps name -> ("matrix"|"vector"|"scalar",
    list of values), one row per entity: Spark's KMeansModel layout is one
    (clusterIdx: int, clusterCenter: VectorUDT) row per cluster."""
    _write_data(path, columns, {name: values for name, (kind, values) in columns.items()})


def _write_data(path: str, columns: Dict[str, tuple], npz: Dict[str, Any]) -> None:
    """``columns``: name -> (kind, list of row values) for parquet;
    ``npz``: name -> the array the ``.npz`` fallback stores."""
    data_dir = os.path.join(path, "data")
    os.makedirs(data_dir, exist_ok=True)
    # After the directory exists, before any data file: a fault here
    # leaves the half-written layout (metadata, no data) that the atomic
    # MLWriter.save keeps invisible to load().
    fault_point("persistence.write")
    if not _HAS_ARROW:
        np.savez(
            os.path.join(data_dir, "part-00000.npz"),
            **{name: np.asarray(value) for name, value in npz.items()},
        )
        return
    matrix_type, vector_type = _arrow_types()
    fields, arrays = [], []
    for name, (kind, values) in columns.items():
        if kind == "matrix":
            fields.append((name, matrix_type))
            arrays.append(pa.array([_matrix_struct(v) for v in values], type=matrix_type))
        elif kind == "vector":
            fields.append((name, vector_type))
            arrays.append(pa.array([_vector_struct(v) for v in values], type=vector_type))
        else:
            arr = pa.array(list(values))
            fields.append((name, arr.type))
            arrays.append(arr)
    table = pa.Table.from_arrays(arrays, schema=pa.schema(fields))
    pq.write_table(table, os.path.join(data_dir, "part-00000.parquet"))
    open(os.path.join(data_dir, "_SUCCESS"), "w").close()


def _read_all_parts(parquets: list):
    """One table from every part file, in part order (Spark writes one
    part per task, and an empty part may sort first)."""
    tables = [pq.read_table(p) for p in parquets]
    if len(tables) == 1:
        return tables[0]
    schema = tables[0].schema.remove_metadata()
    return pa.concat_tables(
        [t.cast(schema) if t.schema.remove_metadata() != schema else t for t in tables]
    )


def _decode(value: Any) -> Any:
    if isinstance(value, dict) and "numRows" in value:
        return matrix_from_struct(value)
    if isinstance(value, dict) and "size" in value:
        return vector_from_struct(value)
    return value


def _read_data(path: str):
    """(parquet table or None, npz dict or None) of ``<path>/data``."""
    data_dir = os.path.join(path, "data")
    parquets = sorted(glob.glob(os.path.join(data_dir, "*.parquet")))
    if parquets:
        if not _HAS_ARROW:
            raise RuntimeError(f"{data_dir} holds parquet but pyarrow is not installed")
        return _read_all_parts(parquets), None
    npzs = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if npzs:
        with np.load(npzs[0]) as z:
            return None, {k: z[k] for k in z.files}
    raise FileNotFoundError(f"no data files under {data_dir}")


def load_data(path: str) -> Dict[str, Any]:
    """Read ``<path>/data`` back into {name: decoded value}."""
    table, npz = _read_data(path)
    if table is None:
        return npz
    return {name: _decode(value) for name, value in table.to_pylist()[0].items()}


def load_rows(path: str) -> Dict[str, list]:
    """Read a multi-row ``<path>/data`` table, every part file, into
    {name: [decoded values]}."""
    table, npz = _read_data(path)
    if table is None:
        return {name: list(values) for name, values in npz.items()}
    rows = table.to_pylist()
    return {name: [_decode(row[name]) for row in rows] for name in table.column_names}


class MLWriter:
    """Spark-style ``model.write.overwrite().save(path)`` chain; ``save``
    is atomic at the directory level (temp sibling, then ``os.replace``),
    and the complete write runs under the shared retry policy, each
    attempt against a fresh temp directory."""

    def __init__(self, instance):
        self._instance = instance
        self._overwrite = False

    def overwrite(self) -> "MLWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        if os.path.exists(path) and not self._overwrite:
            raise FileExistsError(f"{path} exists; use .overwrite()")
        parent = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(parent, exist_ok=True)
        tmp = os.path.join(
            parent, f".{os.path.basename(path)}.tmp-save-{uuid.uuid4().hex[:12]}"
        )

        def _write_complete():
            if os.path.exists(tmp):  # a failed earlier attempt
                shutil.rmtree(tmp)
            self._instance._save_impl(tmp)

        try:
            with TraceRange("persistence save", TraceColor.WHITE):
                default_policy().run(_write_complete, name="persistence.write")
                if os.path.exists(path):  # _overwrite, checked above
                    shutil.rmtree(path)
                os.replace(tmp, path)
            bump_counter("persistence.write")
            emit("persistence", action="write", path=path, model=type(self._instance).__name__)
        finally:
            if os.path.exists(tmp):
                shutil.rmtree(tmp, ignore_errors=True)


class MLReadable:
    """Mixin granting ``.write`` / ``.save`` / ``.load`` (DefaultParamsReadable)."""

    @property
    def write(self) -> MLWriter:
        return MLWriter(self)

    def save(self, path: str) -> None:
        self.write.save(path)

    def _save_impl(self, path: str) -> None:
        save_metadata(self, path)

    @classmethod
    def load(cls: Type, path: str):
        return cls._load_impl(path)

    @classmethod
    def _load_impl(cls: Type, path: str):
        metadata = load_metadata(path, expected_class=cls.__name__)
        instance = cls()
        instance.uid = metadata["uid"]
        get_and_set_params(instance, metadata)
        return instance
