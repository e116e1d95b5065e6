"""Model/estimator persistence, format-compatible with Spark ML.

Port of the reference's ``core/persistence.py``: ``<path>/metadata/part-00000``
is one JSON line (class, timestamp, sparkVersion, uid, paramMap,
defaultParamMap) and ``<path>/data`` a one-row parquet table in Spark's
MatrixUDT/VectorUDT struct encoding, so a model saved by either package
loads in the other. Without ``pyarrow`` the data goes to
``<path>/data/part-00000.npz`` instead (the reference's fallback), which
this package reads back.

Left out until the robustness slice: the fault-injection point and the
retry policy around the write. ``MLWriter.save`` keeps the reference's
directory-level atomicity (write a temp sibling, then ``os.replace``).

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

from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter
from spark_rapids_ml_tpu_torch.version import __version__


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


def save_metadata(instance, path: str, class_name: Optional[str] = None) -> None:
    """DefaultParamsWriter.saveMetadata equivalent."""
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


def save_data(path: str, columns: Dict[str, tuple]) -> None:
    """Write ``<path>/data`` as one-row single-partition parquet (or
    ``.npz`` without pyarrow). ``columns`` maps name ->
    ("matrix"|"vector"|"scalar", value)."""
    data_dir = os.path.join(path, "data")
    os.makedirs(data_dir, exist_ok=True)
    if not _HAS_ARROW:
        np.savez(
            os.path.join(data_dir, "part-00000.npz"),
            **{name: np.asarray(value) for name, (kind, value) in columns.items()},
        )
        return
    matrix_type, vector_type = _arrow_types()
    fields, arrays = [], []
    for name, (kind, value) in columns.items():
        if kind == "matrix":
            fields.append((name, matrix_type))
            arrays.append(pa.array([_matrix_struct(value)], type=matrix_type))
        elif kind == "vector":
            fields.append((name, vector_type))
            arrays.append(pa.array([_vector_struct(value)], type=vector_type))
        else:
            arr = pa.array([value])
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


def load_data(path: str) -> Dict[str, Any]:
    """Read ``<path>/data`` back into {name: decoded value}."""
    data_dir = os.path.join(path, "data")
    parquets = sorted(glob.glob(os.path.join(data_dir, "*.parquet")))
    if parquets:
        if not _HAS_ARROW:
            raise RuntimeError(f"{data_dir} holds parquet but pyarrow is not installed")
        row = _read_all_parts(parquets).to_pylist()[0]
        out: Dict[str, Any] = {}
        for name, value in row.items():
            if isinstance(value, dict) and "numRows" in value:
                out[name] = matrix_from_struct(value)
            elif isinstance(value, dict) and "size" in value:
                out[name] = vector_from_struct(value)
            else:
                out[name] = value
        return out
    npzs = sorted(glob.glob(os.path.join(data_dir, "*.npz")))
    if npzs:
        with np.load(npzs[0]) as z:
            return {k: z[k] for k in z.files}
    raise FileNotFoundError(f"no data files under {data_dir}")


class MLWriter:
    """Spark-style ``model.write.overwrite().save(path)`` chain; ``save``
    is atomic at the directory level (temp sibling, then ``os.replace``)."""

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
        try:
            with TraceRange("persistence save", TraceColor.WHITE):
                self._instance._save_impl(tmp)
                if os.path.exists(path):  # _overwrite, checked above
                    shutil.rmtree(path)
                os.replace(tmp, path)
            bump_counter("persistence.write")
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
