"""Input data handling: vectors, partitions, and a minimal DataFrame shim.

Port of the reference's ``core/data.py``. The native representations:
  - ``numpy.ndarray`` (n, d)            — a single dense partition
  - ``scipy.sparse`` matrix             — sparse rows, densified per block
  - ``pandas.DataFrame`` + input column — column of array-likes / SparseVector
  - ``list`` of any of the above        — explicit partitions (the RDD analogue)
  - ``DataFrame`` shim below            — named columns over the same storage
  - ``torch.Tensor`` (n, d)             — device-resident input, consumed in
    place where it lives (the reference's ``jax.Array`` mode)

Everything host-side funnels through :func:`as_partitions`, which yields
dense row-major float blocks. Streaming sources (block iterators, block
readers, iterator factories) are recognised and refused: their fit and
transform paths arrive with the streaming slice.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

try:
    import scipy.sparse as _sp
except ImportError:  # pragma: no cover
    _sp = None


STREAMING_SLICE = (
    "streaming block sources (iterators, block readers, iterator factories) "
    "are not ported yet: they arrive with the streaming item (ROADMAP A.5a); "
    "pass numpy partitions or a torch.Tensor"
)


class SparseVector:
    """Spark-ML-style sparse vector: (size, indices, values)."""

    __slots__ = ("size", "indices", "values")

    def __init__(self, size: int, indices: Sequence[int], values: Sequence[float]):
        self.size = int(size)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.values = np.asarray(values, dtype=np.float64)
        if self.indices.shape != self.values.shape:
            raise ValueError("indices and values must have the same length")

    def toArray(self) -> np.ndarray:
        out = np.zeros(self.size, dtype=np.float64)
        out[self.indices] = self.values
        return out

    def __len__(self) -> int:
        return self.size

    def __repr__(self) -> str:
        return f"SparseVector({self.size}, {self.indices.tolist()}, {self.values.tolist()})"


class DenseVector:
    """Spark-ML-style dense vector (thin ndarray wrapper for API parity)."""

    __slots__ = ("values",)

    def __init__(self, values: Sequence[float]):
        self.values = np.asarray(values, dtype=np.float64)

    def toArray(self) -> np.ndarray:
        return self.values

    def __len__(self) -> int:
        return self.values.shape[0]

    def __repr__(self) -> str:
        return f"DenseVector({self.values.tolist()})"


def Vectors_dense(*values) -> DenseVector:
    if len(values) == 1 and isinstance(values[0], (list, tuple, np.ndarray)):
        return DenseVector(values[0])
    return DenseVector(values)


def Vectors_sparse(size: int, indices, values) -> SparseVector:
    return SparseVector(size, indices, values)


class Vectors:
    """Namespace matching org.apache.spark.ml.linalg.Vectors factory methods."""

    dense = staticmethod(Vectors_dense)
    sparse = staticmethod(Vectors_sparse)


def _row_to_array(row: Any) -> np.ndarray:
    if isinstance(row, (SparseVector, DenseVector)):
        return row.toArray()
    if _sp is not None and _sp.issparse(row):
        return np.asarray(row.todense()).ravel()
    return np.asarray(row, dtype=np.float64).ravel()


def is_device_array(data: Any) -> bool:
    """True for ``torch.Tensor`` inputs — consumed in place where they
    live, in their own dtype, with no host round-trip (the reference's
    ``jax.Array`` mode). numpy arrays take the partition path."""
    return isinstance(data, torch.Tensor)


_TORCH_TO_NUMPY = {
    torch.float64: np.dtype(np.float64),
    torch.float32: np.dtype(np.float32),
    torch.float16: np.dtype(np.float16),
}


def infer_input_dtype(data: Any):
    """Best-effort floating dtype of the user's raw container, read
    before :func:`as_partitions` coerces to float64 (drives
    ``precision="auto"``). Python floats and the Vectors types are
    float64; numpy / scipy / pandas / torch containers report their own
    floating dtype; anything else reports None."""
    if isinstance(data, np.ndarray):
        return data.dtype if np.issubdtype(data.dtype, np.floating) else None
    if is_device_array(data):
        return _TORCH_TO_NUMPY.get(data.dtype)
    if _sp is not None and _sp.issparse(data):
        return data.dtype if np.issubdtype(data.dtype, np.floating) else None
    if isinstance(data, (SparseVector, DenseVector, float)):
        return np.dtype(np.float64)
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover
        pd = None
    if pd is not None and isinstance(data, (pd.DataFrame, pd.Series)):
        if isinstance(data, pd.Series):
            first = data.iloc[0] if len(data) else None
            if first is not None and not np.isscalar(first):
                return infer_input_dtype(first)
            dts = [data.dtype]
        else:
            dts = list(data.dtypes)
        kinds = {str(d) for d in dts}
        if "float64" in kinds:
            return np.dtype(np.float64)
        if "float32" in kinds:
            return np.dtype(np.float32)
        return None
    if isinstance(data, (list, tuple)):
        return infer_input_dtype(data[0]) if len(data) else None
    return None


def _block_to_dense(block: Any, dtype=None) -> np.ndarray:
    """One partition-like object as a dense (rows, d) float array
    (float64 unless ``dtype`` is given)."""
    dt = np.float64 if dtype is None else np.dtype(dtype)
    if isinstance(block, np.ndarray):
        if block.ndim == 1:
            return block[None, :].astype(dt, copy=False)
        return np.ascontiguousarray(block, dtype=dt)
    if _sp is not None and _sp.issparse(block):
        return np.asarray(block.todense(), dtype=dt)
    if isinstance(block, (SparseVector, DenseVector)):
        return _row_to_array(block)[None, :].astype(dt, copy=False)
    rows = [_row_to_array(r) for r in block]
    if not rows:
        return np.zeros((0, 0), dtype=dt)
    return np.stack(rows).astype(dt, copy=False)


class DataFrame:
    """Minimal named-column frame so estimator code reads like Spark ML."""

    def __init__(self, columns: Optional[dict] = None):
        self._columns: dict = dict(columns or {})

    @classmethod
    def from_rows(cls, rows: Iterable[Tuple], schema: Sequence[str]) -> "DataFrame":
        cols: dict = {name: [] for name in schema}
        for row in rows:
            for name, value in zip(schema, row):
                cols[name].append(value)
        return cls(cols)

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    def select(self, name: str):
        if name not in self._columns:
            raise KeyError(f"no column {name!r}; have {self.columns}")
        return self._columns[name]

    def withColumn(self, name: str, values) -> "DataFrame":
        cols = dict(self._columns)
        cols[name] = values
        return DataFrame(cols)

    def count(self) -> int:
        first = next(iter(self._columns.values()))
        return len(first)

    def collect(self) -> List[tuple]:
        names = self.columns
        return list(zip(*(self._columns[n] for n in names)))


def extract_column(dataset: Any, input_col: Optional[str]) -> Any:
    """Pull the raw vector column out of whatever ``dataset`` is."""
    if isinstance(dataset, DataFrame):
        if input_col is None:
            raise ValueError("inputCol must be set for DataFrame input")
        return dataset.select(input_col)
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover
        return dataset
    if isinstance(dataset, pd.DataFrame):
        if input_col is not None and input_col in dataset.columns:
            return dataset[input_col].tolist()
        if input_col is not None:
            raise KeyError(f"no column {input_col!r} in pandas DataFrame")
        return dataset.to_numpy(dtype=np.float64)
    return dataset


def as_partitions(
    data: Any, num_partitions: Optional[int] = None, dtype=None
) -> List[np.ndarray]:
    """Normalize input into a list of dense (rows_i, d) float partitions
    (float64 by default). A ``list``/``tuple`` of 2-D blocks is
    pre-partitioned; anything else becomes one partition, optionally
    re-split into ``num_partitions`` row blocks."""
    if is_streaming_source(data):
        raise NotImplementedError(STREAMING_SLICE)
    if isinstance(data, (list, tuple)) and data and _is_block(data[0]):
        parts = [_block_to_dense(b, dtype=dtype) for b in data]
    else:
        parts = [_block_to_dense(data, dtype=dtype)]
    d = parts[0].shape[1]
    for p in parts:
        if p.shape[1] != d:
            raise ValueError(f"inconsistent feature dims: {p.shape[1]} vs {d}")
    if num_partitions is not None and len(parts) == 1 and num_partitions > 1:
        parts = [np.ascontiguousarray(b) for b in np.array_split(parts[0], num_partitions)]
    return parts


def _is_block(obj: Any) -> bool:
    if isinstance(obj, np.ndarray) and obj.ndim == 2:
        return True
    return _sp is not None and _sp.issparse(obj)


def is_streaming_source(data: Any) -> bool:
    """True for inputs that stream blocks: an iterator/generator, an
    object exposing ``iter_blocks``, or a zero-argument callable
    returning a block iterator (the reference's three kinds)."""
    from collections.abc import Iterator

    if isinstance(data, Iterator):
        return True
    if callable(getattr(data, "iter_blocks", None)):
        return True
    if callable(data) and not isinstance(data, type):
        return _is_zero_arg_callable(data)
    return False


def _is_zero_arg_callable(fn: Any) -> bool:
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):  # no introspectable signature
        return True
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
            if p.default is p.empty:
                return False
    return True


def as_matrix(data: Any, dtype=None) -> np.ndarray:
    """Normalize input into one dense (n, d) float matrix (float64 by default)."""
    parts = as_partitions(data, dtype=dtype)
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts, axis=0)


def num_features(data: Any) -> int:
    """Feature count by peeking at the first partition/row only."""
    if isinstance(data, np.ndarray) or is_device_array(data):
        return int(data.shape[1] if data.ndim == 2 else data.shape[0])
    if _sp is not None and _sp.issparse(data):
        return data.shape[1]
    if isinstance(data, (list, tuple)) and data:
        first = data[0]
        if _is_block(first):
            return first.shape[1]
        return len(_row_to_array(first))
    return as_partitions(data)[0].shape[1]
