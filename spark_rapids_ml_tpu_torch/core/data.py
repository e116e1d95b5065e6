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
dense row-major float blocks. Streaming sources (a block iterator, a
block reader with ``iter_blocks`` — :class:`HostArrayBlockReader`,
:class:`ArrowBlockReader`, ``native.NpyBlockReader`` — or a zero-argument
iterator factory) never materialize: the estimators' streaming paths
take them block by block (:func:`iter_stream_blocks`), at constant
memory. A reader that knows its ``dtype`` reports it to
:func:`infer_input_dtype`. :func:`host_rows_shape` is the fit memory
gate's shape probe.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.utils.envknobs import env_int, reject_autotune

try:
    import scipy.sparse as _sp
except ImportError:  # pragma: no cover
    _sp = None

#: Default rows per block of the fit-path block readers (one block is
#: resident on the device at a time).
DEFAULT_FIT_BLOCK_ROWS = 65536

FIT_BLOCK_ROWS_ENV = "TPUML_FIT_BLOCK_ROWS"


def fit_block_rows(
    family: Optional[str] = None,
    *,
    width: Optional[int] = None,
    itemsize: int = 4,
) -> int:
    """Rows per block of the fit-path block readers and of a degraded
    streaming fit: ``TPUML_FIT_BLOCK_ROWS`` when it is set (an integer
    >= 1), else :data:`DEFAULT_FIT_BLOCK_ROWS`. The signature is the
    reference's; ``family``, ``width`` and ``itemsize`` size the
    autotuner's recommendation there, which is not ported: with
    ``TPUML_AUTOTUNE=on`` and the block knob unset this raises
    ``NotImplementedError`` (ROADMAP A.9)."""
    explicit = env_int(FIT_BLOCK_ROWS_ENV, None, minimum=1)
    if explicit is not None:
        return explicit
    reject_autotune()
    return DEFAULT_FIT_BLOCK_ROWS


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
    if callable(getattr(data, "iter_blocks", None)) and hasattr(data, "dtype"):
        # Block readers know their dtype.
        try:
            dt = np.dtype(data.dtype)
        except TypeError:
            return None
        return dt if np.issubdtype(dt, np.floating) else None
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


def dense_block(block: Any) -> np.ndarray:
    """One raw block of a stream as a dense host array: a float32 block
    stays float32 (it goes to the device as it is and widens there, to the
    same values), anything else is float64."""
    return _block_to_dense(block, dtype=np.float32 if getattr(block, "dtype", None) == np.float32 else None)


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


def extract_features(dataset: Any, col: str, drop: Optional[str] = None) -> Any:
    """Feature extraction shared by the estimators: the DataFrame shim
    selects ``col``; pandas uses ``col`` if present, else treats the frame
    (minus the optional ``drop`` column, e.g. a row id) as a bare feature
    matrix; arrays, tensors and lists pass through."""
    if isinstance(dataset, DataFrame):
        return dataset.select(col)
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover
        return dataset
    if isinstance(dataset, pd.DataFrame):
        if col in dataset.columns:
            return extract_column(dataset, col)
        keep = [c for c in dataset.columns if c != drop]
        return dataset[keep].to_numpy(dtype=np.float64)
    return dataset


def extract_weights(dataset: Any, weight_col: Optional[str]) -> Optional[np.ndarray]:
    """Optional per-row weight column (Spark's ``weightCol``), as float64.

    None when no weight column is configured. Named-column containers
    only: configuring ``weightCol`` on a bare array is an error, not a
    silent ignore. Weights must be non-negative, not NaN, not all zero."""
    if weight_col is None:
        return None
    w = None
    if isinstance(dataset, DataFrame):
        w = np.asarray(dataset.select(weight_col), dtype=np.float64)
    else:
        try:
            import pandas as pd
        except ImportError:  # pragma: no cover
            pd = None
        if pd is not None and isinstance(dataset, pd.DataFrame):
            if weight_col not in dataset.columns:
                raise KeyError(f"no column {weight_col!r} in pandas DataFrame")
            w = dataset[weight_col].to_numpy(dtype=np.float64)
    if w is None:
        raise TypeError(
            f"weightCol={weight_col!r} requires a dataset with named columns "
            f"(DataFrame shim or pandas), got {type(dataset).__name__}"
        )
    w = w.ravel()
    if not np.all(w >= 0):  # also rejects NaN
        raise ValueError("weights must be non-negative and non-NaN")
    if not np.any(w > 0):
        raise ValueError("at least one weight must be positive")
    return w


def as_partitions(
    data: Any, num_partitions: Optional[int] = None, dtype=None
) -> List[np.ndarray]:
    """Normalize input into a list of dense (rows_i, d) float partitions
    (float64 by default). A ``list``/``tuple`` of 2-D blocks is
    pre-partitioned; anything else becomes one partition, optionally
    re-split into ``num_partitions`` row blocks. A streaming source is
    refused: it would have to be materialized."""
    if is_streaming_source(data):
        raise ValueError(
            "a streaming block source is not materialized into partitions; "
            "pass it to fit (or transform), which streams it block by block"
        )
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


def is_reiterable_stream(data: Any) -> bool:
    """True for streaming sources that can be iterated more than once: a
    block reader (``iter_blocks``) or an iterator factory (zero-argument
    callable). A one-shot generator streams but cannot be re-read, so the
    multi-pass algorithms (the randomized sketch, Lloyd) refuse it."""
    if callable(getattr(data, "iter_blocks", None)):
        return True
    from collections.abc import Iterator

    return (
        callable(data)
        and not isinstance(data, (type, Iterator))
        and _is_zero_arg_callable(data)
    )


def peek_stream_width(data: Any) -> int:
    """Feature width of a re-iterable streaming source, read from the first
    non-empty block of a fresh iterator (a routing probe; never call it on
    a one-shot generator, whose rows it would consume). An array, tensor
    or sparse matrix is read by its shape, with no copy; only a block of
    rows without one is densified."""
    for blk in iter_stream_blocks(data):
        shape = getattr(blk, "shape", None)
        if shape is None or len(shape) != 2:
            shape = _block_to_dense(blk).shape
        if shape[0] > 0:
            return int(shape[1])
    raise ValueError("streaming source yielded no rows")


def iter_stream_blocks(data: Any):
    """A fresh iterator of raw blocks over a streaming source (see
    :func:`is_streaming_source`)."""
    from collections.abc import Iterator

    if isinstance(data, Iterator):
        return data
    if callable(getattr(data, "iter_blocks", None)):
        return data.iter_blocks()
    if callable(data):
        return iter(data())
    raise TypeError(f"not a streaming block source: {type(data).__name__}")


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


def host_rows_shape(data: Any) -> Optional[Tuple[int, int]]:
    """(n_rows, n_features) of a host input without densifying it: the
    probe the fit memory gate prices from. None when the shape cannot be
    known without materializing, and for a tensor, which computes where it
    lives and is never copied to another device by a fit (nothing left to
    admit)."""
    if is_device_array(data):
        return None
    if isinstance(data, np.ndarray):
        if data.ndim == 2:
            return (int(data.shape[0]), int(data.shape[1]))
        if data.ndim == 1:
            return (1, int(data.shape[0]))
        return None
    if _sp is not None and _sp.issparse(data):
        return (int(data.shape[0]), int(data.shape[1]))
    if isinstance(data, (SparseVector, DenseVector)):
        return (1, len(data.toArray()))
    if isinstance(data, (list, tuple)) and data:
        first = data[0]
        if _is_block(first):
            if any(not _is_block(p) for p in data):
                return None
            return (int(sum(p.shape[0] for p in data)), int(first.shape[1]))
        try:
            return (len(data), len(_row_to_array(first)))
        except (TypeError, ValueError):
            return None
    return None


class HostArrayBlockReader:
    """Re-iterable block view over one host matrix: blocks are row slices
    (numpy views, no copy), so a fit through it keeps one block on the
    device at a time. Exposes ``dtype`` for :func:`infer_input_dtype`."""

    def __init__(self, x: Any, block_rows: Optional[int] = None):
        self._x = np.asarray(x)
        if self._x.ndim != 2:
            raise ValueError(
                f"HostArrayBlockReader needs a 2-D matrix, got {self._x.ndim}-D"
            )
        self.block_rows = (
            int(block_rows)
            if block_rows
            else fit_block_rows(
                "fit.host_matrix", width=int(self._x.shape[1]), itemsize=int(self._x.dtype.itemsize)
            )
        )
        if self.block_rows < 1:
            raise ValueError("block_rows must be >= 1")

    @property
    def dtype(self):
        return self._x.dtype

    @property
    def shape(self) -> Tuple[int, int]:
        return (int(self._x.shape[0]), int(self._x.shape[1]))

    def iter_blocks(self) -> Iterable[np.ndarray]:
        for i in range(0, self._x.shape[0], self.block_rows):
            yield self._x[i : i + self.block_rows]


class ArrowBlockReader:
    """Re-iterable block reader over an on-disk parquet dataset (a file or
    a directory), read through ``pyarrow.dataset`` one record batch of
    ``block_rows`` at a time, so a fit never holds the dataset in host or
    device memory. Feature ``columns`` default to every column except
    ``exclude``; a list-typed column (Spark's packed vector column)
    expands to its width. :meth:`read_column` materializes one column
    (labels). ``pyarrow`` is imported when a reader is made, not with
    this module."""

    def __init__(
        self,
        source: Any,
        columns: Optional[Sequence[str]] = None,
        *,
        block_rows: Optional[int] = None,
        dtype: Any = None,
        exclude: Sequence[str] = (),
    ):
        import pyarrow as pa
        import pyarrow.dataset as pads

        self._ds = (
            source
            if isinstance(source, pads.Dataset)
            else pads.dataset(source, format="parquet")
        )
        schema = self._ds.schema
        if columns is None:
            columns = [c for c in schema.names if c not in set(exclude)]
        else:
            missing = [c for c in columns if c not in schema.names]
            if missing:
                raise KeyError(f"no such column(s) in dataset: {missing}")
        if not columns:
            raise ValueError("ArrowBlockReader needs at least one feature column")
        self.columns = list(columns)
        if dtype is not None:
            self._dtype = np.dtype(dtype)
        else:
            # float32 only when every feature column is float32; anything
            # else reads as float64.
            def _leaf(t):
                return t.value_type if pa.types.is_list(t) or pa.types.is_fixed_size_list(t) else t

            all_f32 = all(_leaf(schema.field(c).type) == pa.float32() for c in self.columns)
            self._dtype = np.dtype(np.float32 if all_f32 else np.float64)
        self.block_rows = (
            int(block_rows)
            if block_rows
            else fit_block_rows("fit.arrow", width=len(self.columns), itemsize=int(self._dtype.itemsize))
        )

    @property
    def dtype(self):
        return self._dtype

    def num_rows(self) -> int:
        return int(self._ds.count_rows())

    @staticmethod
    def _column_to_numpy(chunk) -> np.ndarray:
        import pyarrow as pa

        t = chunk.type
        if pa.types.is_list(t) or pa.types.is_fixed_size_list(t):
            # flatten(), not .values: a sliced batch shares its parent's
            # buffer, and .values would return the whole column.
            flat = np.asarray(chunk.flatten())
            if pa.types.is_list(t):
                widths = np.asarray(chunk.value_lengths())
                if widths.size and not np.all(widths == widths[0]):
                    raise ValueError("ragged list column cannot form a matrix")
                width = int(widths[0]) if widths.size else 0
            else:
                width = t.list_size
            return flat.reshape(-1, width)
        return np.asarray(chunk.to_numpy(zero_copy_only=False)).reshape(-1, 1)

    def iter_blocks(self) -> Iterable[np.ndarray]:
        for batch in self._ds.to_batches(columns=self.columns, batch_size=self.block_rows):
            if batch.num_rows == 0:
                continue
            cols = [self._column_to_numpy(batch.column(i)) for i in range(batch.num_columns)]
            block = cols[0] if len(cols) == 1 else np.concatenate(cols, axis=1)
            yield np.ascontiguousarray(block, dtype=self._dtype)

    def read_column(self, name: str, dtype: Any = np.float64) -> np.ndarray:
        """One full column as a host array (label extraction)."""
        if name not in self._ds.schema.names:
            raise KeyError(f"no such column in dataset: {name!r}")
        tbl = self._ds.to_table(columns=[name])
        return np.asarray(tbl.column(0).to_numpy(zero_copy_only=False), dtype=dtype)
