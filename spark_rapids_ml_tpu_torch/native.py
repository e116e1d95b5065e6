"""ctypes bindings to the native host runtime (``native/src/tpuml_host.cpp``).

The port's own loader over the reference's C++ source, read in place and
never edited. At first use the source builds with
``g++ -O3 -std=c++17 -shared -fPIC`` into
``build/native_host/<source hash>/libtpuml_host.so`` at the root of the
checkout: the compiler writes a temporary file that is ``os.replace``-d
into place, under an exclusive file lock, so processes that load at once
build once and never see a half-written library. The loaded library must
report ``tpuml_abi_version() == 1``. When the build fails (no ``g++``, no
source), :func:`available` is False, :func:`build_error` says why, and
callers take their device or numpy routes: the native layer accelerates,
never gates (the reference's rule). Nothing is written into the
reference's package.

Surface, as the reference's ``native/__init__.py``:
  - :class:`SprAccumulator` fp64 Kahan-compensated streaming covariance
    (the packed spr/treeAggregate path of ``useGemm=False``)
  - :func:`csr_to_dense`    sparse batch assembly
  - :func:`center_scale_f32` fused float64 center + float32 narrow
  - :func:`trace_push` / :func:`trace_pop` host trace ranges
  - :class:`NpyBlockReader` a block reader over a ``.npy`` file (mmap +
    readahead in C++), accepted as a stream by every streaming fit
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR.parent / "native" / "src" / "tpuml_host.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native_host"
LIB_NAME = "libtpuml_host.so"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
ABI_VERSION = 1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded by _lock
_load_attempted = False  # guarded by _lock
_build_error: Optional[str] = None  # guarded by _lock


def library_path() -> Path:
    """Where the source builds to, keyed by its content and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


def _build(out: Path) -> None:
    """Compile the source into ``out`` unless another process already has;
    raises RuntimeError with the compiler's output on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if out.exists():
                return
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ was not found on PATH")
            tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True, timeout=300,
            )
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ exit {proc.returncode}:\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32, i64, dbl, vp = ctypes.c_int32, ctypes.c_int64, ctypes.c_double, ctypes.c_void_p
    p = ctypes.POINTER
    lib.tpuml_spr_create.restype = vp
    lib.tpuml_spr_create.argtypes = [i64]
    lib.tpuml_spr_destroy.restype = None
    lib.tpuml_spr_destroy.argtypes = [vp]
    lib.tpuml_spr_add_block.restype = i32
    lib.tpuml_spr_add_block.argtypes = [vp, p(dbl), i64]
    lib.tpuml_spr_merge.restype = i32
    lib.tpuml_spr_merge.argtypes = [vp, vp]
    lib.tpuml_spr_rows.restype = i64
    lib.tpuml_spr_rows.argtypes = [vp]
    lib.tpuml_spr_finalize.restype = i32
    lib.tpuml_spr_finalize.argtypes = [vp, p(dbl), p(dbl), i32]
    lib.tpuml_csr_to_dense_f64.restype = i32
    lib.tpuml_csr_to_dense_f64.argtypes = [p(i64), p(i32), p(dbl), i64, i64, p(dbl)]
    lib.tpuml_csr_to_dense_f32.restype = i32
    lib.tpuml_csr_to_dense_f32.argtypes = [p(i64), p(i32), p(dbl), i64, i64, p(ctypes.c_float)]
    lib.tpuml_center_scale_f32.restype = i32
    lib.tpuml_center_scale_f32.argtypes = [p(dbl), p(dbl), dbl, i64, i64, p(ctypes.c_float)]
    lib.tpuml_trace_push.restype = None
    lib.tpuml_trace_push.argtypes = [ctypes.c_char_p]
    lib.tpuml_trace_pop.restype = None
    lib.tpuml_trace_pop.argtypes = []
    lib.tpuml_npy_open.restype = vp
    lib.tpuml_npy_open.argtypes = [ctypes.c_char_p]
    lib.tpuml_npy_info.restype = i32
    lib.tpuml_npy_info.argtypes = [vp, p(i64), p(i64), p(i32)]
    lib.tpuml_npy_prefetch.restype = i32
    lib.tpuml_npy_prefetch.argtypes = [vp, i64, i64]
    lib.tpuml_npy_read_block.restype = i32
    lib.tpuml_npy_read_block.argtypes = [vp, i64, i64, vp]
    lib.tpuml_npy_release.restype = i32
    lib.tpuml_npy_release.argtypes = [vp, i64, i64]
    lib.tpuml_npy_close.restype = None
    lib.tpuml_npy_close.argtypes = [vp]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built first if needed; None when it
    cannot be built or loaded (:func:`build_error` says why). The first
    call decides for the process."""
    global _lib, _load_attempted, _build_error
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            _build_error = f"{type(exc).__name__}: {exc}"
            return None
        lib.tpuml_abi_version.restype = ctypes.c_int32
        lib.tpuml_abi_version.argtypes = []
        version = lib.tpuml_abi_version()
        if version != ABI_VERSION:
            _build_error = f"{path}: ABI version {version}, expected {ABI_VERSION}"
            return None
        _lib = _bind(lib)
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's stderr for a failed
    build), or None."""
    with _lock:
        return _build_error


def _as_c(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class SprAccumulator:
    """fp64 streaming covariance accumulator (native; Kahan-compensated):
    the shifted second-moment sum in packed-upper layout (cuBLAS ``Dspr``
    FILL_MODE_UPPER), one rank-1 update per row on one host thread."""

    def __init__(self, n_cols: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error()}")
        self._lib = lib
        self._handle = lib.tpuml_spr_create(n_cols)
        if not self._handle:
            raise ValueError(f"invalid n_cols {n_cols} (must be 1..65535)")
        self.n_cols = n_cols

    def add_block(self, block: np.ndarray) -> "SprAccumulator":
        block = np.ascontiguousarray(block, dtype=np.float64)
        if block.ndim != 2 or block.shape[1] != self.n_cols:
            raise ValueError(f"block must be (rows, {self.n_cols})")
        rc = self._lib.tpuml_spr_add_block(self._handle, _as_c(block, ctypes.c_double), block.shape[0])
        if rc != 0:
            raise RuntimeError(f"spr_add_block failed: {rc}")
        return self

    def merge(self, other: "SprAccumulator") -> "SprAccumulator":
        rc = self._lib.tpuml_spr_merge(self._handle, other._handle)
        if rc != 0:
            raise RuntimeError(f"spr_merge failed: {rc}")
        return self

    @property
    def n_rows(self) -> int:
        return int(self._lib.tpuml_spr_rows(self._handle))

    def finalize(self, center: bool = True):
        """``(covariance (n, n), column means (n,))``: the sample
        covariance with ``center``, else the raw second moment / (rows − 1)."""
        n = self.n_cols
        cov = np.empty((n, n), dtype=np.float64)
        mean = np.empty(n, dtype=np.float64)
        rc = self._lib.tpuml_spr_finalize(
            self._handle, _as_c(cov, ctypes.c_double), _as_c(mean, ctypes.c_double), 1 if center else 0
        )
        if rc == -2:
            raise ValueError(f"need at least 2 rows, got {self.n_rows}")
        if rc != 0:
            raise RuntimeError(f"spr_finalize failed: {rc}")
        return cov, mean

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.tpuml_spr_destroy(handle)
            self._handle = None


def csr_to_dense(indptr, indices, values, n_cols: int, dtype=np.float64) -> np.ndarray:
    """CSR rows to a dense block (numpy when the library is unavailable)."""
    lib = get_lib()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float64)
    n_rows = indptr.shape[0] - 1
    if lib is None:
        out = np.zeros((n_rows, n_cols), dtype=dtype)
        for r in range(n_rows):
            sl = slice(indptr[r], indptr[r + 1])
            out[r, indices[sl]] = values[sl]
        return out
    f32 = np.dtype(dtype) == np.float32
    out = np.empty((n_rows, n_cols), dtype=np.float32 if f32 else np.float64)
    fn = lib.tpuml_csr_to_dense_f32 if f32 else lib.tpuml_csr_to_dense_f64
    rc = fn(
        _as_c(indptr, ctypes.c_int64), _as_c(indices, ctypes.c_int32),
        _as_c(values, ctypes.c_double), n_rows, n_cols,
        _as_c(out, ctypes.c_float if f32 else ctypes.c_double),
    )
    if rc != 0:
        raise ValueError(f"csr_to_dense failed: {rc} (bad column index?)")
    return out


def center_scale_f32(x: np.ndarray, mean: np.ndarray, scale: float) -> np.ndarray:
    """``(x − mean) · scale`` in float64, narrowed to float32."""
    lib = get_lib()
    x = np.ascontiguousarray(x, dtype=np.float64)
    mean = np.ascontiguousarray(mean, dtype=np.float64)
    if lib is None:
        return ((x - mean) * scale).astype(np.float32)
    out = np.empty(x.shape, dtype=np.float32)
    rc = lib.tpuml_center_scale_f32(
        _as_c(x, ctypes.c_double), _as_c(mean, ctypes.c_double),
        float(scale), x.shape[0], x.shape[1], _as_c(out, ctypes.c_float),
    )
    if rc != 0:
        raise RuntimeError(f"center_scale failed: {rc}")
    return out


def trace_push(name: str) -> None:
    lib = get_lib()
    if lib is not None:
        lib.tpuml_trace_push(name.encode())


def trace_pop() -> None:
    lib = get_lib()
    if lib is not None:
        lib.tpuml_trace_pop()


class NpyBlockReader:
    """Streaming block reader over a C-order float32/float64 ``.npy`` file.

    The mmap and readahead live in C++: :meth:`iter_blocks` warms the next
    block while the current one is used, each read is one copy out of the
    mapping, and a block's pages are released once it is copied. Blocks
    are fresh ``(rows, d)`` arrays. Pass the reader to a fit for constant
    host and device memory::

        reader = NpyBlockReader("data.npy", block_rows=1 << 20)
        PCA().setK(8).fit(reader)
        LinearRegression().fit((reader, y))
    """

    def __init__(self, path: str, block_rows: int = 1 << 20):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error()}")
        if int(block_rows) < 1:
            raise ValueError("block_rows must be >= 1")
        self._lib = lib
        self._handle = lib.tpuml_npy_open(os.fsencode(path))
        if not self._handle:
            raise ValueError(f"cannot open {path!r}: not a C-order float32/float64 .npy")
        rows, cols, dtype = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int32()
        lib.tpuml_npy_info(self._handle, ctypes.byref(rows), ctypes.byref(cols), ctypes.byref(dtype))
        self.shape = (rows.value, cols.value)
        self.dtype = np.float32 if dtype.value == 0 else np.float64
        self.block_rows = int(block_rows)

    def read_block(self, start: int, n_rows: int) -> np.ndarray:
        if not self._handle:
            raise ValueError("read_block on a closed NpyBlockReader")
        n_rows = min(n_rows, self.shape[0] - start)
        out = np.empty((n_rows, self.shape[1]), dtype=self.dtype)
        rc = self._lib.tpuml_npy_read_block(self._handle, start, n_rows, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise ValueError(f"read_block({start}, {n_rows}) failed: {rc}")
        return out

    def iter_blocks(self):
        n, b = self.shape[0], self.block_rows
        for start in range(0, n, b):
            if start + b < n:  # warm the next block while this one is used
                self._lib.tpuml_npy_prefetch(self._handle, start + b, b)
            yield self.read_block(start, b)
            if self._handle:
                # The block was copied out: drop its mapped pages, so a pass
                # stays resident-bounded by about one block.
                self._lib.tpuml_npy_release(self._handle, start, b)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.tpuml_npy_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NpyBlockReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
