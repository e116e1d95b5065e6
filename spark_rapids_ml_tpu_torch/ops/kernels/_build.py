"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded with ``ctypes``. Builds land in
``build/torch_kernels/`` at the root of the checkout, keyed by a hash of
the source and the flags, so a changed source rebuilds and an unchanged
one loads at once. Nothing is built when a module is imported: the first
launch builds (or :func:`build_all` does, all sources in parallel, one
``nvcc`` each). A missing ``nvcc`` is an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}  # guarded by _lock
#: name -> nvcc's compiler output (ptxas register/spill report) of the
#: build this process ran; empty for a library that was already built.
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` / ``$CUDA_PATH`` or the
    toolkit's default prefix ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc was not found (PATH, CUDA_HOME, CUDA_PATH, /usr/local/cuda); "
        "the CUDA kernels of spark_rapids_ml_tpu_torch build with it"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its content and flags."""
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Iterable[str]) -> float:
    """Build every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    pending: List[tuple] = []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc: Optional[str] = None
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        pending.append((name, out, tmp, proc))
    failures = []
    for name, out, tmp, proc in pending:
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
