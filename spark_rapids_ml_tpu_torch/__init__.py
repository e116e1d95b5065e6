"""spark_rapids_ml_tpu_torch — the PyTorch/CUDA port of spark_rapids_ml_tpu.

The JAX package beside this one is the reference: every module here has
one twin there, at the same relative path, and is held against it on the
same inputs by ``tests/test_torch_*.py``. This package imports ``torch``
and ``numpy`` and never ``jax`` or anything of the JAX package.

Layer map (the reference's, one for one):
  - ``feature`` / ``clustering`` / ``manifold`` / ``regression`` /
    ``classification`` / ``models`` — user-facing estimators (PCA, KMeans,
    UMAP, LinearRegression, LogisticRegression and their models)
  - ``evaluation``            — Regression, Multiclass and Binary evaluators
  - ``linalg``                — row-matrix orchestration (RowMatrix)
  - ``core``                  — params, data, ingest, persistence, serving
  - ``ops``                   — plain tensor math (covariance, eigh, GEMMs,
    KMeans, kNN, UMAP, linear and logistic solvers, L-BFGS, metrics)
  - ``ops.kernels`` + ``csrc``— hand-written Hopper kernels (CUDA C++,
    built with nvcc on first use, bound with ctypes)
  - ``device``                — where entry points compute (CUDA by default)
  - ``utils.tracing``         — NVTX ranges and plain counters
"""

from spark_rapids_ml_tpu_torch.version import __version__

__all__ = ["__version__"]
