"""spark_rapids_ml_tpu_torch — the PyTorch/CUDA port of spark_rapids_ml_tpu.

The JAX package beside this one is the reference: every module here has
one twin there, at the same relative path, and is held against it on the
same inputs by ``tests/test_torch_*.py``. This package imports ``torch``
and ``numpy`` and never ``jax`` or anything of the JAX package.

Layer map (the reference's, one for one):
  - ``feature`` / ``clustering`` / ``manifold`` / ``regression`` /
    ``classification`` / ``neighbors`` / ``models`` — user-facing
    estimators (PCA, KMeans, UMAP, LinearRegression, LogisticRegression,
    NearestNeighbors, ApproximateNearestNeighbors and their models)
  - ``evaluation``            — Regression, Multiclass and Binary evaluators
  - ``pipeline`` / ``tuning`` — Pipeline and PipelineModel; ParamGridBuilder,
    CrossValidator and TrainValidationSplit
  - ``pipeline_fusion`` / ``serving`` — the fuser, the ServingSignature
    each model declares, and the in-process serving runtime
  - ``linalg``                — row-matrix orchestration (RowMatrix)
  - ``core``                  — params, data, ingest, persistence, serving,
    the fit memory guard (``membudget``)
  - ``ops``                   — plain tensor math (covariance, eigh, GEMMs,
    KMeans, kNN (resident and streamed), IVF-Flat and IVF-PQ, UMAP,
    linear and logistic solvers, L-BFGS, metrics)
  - ``ops.kernels`` + ``csrc``— hand-written Hopper kernels (CUDA C++,
    built with nvcc on first use, bound with ctypes)
  - ``native``                — ctypes loader of the host C++ runtime (the
    packed covariance accumulator, ``NpyBlockReader``), built with g++
  - ``parallel``              — device meshes, row sharding, the collectives
    of the mesh routes and the ``torch.distributed`` gang bring-up
  - ``device``                — where entry points compute (CUDA by default)
  - ``utils.tracing``         — span-recording ranges (NVTX on CUDA) and
    the counter aliases over the metrics registry
  - ``utils.envknobs``        — the ``TPUML_*`` knobs the port reads
  - ``robustness``            — fault injection (``TPUML_FAULTS``), the
    retry policy, checkpointed fits that resume mid-solve
    (``TPUML_CHECKPOINT_*``), OOM classification, degradation records
  - ``observability``         — the event log and telemetry shards, the
    metrics registry and its exposition, fit reports, profiler sessions,
    heartbeats, SLOs, the flight recorder and gang trace assembly
"""

from spark_rapids_ml_tpu_torch.version import __version__

__all__ = ["__version__"]
