"""Incremental refit — ``partial_fit(estimator, new_rows, model=prev)``.

Port of the reference's ``lifecycle/partial_fit.py``. Two mechanically
different families behind one verb:

- **Iterative solvers** (KMeans / LogisticRegression / LinearRegression):
  the refit is a normal fit over the new rows, seeded from the previous
  model's solution through each family's ``setInitialModel`` hook and
  driven by the segmented solver (``robustness/checkpoint.py``), so
  convergence is counter-observable: ``checkpoint.solver_iters`` counts
  each segment's iterations, and a warm seed that starts near the optimum
  runs fewer. With ``model=None`` the seed is the family's own cold init,
  so the zero state is bit-identical to a from-scratch fit of the same
  rows (segmented ≡ monolithic).

- **PCA**: the sufficient statistic is the model. Each call folds the new
  rows into a :class:`ShiftedMoments` block and merges it into the moments
  carried on the previous model (``model._moments``), the exact re-basing
  merge the gang fit uses across processes (``core/moments.py``). The
  eigensolve re-runs on the merged covariance, so PCA's ``dataset``
  accumulates across calls while the solver families' ``dataset``
  replaces. A tensor's rows fold on its own device through kernel K1's
  float64 route. Host rows fold where the platform computes: on the
  ``"cuda"`` platform they go to the card as float64 and take the same K1
  route (a refit of journaled host rows, as the lifecycle controller's,
  runs on the card); on ``"cpu"`` they fold in host float64, as in the
  reference.

This module is the single dispatch point; ``Estimator.partial_fit``
delegates here.
"""

from __future__ import annotations

import copy as _copy
from typing import Any, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.utils.envknobs import env_int

EVERY_ENV = "TPUML_LIFECYCLE_EVERY"


def partial_fit(estimator: Any, dataset: Any, *, model: Optional[Any] = None):
    """Refit ``estimator`` over ``dataset`` seeded from ``model``.

    Returns a fresh fitted model; neither ``estimator`` nor ``model`` is
    mutated (the estimator is cloned, warm-start state lives on the
    clone). ``model=None`` is the zero state: identical to a cold fit.
    """
    from spark_rapids_ml_tpu_torch.models.pca import PCA

    if isinstance(estimator, PCA):
        return _partial_fit_pca(estimator, dataset, model)

    from spark_rapids_ml_tpu_torch.models.kmeans import KMeans
    from spark_rapids_ml_tpu_torch.models.linear_regression import LinearRegression
    from spark_rapids_ml_tpu_torch.models.logistic_regression import LogisticRegression

    if not isinstance(estimator, (KMeans, LogisticRegression, LinearRegression)):
        raise TypeError(
            "partial_fit supports KMeans, LogisticRegression, "
            "LinearRegression (solution-seeded segmented refit) and PCA "
            f"(streaming-moment merge); got {type(estimator).__name__}"
        )
    clone = estimator.copy()
    if model is not None:
        clone.setInitialModel(model)
    # Force the segmented solver (the disk-free EphemeralSegmenter unless
    # a TPUML_CHECKPOINT_* checkpointer is armed), so every refit counts
    # its iterations on checkpoint.solver_iters.
    clone._force_segment_every = env_int(EVERY_ENV, 8, minimum=1)
    emit(
        "lifecycle",
        action="partial_fit",
        estimator=type(estimator).__name__,
        warm=model is not None,
    )
    return clone.fit(dataset)


def _new_moments(dataset: Any, input_col: Optional[str]):
    """The new rows' :class:`ShiftedMoments`: a tensor (or a stream's
    tensor blocks) on its device; host rows as float64 on the platform's
    device (:func:`_placed`)."""
    from spark_rapids_ml_tpu_torch.core.data import (
        _block_to_dense,
        as_matrix,
        extract_column,
        is_device_array,
        is_streaming_source,
        iter_stream_blocks,
    )
    from spark_rapids_ml_tpu_torch.core.moments import ShiftedMoments

    rows = extract_column(dataset, input_col)
    if is_streaming_source(rows):
        new_mom = None
        for blk in iter_stream_blocks(rows):
            part = blk if is_device_array(blk) else _placed(np.asarray(_block_to_dense(blk), dtype=np.float64))
            if part.shape[0] == 0:
                continue
            if new_mom is None:
                new_mom = ShiftedMoments(part.shape[1])
            new_mom.add_block(part)
        if new_mom is None:
            raise ValueError("partial_fit got an empty stream")
        return new_mom
    x = rows if is_device_array(rows) else np.asarray(as_matrix(rows), dtype=np.float64)
    if x.ndim != 2 or x.shape[0] == 0:
        raise ValueError(f"partial_fit needs a non-empty (n, d) batch, got {tuple(x.shape)}")
    return ShiftedMoments(x.shape[1]).add_block(x if is_device_array(x) else _placed(x))


def _placed(host: np.ndarray):
    """Host float64 rows where they fold: on the card (a float64 tensor,
    so K1's float64 route) on the ``"cuda"`` platform, unchanged on the
    CPU platform. Raises on ``"cuda"`` without a card."""
    from spark_rapids_ml_tpu_torch import device as _device

    if _device.get_platform() != "cuda" or host.size == 0:
        return host
    import torch

    return torch.from_numpy(np.ascontiguousarray(host)).to(_device.resolve_device())


def _partial_fit_pca(estimator, dataset, model):
    """Exact streaming PCA: fold new rows into the carried moments.

    Mirrors the reference's host float64 tail (clip → trace-normalize →
    slice), so a single-call ``partial_fit(est, all_rows)`` matches
    ``est.fit(all_rows)`` up to the eigensolver's path, and the moments are
    exact however the rows were split across calls (the merge re-bases
    shifts algebraically)."""
    from spark_rapids_ml_tpu_torch.models.pca import PCAModel
    from spark_rapids_ml_tpu_torch.ops.eigh import eigh_descending_host

    new_mom = _new_moments(dataset, estimator.getInputCol())
    prev = None
    if model is not None:
        prev = getattr(model, "_moments", None)
        if prev is None:
            raise ValueError(
                "PCA partial_fit needs a previous model that carries "
                "streaming moments (one produced by partial_fit); a plain "
                "fit() model has already collapsed its sufficient statistics"
            )
        if prev.n_cols != new_mom.n_cols:
            raise ValueError(
                f"feature width changed: previous moments have "
                f"{prev.n_cols} columns, new rows have {new_mom.n_cols}"
            )
    # Deep-copy before merging: the caller's previous model must stay a
    # valid rollback target, not silently absorb the new rows.
    mom = _copy.deepcopy(prev).merge(new_mom) if prev is not None else new_mom

    cov, _mean = mom.finalize(center=estimator.getMeanCentering())
    w, u = eigh_descending_host(cov)
    w = np.clip(w, 0, None)
    total = w.sum()
    explained = w / total if total > 0 else w
    k = estimator.getK()
    if not 1 <= k <= cov.shape[0]:
        raise ValueError(f"k must be in [1, {cov.shape[0]}], got {k}")
    fitted = PCAModel(estimator.uid, u[:, :k], explained[:k])
    fitted._moments = mom  # carried forward for the next incremental call
    emit(
        "lifecycle",
        action="partial_fit",
        estimator="PCA",
        warm=model is not None,
        rows_total=mom.n_rows,
    )
    return estimator._copyValues(fitted)
