"""Device-side evaluator reductions — port of the reference's ``ops/metrics.py``.

The evaluators (``evaluation.py``) route tensor pairs and large host pairs
here, so the reduction stays on the device: plain reductions for
regression, one ``bincount`` of the composite label for the multiclass
confusion matrix, and one sort plus cumulative scans for the AUC.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def regression_metrics_device(y: torch.Tensor, p: torch.Tensor):
    """``(rmse, mse, mae, r2)`` as 0-d tensors."""
    err = y - p
    mse = torch.mean(err * err)
    mae = torch.mean(torch.abs(err))
    ss_tot = torch.sum((y - torch.mean(y)) ** 2)
    r2 = torch.where(ss_tot > 0, 1.0 - torch.sum(err * err) / ss_tot, torch.zeros_like(ss_tot))
    return torch.sqrt(mse), mse, mae, r2


def confusion_matrix_device(y: torch.Tensor, p: torch.Tensor, n_classes: int) -> torch.Tensor:
    """(C, C) confusion counts from ONE bincount of ``y·C + p``, no (n, C)
    one-hot. Labels must lie in [0, C): unlike ``jnp.bincount(length=)``,
    ``torch.bincount`` grows past ``minlength`` instead of truncating, so
    the caller's range check is what keeps the shape."""
    comp = y.to(torch.int64) * n_classes + p.to(torch.int64)
    return torch.bincount(comp, minlength=n_classes * n_classes).reshape(n_classes, n_classes)


def multiclass_metrics_device(y: torch.Tensor, p: torch.Tensor, n_classes: int) -> dict:
    """``{accuracy, f1, weightedPrecision, weightedRecall}`` from the
    device confusion matrix (host math on the (C, C) result)."""
    cm = confusion_matrix_device(y, p, n_classes).cpu().numpy().astype(np.float64)
    n = cm.sum()
    tp = np.diag(cm)
    per_actual = cm.sum(axis=1)
    per_pred = cm.sum(axis=0)
    weights = per_actual / n
    prec = np.where(per_pred > 0, tp / np.maximum(per_pred, 1), 0.0)
    rec = np.where(per_actual > 0, tp / np.maximum(per_actual, 1), 0.0)
    f1 = np.where(prec + rec > 0, 2 * prec * rec / np.maximum(prec + rec, 1e-300), 0.0)
    return {
        "accuracy": float(tp.sum() / n),
        "f1": float(weights @ f1),
        "weightedPrecision": float(weights @ prec),
        "weightedRecall": float(weights @ rec),
    }


def _pack_f32_keys(y: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """float32 scores → int64 keys that sort in score order, the label in
    bit 0: the standard monotone bit transform of the 32 score bits
    (sign set: flip all; clear: flip the sign), shifted up one. The key
    needs 33 bits. −0.0 becomes +0.0 first, so both zeros share a group."""
    sz = torch.where(s == 0, torch.zeros_like(s), s)
    u = sz.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u ^ 0x80000000)
    return (key << 1) | y.to(torch.int64)


def binary_auc_device(y: torch.Tensor, s: torch.Tensor, metric: str = "areaUnderROC") -> torch.Tensor:
    """Tie-grouped AUC (ROC or PR) on the device (:func:`_binary_auc`);
    with the cost ledger on, a ``metrics.binary_auc`` program of its own
    shape, counted as a sort of the n scores (:func:`auc_cost`)."""
    from spark_rapids_ml_tpu_torch.observability import costs

    led = costs.active()
    if led is None:
        return _binary_auc(y, s, metric=metric)
    n = int(s.shape[0])
    key = costs.record_fallback(_binary_auc, name="metrics.binary_auc", static={"metric": metric}, args=(y, s),
                                cost=lambda: auc_cost(n))
    return costs.timed_invocation(led, key, n, s.device, lambda: _binary_auc(y, s, metric=metric))


def auc_cost(n: int) -> dict:
    """The counted work of one AUC over n scores: a comparison sort,
    n·log2(n) comparisons, moving 8-byte keys through 2·log2(n) passes
    (the smoke's sort bound), plus the labels and scores read once and
    two scans."""
    passes = max(math.log2(max(n, 2)), 1.0)
    return {"flops": float(n * passes + 4 * n), "transcendentals": 0.0,
            "bytes_accessed": float(2 * 8 * n * passes + 16 * n)}


def _binary_auc(y: torch.Tensor, s: torch.Tensor, metric: str = "areaUnderROC") -> torch.Tensor:
    """Tie-grouped AUC (ROC or PR), one sort and cumulative scans: one
    curve point per distinct score, trapezoids through ties, as the host
    evaluator computes it.

    float32 scores sort as packed int64 keys (one one-operand sort; tie
    groups are exact, and only group-end counts are read, so the label
    order inside a group does not matter); other dtypes sort stably on the
    score and carry the labels by the permutation. Counts are integers
    (int64), exact at any n. The curve's points are the cumulative counts
    at the group ends, compacted with one ``nonzero`` (one sync): the
    reference carries the previous point forward with a running max
    (``lax.cummax``) because XLA needs static shapes, and
    ``torch.cummax`` is a slow scan with indices on the card (``PERF.md``
    §5); the trapezoids are the same."""
    n = s.shape[0]
    if s.dtype == torch.float32:
        srt = torch.flip(torch.sort(_pack_f32_keys(y, s)).values, (0,))  # descending
        is_pos = srt & 1
        key_desc = srt >> 1
        distinct = torch.cat([key_desc[1:] != key_desc[:-1], key_desc.new_ones(1, dtype=torch.bool)])
    else:
        s_desc, order = torch.sort(s, descending=True, stable=True)
        is_pos = (y[order] == 1).to(torch.int64)
        distinct = torch.cat([s_desc[1:] != s_desc[:-1], s_desc.new_ones(1, dtype=torch.bool)])
    dt = s.dtype if s.is_floating_point() else torch.float64
    n_pos_i = torch.sum(is_pos)
    n_pos = n_pos_i.to(dt)
    n_neg = (n - n_pos_i).to(dt)
    ends = torch.nonzero(distinct).squeeze(1)
    tp_end = torch.cumsum(is_pos, dim=0)[ends]
    fp_end = ends + 1 - tp_end  # fp = rank − tp
    zero = tp_end.new_zeros(1)
    tp_k, fp_k = tp_end.to(dt), fp_end.to(dt)
    tp_p = torch.cat([zero, tp_end[:-1]]).to(dt)
    fp_p = torch.cat([zero, fp_end[:-1]]).to(dt)
    has_prev = torch.arange(ends.shape[0], device=s.device) > 0
    one = torch.ones((), dtype=dt, device=s.device)
    if metric == "areaUnderROC":
        xs = fp_k / torch.maximum(n_neg, one)
        ys = tp_k / torch.maximum(n_pos, one)
        x_prev = fp_p / torch.maximum(n_neg, one)
        y_prev = tp_p / torch.maximum(n_pos, one)
    else:
        xs = tp_k / torch.maximum(n_pos, one)  # recall
        ys = tp_k / torch.maximum(tp_k + fp_k, one)  # precision
        x_prev = tp_p / torch.maximum(n_pos, one)
        # The curve starts at precision 1.0 (Spark's convention).
        y_prev = torch.where(has_prev, tp_p / torch.maximum(tp_p + fp_p, one), one)
    auc = torch.sum((xs - x_prev) * (ys + y_prev) / 2.0)
    degenerate = torch.logical_or(n_pos == 0, n_neg == 0)
    return torch.where(degenerate, torch.zeros_like(auc), auc)


__all__ = [
    "regression_metrics_device",
    "confusion_matrix_device",
    "multiclass_metrics_device",
    "binary_auc_device",
]
