"""The comparison fails a broken program. Each case drives a whole tiny
run on the CPU (the look for a card skipped) with the port's timed path
broken underneath, once for each fault the cell can have, and sees
``correct`` come out false:

- half of the rows left out, the estimate taken over the rest;
- an answer altered where it is produced;
- a Lloyd step that returns its state unchanged (KMeans's fit, the one
  iterative state a cell's window drives).

The cells run on one chip, so no exchange between chips can be left out.
"""

import pytest

import spark_rapids_ml_tpu_torch.linalg.row_matrix as row_matrix
import spark_rapids_ml_tpu_torch.models.kmeans as models_kmeans
import spark_rapids_ml_tpu_torch.ops.kmeans as ops_kmeans
from portbench.tests.rehearse import rehearse


def _half_gram(orig):
    def gram(x, mean):
        half = x[: x.shape[0] // 2]
        return orig(half, mean) * (x.shape[0] / half.shape[0])
    return gram


def _altered_eigh(orig):
    def eigh(*args, **kw):
        w, v, promoted = orig(*args, **kw)
        v = v.clone()
        v[0, 0] += 0.05
        return w, v, promoted
    return eigh


def _half_rows(orig):
    def prepare(rows, *args, **kw):
        xs, mask, n, d = orig(rows, *args, **kw)
        return xs[: n // 2], mask[: n // 2], n // 2, d
    return prepare


def _still_step(orig):
    def step(x, mask, centers, *args, **kw):
        _, cost = orig(x, mask, centers, *args, **kw)
        return centers, cost
    return step


def _altered_lloyd(orig):
    def lloyd(*args, **kw):
        centers, cost, n_iter = orig(*args, **kw)
        centers = centers.clone()
        centers[3, 0] += 1.0
        return centers, cost, n_iter
    return lloyd


FAULTS = {
    ("pca.fit", "half rows"): (row_matrix, "centered_gram_cuda", _half_gram),
    ("pca.fit", "altered component"): (row_matrix, "eigh_auto", _altered_eigh),
    ("kmeans.fit", "half rows"): (models_kmeans, "prepare_rows", _half_rows),
    ("kmeans.fit", "altered centre"): (models_kmeans, "lloyd", _altered_lloyd),
    ("kmeans.fit", "still step"): (ops_kmeans, "lloyd_step", _still_step),
}


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    module, attr, breaker = FAULTS[(cell, fault)]
    monkeypatch.setattr(module, attr, breaker(getattr(module, attr)))
    out = rehearse(cell, seconds=0.2)
    assert not out.correct, out.checks
    assert any(c["value"] > c["limit"] for c in out.checks.values())
