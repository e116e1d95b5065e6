"""Carrying fitted weights from the JAX package into this one.

:func:`pca_model_from_numpy` builds a port ``PCAModel`` from the reference
model's arrays and param map, handed over as numpy and a plain dict —
so both packages compute the same transform without this package
importing the other. The second route is persistence: a model saved by
either package loads in the other (``PCAModel.load``).

Typical use, in code that has both packages::

    ref = reference_pca.fit(x)                    # the JAX model
    params = {p.name: v for p, v in ref.extractParamMap().items()}
    model = pca_model_from_numpy(ref.pc, ref.explainedVariance,
                                 uid=ref.uid, params=params)
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.models.pca import PCAModel


def pca_model_from_numpy(
    pc,
    explained_variance,
    uid: Optional[str] = None,
    params: Optional[Dict[str, Any]] = None,
) -> PCAModel:
    """A port ``PCAModel`` holding ``pc`` (d, k) and ``explained_variance``
    (k,) as float64, with every param of ``params`` that the model has
    set on it (reference-only params such as ``deployMode`` are skipped)."""
    pc = np.asarray(pc, dtype=np.float64)
    ev = np.asarray(explained_variance, dtype=np.float64)
    if pc.ndim != 2 or ev.shape != (pc.shape[1],):
        raise ValueError(
            f"pc must be (d, k) and explained_variance (k,), got {pc.shape} and {ev.shape}"
        )
    model = PCAModel(uid, pc, ev)
    for name, value in (params or {}).items():
        if model.hasParam(name):
            model.set(model.getParam(name), value)
    return model
