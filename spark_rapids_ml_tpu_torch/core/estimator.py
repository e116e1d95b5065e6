"""Estimator / Model base classes mirroring Spark ML's abstractions.

Port of the reference's ``core/estimator.py``: ``Estimator.fit(dataset)``
delegates to the family's ``_fit`` and returns a ``Model`` (a
``Transformer``). ``fit`` is the fit path's OOM safety net, as in the
reference: a device OOM that escaped the family's own recovery re-raises
as the structured ``core.membudget.FitMemoryError``. Left out until their
slices: gang deployment, the run recorder around ``fit``,
``partial_fit`` and fit checkpointing.
"""

from __future__ import annotations

from typing import Any, Optional

from spark_rapids_ml_tpu_torch.core.membudget import reraise_if_oom
from spark_rapids_ml_tpu_torch.core.params import Param, Params, toString
from spark_rapids_ml_tpu_torch.core.persistence import MLReadable


class HasInputCol(Params):
    inputCol = Param("_", "inputCol", "input column name", toString)

    def getInputCol(self) -> Optional[str]:
        return self.getOrDefault(self.inputCol) if self.isDefined(self.inputCol) else None

    def setInputCol(self, value: str):
        return self.set(self.inputCol, value)


class HasOutputCol(Params):
    outputCol = Param("_", "outputCol", "output column name", toString)

    def getOutputCol(self) -> str:
        if self.isDefined(self.outputCol):
            return self.getOrDefault(self.outputCol)
        return f"{self.uid}__output"

    def setOutputCol(self, value: str):
        return self.set(self.outputCol, value)


class Transformer(Params):
    def transform(self, dataset: Any) -> Any:
        raise NotImplementedError


class Estimator(Params):
    def fit(self, dataset: Any):
        """Fit ``dataset`` and return the fitted model. A raw device OOM
        never escapes: it re-raises as ``FitMemoryError``."""
        try:
            return self._fit(dataset)
        except RuntimeError as exc:
            failure = exc
        device_id = self.getOrDefault("gpuId") if self.hasParam("gpuId") else -1
        reraise_if_oom(failure, type(self).__name__, device_id)
        raise failure

    def _fit(self, dataset: Any):
        raise NotImplementedError


class Model(Transformer, MLReadable):
    """A fitted transformer; carries a parent uid via copyValues like Spark."""
