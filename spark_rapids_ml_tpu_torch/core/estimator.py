"""Estimator / Model base classes mirroring Spark ML's abstractions.

Port of the reference's ``core/estimator.py``: ``Estimator.fit(dataset)``
delegates to the family's ``_fit`` and returns a ``Model`` (a
``Transformer``). ``fit`` is the fit path's OOM safety net, as in the
reference: a device OOM that escaped the family's own recovery re-raises
as the structured ``core.membudget.FitMemoryError``. ``deployMode`` (env
twin ``TPUML_GANG_FIT``) makes a fit one member of a
``torch.distributed`` gang, as in the reference, and
:meth:`Estimator._fit_checkpointer` hands the segmented solvers their
checkpointer (``robustness/checkpoint.py``). :meth:`Estimator.partial_fit`
is the continuous-training entry (``lifecycle/partial_fit.py``). Every
``fit`` runs under the run recorder (``observability/report.py``), as in
the reference: a ``fit`` run scope (a nested fit — a CrossValidator's, a
pipeline stage's, ``partial_fit``'s — joins the outer run), optionally a
``torch.profiler`` session (``TPUML_PROFILE_DIR``), and the finished
report on the model as :meth:`Model.fit_report`.
"""

from __future__ import annotations

from typing import Any, Optional

from spark_rapids_ml_tpu_torch.core.membudget import reraise_if_oom
from spark_rapids_ml_tpu_torch.core.params import Param, Params, toString
from spark_rapids_ml_tpu_torch.core.persistence import MLReadable
from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.utils.envknobs import env_int, env_str


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
    #: Fit deployment mode: ``"single"`` (default) fits on this process's
    #: devices alone; ``"gang"`` makes this process one member of a
    #: ``torch.distributed`` gang — every member calls the same ``fit``
    #: with its LOCAL rows, the ingest funnel lays them out as one
    #: row-sharded input, and the reductions are all-reduced, so every
    #: member returns the identical whole-dataset model. The env twin is
    #: ``TPUML_GANG_FIT=1``.
    deployMode = Param("_", "deployMode", "fit deployment mode: 'single' or 'gang'", toString)

    def getDeployMode(self) -> str:
        if self.isDefined(self.deployMode):
            return self.getOrDefault(self.deployMode)
        return "gang" if env_str("TPUML_GANG_FIT", "0") == "1" else "single"

    def setDeployMode(self, value: str):
        if value not in ("single", "gang"):
            raise ValueError(f"deployMode must be 'single' or 'gang', got {value!r}")
        return self.set(self.deployMode, value)

    def _join_gang(self) -> None:
        """Gang-member bring-up at the top of a gang fit: join the gang
        when ``TPUML_NUM_PROCESSES > 1`` or ``TPUML_COORDINATOR`` is set
        (idempotent), and default this estimator's mesh to the gang's
        (``global_mesh``). A family without a mesh route raises its
        ROADMAP item here (``setMesh``) or at its fit."""
        from spark_rapids_ml_tpu_torch.parallel import distributed as gang

        num = env_int("TPUML_NUM_PROCESSES", minimum=1)
        if (num is not None and num > 1) or env_str("TPUML_COORDINATOR"):
            gang.initialize()
        if getattr(self, "mesh", None) is None and hasattr(self, "setMesh"):
            self.setMesh(gang.global_mesh())
        emit("gang_fit", action="join", estimator=type(self).__name__,
             num_processes=gang.process_count(), process_id=gang.process_index())

    def fit(self, dataset: Any):
        """Fit ``dataset`` and return the fitted model, instrumented: the
        call runs under a ``fit`` run scope (a fresh ``run_id``
        standalone, the ambient one inside a caller's scope), optionally
        inside a ``TPUML_PROFILE_DIR`` profiler session, and the finished
        :class:`~spark_rapids_ml_tpu_torch.observability.report.RunReport`
        (stage tree, counter deltas, device memory) hangs off the model as
        ``model.fit_report()``. Families implement :meth:`_fit`; an
        estimator that overrides ``fit`` opts out, as in the reference.

        A raw device OOM never escapes: it re-raises as
        ``FitMemoryError``."""
        from spark_rapids_ml_tpu_torch.observability.report import RunRecorder

        with RunRecorder("fit", type(self).__name__) as rec:
            model = self._fit_guarded(dataset)
        rec.attach(model)
        return model

    def _fit_guarded(self, dataset: Any):
        """The gang join and :meth:`_fit`, with the OOM safety net."""
        try:
            if self.getDeployMode() == "gang":
                self._join_gang()
            return self._fit(dataset)
        except RuntimeError as exc:
            failure = exc
        device_id = self.getOrDefault("gpuId") if self.hasParam("gpuId") else -1
        try:
            reraise_if_oom(failure, type(self).__name__, device_id)
            raise failure
        finally:
            # The raised error's traceback holds this frame: drop the
            # frame's reference to it, or the two form a cycle that keeps
            # whatever the failed fit placed alive until a collection.
            failure = None

    def _fit(self, dataset: Any):
        raise NotImplementedError

    def partial_fit(self, dataset: Any, *, model=None):
        """Incremental refit: fit over ``dataset`` (the NEW rows only),
        seeding the segmented solver from ``model``'s solution — the
        continuous-training entry (``lifecycle/partial_fit.py``). With
        ``model=None`` this is the zero state: bit-identical to a
        from-scratch fit of ``dataset``. Supported for KMeans (center
        seed), LogisticRegression (L-BFGS seed), LinearRegression (FISTA
        seed), and PCA (exact streaming-moment merge, where ``dataset``
        accumulates rather than replaces); other families raise
        ``TypeError``."""
        from spark_rapids_ml_tpu_torch.lifecycle.partial_fit import partial_fit

        return partial_fit(self, dataset, model=model)

    def _fit_checkpointer(self, solver: str, data=()):
        """This fit's checkpoint handle (``robustness/checkpoint.py``), or
        None when the ``TPUML_CHECKPOINT_*`` knobs leave checkpointing off,
        the default, in which case nothing is computed and the fit keeps
        its monolithic solver.

        Identity is (estimator uid, parameter hash, data fingerprint): the
        checkpointer finds the newest valid snapshot under
        ``TPUML_CHECKPOINT_DIR``, the segmented solver resumes mid-solve
        bit for bit, and a completed fit removes its snapshots. A forced
        segment length (``_force_segment_every``, ``partial_fit``'s) gives
        a disk-free segmenter when the knobs are off."""
        from spark_rapids_ml_tpu_torch.robustness.checkpoint import EphemeralSegmenter, FitCheckpointer

        ckpt = FitCheckpointer.for_fit(self, solver=solver, data=data)
        if ckpt is None and getattr(self, "_force_segment_every", 0):
            return EphemeralSegmenter(self._force_segment_every)
        return ckpt


class Model(Transformer, MLReadable):
    """A fitted transformer; carries a parent uid via copyValues like Spark."""

    _fit_report = None

    def fit_report(self):
        """The :class:`~spark_rapids_ml_tpu_torch.observability.report.RunReport`
        of the fit that produced this model (stage-timing tree, counter
        deltas, checkpoint activity, device memory), or None for models
        built outside an instrumented fit (loaded from disk, unpickled
        from a report-less model, hand-constructed)."""
        return self._fit_report
