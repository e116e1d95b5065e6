"""Barrier-stage gang deployment — port of the reference's
``spark/barrier.py``.

A multi-process ``torch.distributed`` fit is a gang: one process group,
collectives over every member. Spark's per-task retry is wrong for it
(a retried task would rejoin a cohort whose peers are dead or hung), so
the Spark deployment is a **barrier stage** (``rdd.barrier().
mapPartitions``): the scheduler launches every task together and retries
the WHOLE stage when any task fails.

  - :func:`barrier_gang_run` — run a per-partition task function as one
    barrier stage and collect its outputs; any task failure relaunches
    the gang (Spark's stage retry, up to spark.stage.maxConsecutiveAttempts),
    and the driver may resubmit the stage (``TPUML_BARRIER_RESUBMITS``).
  - :func:`gang_coordinates` — the ``parallel.distributed.initialize``
    arguments (coordinator address, process count and id) of one member,
    from the barrier task context, so each relaunched gang forms a FRESH
    process group on a fresh port.
  - :func:`gang_fit` — one barrier stage whose members each call the
    public ``Estimator.fit`` with ``deployMode='gang'``.

  - :func:`serving_gang_run` — the serving tier's members as one barrier
    stage (``RoutingRuntime(launch="barrier")``).

Works the same against genuine pyspark and the contract stub
(``tests/pyspark_stub``).
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Iterator, Optional

from spark_rapids_ml_tpu_torch.robustness.degrade import run_degradable
from spark_rapids_ml_tpu_torch.robustness.retry import RetryPolicy
from spark_rapids_ml_tpu_torch.utils.envknobs import env_int

#: The reference's conventional coordinator port (``TPUML_GANG_PORT``).
DEFAULT_COORDINATOR_PORT = 8476

# Driver-side STAGE resubmissions (whole-gang, on top of the scheduler's
# own spark.stage.maxConsecutiveAttempts budget). Default 1 = submit once
# and trust the scheduler; raise it when the cluster's stage budget is too
# small for the failure domain.
BARRIER_RESUBMITS_ENV = "TPUML_BARRIER_RESUBMITS"


def barrier_gang_run(
    rdd,
    task_fn: Callable[[Optional[object], Iterator], Iterable],
    policy: Optional[RetryPolicy] = None,
    checkpoint_dir: Optional[str] = None,
) -> list:
    """Run ``task_fn(barrier_ctx, partition_iterator)`` over every
    partition as ONE barrier stage and return the collected outputs.

    ``barrier_ctx`` is the ``BarrierTaskContext`` (None only where a
    runtime lacks barrier support). Its ``barrier()`` is called before
    ``task_fn``, so no member starts compute until the whole gang is
    scheduled. Any exception in any task relaunches ALL tasks (Spark's
    barrier-stage retry); after the scheduler's stage-attempt limit the
    error reaches the driver, where the shared :class:`RetryPolicy` owns
    what happens next: a ``ValueError`` from the task is a bug and
    re-raises untouched; a runtime failure may resubmit the whole stage
    (``TPUML_BARRIER_RESUBMITS``, default 1 = no resubmit), and an
    exhausted budget raises one ``RetryExhaustedError`` — never a hang.
    ``TPUML_DEGRADE=cpu`` is refused (``robustness.degrade.run_degradable``):
    the port has no driver-local fallback stage.

    ``checkpoint_dir`` (a path every executor can reach) is the
    elastic-resume handoff: each member exports it as
    ``TPUML_CHECKPOINT_DIR`` for the task's lifetime, so an iterative fit
    inside the task snapshots its solver state and a resubmitted gang
    resumes mid-solve. Give the estimators STABLE uids: a checkpoint's
    identity is uid + param hash. Every driver-side resubmission bumps
    the ``gang.resubmit`` counter.

    Each member declares the ``barrier.attempt`` fault site right after
    the launch barrier, so a chaos test can fail attempt 0 and assert the
    relaunch refits bitwise.

    The stage runs as ONE distributed trace: the driver opens (or joins)
    a trace under a ``barrier gang`` span, and a carrier dict — the trace
    coordinates (``TPUML_TRACE_ID`` / ``TPUML_TRACE_PARENT``), the
    telemetry shard dir (``TPUML_TELEMETRY_DIR``) and the checkpoint dir
    — rides the task closure into every member, which exports it for the
    task's lifetime. Each member runs under a heartbeat scope.
    """
    from spark_rapids_ml_tpu_torch.observability import events as _events
    from spark_rapids_ml_tpu_torch.utils.tracing import TraceColor, TraceRange, bump_counter

    with _events.run_scope("gang", "barrier_gang_run"), TraceRange("barrier gang", TraceColor.CYAN):
        carrier = _events.inject_env({})
        if checkpoint_dir is not None:
            from spark_rapids_ml_tpu_torch.robustness.checkpoint import DIR_ENV

            carrier[DIR_ENV] = checkpoint_dir
        tdir = _events.telemetry_dir()
        if tdir is not None:
            carrier[_events.TELEMETRY_DIR_ENV] = tdir

        def wrapped(it):
            from pyspark import BarrierTaskContext

            from spark_rapids_ml_tpu_torch.observability import events as _ev
            from spark_rapids_ml_tpu_torch.observability.heartbeat import heartbeat_scope
            from spark_rapids_ml_tpu_torch.robustness.faults import fault_point

            # Export the carrier for the TASK's lifetime only: executor
            # processes are reused across tasks (and under the stub the
            # "executor" is the driver), so a permanent export would leak
            # this stage's trace into the next job's.
            saved = {k: os.environ.get(k) for k in carrier}
            os.environ.update(carrier)
            # A SIGTERM'd member flushes its shard and manifest from the
            # handler; off the main thread (the stub) this is a no-op.
            undo_sigterm = _ev.install_sigterm_flush()
            try:
                if not _ev.enabled():
                    # A fresh executor process: wire its own telemetry
                    # shard (or event log) and pick up the driver's trace.
                    _ev.configure()
                ctx = BarrierTaskContext.get()
                if ctx is not None:
                    ctx.barrier()
                fault_point("barrier.attempt")
                try:
                    member = int(ctx.partitionId()) if ctx is not None else 0
                except Exception:  # a stub context without partitionId
                    member = 0
                with _ev.trace_scope(_ev.current_trace() or _ev.extract_env()):
                    with heartbeat_scope(member, what="barrier"):
                        result = task_fn(ctx, it)
                        if hasattr(result, "__next__"):
                            # Drain a generator INSIDE the scopes: a lazily
                            # consumed body would run after the carrier is
                            # restored and the heartbeat stopped.
                            result = list(result)
                        return result
            finally:
                undo_sigterm()
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v

        if policy is None:
            # Not the generic TPUML_RETRY_MAX_ATTEMPTS: the scheduler
            # already retries the stage, so driver-side resubmission has
            # its own (default-off) budget.
            policy = RetryPolicy(max_attempts=env_int(BARRIER_RESUBMITS_ENV, 1, minimum=1))

        def _on_resubmit(attempt, exc):
            bump_counter("gang.resubmit")
            _events.emit("barrier", action="resubmit", attempt=attempt, error=type(exc).__name__)

        return run_degradable(
            lambda: policy.run(
                lambda: rdd.barrier().mapPartitions(wrapped).collect(),
                name="barrier.stage",
                on_retry=_on_resubmit,
            ),
            what="barrier gang fit",
        )


def gang_coordinates(ctx, port: int = DEFAULT_COORDINATOR_PORT) -> dict:
    """``parallel.distributed.initialize`` kwargs for one barrier member.

    The barrier task infos are the gang roster: task 0's host is the
    coordinator, the partition id is the process id. The task ATTEMPT
    number offsets the port: a failed attempt's rendezvous store can
    outlive its task while still bound to the port, so a relaunched gang
    on the same address could collide with (or join) the dead cohort's.
    """
    infos = ctx.getTaskInfos()
    host = infos[0].address.split(":")[0]
    attempt = int(getattr(ctx, "attemptNumber", lambda: 0)())
    return {
        "coordinator_address": f"{host}:{port + attempt}",
        "num_processes": len(infos),
        "process_id": int(ctx.partitionId()),
    }


def _as_feature_row(value):
    """One partition element as a dense numpy feature row (pyspark Vectors
    expose ``toArray``; anything else must already be array-like)."""
    import numpy as np

    return np.asarray(value.toArray() if hasattr(value, "toArray") else value, dtype=np.float64)


def _gang_extract(it, labeled: bool):
    """Materialize one member's partition as its LOCAL fit dataset: a
    (rows, d) matrix, or an ``(x, y)`` pair when ``labeled`` (elements are
    (features, label) sequences — the ``select(features, label).rdd`` row
    shape)."""
    import numpy as np

    xs, ys = [], []
    for r in it:
        if labeled:
            xs.append(_as_feature_row(r[0]))
            ys.append(float(r[1]))
        else:
            xs.append(_as_feature_row(r[0] if isinstance(r, (tuple, list)) else r))
    x = np.stack(xs) if xs else np.zeros((0, 0))
    return (x, np.asarray(ys)) if labeled else x


def gang_fit(
    estimator,
    rdd,
    labeled: bool = False,
    extract: Optional[Callable[[Iterator], object]] = None,
    port: Optional[int] = None,
    policy: Optional[RetryPolicy] = None,
    checkpoint_dir: Optional[str] = None,
) -> list:
    """Fit ``estimator`` gang-parallel: one barrier stage, one gang member
    per partition, each calling the PUBLIC ``fit()`` on its local rows::

        models = gang_fit(PCA().setK(2), df.rdd.map(lambda r: r[0]))

    Per member: the partition materializes as that member's LOCAL dataset
    (``labeled`` switches to (x, y) extraction; ``extract`` overrides the
    mapping), :func:`gang_coordinates` derives the member's coordinates
    from the barrier roster, and — for gangs of more than one member —
    they export as ``TPUML_COORDINATOR`` / ``TPUML_NUM_PROCESSES`` /
    ``TPUML_PROCESS_ID`` for the fit's lifetime. The member copies the
    estimator, sets ``deployMode='gang'`` and calls ``fit``:
    ``Estimator._join_gang`` joins the process group and sets the gang's
    mesh (``parallel.distributed.global_mesh``), and every member returns
    the identical whole-dataset model (the driver keeps ``models[0]``).

    All of :func:`barrier_gang_run`'s machinery rides along. The member
    of a gang of one keeps the estimator's uid, so with ``checkpoint_dir``
    a relaunched attempt resumes from the snapshots of the attempt it
    replaces; members of a larger gang draw fresh uids (the reference's
    copy) and refit from the start. ``port
    defaults to ``TPUML_GANG_PORT``. The contract stub runs barrier tasks
    one after another on the driver, so only single-member gangs (one
    partition) run under it; a real cluster schedules members together.
    """
    if port is None:
        port = env_int("TPUML_GANG_PORT", DEFAULT_COORDINATOR_PORT, minimum=1)
    do_extract = extract if extract is not None else (lambda it: _gang_extract(it, labeled))

    def task(ctx, it):
        local = do_extract(it)
        gang_env = {}
        if ctx is not None and hasattr(ctx, "getTaskInfos"):
            coords = gang_coordinates(ctx, port)
            if int(coords["num_processes"]) > 1:
                gang_env = {
                    "TPUML_COORDINATOR": coords["coordinator_address"],
                    "TPUML_NUM_PROCESSES": str(coords["num_processes"]),
                    "TPUML_PROCESS_ID": str(coords["process_id"]),
                }
        saved = {k: os.environ.get(k) for k in gang_env}
        os.environ.update(gang_env)
        try:
            member = estimator.copy().setDeployMode("gang")
            if not gang_env:
                # A copy draws a fresh uid; a gang of one keeps the
                # estimator's, since a checkpoint's identity is uid + param
                # hash and a relaunched attempt must find the snapshots of
                # the one before. Members of a larger gang keep their fresh
                # uids: their snapshots are named by step alone, so under
                # one uid they would overwrite each other's, and members
                # restoring different steps would run mismatched
                # collectives.
                member.uid = estimator.uid
            return [member.fit(local)]
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    return barrier_gang_run(rdd, task, policy=policy, checkpoint_dir=checkpoint_dir)


def serving_gang_run(rdd, rendezvous: str, policy: Optional[RetryPolicy] = None) -> list:
    """Run serving-tier members as ONE barrier stage: each partition's
    task body is :func:`serving.worker.serve_member` (publish a contact
    card into ``rendezvous``, accept the router connection, serve until
    shutdown). Partition elements are member ids (ints); an empty
    partition falls back to its partition id, so the common
    ``parallelize(range(n), n)`` roster works with either convention.
    A member serves on its executor's platform (``device.set_platform``).

    Blocks until the whole gang drains (the router's ``close``), so the
    router runs it on a background thread. All of
    :func:`barrier_gang_run`'s machinery (launch barrier, whole-stage
    relaunch, per-member heartbeats, the trace/telemetry carrier)
    applies unchanged; the trace carrier is what merges every member's
    serving events into the router's trace. The contract stub runs
    barrier tasks sequentially on the driver, so only a single-member
    gang runs under the stub; a real cluster schedules members
    concurrently."""
    from spark_rapids_ml_tpu_torch.serving.worker import serve_member

    def task(ctx, it):
        members = sorted(int(i) for i in it)
        if not members:
            try:
                members = [int(ctx.partitionId())] if ctx is not None else [0]
            except Exception:
                members = [0]
        return [serve_member(m, rendezvous) for m in members]

    return barrier_gang_run(rdd, task, policy=policy)


__all__ = [
    "BARRIER_RESUBMITS_ENV",
    "DEFAULT_COORDINATOR_PORT",
    "barrier_gang_run",
    "gang_coordinates",
    "gang_fit",
    "serving_gang_run",
]
