"""Deterministic fault injection: named sites, seedless schedules.

Port of the reference's ``robustness/faults.py``. Every layer that can
fail declares a named injection site, and a schedule says which
invocations of that site raise, so the recovery paths (the retry policy,
the atomic model writer, checkpointed fits that resume mid-solve) can be
provoked on purpose and tested.

Sites (the whole vocabulary; a spec naming anything else is an error):

  - ``ingest.device_put``       host->device placement (``core/ingest.py``,
                                ``parallel/mesh.py``)
  - ``distributed.initialize``  ``torch.distributed`` bring-up
                                (``parallel/distributed.py``)
  - ``barrier.attempt``         a barrier-stage gang attempt (the Spark item)
  - ``collective.psum``         the cross-process moment merge
                                (``parallel/distributed.py``)
  - ``persistence.write``       model data write (``core/persistence.py``)
  - ``checkpoint.write``        one solver-state snapshot write
                                (``robustness/checkpoint.py``)
  - ``checkpoint.restore``      one checkpoint-file read attempt
                                (``robustness/checkpoint.py``)
  - ``checkpoint.segment``      the preemption point between solver
                                segments (the segmented solvers)
  - ``solver.segment``          one solver segment / streaming-pass
                                execution (the fit-path OOM chokepoint)
  - ``ipc.send``, ``ipc.recv``  one serving-tier frame (the distributed
                                serving tier)
  - ``member.launch``, ``member.join``  one elastic serving member
  - ``refit.ingest``, ``refit.quality_gate``, ``refit.swap``  one
                                continuous-training cycle (lifecycle)
  - ``drift.tick``              one drift-trigger evaluation (lifecycle)

The sites of the modules the port has not reached yet parse and arm like
the rest; they are placed when those modules land.

Schedules are counters, not random draws, so a chaos test is exactly
reproducible:

  - ``site=N``           fail the first N invocations, then succeed
  - ``site=always``      fail every invocation
  - ``site=N@K``         skip the first K invocations, then fail the next
                         N (``always@K``: every invocation from the K-th on)
  - append ``:fatal``    raise a fault classified FATAL (never retried)
  - append ``:torn``     a TORN write: the site is killed mid-file, so a
                         truncated artifact lands at the FINAL path (only
                         ``checkpoint.write`` honours it)
  - append ``:oom``      a synthetic ``RESOURCE_EXHAUSTED``: the fault
                         carries the out-of-memory marker, so the fit-path
                         OOM recovery classifies injected and real OOMs
                         alike (``robustness/retry.is_oom_error``)
  - append ``:stall``    FREEZE instead of raise: the site blocks (in small
                         sleeps, bounded by ``STALL_MAX_S``) until the plan
                         is disarmed or the process is killed

Specs come from ``TPUML_FAULTS`` (semicolon- or comma-separated entries,
e.g. ``persistence.write=1;ingest.device_put=2``), read once at import by
:func:`arm_from_env`, or from the :func:`inject` context manager. With no
plan armed, :func:`fault_point` is one ``None`` check.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.utils.envknobs import env_str
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock

KNOWN_SITES = frozenset(
    {
        "ingest.device_put",
        "distributed.initialize",
        "barrier.attempt",
        "collective.psum",
        "persistence.write",
        "checkpoint.write",
        "checkpoint.restore",
        "checkpoint.segment",
        "solver.segment",
        "ipc.send",
        "ipc.recv",
        "member.launch",
        "member.join",
        "refit.ingest",
        "refit.quality_gate",
        "refit.swap",
        "drift.tick",
    }
)

#: Upper bound on one ``:stall`` freeze.
STALL_MAX_S = 60.0

ALWAYS = -1  # sentinel count: fail every invocation

FAULTS_ENV = "TPUML_FAULTS"


class InjectedFault(RuntimeError):
    """The error an armed fault site raises. Transient by default (the
    retry layer classifies it retryable); ``fatal=True`` is classified
    fatal and never retried; ``torn=True`` models a kill mid-file;
    ``oom=True`` carries the out-of-memory marker in its message."""

    def __init__(
        self,
        site: str,
        invocation: int,
        fatal: bool = False,
        torn: bool = False,
        oom: bool = False,
    ):
        self.site = site
        self.invocation = invocation
        self.fatal = fatal
        self.torn = torn
        self.oom = oom
        kind = "fatal" if fatal else "transient"
        if torn:
            kind += " torn-write"
        msg = f"injected {kind} fault at site {site!r} (invocation {invocation})"
        if oom:
            msg = f"RESOURCE_EXHAUSTED: out of memory — {msg}"
        super().__init__(msg)


class Schedule:
    """One site's failure schedule: fail invocations [skip, skip+count),
    or every invocation from ``skip`` on for ``count=ALWAYS``."""

    def __init__(
        self,
        count: int,
        fatal: bool = False,
        torn: bool = False,
        oom: bool = False,
        stall: bool = False,
        skip: int = 0,
    ):
        if count != ALWAYS and count < 0:
            raise ValueError(f"schedule count must be >= 0 or ALWAYS, got {count}")
        if skip < 0:
            raise ValueError(f"schedule skip must be >= 0, got {skip}")
        self.count = count
        self.fatal = fatal
        self.torn = torn
        self.oom = oom
        self.stall = stall
        self.skip = skip

    def should_fail(self, invocation: int) -> bool:
        if invocation < self.skip:
            return False
        return self.count == ALWAYS or invocation < self.skip + self.count

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        n = "always" if self.count == ALWAYS else str(self.count)
        if self.skip:
            n += f"@{self.skip}"
        flags = "".join(f", {f}" for f in ("fatal", "torn", "oom", "stall") if getattr(self, f))
        return f"Schedule({n}{flags})"


_SUFFIXES = ("fatal", "torn", "oom", "stall")


def parse_spec(spec: str) -> Dict[str, Schedule]:
    """Parse a ``TPUML_FAULTS`` spec string into {site: Schedule}; the
    errors and their messages are the reference's."""
    plan: Dict[str, Schedule] = {}
    for entry in spec.replace(",", ";").split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"malformed fault entry {entry!r}: expected "
                "site=N | site=always, optionally suffixed "
                ":fatal|:torn|:oom|:stall"
            )
        site, _, sched = entry.partition("=")
        site = site.strip()
        if site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {site!r}: known sites are "
                f"{sorted(KNOWN_SITES)}"
            )
        sched = sched.strip()
        flags = dict.fromkeys(_SUFFIXES, False)
        while True:
            suffix = next((f for f in _SUFFIXES if sched.endswith(":" + f)), None)
            if suffix is None:
                break
            flags[suffix] = True
            sched = sched[: -len(suffix) - 1]
        skip = 0
        if "@" in sched:
            sched, _, skip_s = sched.partition("@")
            try:
                skip = int(skip_s)
            except ValueError:
                raise ValueError(
                    f"malformed skip offset {skip_s!r} for site {site!r}: "
                    "expected site=N@K with integer K"
                ) from None
            if skip < 0:
                raise ValueError(
                    f"skip offset for site {site!r} must be >= 0, got {skip}"
                )
        if sched == "always":
            count = ALWAYS
        else:
            try:
                count = int(sched)
            except ValueError:
                raise ValueError(
                    f"malformed schedule {sched!r} for site {site!r}: "
                    "expected an integer count or 'always'"
                ) from None
            if count < 0:
                raise ValueError(
                    f"schedule count for site {site!r} must be >= 0, got {count}"
                )
        plan[site] = Schedule(count, skip=skip, **flags)
    return plan


class FaultPlan:
    """An active set of schedules with per-site invocation counters
    (per plan, thread-safe); ``fired`` records every fault raised."""

    def __init__(self, schedules: Dict[str, Schedule]):
        self._schedules = dict(schedules)
        self._counts: Dict[str, int] = {}  # guarded-by: _lock
        self._lock = make_lock("faults.plan")
        self.fired: List[Tuple[str, int]] = []

    def invocations(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def check(self, site: str) -> None:
        sched = self._schedules.get(site)
        if sched is None:
            return
        with self._lock:
            invocation = self._counts.get(site, 0)
            self._counts[site] = invocation + 1
            if not sched.should_fail(invocation):
                return
            self.fired.append((site, invocation))
            emit("fault", action="fire", site=site, invocation=invocation,
                 fatal=sched.fatal, torn=sched.torn, oom=sched.oom,
                 stall=sched.stall)
        if sched.stall:
            # Freeze outside the lock, until the plan is replaced or the
            # bound expires.
            deadline = time.monotonic() + STALL_MAX_S
            while _active is self and time.monotonic() < deadline:
                time.sleep(0.05)
            return
        raise InjectedFault(
            site, invocation, fatal=sched.fatal, torn=sched.torn, oom=sched.oom,
        )


# The active plan; None (the production state) makes fault_point one
# attribute load and comparison.
_active: Optional[FaultPlan] = None


def fault_point(site: str) -> None:
    """Declare a named injection site: raises :class:`InjectedFault` when
    the active plan schedules a failure for this invocation."""
    if _active is None:
        return
    _active.check(site)


def active_plan() -> Optional[FaultPlan]:
    return _active


def arm(spec: Union[str, Dict[str, Schedule]]) -> FaultPlan:
    """Install a fault plan (replacing any active one) and return it."""
    global _active
    plan = FaultPlan(parse_spec(spec) if isinstance(spec, str) else spec)
    _active = plan
    emit("fault", action="arm", sites=sorted(plan._schedules))
    return plan


def disarm() -> None:
    global _active
    _active = None
    emit("fault", action="disarm")


class inject:
    """Context manager: arm a plan for the block, restore the previous
    plan (usually none) on exit.

    >>> with inject("persistence.write=1") as plan:
    ...     model.write.overwrite().save(path)   # first write fails, retried
    >>> plan.fired
    [('persistence.write', 0)]
    """

    def __init__(self, spec: Union[str, Dict[str, Schedule]]):
        self._spec = spec
        self._prev: Optional[FaultPlan] = None
        self.plan: Optional[FaultPlan] = None

    def __enter__(self) -> FaultPlan:
        self._prev = _active
        self.plan = arm(self._spec)
        return self.plan

    def __exit__(self, *exc) -> None:
        global _active
        _active = self._prev


def arm_from_env() -> Optional[FaultPlan]:
    """Arm a plan from ``TPUML_FAULTS`` when set (a no-op otherwise). Runs
    once at import, so a launcher can inject into any process without code
    changes; harnesses that set the variable later call it again."""
    spec = env_str(FAULTS_ENV)
    if spec:
        return arm(spec)
    return None


arm_from_env()
