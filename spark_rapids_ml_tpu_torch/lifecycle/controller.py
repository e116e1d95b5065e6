"""LifecycleController — the journaled refit→swap state machine.

Port of the reference's ``lifecycle/controller.py``. The runtime is
anything with the registry façade: the in-process
:class:`~spark_rapids_ml_tpu_torch.serving.server.ServingRuntime` or the
replicated :class:`~spark_rapids_ml_tpu_torch.serving.router.RoutingRuntime`,
whose register, warm, flip and rollback take the router's zero-shed
paths (every member warms before the alias moves). One difference by
design: candidates and incumbents are journaled with plain :mod:`pickle`
(port models pickle by value, ``core/params.py``), where the reference
goes through its serving tier's cloudpickle codec; a router still ships
the candidate to its members through that codec (``serving/ipc.py``). A
tensor batch is copied to the host at ingest, which journals host
float64 rows as the reference does.

One :meth:`run_cycle` call takes a batch of fresh rows through

    ingest → refit → quality_gate → register → warm → flip

with every stage transition committed to the :class:`CycleJournal`
BEFORE the next stage runs. ``kill -9`` at any instant resumes the SAME
cycle on restart: completed stages replay from their journaled payloads
(the ingested split, the pickled candidate, the gate scores), and only
the stage that was in flight re-executes. Idempotency at the one
externally-visible stage — register — rides the journal's version
fence: the registry high-water is journaled *before* registering, so
re-entry can tell "my register landed" (adopt the version above the
fence) from "it never landed" (register now), and a crash loop can
never mint duplicate versions or leave a half-warmed alias flip.

Fault surface: each stage body sits behind a named fault site inside a
:class:`~spark_rapids_ml_tpu_torch.robustness.retry.RetryPolicy` —
``refit.ingest`` (ingest + the refit itself), ``refit.quality_gate``
(scoring), and ``refit.swap`` (register, warm, flip — hit 1/2/3 of the
site, so ``refit.swap=2:fatal`` kills exactly between register and
warm). The solver inside the refit stage has its own preemption story
(``checkpoint.segment``, ``robustness/checkpoint.py``).

The gate never flips on a loser: a candidate that does not beat the
incumbent on the held-out slice ends the cycle with the incumbent still
serving. After a flip, :meth:`watch` is the post-flip regression check:
a live score that drops more than ``TPUML_LIFECYCLE_REGRESS_TOL``
(relative) below the gate-time candidate score triggers the registry's
one-op ``rollback`` and reverts the controller's own incumbent pointer:
an alias move, like the forward flip, so no request is shed.
"""

from __future__ import annotations

import io
import json
import os
import pickle
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from spark_rapids_ml_tpu_torch.core.lazy_state import to_host
from spark_rapids_ml_tpu_torch.core.persistence import atomic_file_write
from spark_rapids_ml_tpu_torch.lifecycle.journal import CycleJournal
from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.robustness.faults import fault_point
from spark_rapids_ml_tpu_torch.robustness.retry import RetryPolicy, default_policy
from spark_rapids_ml_tpu_torch.utils.envknobs import env_float, env_str
from spark_rapids_ml_tpu_torch.utils.tracing import bump_counter

INCUMBENT_FILE = "incumbent.pkl"
PREV_INCUMBENT_FILE = "incumbent_prev.pkl"
LAST_FLIP_FILE = "last_flip.json"


@dataclass
class CycleOutcome:
    """What one :meth:`LifecycleController.run_cycle` did."""

    cycle: int
    action: str  # "flipped" | "rejected"
    version: Optional[int]
    candidate_score: Optional[float]
    incumbent_score: Optional[float]


def _atomic_pickle(path: str, obj: Any) -> None:
    # Port models pickle by value (their Param maps by name), so plain
    # pickle is the codec; a model's device state is written as host
    # arrays (core/lazy_state.py).
    atomic_file_write(path, pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))


def _load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.loads(f.read())


def next_cycle_id(directory: str) -> int:
    """The id a FRESH cycle in ``directory`` should use: one past the
    last finished cycle, 0 when nothing (readable) is there. An
    unfinished journal's id is irrelevant here — resume keeps its own."""
    path = os.path.join(directory, "cycle.json")
    try:
        with open(path, "rb") as f:
            data = json.loads(f.read().decode("utf-8"))
        return int(data["cycle"]) + 1
    except (OSError, ValueError, KeyError, TypeError):
        return 0


class LifecycleController:
    def __init__(
        self,
        estimator: Any,
        runtime: Any,
        name: str,
        *,
        score_fn: Callable[[Any, np.ndarray, Optional[np.ndarray]], float],
        directory: Optional[str] = None,
        alias: str = "prod",
        holdout_frac: Optional[float] = None,
        gate_margin: Optional[float] = None,
        regress_tol: Optional[float] = None,
        warm_buckets: Tuple[int, ...] = (1,),
        model: Optional[Any] = None,
        policy: Optional[RetryPolicy] = None,
    ):
        """``runtime`` is anything with the registry façade (``register``,
        ``warm``, ``set_alias``, ``rollback`` and ``registry.versions``):
        the port's :class:`~spark_rapids_ml_tpu_torch.serving.server.ServingRuntime`
        or :class:`~spark_rapids_ml_tpu_torch.serving.router.RoutingRuntime`. ``score_fn(model, X, y) -> float``, higher
        is better, drives both the gate and :meth:`watch`."""
        directory = directory or env_str("TPUML_LIFECYCLE_DIR")
        if not directory:
            raise ValueError(
                "LifecycleController needs a journal directory: pass "
                "directory= or set TPUML_LIFECYCLE_DIR"
            )
        os.makedirs(directory, exist_ok=True)
        self.estimator = estimator
        self.runtime = runtime
        self.name = name
        self.alias = alias
        self.directory = directory
        self.score_fn = score_fn
        self.holdout_frac = (
            env_float("TPUML_LIFECYCLE_HOLDOUT", 0.2, minimum=0.0)
            if holdout_frac is None else float(holdout_frac)
        )
        if not 0.0 < self.holdout_frac < 1.0:
            raise ValueError(
                f"holdout fraction must be in (0, 1), got {self.holdout_frac}"
            )
        self.gate_margin = (
            env_float("TPUML_LIFECYCLE_GATE_MARGIN", 0.0)
            if gate_margin is None else float(gate_margin)
        )
        self.regress_tol = (
            env_float("TPUML_LIFECYCLE_REGRESS_TOL", 0.1, minimum=0.0)
            if regress_tol is None else float(regress_tol)
        )
        self.warm_buckets = tuple(warm_buckets)
        self._policy = policy or default_policy()
        self._identity = {
            "name": name, "estimator": type(estimator).__name__,
        }
        # The incumbent pointer survives whole-process death alongside
        # the journal: restored here, rewritten atomically on every flip.
        self.model = model
        inc_path = os.path.join(directory, INCUMBENT_FILE)
        if self.model is None and os.path.exists(inc_path):
            self.model = _load_pickle(inc_path)

    # --- stage plumbing ---

    def _stage(
        self,
        journal: CycleJournal,
        stage: str,
        site: str,
        fn: Callable[[], Dict[str, Any]],
    ) -> Tuple[Dict[str, Any], bool]:
        """Run ``stage`` exactly once per cycle: a journaled completion
        replays its payload; otherwise the body runs behind its fault
        site under the retry policy and the result is committed before
        anything downstream can observe it. Returns (payload, replayed)."""
        if journal.done(stage):
            bump_counter("lifecycle.stage.replayed")
            return journal.payload(stage), True

        def body() -> Dict[str, Any]:
            fault_point(site)
            return fn()

        payload = self._policy.run(body, site)
        journal.mark(stage, payload)
        return payload, False

    def _path(self, journal: CycleJournal, tag: str) -> str:
        return os.path.join(self.directory, f"cycle_{journal.cycle}_{tag}")

    @staticmethod
    def _as_dataset(x: np.ndarray, y: Optional[np.ndarray]):
        return x if y is None else (x, y)

    # --- the cycle ---

    def run_cycle(
        self, x: np.ndarray, y: Optional[np.ndarray] = None
    ) -> CycleOutcome:
        """Take one batch of fresh rows through the full state machine.
        On a resumed cycle the ``x``/``y`` arguments are IGNORED in favor
        of the journaled ingest — the cycle that crashed is the cycle
        that finishes."""
        journal = CycleJournal.resume_or_start(
            self.directory, self._identity, next_cycle_id(self.directory)
        )

        # -- ingest: deterministic train/holdout split, persisted before
        # any compute touches it --
        def do_ingest() -> Dict[str, Any]:
            xs = to_host(x, np.float64)
            if xs.ndim != 2 or xs.shape[0] < 2:
                raise ValueError(
                    f"run_cycle needs a (n>=2, d) batch, got {xs.shape}"
                )
            ys = None if y is None else to_host(y, np.float64)
            rng = np.random.default_rng(journal.cycle)
            perm = rng.permutation(xs.shape[0])
            n_hold = max(1, int(round(xs.shape[0] * self.holdout_frac)))
            hold, train = perm[:n_hold], perm[n_hold:]
            if train.size == 0:
                raise ValueError(
                    f"holdout fraction {self.holdout_frac} leaves no "
                    f"training rows out of {xs.shape[0]}"
                )
            arrays = {"x_train": xs[train], "x_hold": xs[hold]}
            if ys is not None:
                arrays["y_train"] = ys[train]
                arrays["y_hold"] = ys[hold]
            buf = io.BytesIO()
            np.savez(buf, **arrays)
            path = self._path(journal, "data.npz")
            atomic_file_write(path, buf.getvalue())
            return {
                "data": path,
                "n_train": int(train.size),
                "n_holdout": int(n_hold),
                "labeled": ys is not None,
            }

        ingest, _ = self._stage(journal, "ingest", "refit.ingest", do_ingest)
        data = np.load(ingest["data"])
        x_train, x_hold = data["x_train"], data["x_hold"]
        y_train = data["y_train"] if ingest["labeled"] else None
        y_hold = data["y_hold"] if ingest["labeled"] else None

        # -- refit: the incremental fit, candidate pickled before the
        # gate ever sees it (a crash after refit must not refit twice —
        # partial_fit seeded twice is a different model) --
        def do_refit() -> Dict[str, Any]:
            candidate = self.estimator.partial_fit(
                self._as_dataset(x_train, y_train), model=self.model
            )
            path = self._path(journal, "candidate.pkl")
            _atomic_pickle(path, candidate)
            return {"model": path}

        refit, replayed = self._stage(journal, "refit", "refit.ingest", do_refit)
        candidate = _load_pickle(refit["model"])

        # -- quality gate: candidate must beat the incumbent on the
        # held-out slice or the alias never moves --
        def do_gate() -> Dict[str, Any]:
            cand = float(self.score_fn(candidate, x_hold, y_hold))
            inc = (
                float(self.score_fn(self.model, x_hold, y_hold))
                if self.model is not None else None
            )
            passed = inc is None or cand >= inc + self.gate_margin
            return {"passed": passed, "candidate": cand, "incumbent": inc}

        gate, _ = self._stage(
            journal, "quality_gate", "refit.quality_gate", do_gate
        )
        if not gate["passed"]:
            emit(
                "lifecycle", action="gate_reject", model=self.name,
                cycle=journal.cycle, candidate_score=gate["candidate"],
                incumbent_score=gate["incumbent"],
            )
            bump_counter("lifecycle.gate.rejected")
            journal.finish()
            return CycleOutcome(
                cycle=journal.cycle, action="rejected", version=None,
                candidate_score=gate["candidate"],
                incumbent_score=gate["incumbent"],
            )

        # -- register: fenced for idempotency (module docstring) --
        version = self._register(journal, candidate)

        # -- warm: every member compiles the candidate's buckets before
        # any traffic can route to it --
        def do_warm() -> Dict[str, Any]:
            self.runtime.warm(
                self.name, version=version, buckets=self.warm_buckets
            )
            return {"version": version, "buckets": list(self.warm_buckets)}

        self._stage(journal, "warm", "refit.swap", do_warm)

        # -- flip: the alias moves only after warm has compiled the
        # candidate's buckets, so no request waits on a capture (a router
        # warms every member and broadcasts before its own alias moves:
        # zero-shed) --
        def do_flip() -> Dict[str, Any]:
            self.runtime.set_alias(self.name, self.alias, version)
            return {"version": version}

        self._stage(journal, "flip", "refit.swap", do_flip)

        # Post-flip bookkeeping is local-only and idempotent: the new
        # incumbent pointer and the watch baseline, each atomic.
        inc_path = os.path.join(self.directory, INCUMBENT_FILE)
        if os.path.exists(inc_path):
            prev = os.path.join(self.directory, PREV_INCUMBENT_FILE)
            os.replace(inc_path, prev)
        _atomic_pickle(inc_path, candidate)
        atomic_file_write(
            os.path.join(self.directory, LAST_FLIP_FILE),
            json.dumps({
                "cycle": journal.cycle, "version": version,
                "score": gate["candidate"],
            }).encode("utf-8"),
        )
        self.model = candidate
        emit(
            "lifecycle", action="flipped", model=self.name,
            cycle=journal.cycle, version=version, alias=self.alias,
            candidate_score=gate["candidate"],
            incumbent_score=gate["incumbent"],
        )
        bump_counter("lifecycle.cycle.flipped")
        journal.finish()
        return CycleOutcome(
            cycle=journal.cycle, action="flipped", version=version,
            candidate_score=gate["candidate"],
            incumbent_score=gate["incumbent"],
        )

    def _register(self, journal: CycleJournal, candidate: Any) -> int:
        """The fenced register stage. Three re-entry shapes:

        - first entry: journal the registry high-water W, register,
          record the assigned version;
        - crash BETWEEN register and its journal mark: a version above W
          exists in the live registry — adopt it, register nothing;
        - whole-process death AFTER the mark (in-memory registry reborn
          empty, incumbent re-registered by the serving bootstrap): the
          journaled version is missing, so re-register and insist the
          fresh registry hands back the SAME version — anything else
          means the bootstrap diverged from the pre-crash history.
        """
        if journal.done("register"):
            v = int(journal.payload("register")["version"])
            if v in self.runtime.registry.versions(self.name):
                return v

            def re_register() -> Dict[str, Any]:
                fault_point("refit.swap")
                mv = self.runtime.register(self.name, candidate)
                if mv.version != v:
                    raise RuntimeError(
                        f"re-registration of {self.name!r} landed on "
                        f"v{mv.version}, journal says v{v}: the restart "
                        "bootstrap diverged from pre-crash registry history"
                    )
                return {"version": v}

            self._policy.run(re_register, "refit.swap")
            return v

        if journal.fence() is None:
            versions = self.runtime.registry.versions(self.name)
            journal.set_fence(max(versions) if versions else 0)
        fence = journal.fence()

        def do_register() -> Dict[str, Any]:
            fault_point("refit.swap")
            versions = self.runtime.registry.versions(self.name)
            above = [v for v in versions if v > fence]
            if above:
                # Our pre-crash register landed (this controller is the
                # model's single writer) — adopt, don't duplicate.
                bump_counter("lifecycle.register.adopted")
                return {"version": max(above), "adopted": True}
            mv = self.runtime.register(self.name, candidate)
            return {"version": int(mv.version), "adopted": False}

        payload = self._policy.run(do_register, "refit.swap")
        journal.mark("register", payload)
        return int(payload["version"])

    # --- post-flip regression watch ---

    def watch(self, live_score: float) -> Optional[int]:
        """Compare live traffic quality against the score the candidate
        earned at its gate. A relative drop beyond ``regress_tol``
        triggers the registry's one-op rollback and reverts the
        controller's incumbent pointer. Returns the version now serving
        after a rollback, None when the flip is healthy (or there is no
        flip to watch)."""
        path = os.path.join(self.directory, LAST_FLIP_FILE)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            flip = json.loads(f.read().decode("utf-8"))
        base = float(flip["score"])
        drop = base - float(live_score)
        if drop <= self.regress_tol * max(abs(base), 1e-12):
            return None
        version = self.runtime.rollback(self.name, self.alias)
        prev = os.path.join(self.directory, PREV_INCUMBENT_FILE)
        if os.path.exists(prev):
            self.model = _load_pickle(prev)
            _atomic_pickle(os.path.join(self.directory, INCUMBENT_FILE), self.model)
        emit(
            "lifecycle", action="auto_rollback", model=self.name,
            alias=self.alias, version=version, cycle=flip["cycle"],
            gate_score=base, live_score=float(live_score),
        )
        bump_counter("lifecycle.auto_rollback")
        os.remove(path)  # one rollback per flip; don't re-trigger
        return version
