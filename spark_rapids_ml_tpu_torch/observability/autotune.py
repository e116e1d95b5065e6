"""Ledger-driven autotuner — port of the reference's
``observability/autotune.py``: measured cost models replace static
guesses.

* :class:`FamilyModel` / :func:`fit_cost_models` — per program family a
  linear model fitted from the live ledger entries: ``wall(rows) = a·rows
  + b`` from per-invocation wall (compile seconds excluded; on the card
  the ledger's wall is device time from CUDA events, so the model prices
  the program, not its enqueue) and ``bytes(rows) = a·rows + b`` from the
  argument + temp + output bytes, with ``bytes_accessed`` as the fallback
  where no memory field is known.
* :class:`TuneStore` — a persistent JSON of *accepted* decisions keyed
  shard-stably like the ledger (knob name + family/width strings),
  written atomically; a corrupt file reads as an empty store (counter
  ``autotune.store.corrupt``). Its file is the reference's format: either
  package loads the other's.
* :class:`Autotuner` — the measure-and-commit loop (a regression is never
  accepted), the learned per-(model, width) serving bucket ladder, and
  the p95 wall samples behind the batcher's window.

Behind ``TPUML_AUTOTUNE=off|on`` with the ledger's one-``None``-check
discipline: off is today's behaviour bit for bit, and a tuner holding no
evidence decides what the static heuristics decide.

The decision points that consult it when on:

(a) streaming block rows — ``core.data.fit_block_rows`` and
    ``ops.kmeans._auto_block_rows`` size blocks from measured headroom,
    capped by blocks the ledger proved fatal (:meth:`Autotuner.note_oom`,
    from ``core.membudget``'s streaming recovery, which also measures and
    commits the block it ran);
(b) the serving bucket ladder — hot batch sizes earn exact-fit rungs
    (``core.serving.ladder_bucket_rows``); a commit drops the cached
    programs it leaves unreachable through the cache's own drop path, so
    no graph is closed under a replay that holds it;
(c) the MicroBatcher's coalescing window from the measured p95 wall
    (``serving/batcher.MicroBatcher._delay_s_for``);
(d) ``core.membudget.fit_memory_guard`` prices admission through the
    fitted bytes model;
(e) the precision gate ``ops.precision.tune_precision``;
(f) the router's shard threshold, :meth:`Autotuner.recommend_shard_rows`
    (``serving/router.RoutingRuntime._is_oversized``), and the elastic
    scaler's latency budget from :meth:`Autotuner.recommend_delay_s`.

This module imports :mod:`observability.costs`; costs does not import
this module, so the two hooks it needs there (the row-bucket probe of the
retrace watchdog and the invocation observer feeding wall samples) are
installed by :func:`configure`.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from spark_rapids_ml_tpu_torch.observability import costs as _costs
from spark_rapids_ml_tpu_torch.observability.events import emit
from spark_rapids_ml_tpu_torch.observability.metrics import default_registry
from spark_rapids_ml_tpu_torch.utils.envknobs import env_choice, env_int, env_str
from spark_rapids_ml_tpu_torch.utils.lockcheck import make_lock

def bump_counter(name: str, amount: int = 1) -> None:
    """``utils.tracing.bump_counter`` (which imports this package)."""
    default_registry.counter(name).inc(amount)


AUTOTUNE_ENV = "TPUML_AUTOTUNE"
TUNE_STORE_ENV = "TPUML_TUNE_STORE"
HOT_MIN_ENV = "TPUML_AUTOTUNE_HOT_MIN"

#: Observations of one exact batch size before the ladder admits it.
DEFAULT_HOT_MIN = 16
#: Exact-fit rungs per (model, width) — bounds compile count.
MAX_LADDER_RUNGS = 8
#: Tuned block sizes stay multiples of this (mirrors
#: ``membudget.MIN_BLOCK_ROWS`` — not imported: membudget consults us).
MIN_TUNED_BLOCK_ROWS = 256
MAX_TUNED_BLOCK_ROWS = 1 << 22
#: Fraction of measured headroom a tuned block may claim — the rest
#: absorbs accumulators, partial-reduction temps and allocator slack.
HEADROOM_SAFETY = 0.8
#: Width-only bytes fallback: input block + padded copy + temp slack.
INPUT_COPIES = 3
#: Wall samples kept per family for p95 estimates.
WALL_SAMPLES = 512

STORE_VERSION = 1


# --- the cost model -----------------------------------------------------


@dataclass
class FamilyModel:
    """Linear measured-cost model for one program family.

    ``wall_a/wall_b``: compile-amortized seconds = a·rows + b, from
    per-invocation wall. ``bytes_a/bytes_b``: per-execution bytes =
    a·rows + b, from the ledger's memory fields. A coefficient pair is
    ``None`` when the ledger had no usable points for that dimension.
    """

    family: str
    wall_a: Optional[float] = None
    wall_b: Optional[float] = None
    bytes_a: Optional[float] = None
    bytes_b: Optional[float] = None
    points: int = 0
    evidence: List[str] = field(default_factory=list)

    def predict_wall(self, rows: int) -> Optional[float]:
        if self.wall_a is None:
            return None
        return max(self.wall_a * rows + (self.wall_b or 0.0), 0.0)

    def predict_bytes(self, rows: int) -> Optional[int]:
        if self.bytes_a is None:
            return None
        return max(int(self.bytes_a * rows + (self.bytes_b or 0.0)), 0)

    def as_dict(self) -> dict:
        return {
            "family": self.family,
            "wall_a": self.wall_a,
            "wall_b": self.wall_b,
            "bytes_a": self.bytes_a,
            "bytes_b": self.bytes_b,
            "points": self.points,
            "evidence": list(self.evidence),
        }


def _linfit(pts: List[Tuple[int, float]]) -> Tuple[Optional[float], Optional[float]]:
    """Least-squares ``y = a·x + b`` over (rows, value) points; duplicate
    row counts average first so a hot bucket doesn't dominate the fit.
    One distinct x degrades to ``a = y/x, b = 0``. Both coefficients
    clamp at 0 (negative slope/intercept means noise, not cost)."""
    if not pts:
        return None, None
    agg: Dict[int, List[float]] = {}
    for r, v in pts:
        agg.setdefault(int(r), []).append(float(v))
    xs = sorted(agg)
    ys = [sum(agg[x]) / len(agg[x]) for x in xs]
    if len(xs) == 1:
        x, y = xs[0], ys[0]
        return (y / x if x else 0.0), 0.0
    xm = sum(xs) / len(xs)
    ym = sum(ys) / len(ys)
    var = sum((x - xm) ** 2 for x in xs)
    if var <= 0.0:
        return None, None
    a = sum((x - xm) * (y - ym) for x, y in zip(xs, ys)) / var
    b = ym - a * xm
    return max(a, 0.0), max(b, 0.0)


def fit_cost_models(entries: Iterable[Any]) -> Dict[str, FamilyModel]:
    """Fit one :class:`FamilyModel` per program family from ledger
    entries (:class:`costs.ProgramCost` or anything with the same
    fields). Entries without a row count contribute nothing; wall points
    need at least one invocation (compile time never pollutes the
    slope); bytes points prefer the memory analysis over the
    cost-analysis ``bytes_accessed`` traffic estimate."""
    by_fam: Dict[str, List[tuple]] = {}
    for e in entries:
        rows = getattr(e, "rows", None)
        if not rows or rows <= 0:
            continue
        wall = None
        if getattr(e, "invocations", 0) and getattr(e, "wall_seconds", 0.0) > 0:
            wall = e.wall_seconds / e.invocations
        mem = None
        fields = (
            getattr(e, "argument_bytes", None),
            getattr(e, "temp_bytes", None),
            getattr(e, "output_bytes", None),
        )
        if any(f is not None for f in fields):
            mem = sum(f or 0 for f in fields)
        elif getattr(e, "bytes_accessed", None) is not None:
            mem = e.bytes_accessed
        by_fam.setdefault(e.family, []).append((int(rows), wall, mem, e.key))
    models: Dict[str, FamilyModel] = {}
    for fam, pts in by_fam.items():
        wall_a, wall_b = _linfit([(r, w) for r, w, _, _ in pts if w is not None])
        bytes_a, bytes_b = _linfit([(r, m) for r, _, m, _ in pts if m is not None])
        if wall_a is None and bytes_a is None:
            continue
        models[fam] = FamilyModel(
            family=fam,
            wall_a=wall_a,
            wall_b=wall_b,
            bytes_a=bytes_a,
            bytes_b=bytes_b,
            points=len(pts),
            evidence=[k for _, _, _, k in pts],
        )
    return models


def _p95(vals: List[float]) -> float:
    s = sorted(vals)
    return s[min(len(s) - 1, int(round(0.95 * (len(s) - 1))))]


# --- the persistent decision store --------------------------------------


def store_key(knob: str, ident: str) -> str:
    """Stable store key: knob name + identity strings only (family,
    width, dtype — never process-local ids), same discipline as
    ``costs.ledger_key`` so shards agree on what they tuned."""
    return f"{knob}|{ident}"


class TuneStore:
    """Persistent JSON of accepted autotune decisions.

    ``path=None`` keeps the store in memory (tuning still works, it just
    doesn't survive the process). Writes are atomic (tmp + ``os.replace``);
    a corrupt file counts ``autotune.store.corrupt`` and falls back to an
    empty store rather than failing the run."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.corrupt = False
        self._lock = make_lock("autotune.store")
        self._decisions: Dict[str, dict] = {}  # guarded-by: _lock
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    doc = json.load(f)
                decisions = doc.get("decisions")
                if not isinstance(decisions, dict):
                    raise ValueError("decisions missing")
                self._decisions = {str(k): dict(v) for k, v in decisions.items()}
            except (OSError, ValueError, TypeError, AttributeError):
                self.corrupt = True
                self._decisions = {}
                bump_counter("autotune.store.corrupt")

    def get(self, knob: str, ident: str) -> Optional[dict]:
        with self._lock:
            dec = self._decisions.get(store_key(knob, ident))
            return dict(dec) if dec is not None else None

    def put(self, decision: dict) -> None:
        key = store_key(decision["knob"], decision["key"])
        with self._lock:
            self._decisions[key] = dict(decision)
            self._save_locked()

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(d) for d in self._decisions.values()]

    def _save_locked(self) -> None:
        if not self.path:
            return
        doc = {
            "version": STORE_VERSION,
            "ts": time.time(),
            "decisions": self._decisions,
        }
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass


# --- the tuner ----------------------------------------------------------


class Autotuner:
    """Measured-cost decisions over the live ledger + tune store."""

    def __init__(self, store: TuneStore, hot_min: int = DEFAULT_HOT_MIN):
        self.store = store
        self.hot_min = int(hot_min)
        self._lock = make_lock("autotune.tuner")
        # guarded-by: _lock
        self._batch_counts: Dict[tuple, Dict[int, int]] = {}
        self._ladders: Dict[tuple, tuple] = {}  # guarded-by: _lock
        self._ladder_sizes: set = set()  # guarded-by: _lock
        self._walls: Dict[str, deque] = {}  # guarded-by: _lock
        self._oom_ceiling: Dict[str, int] = {}  # guarded-by: _lock
        self._models: Dict[str, FamilyModel] = {}  # guarded-by: _lock
        self._models_stamp: Optional[tuple] = None  # guarded-by: _lock
        for dec in store.snapshot():
            if dec.get("knob") == "serving_ladder":
                fam, _, w = str(dec.get("key", "")).rpartition("|")
                try:
                    rungs = tuple(sorted(int(v) for v in dec.get("value") or ()))
                    width = int(w)
                except (TypeError, ValueError):
                    continue
                self._ladders[(fam, width)] = rungs
                self._ladder_sizes.update(rungs)
            elif dec.get("knob") == "fit_oom_ceiling":
                try:
                    self._oom_ceiling[str(dec["key"])] = int(dec["value"])
                except (KeyError, TypeError, ValueError):
                    continue

    # --- ledger feeds (installed as costs hooks) -----------------------

    def observe_wall(self, family: str, rows: int, seconds: float) -> None:
        """Invocation observer (``costs.set_invocation_observer``): keeps
        a bounded reservoir of (rows, seconds) per family — the ledger
        entry itself only holds cumulative wall, not a distribution."""
        with self._lock:
            dq = self._walls.get(family)
            if dq is None:
                dq = self._walls[family] = deque(maxlen=WALL_SAMPLES)
            dq.append((int(rows), float(seconds)))

    def is_ladder_bucket(self, rows: int) -> bool:
        """Row-bucket probe (``costs.set_row_bucket_probe``): learned
        exact-fit buckets are legitimate compiles, not retraces."""
        with self._lock:
            return rows in self._ladder_sizes

    # --- the fitted models ---------------------------------------------

    def models(self) -> Dict[str, FamilyModel]:
        """Current per-family cost models, refitted when the ledger has
        new entries or invocations since the last fit."""
        led = _costs.active()
        if led is None:
            with self._lock:
                return dict(self._models)
        entries = led.entries()
        stamp = (len(entries), sum(e.invocations for e in entries))
        with self._lock:
            if stamp != self._models_stamp:
                self._models = fit_cost_models(entries)
                self._models_stamp = stamp
            return dict(self._models)

    def model_for(self, family: str) -> Optional[FamilyModel]:
        """Best model for a family name: exact match, else the
        most-evidenced model whose family name contains (or is contained
        by) the query — fit drivers say ``kmeans`` while ledger families
        read ``kmeans.lloyd.segment``."""
        models = self.models()
        if family in models:
            return models[family]
        hits = [
            m for fam, m in models.items()
            if family and (fam.startswith(family) or family in fam)
        ]
        if not hits:
            return None
        return max(hits, key=lambda m: m.points)

    def hbm_headroom(self) -> Optional[int]:
        """Measured HBM headroom in bytes: the fit memory budget (live
        free HBM unless ``TPUML_FIT_MEM_BUDGET`` pins it) minus the
        in-use churn the watermark sampler observed recently — a block
        sized to headroom that ignores sampler-seen spikes OOMs on the
        next spike. ``None`` when the backend reports no memory stats."""
        from spark_rapids_ml_tpu_torch.core.membudget import fit_mem_budget

        budget = fit_mem_budget()
        if not budget:
            return None
        samp = _costs.sampler()
        if samp is not None and samp.samples:
            recent = [s[1] for s in list(samp.samples)[-32:]]
            budget -= max(0, max(recent) - min(recent))
        return max(int(budget), 0)

    # --- decision (a): streaming block rows ----------------------------

    def recommend_block_rows(
        self,
        family: str,
        *,
        default: int,
        width: Optional[int] = None,
        itemsize: int = 4,
    ) -> int:
        """The largest block fitting measured HBM headroom for
        ``family``: a committed tune-store decision wins; else the
        fitted bytes-per-row model prices candidate blocks; else a
        width×itemsize estimate; else ``default``. Always capped by the
        family's OOM ceiling — a block size the ledger proved fatal is
        never proposed again (halving only on ledgered evidence)."""
        dec = self.store.get("fit_block_rows", family)
        if dec is not None:
            try:
                return self._clamp_block(int(dec["value"]), family)
            except (KeyError, TypeError, ValueError):
                pass
        headroom = self.hbm_headroom()
        if not headroom:
            return self._clamp_block(default, family, floor=1)
        model = self.model_for(family)
        usable = headroom * HEADROOM_SAFETY
        if model is not None and model.bytes_a:
            block = int(usable / model.bytes_a)
        elif width:
            block = int(usable / (width * itemsize * INPUT_COPIES))
        else:
            return self._clamp_block(default, family, floor=1)
        return self._clamp_block(block, family)

    def _clamp_block(self, block: int, family: str, floor: int = MIN_TUNED_BLOCK_ROWS) -> int:
        with self._lock:
            cap = self._oom_ceiling.get(family)
        if cap is not None:
            block = min(block, cap)
        block = max(floor, min(block, MAX_TUNED_BLOCK_ROWS))
        if block >= MIN_TUNED_BLOCK_ROWS:
            block = (block // MIN_TUNED_BLOCK_ROWS) * MIN_TUNED_BLOCK_ROWS
        return block

    def recommend_kmeans_block_rows(
        self, n: int, k: int, data_shards: int
    ) -> Optional[int]:
        """KMeans distance-block sizing from measured headroom instead of
        the static 9 GB guess: unblocked when the f32 distance matrix
        fits, else the largest row block whose ``block×k`` slab fits.
        ``None`` (no memory stats) falls back to the static heuristic."""
        headroom = self.hbm_headroom()
        if not headroom:
            return None
        usable = headroom * HEADROOM_SAFETY
        if 4 * int(n) * int(k) // max(int(data_shards), 1) <= usable:
            return int(n) + 1
        block = int(usable // (4 * max(int(k), 1)))
        return max(8, (block // 8) * 8)

    def note_oom(self, family: str, block_rows: int) -> None:
        """Ledgered evidence that ``block_rows`` OOMed for ``family``:
        future recommendations stay strictly below it."""
        ceiling = max(MIN_TUNED_BLOCK_ROWS, int(block_rows) // 2)
        with self._lock:
            prev = self._oom_ceiling.get(family)
            if prev is not None and prev <= ceiling:
                return
            self._oom_ceiling[family] = ceiling
        self.store.put({
            "knob": "fit_oom_ceiling",
            "key": family,
            "value": ceiling,
            "metric": None,
            "metric_name": "oom_block_rows",
            "evidence": [f"oom@{int(block_rows)}"],
            "rejected": [],
            "trials": 1,
            "updated": time.time(),
        })
        emit("autotune", action="oom_ceiling", family=family, ceiling=ceiling)

    # --- decision (b): the serving bucket ladder -----------------------

    def _pick_locked(self, ladder: tuple, n: int, default_bucket: int) -> int:
        best = default_bucket
        for s in ladder:
            if n <= s < best:
                best = s
        return best

    def peek_serving_bucket(
        self, family: str, width: int, n: int, default_bucket: int
    ) -> int:
        """Ladder-aware bucket WITHOUT observing traffic — admission
        pricing must agree with the execution bucket without double
        counting the request."""
        with self._lock:
            ladder = self._ladders.get((str(family), int(width)), ())
            return self._pick_locked(ladder, n, default_bucket)

    def serving_bucket(
        self, family: str, width: int, n: int, default_bucket: int
    ) -> int:
        """Observe one request of ``n`` rows for (family, width) and
        return its bucket. Exact sizes the traffic histogram proves hot
        (``hot_min`` sightings while still paying padding) are admitted
        as exact-fit rungs — including sizes below the pow-2 ladder's
        8-row minimum — and the cached programs the new ladder leaves
        unreachable are dropped."""
        fam_key = (str(family), int(width))
        grown = None
        with self._lock:
            counts = self._batch_counts.setdefault(fam_key, {})
            counts[n] = counts.get(n, 0) + 1
            ladder = self._ladders.get(fam_key, ())
            pick = self._pick_locked(ladder, n, default_bucket)
            if (
                pick != n
                and counts[n] >= self.hot_min
                and n not in ladder
                and len(ladder) < MAX_LADDER_RUNGS
            ):
                ladder = tuple(sorted(ladder + (n,)))
                self._ladders[fam_key] = ladder
                self._ladder_sizes.add(n)
                grown = ladder
                pick = n
        if grown is not None:
            self._commit_ladder(family, width, grown, n)
        return pick

    def _commit_ladder(
        self, family: str, width: int, ladder: tuple, admitted: int
    ) -> None:
        # Outside self._lock: the store has its own lock, and the drop
        # takes the serving layer's.
        self.store.put({
            "knob": "serving_ladder",
            "key": f"{family}|{int(width)}",
            "value": [int(v) for v in ladder],
            "metric": None,
            "metric_name": "exact_fit_rungs",
            "evidence": [f"hot@{int(admitted)}x{self.hot_min}"],
            "rejected": [],
            "trials": len(ladder),
            "updated": time.time(),
        })
        bump_counter("autotune.ladder.grow")
        emit(
            "autotune", action="ladder_grow", family=str(family),
            width=int(width), admitted=int(admitted),
            ladder=[int(v) for v in ladder],
        )
        from spark_rapids_ml_tpu_torch.core.serving import drop_shadowed_programs

        drop_shadowed_programs(str(family), int(width), ladder, int(admitted))

    # --- decision (c): deadline + shard threshold ----------------------

    def _wall_samples(self, family: str) -> List[Tuple[int, float]]:
        with self._lock:
            out: List[Tuple[int, float]] = []
            for fam, dq in self._walls.items():
                if fam == family or fam.startswith(family) or family in fam:
                    out.extend(dq)
            return out

    def recommend_delay_s(self, family: str, default_s: float) -> float:
        """MicroBatcher coalescing deadline ≈ the measured p95 program
        wall of the target (largest observed) bucket — a batch should
        wait about the time it saves. Falls back to the static default
        until the family has enough samples."""
        samples = self._wall_samples(family)
        if len(samples) < 8:
            return default_s
        target = max(r for r, _ in samples)
        at_target = [s for r, s in samples if r == target]
        walls = at_target if len(at_target) >= 4 else [s for _, s in samples]
        p95 = _p95(walls)
        return min(max(p95, 0.0), max(default_s * 10.0, 0.25))

    def recommend_shard_rows(self, family: str) -> Optional[int]:
        """Router shard threshold from the fitted wall model: shard a
        request once its predicted wall exceeds 4× the p95 wall of the
        target bucket (it would monopolize a member for several batch
        windows). ``None`` until the model and samples exist."""
        model = self.model_for(family)
        if model is None or not model.wall_a:
            return None
        samples = self._wall_samples(family)
        if len(samples) < 8:
            return None
        target_rows = max(r for r, _ in samples)
        target_wall = _p95([s for _, s in samples])
        rows = int((4.0 * target_wall - (model.wall_b or 0.0)) / model.wall_a)
        rows = max(rows, 2 * target_rows)
        bucket = 1
        while bucket < rows:
            bucket <<= 1
        return bucket

    # --- decision (d): admission pricing -------------------------------

    def price_input_bytes(self, family: str, rows: int) -> Optional[int]:
        """Per-fit device bytes for ``rows`` via the fitted bytes model —
        ``fit_memory_guard`` uses this instead of re-deriving padding
        arithmetic. ``None`` when no family model has byte points."""
        model = self.model_for(family)
        if model is None:
            return None
        return model.predict_bytes(int(rows))

    # --- the measure-and-commit loop -----------------------------------

    def record_trial(
        self,
        knob: str,
        key: str,
        value: Any,
        metric: float,
        *,
        evidence: Iterable[str] = (),
        metric_name: str = "seconds_per_row",
        ok: bool = True,
        reason: str = "regression",
    ) -> bool:
        """Commit-or-revert: commit ``value`` as the incumbent for
        (knob, key) iff its measured ``metric`` (lower is better) beats
        the incumbent's; otherwise keep the incumbent and record the
        rejected candidate. A regression is never accepted. A caller
        that already knows the candidate is disqualified (``ok=False``
        — e.g. the precision gate's parity probe missed its bound)
        records it rejected with ``reason`` no matter how fast it ran.
        """
        metric = float(metric)
        inc = self.store.get(knob, key)
        if not ok:
            if inc is None:
                # Nothing to stand against yet: persist a placeholder so
                # the rejection (and its reason) is still on the record.
                inc = {
                    "knob": knob, "key": key, "value": None,
                    "metric": None, "metric_name": metric_name,
                    "evidence": [], "rejected": [], "trials": 0,
                }
            inc.setdefault("rejected", []).append({
                "value": value,
                "metric": metric,
                "reason": reason,
            })
            inc["trials"] = int(inc.get("trials", 0)) + 1
            inc["updated"] = time.time()
            self.store.put(inc)
            bump_counter("autotune.revert")
            emit(
                "autotune", action="revert", knob=knob, key=key,
                value=value, metric=metric, incumbent=inc.get("value"),
                reason=reason,
            )
            return False
        if inc is not None and inc.get("value") == value:
            # Re-measurement of the incumbent: keep its best evidence.
            if metric < float(inc.get("metric") or float("inf")):
                inc["metric"] = metric
                inc["evidence"] = list(evidence) or inc.get("evidence", [])
            inc["trials"] = int(inc.get("trials", 0)) + 1
            inc["updated"] = time.time()
            self.store.put(inc)
            return True
        if inc is None or metric < float(inc.get("metric") or float("inf")):
            rejected = list(inc.get("rejected", [])) if inc else []
            if inc is not None:
                rejected.append({
                    "value": inc.get("value"),
                    "metric": inc.get("metric"),
                    "reason": "superseded",
                })
            self.store.put({
                "knob": knob,
                "key": key,
                "value": value,
                "metric": metric,
                "metric_name": metric_name,
                "evidence": list(evidence),
                "rejected": rejected,
                "trials": (int(inc.get("trials", 0)) + 1) if inc else 1,
                "updated": time.time(),
            })
            bump_counter("autotune.commit")
            emit(
                "autotune", action="commit", knob=knob, key=key,
                value=value, metric=metric,
            )
            return True
        inc.setdefault("rejected", []).append({
            "value": value,
            "metric": metric,
            "reason": "regression",
        })
        inc["trials"] = int(inc.get("trials", 0)) + 1
        inc["updated"] = time.time()
        self.store.put(inc)
        bump_counter("autotune.revert")
        emit(
            "autotune", action="revert", knob=knob, key=key,
            value=value, metric=metric, incumbent=inc.get("value"),
        )
        return False

    def measure_and_commit(
        self,
        knob: str,
        key: str,
        value: Any,
        run: Callable[[], Any],
        *,
        rows: Optional[int] = None,
    ) -> Tuple[Any, float, bool]:
        """Run one candidate under the ledger and commit-or-revert it.

        ``run`` executes the workload with ``value`` already applied by
        the caller. The metric is HOST wall per row, the reference's: the
        whole trial (copies, host work and waits included) is what a block
        size trades, where the ledger's per-program walls see only the
        programs. The ledger delta backs the decision: the evidence list
        records the program keys that moved during the trial. Returns
        ``(result, metric, committed)``."""
        led = _costs.active()
        base = led.invocation_snapshot() if led is not None else None
        t0 = time.perf_counter()
        result = run()
        host_wall = time.perf_counter() - t0
        evidence: List[str] = []
        if base is not None:
            evidence = [r["key"] for r in _costs.run_delta(base)]
        metric = host_wall / max(int(rows or 0), 1)
        committed = self.record_trial(
            knob, key, value, metric, evidence=evidence,
        )
        return result, metric, committed

    # --- introspection -------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            ladders = {
                f"{fam}|{w}": list(rungs)
                for (fam, w), rungs in self._ladders.items()
            }
            oom = dict(self._oom_ceiling)
            wall_families = {f: len(dq) for f, dq in self._walls.items()}
        return {
            "enabled": True,
            "hot_min": self.hot_min,
            "store_path": self.store.path,
            "store_corrupt": self.store.corrupt,
            "decisions": self.store.snapshot(),
            "ladders": ladders,
            "oom_ceilings": oom,
            "wall_samples": wall_families,
            "models": {f: m.as_dict() for f, m in self.models().items()},
        }


# --- module state (one None check when off, like the ledger) ------------

_TUNER: Optional[Autotuner] = None  # None = off: active() is one read
_config_lock = make_lock("autotune.config")


def active() -> Optional[Autotuner]:
    return _TUNER


def configure(enable: Optional[bool] = None) -> Optional[Autotuner]:
    """(Re)configure from ``TPUML_AUTOTUNE`` (or force with ``enable``).
    Turning the tuner on arms the cost ledger — the tuner is
    ledger-driven, there is nothing to measure without it — and installs
    the two costs hooks; turning it off removes both hooks."""
    global _TUNER
    with _config_lock:
        if enable is None:
            enable = env_choice(AUTOTUNE_ENV, ("off", "on"), "off") == "on"
        if enable:
            if _TUNER is None:
                _costs.configure(enable=True)
                store_path = env_str(TUNE_STORE_ENV)
                proc = env_str("TPUML_PROCESS_ID")
                if store_path and proc not in (None, "", "0"):
                    # Gang members each persist to their OWN store file:
                    # N processes committing through one path would race
                    # the whole-file atomic rewrite (each process loads
                    # decisions once at start, so the last writer drops
                    # its peers' commits). Member 0 keeps the bare path —
                    # the file tooling reads by default — and peers
                    # suffix their rank.
                    store_path = f"{store_path}.p{proc}"
                store = TuneStore(store_path)
                _TUNER = Autotuner(
                    store,
                    hot_min=env_int(HOT_MIN_ENV, DEFAULT_HOT_MIN, minimum=1),
                )
                _costs.set_invocation_observer(_TUNER.observe_wall)
                _costs.set_row_bucket_probe(_TUNER.is_ladder_bucket)
        else:
            if _TUNER is not None:
                _costs.set_invocation_observer(None)
                _costs.set_row_bucket_probe(None)
            _TUNER = None
        return _TUNER


def reset_for_tests() -> None:
    """Drop the tuner (hooks included) and re-read the environment."""
    global _TUNER
    with _config_lock:
        if _TUNER is not None:
            _costs.set_invocation_observer(None)
            _costs.set_row_bucket_probe(None)
        _TUNER = None
    configure()


def tuner_snapshot() -> Optional[dict]:
    """The report hook: ``None`` when off (the report omits the
    section), else :meth:`Autotuner.snapshot`."""
    tuner = _TUNER
    return tuner.snapshot() if tuner is not None else None


configure()
