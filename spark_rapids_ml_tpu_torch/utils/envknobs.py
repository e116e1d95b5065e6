"""One home for the ``TPUML_*`` environment knobs the port reads.

Port of the reference's ``utils/envknobs.py``, cut to the knobs this
package reads. A malformed value raises :class:`EnvKnobError` naming the
variable, the value and the form expected; reading a ``TPUML_*`` name
that is not in :data:`KNOBS` raises ``ValueError`` at the read site
(``TPUML_TEST_*`` harness inputs excepted), so a typo'd knob fails loudly
instead of returning its default forever. Parsing, error types and
messages are the reference's.

Knobs are read in the modules that route (models, ``core``, ``ops``
policy), never in ``ops/kernels``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple


class EnvKnobError(ValueError):
    """A ``TPUML_*`` environment variable holds a malformed value."""

    def __init__(self, name: str, value: str, expected: str):
        self.name = name
        self.value = value
        self.expected = expected
        super().__init__(
            f"environment variable {name}={value!r} is malformed: "
            f"expected {expected}"
        )


@dataclass(frozen=True)
class Knob:
    """One registered ``TPUML_*`` environment knob."""

    name: str
    kind: str  # "int" | "float" | "str" | "choice"
    subsystem: str
    meaning: str
    default: object = None
    choices: Tuple[str, ...] = field(default=())


_MODES = ("f32", "bf16x3", "bf16", "highest", "high", "default")


def _precision_knob(family: str, what: str) -> Knob:
    return Knob(f"TPUML_PRECISION_{family}", "choice", "precision",
                f"per-family precision override for {what} (outranks TPUML_PRECISION)",
                choices=_MODES)


#: Every ``TPUML_*`` knob the port reads, keyed by name.
KNOBS: Dict[str, Knob] = {k.name: k for k in (
    # distributed bring-up (parallel/distributed.py)
    Knob("TPUML_COORDINATOR", "str", "distributed",
         "coordinator host:port of the torch.distributed gang (tcp init method)"),
    Knob("TPUML_NUM_PROCESSES", "int", "distributed",
         "gang size for the distributed bring-up"),
    Knob("TPUML_PROCESS_ID", "int", "distributed",
         "this process's rank in the gang"),
    Knob("TPUML_HEARTBEAT_TIMEOUT", "int", "distributed",
         "seconds before a collective with a dead peer fails survivors"),
    # gang deploy mode (core/estimator.py)
    Knob("TPUML_GANG_FIT", "choice", "distributed",
         "1 routes Estimator.fit through gang deploy mode (each process "
         "feeds its local rows; collectives merge) — the env twin of "
         "setDeployMode('gang')", default="0", choices=("0", "1")),
    Knob("TPUML_GANG_PORT", "int", "distributed",
         "base coordinator port gang_fit derives member coordinates "
         "from (stage attempt number offsets it)", default=8476),
    # gang fit through the spark adapter (spark/adapter.py)
    Knob("TPUML_GANG_FIT_MEMBERS", "int", "distributed",
         "barrier gang members for adapter fits routed through the gang "
         "deploy switch (input coalesces to this many partitions; 1 = "
         "single-member gang, the only size a sequential local scheduler "
         "can run)", default=1),
    # fit memory budget & streaming degradation (core/membudget.py)
    Knob("TPUML_FIT_MEM_BUDGET", "int", "fit-memory",
         "fit admission budget in device bytes (unset = the fit device's "
         "free memory; 0 = gate off)"),
    Knob("TPUML_FIT_BLOCK_ROWS", "int", "fit-memory",
         "rows per block for degraded-streaming fits and the block readers",
         default=65536),
    Knob("TPUML_FIT_OOM_RETRIES", "int", "fit-memory",
         "streaming attempts after device OOM, block rows halving each",
         default=3),
    Knob("TPUML_FIT_DEGRADE", "choice", "fit-memory",
         "auto: over-budget host fits reroute to streaming; off: raise "
         "the structured budget error", default="auto", choices=("auto", "off")),
    # pipeline fusion (pipeline_fusion/fuser.py)
    Knob("TPUML_PIPELINE_FUSION", "choice", "pipeline-fusion",
         "auto = PipelineModel.transform on plain arrays runs the whole "
         "stage chain as one composite kernel on the device (stage-at-a-time "
         "when any stage is unfusable); off = always stage-at-a-time",
         default="auto", choices=("auto", "off")),
    Knob("TPUML_PIPELINE_FUSION_FIT", "choice", "pipeline-fusion",
         "auto = Pipeline.fit places plain-array datasets on device once "
         "so stages (and CV/TVS folds) chain device-resident; off = host "
         "datasets flow stage-at-a-time unmodified",
         default="auto", choices=("auto", "off")),
    # serving program cache and streaming (core/serving.py)
    Knob("TPUML_SERVING_CACHE_SIZE", "int", "serving",
         "bound on the program LRU (entries per process; on CUDA one "
         "captured graph per entry)", default=32),
    Knob("TPUML_SERVING_DONATE", "choice", "serving",
         "read and validated; no effect on CUDA (a graph's input is a "
         "static buffer already)", default="on", choices=("on", "off")),
    Knob("TPUML_SERVE_STREAM_BLOCK", "int", "serving",
         "rows per block of pinned double-buffered host-batch streaming, "
         "and the largest row bucket the program cache captures",
         default=65536),
    # online-serving runtime (serving/)
    Knob("TPUML_SERVE_MAX_BATCH", "int", "serving-runtime",
         "rows per coalesced micro-batch dispatch", default=256),
    Knob("TPUML_SERVE_MAX_DELAY_MS", "float", "serving-runtime",
         "coalescing window from the first request of a forming batch",
         default=5.0),
    Knob("TPUML_SERVE_QUEUE", "int", "serving-runtime",
         "admission queue depth bound", default=1024),
    Knob("TPUML_SERVE_MEM_BUDGET", "int", "serving-runtime",
         "device-memory admission budget in bytes (0 = gate off)",
         default=0),
    Knob("TPUML_DEGRADE", "choice", "robustness",
         "off: a failed device batch errors its requests; cpu: refused "
         "(NotImplementedError): the port does not fall back to the CPU",
         default="off", choices=("off", "cpu")),
    # fault injection and the retry policy (robustness/faults.py, retry.py)
    Knob("TPUML_FAULTS", "str", "robustness",
         "deterministic fault-injection spec (site=N[:fatal|:torn];...)"),
    Knob("TPUML_RETRY_MAX_ATTEMPTS", "int", "robustness",
         "attempts per recoverable operation", default=3),
    Knob("TPUML_RETRY_BASE_DELAY", "float", "robustness",
         "first backoff in seconds (doubles per attempt)", default=0.05),
    Knob("TPUML_RETRY_MAX_DELAY", "float", "robustness",
         "backoff cap in seconds", default=2.0),
    Knob("TPUML_RETRY_DEADLINE", "float", "robustness",
         "overall wall-clock retry budget in seconds"),
    Knob("TPUML_BARRIER_RESUBMITS", "int", "robustness",
         "driver-side whole-stage resubmissions in barrier_gang_run",
         default=1),
    # checkpoint / resume (robustness/checkpoint.py)
    Knob("TPUML_CHECKPOINT_EVERY", "int", "checkpoint",
         "solver iterations per segment (0 = monolithic)", default=0),
    Knob("TPUML_CHECKPOINT_DIR", "str", "checkpoint",
         "checkpoint root reachable by every gang member"),
    Knob("TPUML_CHECKPOINT_KEEP", "int", "checkpoint",
         "snapshots retained per fit", default=2),
    Knob("TPUML_CHECKPOINT_UMAP", "choice", "checkpoint",
         "1 opts UMAP layout SGD into the global checkpoint knobs",
         default="0", choices=("0", "1")),
    # continuous-training lifecycle (lifecycle/controller.py)
    Knob("TPUML_LIFECYCLE_DIR", "str", "lifecycle",
         "journal + candidate-model directory for the continuous-"
         "training controller; the crash-safe cycle resumes from here "
         "after a kill (unset: the controller requires an explicit "
         "journal_dir argument)"),
    Knob("TPUML_LIFECYCLE_HOLDOUT", "float", "lifecycle",
         "fraction of each ingested batch held out for the quality "
         "gate (never trained on)", default=0.2),
    Knob("TPUML_LIFECYCLE_GATE_MARGIN", "float", "lifecycle",
         "how much worse than the incumbent (in score units) the "
         "candidate may be and still flip; 0 = candidate must be at "
         "least as good", default=0.0),
    Knob("TPUML_LIFECYCLE_REGRESS_TOL", "float", "lifecycle",
         "relative post-flip live-score drop vs the gate's candidate "
         "score that triggers the automatic registry rollback",
         default=0.1),
    Knob("TPUML_LIFECYCLE_EVERY", "int", "lifecycle",
         "solver iterations per segment when partial_fit forces the "
         "segmented solver without TPUML_CHECKPOINT_* set (the warm-"
         "seed iteration counters ride the segment loop)", default=8),
    # drift triggers (lifecycle/drift.py)
    Knob("TPUML_DRIFT_THRESHOLD", "float", "drift",
         "population-stability-index threshold between the reference "
         "and live serving-score distributions above which a drift "
         "tick fires a refit", default=0.25),
    Knob("TPUML_DRIFT_MIN_COUNT", "int", "drift",
         "observations in the live window before a drift tick may "
         "fire (small windows make PSI noise, not signal)", default=50),
    # observability (observability/*)
    Knob("TPUML_EVENT_LOG", "str", "observability",
         "JSON-lines event sink: a file path or 'stderr' (unset = off)"),
    Knob("TPUML_PROFILE_DIR", "str", "observability",
         "wrap top-level fits in a torch.profiler session writing a "
         "Chrome-trace JSON file here"),
    Knob("TPUML_METRICS_DUMP", "str", "observability",
         "write a metrics snapshot at exit (.prom = Prometheus text)"),
    Knob("TPUML_GANG_HEARTBEAT_EVERY", "float", "observability",
         "seconds between gang heartbeat records (0 disables)",
         default=5.0),
    Knob("TPUML_TELEMETRY_DIR", "str", "observability",
         "per-process telemetry shards (events-<pid>.jsonl + metrics + "
         "manifest) land here; outranks TPUML_EVENT_LOG"),
    Knob("TPUML_TRACE_ID", "str", "observability",
         "trace-context carrier: the trace id a launcher injected into "
         "this process (inject_env/extract_env)"),
    Knob("TPUML_TRACE_PARENT", "str", "observability",
         "trace-context carrier: the launcher span id this process's "
         "root spans parent to"),
    # the program cost ledger (observability/costs.py)
    Knob("TPUML_COST_LEDGER", "choice", "observability",
         "1 records each program's counted work, measured memory and "
         "device-time walls (captured graphs, bypass runs, solver segments)",
         default="0", choices=("0", "1")),
    Knob("TPUML_COST_LEDGER_DUMP", "str", "observability",
         "write the cost-ledger JSON document here at interpreter exit"),
    Knob("TPUML_HBM_SAMPLE_EVERY_MS", "float", "observability",
         "HBM watermark sampler period in ms (0 = off; needs the ledger)",
         default=0.0),
    Knob("TPUML_RETRACE_STORM", "int", "observability",
         "unexpected retraces per program family before the storm warning",
         default=3),
    Knob("TPUML_PEAK_FLOPS", "float", "observability",
         "declared device peak FLOP/s for roofline utilization estimates"),
    Knob("TPUML_PEAK_BYTES_PER_SEC", "float", "observability",
         "declared device peak HBM bytes/s for roofline utilization"),
    # concurrency sanitizer (utils/lockcheck.py)
    Knob("TPUML_LOCKCHECK", "choice", "lockcheck",
         "off: plain threading primitives; warn: instrumented locks "
         "emit lockcheck events on violations; strict: violations raise",
         default="off", choices=("off", "warn", "strict")),
    Knob("TPUML_LOCKCHECK_STALL_MS", "float", "lockcheck",
         "blocking-acquire wait that triggers the stall watchdog's "
         "all-threads lockcheck event (0 = watchdog off)",
         default=30000.0),
    Knob("TPUML_LOCKCHECK_GRAPH", "str", "lockcheck",
         "write the runtime acquisition-order graph + violation log "
         "here at interpreter exit"),
    # live ops plane (observability/opsplane.py)
    Knob("TPUML_OPS_PORT", "int", "ops-plane",
         "per-process ops HTTP server port exposing /metrics /healthz "
         "/varz /tracez; 0 binds an ephemeral port published in the "
         "telemetry manifest (unset: no server)"),
    Knob("TPUML_OPS_STALL_S", "float", "ops-plane",
         "gang-heartbeat age (seconds) above which /healthz reports the "
         "process unhealthy (0 = heartbeat probe off)", default=30.0),
    # SLOs and the flight recorder (observability/slo.py, flightrec.py)
    Knob("TPUML_SLO", "str", "ops-plane",
         "declared service-level objectives, e.g. "
         "'serving.p95_ms<=50;shed.rate<=0.01;freshness.age_s<=600'; "
         "evaluated on rolling windows, published as slo.burn_rate "
         "gauges + slo events (unset: SLO layer off)"),
    Knob("TPUML_SLO_EVERY_MS", "float", "ops-plane",
         "milliseconds between background SLO evaluation ticks when "
         "the monitor thread is started", default=1000.0),
    Knob("TPUML_FLIGHT", "int", "ops-plane",
         "flight-recorder ring size: keep the last N event records in "
         "memory (even with no event sink configured) and dump them as "
         "flight-<pid>.json on fatal exception, SIGTERM, or a lockcheck "
         "stall strike (0 = recorder off)", default=0),
    Knob("TPUML_FLIGHT_DIR", "str", "ops-plane",
         "directory for flight-recorder dumps (default: the active "
         "TPUML_TELEMETRY_DIR, else the process working directory)"),
    # ledger-driven autotuner (observability/autotune.py)
    Knob("TPUML_AUTOTUNE", "choice", "autotune",
         "on = measured-cost models drive block rows, the serving "
         "bucket ladder, the batcher deadline, admission pricing and the "
         "precision gate (implies the cost ledger); off = every static "
         "heuristic unchanged bit-for-bit",
         default="off", choices=("off", "on")),
    Knob("TPUML_TUNE_STORE", "str", "autotune",
         "persistent JSON of accepted autotune decisions (atomic "
         "writes; corrupt files fall back to an empty store)"),
    Knob("TPUML_AUTOTUNE_HOT_MIN", "int", "autotune",
         "sightings of one exact batch size before the serving ladder "
         "admits it as an exact-fit bucket", default=16),
    # mixed-precision policy (ops/precision.py)
    Knob("TPUML_PRECISION", "choice", "precision",
         "global GEMM precision mode for every policy-aware op family",
         choices=_MODES),
    _precision_knob("COVARIANCE", "the covariance GEMMs"),
    _precision_knob("PCA", "the PCA covariance and sketch GEMMs"),
    _precision_knob("KMEANS", "the KMeans distance/stats GEMMs and kernels"),
    _precision_knob("LOGISTIC", "the logistic X-sweeps"),
    _precision_knob("LINEAR", "the linear-model statistics GEMMs"),
    _precision_knob("SERVING", "the predict/transform GEMMs"),
    # kernel route selection (read in the models)
    Knob("TPUML_UMAP_SCATTER", "choice", "kernels",
         "UMAP tail scatter: pallas = kernel K4 over the tail-sorted edges; "
         "xla = index_add_; auto = K4 on a CUDA layout",
         default="auto", choices=("auto", "pallas", "xla")),
    Knob("TPUML_LOGISTIC_FUSED", "choice", "kernels",
         "1 = fused one-sweep logistic loss+grad; 0 = two-sweep autograd "
         "objective (applies when LogisticRegression(fused=...) is not given)",
         default="1", choices=("0", "1")),
    # distributed serving tier (serving/router.py + serving/worker.py)
    Knob("TPUML_ROUTER_WORKERS", "int", "serving-router",
         "member processes a RoutingRuntime launches", default=2),
    Knob("TPUML_ROUTER_RENDEZVOUS", "str", "serving-router",
         "rendezvous directory of member-<id>.json contact cards "
         "(set by the router for spawned members)", default=None),
    Knob("TPUML_ROUTER_MEMBER", "int", "serving-router",
         "this process's member index in the serving gang "
         "(set by the router for spawned members)", default=None),
    Knob("TPUML_ROUTER_CONNECT_TIMEOUT", "float", "serving-router",
         "seconds the router waits for member rendezvous/acks and a "
         "member waits for the router connection", default=120.0),
    Knob("TPUML_ROUTER_SHARD_ROWS", "int", "serving-router",
         "requests with at least this many rows bypass members for the "
         "router's sharded path (0 = budget-driven only)",
         default=0),
    # elastic gang scaler (serving/elastic.py + router liveness)
    Knob("TPUML_ELASTIC_MIN", "int", "serving-elastic",
         "lower bound on live serving members the scaler may retire "
         "down to", default=1),
    Knob("TPUML_ELASTIC_MAX", "int", "serving-elastic",
         "upper bound on live serving members the scaler may join up "
         "to", default=4),
    Knob("TPUML_ELASTIC_EVERY_MS", "float", "serving-elastic",
         "milliseconds between scaler ticks (signal sample + decision)",
         default=200.0),
    Knob("TPUML_ELASTIC_HIGH", "float", "serving-elastic",
         "mean per-member depth (outstanding + reported queue) above "
         "which a tick votes scale-UP", default=4.0),
    Knob("TPUML_ELASTIC_LOW", "float", "serving-elastic",
         "mean per-member depth below which a tick votes scale-DOWN",
         default=0.5),
    Knob("TPUML_ELASTIC_HYSTERESIS", "int", "serving-elastic",
         "consecutive agreeing ticks before a scale decision executes",
         default=3),
    Knob("TPUML_ELASTIC_COOLDOWN_MS", "float", "serving-elastic",
         "milliseconds after a join/retire during which the scaler only "
         "observes", default=1000.0),
    Knob("TPUML_ELASTIC_STALL_S", "float", "serving-elastic",
         "reported member heartbeat age above which the member is "
         "force-retired as stalled (0 = stall retire off)", default=0.0),
)}

def _require_registered(name: str) -> None:
    """Accessors refuse unregistered ``TPUML_*`` names (``TPUML_TEST_*``
    harness inputs are exempt)."""
    if name.startswith("TPUML_") and not name.startswith("TPUML_TEST_") and name not in KNOBS:
        raise ValueError(
            f"environment knob {name!r} is not registered in "
            "spark_rapids_ml_tpu_torch.utils.envknobs.KNOBS — add a Knob "
            "entry before reading it"
        )


def env_int(name: str, default: Optional[int] = None, minimum: Optional[int] = None) -> Optional[int]:
    """``int(os.environ[name])`` with a named, actionable error."""
    _require_registered(name)
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = int(raw.strip())
    except ValueError:
        raise EnvKnobError(name, raw, "an integer (e.g. 100)") from None
    if minimum is not None and value < minimum:
        raise EnvKnobError(name, raw, f"an integer >= {minimum}")
    return value


def env_float(name: str, default: Optional[float] = None, minimum: Optional[float] = None) -> Optional[float]:
    """``float(os.environ[name])`` with a named, actionable error."""
    _require_registered(name)
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        value = float(raw.strip())
    except ValueError:
        raise EnvKnobError(name, raw, "a number (e.g. 0.5)") from None
    if minimum is not None and value < minimum:
        raise EnvKnobError(name, raw, f"a number >= {minimum}")
    return value


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """A free-form string knob; an empty value reads as unset."""
    _require_registered(name)
    raw = os.environ.get(name)
    if raw is None:
        return default
    value = raw.strip()
    return value if value else default


def env_choice(name: str, choices: Sequence[str], default: str) -> str:
    """A string knob restricted to an explicit vocabulary."""
    _require_registered(name)
    raw = os.environ.get(name)
    if raw is None:
        return default
    value = raw.strip().lower()
    if value not in choices:
        raise EnvKnobError(name, raw, f"one of {'|'.join(choices)}")
    return value
