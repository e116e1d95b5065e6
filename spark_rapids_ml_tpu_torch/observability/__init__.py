"""Structured run telemetry — port of the reference's ``observability/``.

  - :mod:`metrics`   — typed registry: counters (the ``bump_counter``
    surface of ``utils/tracing.py`` is an alias over it), gauges and
    fixed-bucket histograms with labels, the Prometheus text exposition
    and a JSON snapshot (``TPUML_METRICS_DUMP`` writes one at exit).
  - :mod:`events`    — the JSON-lines event log (``TPUML_EVENT_LOG``, or
    per-process shards under ``TPUML_TELEMETRY_DIR``): run ids, trace
    ids carried across threads and processes, the process index, spans,
    the flight ring (``TPUML_FLIGHT``).
  - :mod:`report`    — ``model.fit_report()``: stage timings, counter
    deltas, device memory; :func:`report.gang_report` over a gang's shards.
  - :mod:`heartbeat` — gang heartbeats and the ``gang.heartbeat.age_seconds``
    gauge, so a stuck member is told from a slow one.
  - :mod:`profiling` — ``TPUML_PROFILE_DIR`` wraps a fit in a
    ``torch.profiler`` session.
  - :mod:`slo`       — declared objectives (``TPUML_SLO``), burn rates,
    breach and recover records to subscribers.
  - :mod:`flightrec` — the crash dump of the flight ring.
  - :mod:`trace`     — one merged trace from a telemetry directory.
  - :mod:`costs`     — the program cost ledger (``TPUML_COST_LEDGER``):
    counted work, measured bytes and device-time walls per captured
    graph, bypass run and solver segment; the retrace watchdog; the HBM
    sampler; measured admission pricing. Armed from the environment at
    import, as in the reference.
  - :mod:`autotune`  — the ledger-driven autotuner (``TPUML_AUTOTUNE``):
    block rows, the serving bucket ladder, the batcher's window,
    admission pricing and the precision gate.

The reference's ops server (``opsplane.py``) and lock sanitizer are
ROADMAP A.9 step 5's last part. The reference starts its ops server at
import when ``TPUML_OPS_PORT`` is set and reads ``TPUML_LOCKCHECK*`` as
its modules make their locks, so importing this package with any of
those knobs (or ``TPUML_OPS_STALL_S``) set raises ``NotImplementedError``
naming the item. Like the reference, it starts the SLO monitor at import
when ``TPUML_SLO`` declares objectives.
"""

from spark_rapids_ml_tpu_torch.utils.envknobs import reject_step5_later
from spark_rapids_ml_tpu_torch.observability.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricError,
    Registry,
    default_registry,
)
from spark_rapids_ml_tpu_torch.observability.events import (  # noqa: F401
    EVENT_LOG_ENV,
    TELEMETRY_DIR_ENV,
    TraceContext,
    configure,
    current_run,
    current_run_id,
    current_trace,
    current_trace_context,
    emit,
    enabled,
    extract_env,
    flush_telemetry,
    inject_env,
    run_scope,
    trace_scope,
    validate_record,
)
from spark_rapids_ml_tpu_torch.observability.report import (  # noqa: F401
    RunRecorder,
    RunReport,
    serving_report,
)
from spark_rapids_ml_tpu_torch.observability.heartbeat import (  # noqa: F401
    GangHeartbeat,
    heartbeat_scope,
)
from spark_rapids_ml_tpu_torch.observability.profiling import (  # noqa: F401
    PROFILE_DIR_ENV,
    maybe_profile,
)
from spark_rapids_ml_tpu_torch.observability.costs import (  # noqa: F401
    COST_LEDGER_ENV,
    HbmSampler,
    Ledger,
    ProgramCost,
    RetraceStormWarning,
    ledger_snapshot,
    merge_ledger_docs,
    validate_ledger,
)
from spark_rapids_ml_tpu_torch.observability import autotune  # noqa: F401
from spark_rapids_ml_tpu_torch.observability import flightrec  # noqa: F401
from spark_rapids_ml_tpu_torch.observability import slo  # noqa: F401
from spark_rapids_ml_tpu_torch.observability.slo import (  # noqa: F401
    SLO_ENV,
    SloMonitor,
    parse_slo,
)

#: The knobs of step 5's last part that the reference reads when its
#: observability package is imported.
IMPORT_TIME_LATER_KNOBS = (
    "TPUML_OPS_PORT", "TPUML_OPS_STALL_S",
    "TPUML_LOCKCHECK", "TPUML_LOCKCHECK_STALL_MS", "TPUML_LOCKCHECK_GRAPH",
)

reject_step5_later(*IMPORT_TIME_LATER_KNOBS)
slo.maybe_start_from_env()
