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
  - :mod:`opsplane`  — the per-process ops server (``TPUML_OPS_PORT``):
    ``/metrics``, ``/healthz``, ``/varz`` and ``/tracez`` over the live
    registries.

As in the reference, the ops server and the SLO monitor are armed from
the environment at import (both no-ops, allocating nothing, when
``TPUML_OPS_PORT`` / ``TPUML_SLO`` are unset). The lock sanitizer
(``utils/lockcheck.py``, ``TPUML_LOCKCHECK``) makes every lock of the
package.
"""

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
from spark_rapids_ml_tpu_torch.observability import opsplane  # noqa: F401
from spark_rapids_ml_tpu_torch.observability import slo  # noqa: F401
from spark_rapids_ml_tpu_torch.observability.opsplane import (  # noqa: F401
    OPS_PORT_ENV,
    OpsServer,
)
from spark_rapids_ml_tpu_torch.observability.slo import (  # noqa: F401
    SLO_ENV,
    SloMonitor,
    parse_slo,
)

# The live ops plane is env-armed at import, so EVERY process of a gang
# gets its scrape endpoints and SLO evaluation without member-side code.
opsplane.maybe_start_from_env()
slo.maybe_start_from_env()
