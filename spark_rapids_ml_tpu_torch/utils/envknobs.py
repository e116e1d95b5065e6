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
    # observability (observability/events.py)
    Knob("TPUML_EVENT_LOG", "str", "observability",
         "JSON-lines event sink: a file path or 'stderr' (unset = off)"),
    # the autotuner's committed decisions (not ported: ROADMAP A.9)
    Knob("TPUML_AUTOTUNE", "choice", "autotune",
         "on = measured-cost decisions (not ported; raises); off = the "
         "static heuristics", default="off", choices=("off", "on")),
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
)}

AUTOTUNE_ENV = "TPUML_AUTOTUNE"
AUTOTUNE_ITEM = (
    "TPUML_AUTOTUNE=on (the autotuner's committed decisions) is not ported "
    "yet: it needs the cost ledger and the tuner of the observability item "
    "(ROADMAP A.9)"
)


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


def reject_autotune() -> None:
    """Where the reference would consult its autotuner: with
    ``TPUML_AUTOTUNE=on`` raise ``NotImplementedError`` (the tuner is not
    ported); unset or ``off`` takes the static branch, as the reference
    does with the tuner off."""
    if env_choice(AUTOTUNE_ENV, ("off", "on"), "off") == "on":
        raise NotImplementedError(AUTOTUNE_ITEM)
