"""What a traffic loop hands back, and the helpers the loops share.

A traffic mix is a file of parameters, ``traffic/<mix>.json``; its
``loop`` key names the loop that drives it, ``loops/<loop>.py``, found by
that name. A loop module has:

- ``CHIPS``: the number of cards one run of it drives (a cell that asks
  for another number is refused before it runs);
- ``run(stage, seconds, mix, profiler) -> Window``: set-up's warm-up of
  the cell's own shapes, then the measured window, then (with a
  profiler) the traced slice;
- ``context(window, answers) -> dict``: the loop's own fields for the
  metric readers (``fit_s`` for the fit loop);
- optionally ``judge(samples, x, ref, reference) -> dict``: the numbers
  compared for the outputs the loop kept in ``Window.samples``, each
  under a limit of the configuration.

``stage`` carries what set-up made: the configuration, the seed, the
resident rows ``x``, the cards ``devices``, ``fit_once`` (one fresh fit of
the system under test) and ``mark(label)``, which notes a step of set-up
for the split that a run prints.
"""

from __future__ import annotations

import sys
import traceback
from dataclasses import dataclass, field
from typing import Any, List


@dataclass
class Window:
    """What one window did; times on the host's ``perf_counter``. ``start``
    is the first timed call's start: set-up ends there."""

    start: float
    end: float
    attempted: int = 0
    failed: int = 0
    calls: List[tuple] = field(default_factory=list)
    models: List[Any] = field(default_factory=list)
    samples: List[Any] = field(default_factory=list)
    traced: int = 0
    trace: Any = None


def note_failure(what: str) -> None:
    print(f"portbench: {what} failed:\n{traceback.format_exc()}", file=sys.stderr, flush=True)
