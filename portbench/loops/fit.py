"""The closed fit loop: one caller fits back to back on one card.

Set-up ends with one warm fit (kernels loaded, built on a checkout's
first run, and the solvers' first calls made). The window then runs
fresh fits, each a new estimator on the resident tensor with its model on
the device before the next starts, until the fit that crosses
``seconds`` has finished; ``fit_s`` is the window over the fits completed
in it. A traced run then profiles ``trace_fits`` more fits.
"""

from __future__ import annotations

import time
from typing import Any, List

from portbench.lib.window import Window, note_failure

CHIPS = 1


def run(stage, seconds: float, mix: dict, profiler: Any) -> Window:
    stage.fit_once()
    stage.mark("warm fit")
    start = time.perf_counter()
    win = Window(start, start)
    while True:
        win.attempted += 1
        t0 = time.perf_counter()
        try:
            win.models.append(stage.fit_once())
            done = time.perf_counter()
            win.calls.append((t0, done, done))
        except Exception:  # a failed fit is counted and the window goes on
            win.failed += 1
            note_failure("fit")
        win.end = time.perf_counter()
        if win.end - start >= seconds:
            break
    if profiler is not None:
        with profiler:
            for _ in range(int(mix["trace_fits"])):
                try:
                    win.models.append(stage.fit_once())
                    win.traced += 1
                except Exception:
                    win.failed += 1
                    note_failure("traced fit")
        win.trace = profiler.result
    return win


def context(win: Window, answers: List[dict]) -> dict:
    """``fit_s``, the untraced window's seconds per completed fit (one of
    ``calls`` each), and the traced fits' answers."""
    done = len(win.calls)
    return {"fit_s": (win.end - win.start) / done if done else None,
            "traced_answers": answers[len(answers) - win.traced:] if win.traced else []}
