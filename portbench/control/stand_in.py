"""The control: the plain reference put in the program's place.

:func:`fitter` has the shape of ``lib/system.fitter``; each fit it makes
is the reference's own fit of the rows at ``precision`` (``"tf32"``, the
step below the float32 with IEEE products that the configurations
state; ``"float32"``, the witness), handed back as an answer, which the
reference's ``read_fit`` takes as it is. A run or a reading with it in
the program's place has to come out not correct.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Optional

import torch

from portbench.lib import spec


def fitter(config: dict, seed: int, x: torch.Tensor, precision: str = "tf32",
           bench_dir: Optional[Path] = None) -> Callable[[], Any]:
    reference = spec.load_module((Path(bench_dir) if bench_dir else spec.BENCH_DIR) / "reference"
                                 / f"{config['family']}.py", "reference")

    def fit_once():
        return reference.as_answer(reference.fit(x, config, seed, precision))
    return fit_once
