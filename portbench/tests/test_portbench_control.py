"""The control comes out not correct through the harness: the plain
reference put in the program's place (``control/stand_in.py``) at the
precision below the configuration's, float32 with TF32 products, drives
a whole run of a cell and the comparison with the float64 reference
fails it. The same stand-in at the configuration's own precision, float32
with IEEE products (the witness), passes: the comparison fails the
control for its precision, not for standing in.

On the CPU the control's TF32 is the operands' rounding alone
(``reference/lower.py``). That fails KMeans's cost at a tiny size, but
not PCA's fit, which the card's TF32 accumulation over the cell's long
row blocks fails; so the control is also run on the card, at each cell's
own size, on three seeds."""

import time

import pytest
import torch

from portbench.control import stand_in
from portbench.lib import cell as cell_run
from portbench.lib import spec, system
from portbench.tests.rehearse import rehearse
from portbench.tests.test_portbench_spec import CELLS

#: Cells whose control the CPU's operand rounding fails at a tiny size.
ROUNDING_FAILS = ["kmeans.fit"]


def _in_place(monkeypatch, precision):
    monkeypatch.setattr(system, "fitter", lambda config, seed, x: stand_in.fitter(config, seed, x, precision))


@pytest.mark.parametrize("name", ROUNDING_FAILS)
def test_the_tf32_control_in_the_programs_place_is_not_correct(monkeypatch, name):
    _in_place(monkeypatch, "tf32")
    out = rehearse(name, seconds=0.2)
    assert not out.correct, out.checks
    assert out.failed == 0 and any(c["value"] > c["limit"] for c in out.checks.values())


@pytest.mark.parametrize("name", CELLS)
def test_the_ieee_float32_witness_in_the_programs_place_is_correct(monkeypatch, name):
    _in_place(monkeypatch, "float32")
    out = rehearse(name, seconds=0.2)
    assert out.correct, out.checks


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="the card's TF32 path runs only on a CUDA card")
@pytest.mark.parametrize("seed", [2**31 + 4101, 2**31 + 4102, 2**31 + 4103])
@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_at_the_cells_own_size_on_the_card_is_not_correct(monkeypatch, name, seed):
    _in_place(monkeypatch, "tf32")
    out = cell_run.execute(spec.load_cell(name), seed, 0.5, False, [torch.device("cuda", 0)],
                           [("start", time.perf_counter())], log=lambda *a: None)
    assert not out.correct, out.checks
    assert out.failed == 0 and any(c["value"] > c["limit"] for c in out.checks.values())
