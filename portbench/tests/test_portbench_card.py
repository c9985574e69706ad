"""On the chip, at each cell's own size: a program seed reads within every
limit, and the control (one precision below the cell's, or the program's
int8 path) fails one of them."""

import pytest

from portbench import calibrate, harness
from portbench.tests.small import CELLS


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_within_limits(cell):
    r = calibrate.readings(cell, 2**33 + 101, "program")
    limits = harness.load_cell(cell).limits
    assert all(r["checks"][k] <= v for k, v in limits.items()), r


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    r = calibrate.readings(cell, 2**33 + 202, "control")
    limits = harness.load_cell(cell).limits
    assert any(r["control"][k] > v for k, v in limits.items()), r
