"""The control, the reference one precision below the configuration's in
the program's place, fails each cell's limits (at a size the CPU holds;
the readings at the cells' own sizes come from ``portbench/control.py`` on
the card, ``PERF.md`` §2)."""
import pytest
import torch

from portbench import compare, control
from portbench.tests.conftest import small


@pytest.mark.parametrize("name", ["nl-f32-c262144", "tlad-f64-c262144"])
def test_control_fails_the_limits(name):
    cell = small(name, 4, samples=1)
    high, low = control.readings(cell, [], [1, 2, 3], torch.device("cpu"), out=lambda _: None)
    assert not compare.passes(low, cell.limits), low
