"""The control of ``correct`` on the card: the reference in TF32, put in
the program's place, fails the compared numbers of every cell (here on one
seed and the steps a run of each cell checks; ``control.py`` reads three
seeds or more at the cells' own sizes)."""

import pytest

from portbench import control, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(name, cuda_device):
    cell = harness.find_cell(name)
    got = control.readings(cell, 2**31 + 5, ["tf32"], int(cell.params["control_first_step"]),
                           cuda_device)
    assert got["tf32"] > cell.params["limits"]["out_bytes_off"]
