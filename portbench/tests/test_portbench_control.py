"""The control of every cell (the reference at float8 in the program's
place) comes out as not correct: on a card at the cell's own size on
three seeds (`-m cuda`; it skips without one), and at a small size on
the CPU."""

import pytest

from portbench import control, harness
from portbench.tests import tiny

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_cpu(cell):
    import torch
    torch.set_num_threads(2)
    got = control.control(cell, 7, "cpu", tiny.spec(cell))
    assert not got["correct"], got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303):
        got = control.control(cell, seed, "cuda")
        assert not got["correct"], got
