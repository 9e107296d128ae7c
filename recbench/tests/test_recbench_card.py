"""On the card (``python -m pytest -m cuda recbench/tests``): the harness
end to end at the CPU tests' size, through the program's kernels and
captured graphs, and the control, TF32 on the card's own switch, failing
the cells' limits."""

import pytest

from recbench import control, run, spec
from recbench.tests import tiny

CELLS = [w["name"] for w in spec.benchmark()["workloads"]] + \
    tiny.held_cells()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card_is_correct(cell, card):
    work, cfg, mix = tiny.cell(cell)
    result = run.run_cell(cell, work, cfg, mix, tiny.benchmark(cell), 3,
                          0.5, True, card)
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_card_fails_the_limits(cell, card):
    work, cfg, mix = tiny.cell(cell)
    for seed in (5, 6, 7):
        got = control.readings(cfg, mix, seed, card)
        for name, numbers in got.items():
            limits = {k: v for k, v in work["limits"].items() if k in numbers}
            assert any(numbers[k] > v for k, v in limits.items()), (
                name, numbers)
