"""The control (the reference one precision below each part's, in the
program's place) comes out not correct, while the program passes.

On the card, at the cell's own size and limits, three seeds each
(``-m card``; `benchmark.calibrate` gives the same readings for a dozen
seeds). On the CPU, at the tiny size in float32, the control reads far
above the program."""

import pytest

from benchmark.calibrate import reading
from benchmark.run import ROOT, load_cell
from benchmark.tests.tiny import tiny_cell, workloads

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", workloads())
def test_control_fails_at_the_cells_size(card, workload, seed):
    cell = load_cell(ROOT, workload, trace=False)
    row = reading(cell, seed, control=True, device=card)
    assert row["correct"], row["program"]
    assert any(row["control"][k] > cell.limits[k] for k in cell.limits), row["control"]


@pytest.mark.parametrize("workload", workloads())
def test_control_reads_far_above_the_program(workload):
    row = reading(tiny_cell(workload), SEEDS[0], control=True, device="cpu")
    assert row["correct"], row["program"]
    for k in ("mel", "wav"):
        assert row["control"][k] > 30 * max(row["program"][k], 1e-6), (k, row)
