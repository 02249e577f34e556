"""The data-parallel cell (`entries/train_ranks.py`) on the CPU.

Its batches: the checked steps' and the window's hold `batch` distinct
views each, never the held-out one, and every rank draws the same ones
from the seed (a case of
`test_portbench_layout.py::test_checked_steps_cross_a_switch` for the
four-card cell, in a file of its own).  And a small run of the cell, four
gloo ranks: every compared number within its limit, the bfloat16 control
outside one, and `replica_gap` 0.
"""

import itertools

import pytest

from portbench import generator, harness
from portbench_small import failing, run_small

WORKLOAD = "garden5m_dp4.train_batch4"


@pytest.mark.parametrize("seed", (1, 2 ** 31 + 5))
def test_checked_and_window_batches_hold_distinct_views(seed):
    cell = harness.load_cell(WORKLOAD)
    entry = harness.load_entry(cell.traffic["entry"])
    batch, held = int(cell.config["batch"]), set(cell.traffic["held_out"])
    check = entry.check_batches(cell.traffic, cell.config, seed, batch)
    assert len(check) == cell.traffic["check_steps"]
    window = list(itertools.islice(entry.window_batches(
        generator.Mix(cell.traffic, cell.config, seed), batch), 50))
    for views in check + window:
        assert len(views) == batch == len(set(views)), views
        assert not set(views) & held, views
    # the checked steps take new views: no view twice over both steps
    assert len({j for views in check for j in views}) == batch * len(check)
    # every rank draws the same batches
    again = entry.window_batches(generator.Mix(cell.traffic, cell.config,
                                               seed), batch)
    assert list(itertools.islice(again, 50)) == window
    assert entry.check_batches(cell.traffic, cell.config, seed,
                               batch) == check


def test_small_run_matches_reference_and_control_fails():
    cell, win, readings = run_small(WORKLOAD, control=True, seconds=1.0,
                                    traffic={"pool_views": 6})
    assert win.units >= 1
    prog = readings["prog"]
    assert failing(cell, prog) == [] and prog["replica_gap"] == 0.0
    assert prog["loss_gap"] < 1e-5 and prog["grad_gap"] < 1e-4
    assert failing(cell, readings["ctrl"]) != []
