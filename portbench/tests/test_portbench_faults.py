"""A run whose timed path is broken underneath comes out not correct.

Each case skips the harness's look for a card, drives the rest of a small
run on the CPU with one fault of `portbench/faults.py` planted in the
program's plain path, and sees a compared number miss its limit."""

import pytest

from portbench import faults
from portbench_small import failing, run_small


@pytest.mark.parametrize("workload", ("synth300k.train_views",
                                      "garden5m.train_held10"))
@pytest.mark.parametrize("fault", faults.TRAIN)
def test_train_fault_is_caught(workload, fault):
    import gvrt_tpu_torch as gt
    take_out = faults.plant(gt, fault, "train")
    try:
        cell, _, readings = run_small(workload)
    finally:
        take_out()
    assert failing(cell, readings["prog"]) != []


@pytest.mark.parametrize("workload", ("synth300k.serve_orbit",
                                      "garden5m.serve_orbit"))
@pytest.mark.parametrize("fault", faults.SERVE)
def test_serve_fault_is_caught(workload, fault):
    import gvrt_tpu_torch as gt
    take_out = faults.plant(gt, fault, "serve")
    try:
        cell, _, readings = run_small(workload)
    finally:
        take_out()
    assert failing(cell, readings["prog"]) != []


def test_faults_are_taken_out():
    import gvrt_tpu_torch as gt
    before = (gt.train.trainer.GroupAdam.__dict__["step"],
              gt.render.pallas_vjp.tile_backward,
              gt.render.pallas_forward.forward_tiles_reference)
    for kind, names in (("train", faults.TRAIN), ("serve", faults.SERVE)):
        for name in names:
            faults.plant(gt, name, kind)()
    assert before == (gt.train.trainer.GroupAdam.__dict__["step"],
                      gt.render.pallas_vjp.tile_backward,
                      gt.render.pallas_forward.forward_tiles_reference)
