"""The pose cell (`synth300k.pose`, `entries/pose.py`) in a small run on
the CPU: its checked steps cross a bind, its compared numbers are finite
and within their limits, the bfloat16 control and each fault of
`faults_pose.py` miss a limit, its two readers read nothing without a
device trace, and its reference loads nothing of the port."""

import math
import os
import subprocess
import sys

import pytest

from portbench import faults_pose, generator, harness
from portbench.entries import pose as pose_entry
from portbench.run import Run, load_reader
from portbench_small import failing, run_small

CELL = "synth300k.pose"
#: a camera held 3 steps, so a small window crosses visits
SMALL = {"hold_steps": 3}


def test_checked_steps_cross_a_bind():
    cell = harness.load_cell(CELL)
    for seed in (1, 2 ** 31 + 5, 3300000001):
        order = generator.Mix(cell.traffic, cell.config, seed).check_order()
        assert pose_entry.starts(order) == [True, False, True], order


@pytest.fixture(scope="module")
def small_run():
    return run_small(CELL, control=True, traffic=SMALL, seconds=1.0)


def test_numbers_are_finite_and_within_limits(small_run):
    cell, win, readings = small_run
    assert win.units >= 1
    for side in ("prog", "ctrl"):
        assert set(cell.limits) <= set(readings[side])
        for name in cell.limits:
            assert math.isfinite(readings[side][name]), (side, name)
    assert failing(cell, readings["prog"]) == []


def test_control_fails(small_run):
    cell, _, readings = small_run
    assert failing(cell, readings["ctrl"]) != []


@pytest.mark.parametrize("fault", faults_pose.FAULTS)
def test_fault_is_caught(fault):
    import gvrt_tpu_torch as gt
    take_out = faults_pose.plant(gt, fault)
    try:
        cell, _, readings = run_small(CELL, traffic=SMALL, seconds=0.2)
    finally:
        take_out()
    assert failing(cell, readings["prog"]) != []


def test_faults_are_taken_out():
    import gvrt_tpu_torch as gt
    before = (gt.render.pallas_vjp.tile_backward,
              gt.render.pallas_vjp._backward_plain,
              gt.train.pose.PoseRefiner.__dict__["__init__"])
    for name in faults_pose.FAULTS:
        faults_pose.plant(gt, name)()
    assert before == (gt.render.pallas_vjp.tile_backward,
                      gt.render.pallas_vjp._backward_plain,
                      gt.train.pose.PoseRefiner.__dict__["__init__"])


def test_readers_read_nothing_without_a_device_trace():
    cell, win, _ = run_small(CELL, trace=True, traffic=SMALL, seconds=0.2)
    assert win.device is None
    for metric in ("pose_rays_ms.pose", "bind_ms.pose"):
        assert load_reader(metric)(Run(cell, win, 0.0, 0)) is None, metric


def test_reference_loads_nothing_of_the_port():
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "-c", "import sys, portbench.reference.pose; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'gvrt_tpu_torch', '3dgvrt_lightfield_tpu_torch', 'gvrt_tpu', "
         "'3dgvrt_lightfield_tpu', 'jax', 'jaxlib'}))"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
