"""The reference against the port's plain path on the CPU, the bfloat16
control that the comparison has to fail, and the frozen work count
against chip_smoke.py's."""

import os
import sys

import numpy as np
import pytest
import torch

from portbench_small import WORKLOADS, failing, run_small, small_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_matches_reference(workload):
    """A small run of each cell on the port's plain path: every compared
    number within its limit, the frames or first steps agreeing with the
    reference to rounding."""
    cell, win, readings = run_small(workload)
    assert win.units >= 1
    prog = readings["prog"]
    assert failing(cell, prog) == []
    if "loss_gap" in prog:
        assert prog["loss_gap"] < 1e-5 and prog["grad_gap"] < 1e-4
    else:
        assert prog["rays_off"] <= 1e-3 and prog["rgb_gap"] < 1e-6


def test_rays_each_step_feed():
    """The unbanded trainer fed as the CLI feeds it, a camera batch made
    on the host every step, matches the reference as the pool feed does."""
    cell, win, readings = run_small("synth300k.train_views",
                                    traffic={"rays": "each_step"})
    assert win.units >= 1 and failing(cell, readings["prog"]) == []


@pytest.mark.parametrize("workload", ("synth300k.train_views",
                                      "synth300k.serve_orbit"))
def test_bf16_control_fails(workload):
    """The reference in bfloat16 in the program's place misses a limit."""
    cell, _, readings = run_small(workload, control=True)
    assert failing(cell, readings["prog"]) == []
    assert failing(cell, readings["ctrl"]) != []


def test_counts_match_chip_smoke():
    """The frozen chain count on the reference's binning equals
    chip_smoke.chain_counts on the port's binned scene."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    import gvrt_tpu_torch as gt
    from portbench import counts, harness
    from portbench.reference import binning as rb, camera as rc
    from portbench.reference import composite as rcomp
    from portbench.reference.math import activate, param_rows, \
        response_cutoff
    from portbench.scene import draw
    cell = small_cell("synth300k.serve_orbit")
    st = harness.settings(cell.config)
    leaves, _ = draw(cell.config, 11, "cpu")
    view = rc.orbit_view(cell.config["centre"], 3.0, 30.0, 50.0, 64, 64)
    cam = gt.Camera.from_fovy(64, 64, 50.0, view.c2w)
    binned, rays = chip_smoke.binned_for(gt, gt.GaussianModel(*leaves), cam,
                                         gt.DEFAULT_CONFIG)
    want = chip_smoke.chain_counts(binned, rays, gt.DEFAULT_CONFIG)
    act = activate(*leaves)
    w2c, proj = rc.matrices(view, st)
    b = rb.bin_frame(act, w2c, proj, 64, 64, st)
    rows = param_rows(act)
    rays_r = rc.tile_rays(view, st, "cpu")
    acc, t_in = rcomp.render(rows, b, rays_r, st, residual=True)
    got = counts.chain_counts(rows[b.gid], rays_r, b.tile_counts, t_in,
                              float(acc[:, 5].double().sum()),
                              response_cutoff(st), st.min_transmittance)
    assert got == want
    assert torch.equal(rays_r, rays)


def test_reference_gradient_matches_finite_differences():
    """The reference's gradient (autograd through its own composite) along
    a random direction of the opacity logits, against a central
    difference of its loss in float64."""
    from portbench import harness
    from portbench.reference import binning as rb, camera as rc
    from portbench.reference import composite as rcomp
    from portbench.reference.math import activate
    from portbench.scene import draw
    cell = small_cell("synth300k.train_views")
    st = harness.settings(cell.config)
    scene, model = draw(cell.config, 5, "cpu", cell.traffic["perturb"])
    view = rc.orbit_view(cell.config["centre"], 3.0, 0.0, 50.0, 64, 64)
    w2c, proj = rc.matrices(view, st)
    b = rb.bin_frame(activate(*model), w2c, proj, 64, 64, st)
    rays = rc.tile_rays(view, st, "cpu")
    target = torch.rand((16, 3, 256), generator=torch.Generator()
                        .manual_seed(3))
    model = [x.double() for x in model]
    _, grads, _ = rcomp.loss_and_grads(model, b, rays.double(), target
                                       .double(), st, torch.float64)
    d = torch.randn(model[3].shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    eps = 1e-6

    def loss(s):
        m = list(model)
        m[3] = model[3] + s * d
        return rcomp.loss_and_grads(m, b, rays.double(), target.double(),
                                    st, torch.float64)[0]
    fd = (loss(eps) - loss(-eps)) / (2 * eps)
    assert np.isclose(float((grads[3] * d).sum()), fd, rtol=1e-4)


@pytest.mark.parametrize("workload", ("synth300k.train_views",
                                      "synth300k.serve_orbit"))
def test_metric_readers(workload):
    """Every metric's reader on a small traced and untraced run: the
    spans are read (on the host's clock here), the device metrics have
    nothing to read on the CPU and come out absent, never 0."""
    sys.path.insert(0, os.path.join(ROOT, "portbench"))
    import run
    for trace in (False, True):
        cell, win, _ = run_small(workload, trace=trace)
        r = run.Run(cell, win, 1.5, 0)
        metrics = cell.per_layer if trace else cell.end_to_end
        values = {m["name"]: run.load_reader(m["name"])(r) for m in metrics}
        for name, v in values.items():
            if trace and ("roofline" in name or "idle" in name):
                assert v is None, name
            elif name == "peak_mem_gib":
                assert v is None
            else:
                assert v is not None and v > 0, name


def test_gone_names_read_absent(capsys):
    """A span or counter whose name has gone from the program leaves its
    metric absent (None, never 0) and names itself on standard error."""
    import gvrt_tpu_torch  # noqa: F401  (the program the tables name)
    from portbench import trace
    spans = trace.Spans({"gone": [{"module": "render.tiled",
                                   "attr": "no_such_function"}],
                         "here": [{"module": "render.tiled",
                                   "attr": "bin_topology"}]},
                         torch.device("cpu"))
    spans.remove()
    assert spans.total_ms("gone") is None and spans.total_ms("here") is None
    assert trace.read_counter({"module": "render.pallas_forward",
                               "attr": "no_such.launches"}) is None
    err = capsys.readouterr().err
    assert "render.tiled:no_such_function" in err
    assert "render.pallas_forward:no_such.launches" in err


def test_kernel_without_a_bound_reads_absent(capsys):
    """A kernel whose table entry names no bound file gets no bound (its
    roofline metric reads absent, never against another kernel's bound)
    and is named on standard error; a known bound is counted."""
    from portbench import harness
    from portbench.reference import camera as rc
    from portbench.scene import draw
    cell = small_cell("synth300k.serve_orbit")
    leaves, _ = draw(cell.config, 11, "cpu")
    view = rc.orbit_view(cell.config["centre"], 3.0, 30.0, 50.0, 64, 64)
    got = harness.sample_bounds(
        cell, [view], leaves, "cpu", {"k1": 1.0, "k9": 1.0},
        {"k1": {"bound": "forward"}, "k9": {"bound": "no_such_bound"}})
    assert set(got) == {"k1"} and got["k1"] > 0
    assert "no_such_bound" in capsys.readouterr().err
