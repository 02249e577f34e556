"""The port's pose step (`train.pose.PoseRefiner`) against the benchmark's
plain reference (`portbench/reference/pose.py`), on the CPU, and the pose
loop's refactor against the loop it replaced.

A seeded random scene of 2000 Gaussians (`gt.random_gaussians`, no JAX)
at 64 x 64, 50 deg fovy, tile 8, chunk 64 (~16 hits a ray); the
camera perturbed with sigma_t 0.03 from one seed on both sides (the
program's `perturb_cameras`, the reference's `perturbed_view`), the
target the program's render at the true pose, three Adam steps at lr 3e-3.
Tolerances, each from the rounding of one side against the other in
float32 (the program's binning, plain K1 with its residual and the
hand-derived K2 with the ray cotangents; the reference's own binning,
blocked composite and autograd):

  * the perturbed pose: atol 1e-7 (rodrigues' f32 products in another
    order, then the same float64 product);
  * each step's loss: rtol 1e-5 (tests/test_torch_data_parallel.py's step
    loss; read up to 2.4e-7);
  * each step's d loss / d t and d loss / d r: relative L2 2e-5 (the ray
    cotangents' sums over 4096 rays in another order, then the rays'
    backward; read up to 1.1e-6 over three seeds);
  * the deltas after each step: atol 1e-7, a thirtieth of a thousandth of
    one Adam step of lr 3e-3 (each coordinate moves by about lr times the
    sign of its running gradient, so the deltas see the gradients' errors
    only through the moments' ratios; read up to 6.5e-9).

The refactored `optimize_camera_poses` gives the reports and cameras of
the loop it replaced bit for bit; that loop differentiated the loss
through the rays in one backward, so the same check holds the split
backward (`_PosedRays`: the rays' graph differentiated on its own) to the
single one, as does a direct comparison of one step's gradients.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gvrt_tpu_torch as gt  # noqa: E402
from gvrt_tpu_torch.render.pallas_forward import forward_dispatch  # noqa: E402
from gvrt_tpu_torch.train import pose as tpose  # noqa: E402
from portbench.reference import camera as ref_cam  # noqa: E402
from portbench.reference import pose as ref_pose  # noqa: E402
from portbench.reference.math import Settings, activate, param_rows  # noqa: E402

RES, FOVY, SEED, SIGMA, LR = 64, 50.0, 20260423, 0.03, 3e-3
CFG = gt.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=64)
ST = Settings(tile_size=8, chunk_size=64)


@pytest.fixture(autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(2, n))
    yield
    torch.set_num_threads(n)


def _scene(seed=7):
    g = torch.Generator().manual_seed(seed)
    model = gt.random_gaussians(g, 2000, extent=1.2,
                                scale_range=(-3.3, -2.6), device="cpu")
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    return model


def _c2w():
    c2w = np.eye(4)
    c2w[:3, 3] = [0.05, -0.02, 0.1]
    return c2w


@pytest.fixture(scope="module")
def setting():
    """(model, true camera, target (H, W, 3) numpy)."""
    torch.set_num_threads(min(2, torch.get_num_threads()))
    model = _scene()
    cam = gt.Camera.from_fovy(RES, RES, FOVY, _c2w())
    with torch.no_grad():
        target = gt.render.render_image_tiled(model, cam, CFG,
                                              device="cpu")["rgb"].numpy()
    return model, cam, target


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("impl", ("torch", "auto"))
def test_pose_steps_match_the_reference(setting, impl):
    model, cam, target = setting
    bad = tpose.perturb_cameras([cam], SIGMA, seed=[SEED, 2, 0])[0]
    view = ref_pose.perturbed_view(ref_cam.View(_c2w(), FOVY, RES, RES),
                                   [SEED, 2, 0], SIGMA)
    np.testing.assert_allclose(bad.view_inverse, view.c2w, rtol=0,
                               atol=1e-7)
    refiner = tpose.PoseRefiner(model, bad, target, CFG, LR, impl)
    act = activate(*[x.detach() for x in model.leaves()])
    ref = ref_pose.Refinement(act, param_rows(act), view, ref_cam.to_tiles(
        torch.from_numpy(target), ST.tile_size), ST)
    for k in range(3):
        loss = refiner.step()
        want_loss, want_t, want_r, hits = ref.step()
        assert float(loss) == pytest.approx(want_loss, rel=1e-5), k
        g_t, g_r = refiner.grads()
        assert float(want_t.abs().max()) > 0 and float(want_r.abs().max()) > 0
        assert _rel(g_t, want_t) <= 2e-5, k
        assert _rel(g_r, want_r) <= 2e-5, k
        for got, want in ((refiner.t, ref.t), (refiner.r, ref.r)):
            np.testing.assert_allclose(got.detach().numpy(), want.numpy(),
                                       rtol=0, atol=1e-7, err_msg=str(k))
        if k == 0:
            assert hits > 10


def _loop_before(model, cameras, targets, cfg, steps, lr):
    """`optimize_camera_poses` as it was before `PoseRefiner`: one backward
    through the loss and the rays' graph, a host read of every step's
    loss."""
    out_cams, reports = [], []
    for cam, target in zip(cameras, targets):
        bound = tpose.bind_pose(model, cam, target, cfg)
        t = torch.zeros(3, requires_grad=True)
        r = torch.zeros(3, requires_grad=True)
        opt = torch.optim.Adam([t, r], lr=lr, eps=1e-8)
        with torch.no_grad():
            loss0 = float(tpose.pose_loss(bound, t, r, "torch"))
        val = loss0
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = _single_loss(bound, t, r)
            loss.backward()
            opt.step()
            val = float(loss.detach())
        dt, dr = t.detach().numpy(), r.detach().numpy()
        out_cams.append(tpose.apply_pose_delta(cam, dt, dr))
        reports.append({"loss0": loss0, "loss1": val,
                        "dt_norm": float(np.linalg.norm(dt)),
                        "dr_norm": float(np.linalg.norm(dr))})
    return out_cams, reports


def _single_loss(bound, t, r):
    """The pose loss with the rays in the loss's own graph."""
    rays = tpose._posed_rays(bound.ndc, bound.camera, bound.cfg, t, r)
    acc = forward_dispatch(bound.binned, rays, bound.cfg, "torch")
    return ((acc[:, 0:3, :] - bound.target) ** 2).mean()


def test_optimize_camera_poses_reports_as_before(setting, capsys):
    model, cam, target = setting
    bad = tpose.perturb_cameras([cam, cam], SIGMA, seed=5)
    got_cams, got = tpose.optimize_camera_poses(
        model, bad, [target, target], CFG, steps=4, lr=LR, impl="torch")
    assert capsys.readouterr().out.count("pose-opt") == 2
    want_cams, want = _loop_before(model, bad, [target, target], CFG, 4, LR)
    assert got == want
    for a, b in zip(got_cams, want_cams):
        np.testing.assert_array_equal(a.view_inverse, b.view_inverse)
    assert all(r["loss1"] < r["loss0"] for r in got)


def test_split_backward_equals_the_single_backward(setting):
    model, cam, target = setting
    bad = tpose.perturb_cameras([cam], SIGMA, seed=11)[0]
    bound = tpose.bind_pose(model, bad, target, CFG)
    grads = []
    for loss_fn in (lambda t, r: tpose.pose_loss(bound, t, r, "torch"),
                    lambda t, r: _single_loss(bound, t, r)):
        t = torch.tensor([0.004, -0.002, 0.003], requires_grad=True)
        r = torch.tensor([-0.001, 0.002, 0.0015], requires_grad=True)
        loss = loss_fn(t, r)
        loss.backward()
        grads.append((float(loss.detach()), t.grad.clone(), r.grad.clone()))
    (l1, t1, r1), (l2, t2, r2) = grads
    assert l1 == l2
    assert torch.equal(t1, t2) and torch.equal(r1, r2)
    assert float(t1.abs().max()) > 0 and float(r1.abs().max()) > 0
