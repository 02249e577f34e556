"""PyTorch port, pose refinement (train/pose.py) and the ray cotangents it
runs on, against the JAX package on the CPU.

The JAX side runs impl="scan" (plain autodiff through its scan reference);
the port's side runs impl="torch" (K1's residual and K2 as their plain
versions, the hand-derived ray cotangents).  Scenes come from the JAX
package's generator (tests/port_scenes.py), at tile 8 / chunk 128.
Tolerances, each stated where it is used:
  * `rodrigues` and its gradient: 1e-6;
  * `tile_rays_pose` against JAX's: rtol 1e-6, atol 2e-6; against the
    port's `tile_rays` of the baked camera: tests/test_pose_opt.py's rtol
    1e-6, atol 2e-5;
  * ray cotangents: 3e-5 of the largest (tests/test_ray_grads.py);
  * the pose gradient: 1e-4 relative; `optimize_camera_poses`: loss0 1e-5,
    loss1, |dt| and |dr| 1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.render import binning as jb
from gvrt_tpu.render.pallas_forward import forward_tiles_reference
from gvrt_tpu.render.tiled import _camera_mats
from gvrt_tpu.train import pose as jpose
from gvrt_tpu_torch.render import binning as tb
from gvrt_tpu_torch.render.pallas_forward import forward_dispatch
from gvrt_tpu_torch.train import pose as tpose

from port_scenes import CFG_T8, camera, carry, jax_scene, torch_cfg
from port_scenes import one_torch_thread  # noqa: F401 (autouse)

CFG = CFG_T8.replace(ray_gradients=True)
TCFG = torch_cfg(CFG)


def _scene(n=96, seed=5):
    return jax_scene(n, seed=seed, spread=0.7)


def _jax_binned(model, cam, cfg):
    act = model.activate()
    w2c, proj = _camera_mats(cam)
    cap = jb.plan_capacity(act, w2c, proj, cam.width, cam.height, cfg)
    return jb.bin_gaussians(act, w2c, proj, cam.width, cam.height, cfg, *cap)


def _carry_binned(b):
    """A JAX BinnedScene as the port's, on the CPU (no reduce plan: the
    chunks are constants here)."""
    return tb.BinnedScene(*(torch.from_numpy(np.array(x)) for x in b[:-1]),
                          red=None)


@pytest.mark.parametrize("r", [[0.0, 0.0, 0.0], [1e-7, 0.0, 0.0],
                               [0.3, -0.5, 0.2], [0.0, 0.0, np.pi / 2]],
                         ids=["zero", "1e-7", "generic", "quarter_z"])
def test_rodrigues_and_its_gradient_match_jax(r):
    r = np.asarray(r, np.float32)
    w = np.random.default_rng(0).normal(size=(3, 3)).astype(np.float32)
    want = np.asarray(jpose.rodrigues(jnp.asarray(r)))
    want_g = np.asarray(jax.grad(
        lambda v: jnp.sum(jnp.asarray(w) * jpose.rodrigues(v)))(
            jnp.asarray(r)))
    rt = torch.tensor(r, requires_grad=True)
    got = tpose.rodrigues(rt)
    (torch.from_numpy(w) * got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    assert np.isfinite(rt.grad.numpy()).all()
    np.testing.assert_allclose(rt.grad.numpy(), want_g, atol=1e-6)
    if r[2] == np.float32(np.pi / 2):
        np.testing.assert_allclose(got.detach().numpy() @ [1.0, 0, 0],
                                   [0.0, 1.0, 0.0], atol=1e-6)


@pytest.mark.parametrize("delta", [
    ([0.0, 0.0, 0.0], [0.0, 0.0, 0.0]),
    ([0.1, -0.2, 0.05], [0.02, 0.03, -0.01])], ids=["zero", "moved"])
def test_tile_rays_pose_matches_jax(delta):
    cam = camera(16, height=24)
    dt, dr = (np.asarray(x) for x in delta)
    want = np.asarray(jpose.tile_rays_pose(cam, CFG, dt, dr))
    got = tpose.tile_rays_pose(cam, TCFG, dt, dr, device="cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=2e-6)
    # the baked camera's rays equal the in-graph rays at the delta
    moved = tpose.apply_pose_delta(cam, dt, dr)
    np.testing.assert_allclose(tb.tile_rays(moved, TCFG, "cpu").numpy(),
                               got.numpy(), rtol=1e-6, atol=2e-5)


def test_tile_rays_pose_is_differentiable_and_clips_to_aabb():
    cam = camera(16)
    t = torch.zeros(3, requires_grad=True)
    r = torch.zeros(3, requires_grad=True)
    box = (-1.0, -1.0, -5.0, 1.0, 1.0, 1.0)
    rays = tpose.tile_rays_pose(cam, TCFG, t, r, aabb=box, device="cpu")
    want = np.asarray(jpose.tile_rays_pose(cam, CFG, np.zeros(3),
                                           np.zeros(3), aabb=box))
    np.testing.assert_allclose(rays.detach().numpy(), want, rtol=1e-6,
                               atol=2e-6)
    np.testing.assert_allclose(
        rays.detach().numpy(),
        tb.tile_rays(cam, TCFG, "cpu", aabb=box).numpy(),
        rtol=1e-6, atol=2e-6)
    np.testing.assert_allclose(
        tb.band_rays(cam, TCFG, 2, "cpu", aabb=box).numpy(),
        np.asarray(jb.band_rays(cam, CFG, 2, aabb=box)), rtol=1e-6,
        atol=2e-6)
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=rays[:, 0:6].shape).astype(np.float32))
    (rays[:, 0:6] * w).sum().backward()
    assert t.grad.abs().max() > 0 and r.grad.abs().max() > 0


def test_perturb_cameras_matches_jax():
    cams = [camera(16), g3.Camera.from_fovy(16, 16, 50.0, np.diag(
        [1.0, -1.0, -1.0, 1.0]))]
    want = jpose.perturb_cameras(cams, 0.03, seed=7)
    got = tpose.perturb_cameras(cams, 0.03, seed=7)
    for a, b in zip(got, want):
        # the draws and the float64 translation: identical
        np.testing.assert_allclose(a.view_inverse[:3, 3],
                                   b.view_inverse[:3, 3], rtol=0, atol=1e-12)
        np.testing.assert_array_equal(a.proj_inverse, b.proj_inverse)
        # the rotation block is rodrigues' f32 product: XLA's CPU sqrt, sin
        # and cos differ from torch's by an ulp on some draws
        np.testing.assert_allclose(a.view_inverse[:3, :3],
                                   b.view_inverse[:3, :3], rtol=0,
                                   atol=2.5e-7)


def _ray_loss(acc):
    return (acc[:, 0:3, :] ** 2).mean() + 1e-2 * acc[:, 3, :].mean()


@pytest.mark.parametrize("prod", [True, False], ids=["prod", "logspace"])
def test_ray_grads_match_jax_scan_autodiff(prod):
    """The plain K2's ray cotangents through `forward_dispatch` against
    `jax.grad` of JAX's scan reference w.r.t. the rays, on one binned
    scene: 3e-5 of the largest; the clip rows (6:8) carry nothing."""
    cfg = CFG.replace(transmittance_prod=prod)
    model = _scene(64, seed=3)
    cam = camera(16)
    b = _jax_binned(model, cam, cfg)
    rays = jb.tile_rays(cam, cfg)
    want = np.asarray(jax.grad(
        lambda r: _ray_loss(forward_tiles_reference(b, r, cfg)))(rays))
    r = torch.from_numpy(np.array(rays)).requires_grad_()
    _ray_loss(forward_dispatch(_carry_binned(b), r, torch_cfg(cfg),
                               "torch")).backward()
    got = r.grad.numpy()
    scale = np.abs(want).max()
    assert scale > 0, "degenerate: zero ray grads"
    np.testing.assert_allclose(got / scale, want / scale, atol=3e-5)
    assert np.abs(got[:, 6:8]).max() == 0


def test_ray_grads_silent_zero_when_off():
    cfg = TCFG.replace(ray_gradients=False)
    model = _scene(64, seed=3)
    cam = camera(16)
    b = _carry_binned(_jax_binned(model, cam, CFG_T8))
    r = tb.tile_rays(cam, cfg, "cpu").requires_grad_()
    (forward_dispatch(b, r, cfg, "torch")[:, 0:3] ** 2).mean().backward()
    assert r.grad.abs().max() == 0


def test_pose_recovery_smoke():
    """A translated camera recovers its position by gradient descent
    through the ray origins (tests/test_ray_grads.py's protocol)."""
    model = carry(_scene())
    cam = camera(16)
    with torch.no_grad():
        act = model.activate()
        w2c, proj = _camera_mats(cam)
        cap = tb.plan_capacity(act, w2c, proj, 16, 16, TCFG)
        b = tb.bin_gaussians(act, w2c, proj, 16, 16, TCFG, *cap)
        rays0 = tb.tile_rays(cam, TCFG, "cpu")
        target = forward_dispatch(b, rays0, TCFG, "torch")[:, 0:3]

    def loss_at(delta):
        r = rays0.clone()
        r[:, 0:3] = r[:, 0:3] + delta[None, :, None]
        acc = forward_dispatch(b, r, TCFG, "torch")
        return ((acc[:, 0:3] - target) ** 2).mean()

    start = torch.tensor([0.03, -0.02, 0.04])
    delta = start.clone().requires_grad_()
    loss0 = float(loss_at(delta).detach())
    assert loss0 > 1e-8
    lr, prev = 2.0, loss0
    for _ in range(40):
        delta.grad = None
        loss = loss_at(delta)
        loss.backward()
        val = float(loss.detach())
        assert np.isfinite(val)
        if val > prev:              # overshot: back off the step size
            lr *= 0.5
        prev = val
        with torch.no_grad():
            delta -= lr * delta.grad
    loss1 = float(loss_at(delta).detach())
    assert loss1 < 0.2 * loss0, (loss0, loss1)
    assert float(delta.detach().norm()) < 0.7 * float(start.norm())


def _pose_loss_jax(b, cam, tgt, cfg):
    def loss(t, r):
        acc = forward_tiles_reference(b, jpose.tile_rays_pose(cam, cfg, t, r),
                                      cfg)
        return jnp.mean((acc[:, 0:3, :] - tgt) ** 2)
    return loss


def test_pose_gradient_matches_jax():
    """d loss / d (t, r) at a non-zero delta, each package binning the same
    scene for itself: within 1e-4 relative."""
    jm = _scene()
    cam = camera(16)
    true_cam = jpose.apply_pose_delta(cam, np.asarray([0.02, -0.01, 0.0]),
                                      np.asarray([0.0, 0.01, 0.0]))
    target = np.array(forward_tiles_reference(
        _jax_binned(jm, true_cam, CFG), jb.tile_rays(true_cam, CFG),
        CFG)[:, 0:3])
    dt = np.asarray([0.01, 0.005, -0.01], np.float32)
    dr = np.asarray([0.004, -0.003, 0.002], np.float32)
    want = jax.grad(_pose_loss_jax(_jax_binned(jm, cam, CFG), cam,
                                   jnp.asarray(target), CFG),
                    argnums=(0, 1))(jnp.asarray(dt), jnp.asarray(dr))

    tm = carry(jm)
    with torch.no_grad():
        act = tm.activate()
        w2c, proj = _camera_mats(cam)
        cap = tb.plan_capacity(act, w2c, proj, 16, 16, TCFG)
        b = tb.bin_gaussians(act, w2c, proj, 16, 16, TCFG, *cap)
    t = torch.tensor(dt, requires_grad=True)
    r = torch.tensor(dr, requires_grad=True)
    acc = forward_dispatch(b, tpose.tile_rays_pose(cam, TCFG, t, r,
                                                   device="cpu"),
                           TCFG, "torch")
    ((acc[:, 0:3] - torch.from_numpy(target)) ** 2).mean().backward()
    for got, w in ((t.grad, want[0]), (r.grad, want[1])):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        assert np.linalg.norm(got.numpy() - w) <= 1e-4 * np.linalg.norm(w)


def test_optimize_camera_poses_matches_jax():
    """10 Adam steps from the same perturbed camera in both packages."""
    jm = _scene()
    true_cam = camera(16)
    target = np.asarray(g3.render.render_image_tiled(
        jm, true_cam, CFG_T8, impl="scan")["rgb"])
    bad = jpose.perturb_cameras([true_cam], sigma_t=0.03, seed=3)
    j_cams, j_rep = jpose.optimize_camera_poses(
        jm, bad, [target], CFG_T8, steps=10, lr=5e-3, impl="scan",
        verbose=False)
    t_cams, t_rep = tpose.optimize_camera_poses(
        carry(jm), bad, [target], torch_cfg(CFG_T8), steps=10, lr=5e-3,
        impl="torch", verbose=False)
    want, got = j_rep[0], t_rep[0]
    assert got["loss0"] == pytest.approx(want["loss0"], rel=1e-5)
    for k in ("loss1", "dt_norm", "dr_norm"):
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    np.testing.assert_allclose(t_cams[0].view_inverse,
                               j_cams[0].view_inverse, atol=1e-4)


def test_optimize_camera_poses_recovers_perturbation(capsys):
    """tests/test_pose_opt.py's recovery: 60 steps close most of the
    photometric gap and move the camera toward the true one."""
    jm = _scene()
    true_cam = camera(16)
    model = carry(jm)
    with torch.no_grad():
        target = gt.render.render_image_tiled(model, true_cam, TCFG,
                                              device="cpu")["rgb"].numpy()
    bad = tpose.perturb_cameras([true_cam], sigma_t=0.03, seed=3)
    fixed, reports = tpose.optimize_camera_poses(
        model, bad, [target], TCFG, steps=60, lr=5e-3, impl="torch")
    assert "pose-opt" in capsys.readouterr().out
    rep = reports[0]
    assert rep["loss1"] < 0.35 * rep["loss0"], rep
    err_bad = np.linalg.norm(bad[0].view_inverse[:3, 3]
                             - true_cam.view_inverse[:3, 3])
    err_fix = np.linalg.norm(fixed[0].view_inverse[:3, 3]
                             - true_cam.view_inverse[:3, 3])
    assert err_fix < err_bad, (err_fix, err_bad)
