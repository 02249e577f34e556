"""PyTorch port, model and I/O: cameras, PLY and the parameter table agree
with the JAX package."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.io.cameras import look_at_inverse
from gvrt_tpu.render.binning import param_rows as jax_param_rows
from gvrt_tpu_torch.models.gaussians import LEAVES
from gvrt_tpu_torch.render.binning import param_rows

from port_scenes import carry, jax_scene


@pytest.mark.parametrize("w,h,fov,pose", [(32, 32, 60.0, "eye"),
                                          (48, 24, 39.6, "orbit")])
def test_camera_rays_bit_equal(w, h, fov, pose):
    c2w = np.eye(4) if pose == "eye" else look_at_inverse(
        np.asarray([2.0 * math.cos(0.7), 2.0 * math.sin(0.7), 0.5]),
        np.zeros(3), np.asarray([0.0, 0.0, 1.0]))
    a = g3.Camera.from_fovy(w, h, fov, c2w)
    b = gt.Camera.from_fovy(w, h, fov, c2w)
    assert a.content_key() == b.content_key()
    for x, y in zip(a.rays(), b.rays()):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_ply_round_trip_between_packages(tmp_path, direction):
    jm = jax_scene(50, seed=3)
    path = str(tmp_path / "scene.ply")
    if direction == "jax_to_torch":
        jm.to_ply(path)
        got = gt.GaussianModel.from_ply(path, device="cpu").to_numpy()
        want = {k: np.asarray(getattr(jm, k)) for k in LEAVES}
    else:
        carry(jm).to_ply(path)
        back = g3.GaussianModel.from_ply(path)
        got = {k: np.asarray(getattr(back, k)) for k in LEAVES}
        want = {k: np.asarray(getattr(jm, k)) for k in LEAVES}
    for k in LEAVES:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_from_numpy_activate_param_rows_match_jax():
    jm = jax_scene(300, seed=5)
    tm = carry(jm)
    ja, ta = jm.activate(), tm.activate()
    for f in ("means", "scales", "inv_scales", "rot9", "densities", "sh_flat"):
        np.testing.assert_allclose(getattr(ta, f).detach().numpy(),
                                   np.asarray(getattr(ja, f)), rtol=2e-6,
                                   atol=1e-6, err_msg=f)
    rows_j = np.asarray(jax_param_rows(ja, g3.DEFAULT_CONFIG))
    rows_t = param_rows(ta, gt.DEFAULT_CONFIG).detach().numpy()
    assert rows_t.shape == rows_j.shape == (301, 64)
    # atol 1e-6 on density and SH; the frame columns M = diag(1/s) R^T and
    # b = M mean carry 1/s (up to ~90 here) and |b| (up to ~220), so their
    # bound is 1e-6 of the row's largest frame entry (XLA contracts
    # 1 - 2(yy + zz) into an FMA: one ulp of R, times 1/s)
    frame = np.maximum(np.abs(rows_j[:, :12]).max(axis=1), 1.0)[:, None]
    tol = 1e-6 * np.where(np.arange(64)[None] < 12, frame, 1.0)
    assert (np.abs(rows_t - rows_j) <= tol).all()
    # the to_numpy inverse hands back the carried leaves unchanged
    for k, v in tm.to_numpy().items():
        np.testing.assert_array_equal(v, np.asarray(getattr(jm, k)))


def test_abnormal_filter_matches_jax():
    jm = jax_scene(200, seed=6)
    jm.sh_dc = jm.sh_dc.at[:20].mul(8.0)      # some |albedo| > 3
    tm = carry(jm)
    np.testing.assert_array_equal(tm.abnormal_mask().numpy(),
                                  np.asarray(jm.abnormal_mask()))
    kept = jm.filtered()
    np.testing.assert_array_equal(tm.filtered().means.detach().numpy(),
                                  np.asarray(kept.means))


def test_random_gaussians_from_generator():
    g = torch.Generator().manual_seed(0)
    m = gt.random_gaussians(g, 4000, extent=0.5, scale_range=(-5.0, -4.0),
                            device="cpu")
    assert isinstance(m, torch.nn.Module)
    assert [tuple(getattr(m, k).shape) for k in LEAVES] == [
        (4000, 3), (4000, 3), (4000, 4), (4000,), (4000, 3), (4000, 15, 3)]
    a = m.to_numpy()
    assert np.abs(a["means"]).max() <= 0.5
    assert -5.0 <= a["scales_log"].min() <= a["scales_log"].max() <= -4.0
    assert -2.0 <= a["opacity_logit"].min() <= a["opacity_logit"].max() <= 3.0
    assert abs(a["quats"][:, 0].mean() - 2.0) < 0.1
    assert abs(a["sh_rest"].std() - 0.05) < 0.005
    again = gt.random_gaussians(torch.Generator().manual_seed(0), 4000,
                                extent=0.5, scale_range=(-5.0, -4.0),
                                device="cpu")
    assert torch.equal(again.means, m.means)
