"""PyTorch port, the brute-force renderer's gradients (render/reference.py)
against the JAX package's autodiff gradients and central differences.

The brute-force renderer is the ground truth of the gradient paths (the
JAX package checks its own against finite differences,
tests/test_render_reference.py:74).  Here the port's autograd gradients of
an image loss, on every leaf, against `jax.grad` of the JAX package's
`render_rays` on the same scene and rays: within 1e-5 of each leaf's
largest |grad|.  Then the same central-difference probe as the JAX test
(f32, eps 3e-4 relative, rtol 5e-2, atol 1e-5, the two largest-|grad|
coordinates of every leaf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.render.reference import render_rays as jax_render_rays
from gvrt_tpu_torch.models.gaussians import LEAVES
from gvrt_tpu_torch.render.reference import render_image, render_rays

from port_scenes import camera, carry, jax_scene, torch_cfg
from port_scenes import one_torch_thread  # noqa: F401 (autouse)


def _scene(n, seed):
    return jax_scene(n, seed=seed, scale_range=(-3.0, -1.5))


def _rays(cam):
    o, d = cam.rays()
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _loss(out):
    return (out["rgb"] ** 2).sum() + 1e-2 * out["depth"].sum()


@pytest.mark.parametrize("degree", [4, 2], ids=["degree4", "degree2"])
def test_brute_force_grads_match_jax(degree):
    cfg = g3.DEFAULT_CONFIG.replace(kernel_degree=degree)
    jm = _scene(48, seed=8)
    o, d = _rays(camera(12))
    want = jax.grad(lambda m: _loss(jax_render_rays(
        m.activate(), jnp.asarray(o), jnp.asarray(d), cfg)))(jm)
    tm = carry(jm)
    _loss(render_rays(tm.activate(), torch.from_numpy(o),
                      torch.from_numpy(d), torch_cfg(cfg))).backward()
    for k in LEAVES:
        w = np.asarray(getattr(want, k))
        scale = np.abs(w).max()
        assert scale > 0, k
        np.testing.assert_allclose(getattr(tm, k).grad.numpy(), w, rtol=0,
                                   atol=1e-5 * scale, err_msg=k)


def test_render_image_is_differentiable_only_when_asked():
    tm = carry(_scene(24, seed=9))
    cam = camera(8)
    out = render_image(tm, cam, device="cpu")
    assert out["rgb"].requires_grad
    with torch.no_grad():
        plain = render_image(tm, cam, device="cpu")
    assert not plain["rgb"].requires_grad
    torch.testing.assert_close(out["rgb"].detach(), plain["rgb"], rtol=0,
                               atol=0)
    _loss(out).backward()
    assert all(getattr(tm, k).grad is not None for k in LEAVES)


def test_finite_difference_gradients():
    """tests/test_render_reference.py:74's probe on the port."""
    tm = carry(_scene(12, seed=4))
    cam = camera(8)
    o, d = (torch.from_numpy(x) for x in _rays(cam))
    cfg = gt.DEFAULT_CONFIG

    def loss(m):
        return _loss(render_rays(m.activate(), o, d, cfg))

    loss(tm).backward()
    with torch.no_grad():
        f0 = float(loss(tm))
    assert f0 > 0
    checked = 0
    for field in LEAVES:
        param = getattr(tm, field)
        g_arr = param.grad.numpy().astype(np.float64)
        base = param.detach().clone()
        for fi in np.argsort(-np.abs(g_arr).ravel())[:2]:
            idx = np.unravel_index(fi, g_arr.shape)
            eps = 3e-4 * max(1.0, abs(float(base[idx])))
            vals = []
            for sign in (1.0, -1.0):
                with torch.no_grad():
                    param.copy_(base)
                    param[idx] += sign * eps
                    vals.append(float(loss(tm)))
            with torch.no_grad():
                param.copy_(base)
            fd = (vals[0] - vals[1]) / (2 * eps)
            an = g_arr[idx]
            if abs(fd) < 1e-7 and abs(an) < 1e-7:
                continue
            np.testing.assert_allclose(an, fd, rtol=5e-2, atol=1e-5,
                                       err_msg=f"grad mismatch at "
                                               f"{field}{idx}")
            checked += 1
    assert checked >= 6
