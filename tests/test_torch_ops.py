"""PyTorch port, ops and config: elementwise parity with the JAX package.

Same inputs (made with NumPy from a seed) go through both packages on the
CPU.  Tolerance rtol=2e-6: the two frameworks reach exp/log/pow through
different libm paths (a few ulp), everything else is the same f32 op order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt

RTOL = 2e-6


def _both(fn_jax, fn_torch, *arrays):
    a = fn_jax(*(jnp.asarray(x) for x in arrays))
    b = fn_torch(*(torch.from_numpy(np.array(x)) for x in arrays))
    return np.asarray(a), b.numpy()


def test_config_and_constants_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(g3.RenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(gt.RenderConfig)}
    assert jf == tf
    assert gt.DEFAULT_CONFIG.tile_size == 16 and gt.DEFAULT_CONFIG.chunk_size == 64
    assert gt.DEFAULT_CONFIG.transmittance_prod is True
    for name in ("SH_C0", "SH_C1", "SH_C2", "SH_C3", "SH_MAX_NUM_COEFFS"):
        assert getattr(g3.config, name) == getattr(gt.config, name), name


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4, 5, 8])
def test_particle_response_matches_jax(degree):
    gd = np.random.default_rng(degree).uniform(0.0, 12.0, 4096).astype(np.float32)
    a, b = _both(lambda x: g3.ops.particle_response(x, degree),
                 lambda x: gt.ops.particle_response(x, degree), gd)
    # degree 0 is 1 + s*sqrt(gd): XLA contracts it into one FMA, so the two
    # packages may differ by one ulp of 1.0 where the sum cancels
    np.testing.assert_allclose(b, a, rtol=RTOL,
                               atol=2.0 ** -23 if degree == 0 else 0.0)


@pytest.mark.parametrize("degree,adaptive", [(4.0, False), (2.0, True),
                                             (0.0, False), (-2.0, False)])
def test_kernel_scale_matches_jax(degree, adaptive):
    dens = np.random.default_rng(1).uniform(0.01, 1.0, 2048).astype(np.float32)
    a, b = _both(lambda x: g3.ops.kernel_scale(x, 0.0113, degree, adaptive),
                 lambda x: gt.ops.kernel_scale(x, 0.0113, degree, adaptive),
                 dens)
    np.testing.assert_allclose(b, a, rtol=RTOL)


def test_quaternions_match_jax():
    q = np.random.default_rng(2).normal(size=(4096, 4)).astype(np.float32)
    q[:, 0] += 2.0
    a, b = _both(g3.ops.normalize_quat, gt.ops.normalize_quat, q)
    np.testing.assert_allclose(b, a, rtol=RTOL)
    a, b = _both(lambda x: g3.ops.quaternion.quat_to_rot9(x),
                 gt.ops.quat_to_rot9, a)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(
        gt.ops.quat_to_rotmat(torch.from_numpy(q)).numpy(),
        np.asarray(g3.ops.quat_to_rotmat(jnp.asarray(q))), rtol=RTOL,
        atol=1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_basis_components_match_jax(degree):
    d = np.random.default_rng(3).normal(size=(3, 2048)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    a = g3.ops.sh.sh_basis_components(*(jnp.asarray(c) for c in d), degree)
    b = gt.ops.sh_basis_components(*(torch.from_numpy(c) for c in d), degree)
    assert len(a) == len(b) == (degree + 1) ** 2
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=RTOL,
                                   atol=1e-7)


def test_radiance_from_sh_matches_jax():
    rng = np.random.default_rng(4)
    coeffs = rng.normal(size=(512, 16, 3)).astype(np.float32) * 0.3
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a, b = _both(g3.ops.radiance_from_sh, gt.ops.radiance_from_sh, coeffs, d)
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_intersect_aabb_matches_jax():
    rng = np.random.default_rng(5)
    o = rng.uniform(-150, 150, size=(4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[::7, 1] = 0.0                      # axis-parallel rays hit the clamp
    d[::11, 2] = -1e-8
    aabb = g3.DEFAULT_CONFIG.aabb
    (a0, a1), (b0, b1) = (g3.ops.intersect_aabb(aabb, jnp.asarray(o),
                                                jnp.asarray(d)),
                          gt.ops.intersect_aabb(aabb, torch.from_numpy(o),
                                                torch.from_numpy(d)))
    np.testing.assert_allclose(b0.numpy(), np.asarray(a0), rtol=RTOL)
    np.testing.assert_allclose(b1.numpy(), np.asarray(a1), rtol=RTOL)


@pytest.mark.parametrize("radius", ["scalar", "per_gaussian"])
def test_gaussian_world_aabb_matches_jax(radius):
    rng = np.random.default_rng(6)
    means = rng.normal(size=(1024, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(-5, -1, (1024, 3))).astype(np.float32)
    q = rng.normal(size=(1024, 4)).astype(np.float32)
    rot = np.array(g3.ops.quat_to_rotmat(g3.ops.normalize_quat(
        jnp.asarray(q))))
    r = (np.float32(3.0) if radius == "scalar"
         else rng.uniform(1, 4, 1024).astype(np.float32))
    want = g3.ops.gaussian_world_aabb(jnp.asarray(means), jnp.asarray(scales),
                                      jnp.asarray(rot), jnp.asarray(r))
    got = gt.ops.gaussian_world_aabb(torch.from_numpy(means),
                                     torch.from_numpy(scales),
                                     torch.from_numpy(rot),
                                     torch.as_tensor(r))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=1e-7)
    assert bool((got[0] < got[1]).all())


def test_scene_aabb_matches_jax():
    jm = g3.random_gaussians(jax.random.key(7), 500, extent=1.3)
    tm = gt.GaussianModel.from_numpy(
        {k: np.asarray(getattr(jm, k)) for k in gt.models.gaussians.LEAVES},
        device="cpu")
    for a, b in zip(jm.scene_aabb(), tm.scene_aabb()):
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
