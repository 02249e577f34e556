"""PyTorch port, the combined Gaussian-and-mesh render (render/combined.py)
against the JAX package on the CPU.

The JAX side runs its Gaussian pass with impl="scan", as tests/
test_combined.py does; the port's runs the plain versions of the kernels
(its wrappers take them for CPU tensors).  Both bin for themselves, on
clipped rays: hit counts must be equal on every pixel, the images within
1e-5 (depth 1e-4: distances of a few units).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.hybrid.mesh import Light, Material, MeshScene, _quad
from gvrt_tpu.hybrid.pipeline import HybridConfig as JaxHybridConfig
from gvrt_tpu.render import combined as jcomb
from gvrt_tpu.render.binning import plan_capacity as jax_plan_capacity
from gvrt_tpu.render.binning import tile_rays as jax_tile_rays
from gvrt_tpu.render.tiled import _camera_mats
from gvrt_tpu_torch.hybrid.pipeline import HybridConfig
from gvrt_tpu_torch.render import combined as tcomb

from port_scenes import (assert_grad_close, carry, one_torch_thread,  # noqa: F401
                         torch_cfg)

CFG = g3.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=32)
TCFG = torch_cfg(CFG)
JHCFG = JaxHybridConfig(reflection=False, refraction=False, shadow_rays=False)
HCFG = HybridConfig(reflection=False, refraction=False, shadow_rays=False)
KEYS = ("rgb", "gaussian_rgb", "mesh_rgb", "mesh_t", "depth",
        "transmittance", "hit_count")


def _wall_scene(z=-2.0):
    """tests/test_combined.py's camera-facing white wall over the left half
    of the image."""
    s = MeshScene()
    white = Material(base_color=(1.0, 1.0, 1.0, 1.0), metallic=0.0,
                     roughness=1.0, emissive=(0.5, 0.5, 0.5))
    pos, idx = _quad([-5, -5, z], [-5, 5, z], [0, 5, z], [0, -5, z])
    s.add_object("wall", pos, idx, white)
    s.lights.append(Light(position=(0.0, 0.0, 0.0), color=(1, 1, 1),
                          radius=50.0))
    return s


def _lit_wall_scene():
    """tests/test_combined.py's wall with a +z normal, lit from the front
    left (its Gaussian-shadow scene)."""
    s = MeshScene()
    white = Material(base_color=(1.0, 1.0, 1.0, 1.0), metallic=0.0,
                     roughness=1.0, emissive=(0.1, 0.1, 0.1))
    pos, idx = _quad([-5, -5, -4.0], [0, -5, -4.0], [0, 5, -4.0],
                     [-5, 5, -4.0])
    s.add_object("wall", pos, idx, white)
    s.lights.append(Light(position=(-2.0, 0.0, -1.0), color=(1, 1, 1),
                          radius=50.0))
    return s


def _gaussians(z=-3.0, n=60):
    model = g3.random_gaussians(jax.random.key(2), n, extent=0.8,
                                scale_range=(-3.5, -2.5))
    model.means = model.means.at[:, 2].add(z)
    return model


def _blob(opacity_logit=6.0, mean=(-1.5, 0.0, -2.5), scale=-1.6):
    return g3.GaussianModel(
        means=jnp.asarray([mean], jnp.float32),
        scales_log=jnp.full((1, 3), scale),
        quats=jnp.asarray([[1.0, 0, 0, 0]]),
        opacity_logit=jnp.asarray([opacity_logit]),
        sh_dc=jnp.zeros((1, 3)),
        sh_rest=jnp.zeros((1, 15, 3)),
    )


def _np(out):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in out.items()}


def _assert_outputs_close(got, want):
    assert int(got["overflow"]) == 0 and int(want["overflow"]) == 0
    np.testing.assert_array_equal(got["hit_count"], want["hit_count"])
    np.testing.assert_array_equal(np.isinf(got["mesh_t"]),
                                  np.isinf(want["mesh_t"]))
    for k in KEYS:
        atol = 1e-4 if k in ("depth", "mesh_t") else 1e-5
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=1e-6,
                                   err_msg=k)


# (gaussians' z, count, scene, gaussian_shadows): the cloud behind the wall
# (the march is clipped there), in front of it (composited over it), and
# the lit wall with Gaussian shadows on
CASES = {
    "behind": (-3.0, 60, _wall_scene, False),
    "in_front": (-1.0, 200, _wall_scene, False),
    "shadows": (-2.5, 120, _lit_wall_scene, True),
}


@pytest.fixture(scope="module")
def frames():
    """Both packages' frames of every case at 32^2."""
    cam = g3.Camera.from_fovy(32, 32, 60.0, np.eye(4))
    out = {}
    for name, (z, n, scene_fn, shadows) in CASES.items():
        jm = _gaussians(z=z, n=n)
        scene = scene_fn()
        hj = JaxHybridConfig(reflection=False, refraction=False,
                             shadow_rays=shadows)
        cap = _capacity(jm, cam)
        want = jax.jit(lambda m: jcomb.render_combined(
            m, scene, cam, CFG, hj, impl="scan", capacity=cap,
            gaussian_shadows=shadows))(jm)
        got = tcomb.render_combined(
            carry(jm), scene, cam, TCFG,
            HybridConfig(reflection=False, refraction=False,
                         shadow_rays=shadows), gaussian_shadows=shadows)
        out[name] = (_np(got), _np(want), cam, jm)
    return out


def _capacity(jm, cam):
    """JAX's capacity plan (the jitted JAX render needs it given)."""
    w2c, proj = _camera_mats(cam)
    return tuple(int(c) for c in jax_plan_capacity(
        jm.activate(), w2c, proj, cam.width, cam.height, CFG))


@pytest.mark.parametrize("name", list(CASES))
def test_render_combined_matches_jax(frames, name):
    got, want, _, _ = frames[name]
    _assert_outputs_close(got, want)
    assert np.isfinite(got["mesh_t"]).any() and np.isinf(got["mesh_t"]).any()


def test_mesh_occludes_gaussians_behind(frames):
    """tests/test_combined.py:45-62 on the port: the wall's pixels march
    nothing, the open half renders as the Gaussians alone."""
    got, _, cam, jm = frames["behind"]
    left = got["mesh_t"][:, :14] < np.inf
    assert left.mean() > 0.9
    assert got["hit_count"][:, :14][left].max() == 0
    assert got["rgb"][:, :14][left].min() > 0.2
    alone = _np(gt.render.render_image_tiled(carry(jm), cam, TCFG,
                                             device="cpu"))
    np.testing.assert_allclose(got["rgb"][:, 20:], alone["rgb"][:, 20:],
                               atol=1e-5)
    # off the wall the clip changes nothing: the counts equal the
    # unclipped frame's there
    np.testing.assert_array_equal(got["hit_count"][:, 20:],
                                  alone["hit_count"][:, 20:])


def test_gaussians_in_front_composite_over_mesh(frames):
    got, _, _, _ = frames["in_front"]
    assert got["hit_count"][:, :14].max() > 0
    np.testing.assert_allclose(
        got["rgb"], got["gaussian_rgb"]
        + got["transmittance"][..., None] * got["mesh_rgb"], atol=1e-6)


def test_gaussian_shadows_darken_mesh(frames):
    """gaussian_shadows=True removes light from some wall pixels and adds
    none (tests/test_combined.py:126-167, on the port)."""
    got, _, cam, jm = frames["shadows"]
    base = _np(tcomb.render_combined(carry(jm), _lit_wall_scene(), cam, TCFG,
                                     HCFG.replace(shadow_rays=True)))
    on_wall = np.isfinite(base["mesh_t"])
    diff = (base["mesh_rgb"] - got["mesh_rgb"]).sum(-1)
    assert diff.min() >= -1e-6
    shadowed = (diff > 1e-3) & on_wall
    assert 0 < shadowed.sum() < on_wall.sum()


def test_combined_gradients_match_jax():
    """The gradient of mean rgb through the clipped march, all six
    parameter groups, against jax.grad of the scan path."""
    cam = g3.Camera.from_fovy(16, 16, 60.0, np.eye(4))
    jm = _gaussians(z=-1.0, n=50)
    scene = _wall_scene(z=-2.0)
    cap = _capacity(jm, cam)

    def jloss(m):
        out = jcomb.render_combined(m, scene, cam, CFG, JHCFG, impl="scan",
                                    capacity=cap)
        return jnp.mean(out["rgb"])

    want = jax.jit(jax.grad(jloss))(jm)
    tm = carry(jm)
    out = tcomb.render_combined(tm, scene, cam, TCFG, HCFG, capacity=cap)
    out["rgb"].mean().backward()
    for k in gt.models.gaussians.LEAVES:
        assert_grad_close(getattr(tm, k).grad.numpy(),
                          np.asarray(getattr(want, k)), k)
    assert float(tm.means.grad.norm()) > 0


@pytest.mark.parametrize("chunk", [512, 7])
def test_gaussian_shadow_transmittance_matches_jax(chunk):
    """One opaque Gaussian and a random cloud: the transmittance along
    point -> light segments within 1e-5 relative of JAX's, at two chunk
    sizes (the sum is order-independent per point)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    pts[:3] = [[0.0, 0.0, -2.0], [3.0, 0.0, 3.0], [0.0, 0.0, 1.0]]
    light = np.asarray([0.0, 0.0, 3.0], np.float32)
    for jm in (_blob(4.0, (0.0, 0.0, 0.0), -1.2),
               _gaussians(z=0.0, n=900)):
        want = np.asarray(jcomb.gaussian_shadow_transmittance(
            jm.activate(), jnp.asarray(pts), jnp.asarray(light), CFG,
            chunk=chunk))
        got = tcomb.gaussian_shadow_transmittance(
            carry(jm).activate(), torch.from_numpy(pts),
            torch.from_numpy(light), TCFG, chunk=chunk).detach().numpy()
        # 1e-5 relative: an ulp of alpha (XLA's exp against torch's) is
        # scaled by 1 / (1 - alpha), up to 100 at max_alpha, in log1p
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert want.min() < 0.05
    # the semantics of tests/test_combined.py:95-123: blocked, clear
    t = tcomb.gaussian_shadow_transmittance(
        carry(_blob(4.0, (0.0, 0.0, 0.0), -1.2)).activate(),
        torch.from_numpy(pts[:3]), torch.from_numpy(light), TCFG).detach().numpy()
    assert t[0] < 0.1 and t[1] > 0.999 and t[2] > 0.999


def test_shadow_pass_blocks_points(monkeypatch):
    """Points taken in blocks give the unblocked sums (to 1e-6 relative:
    the CPU's vector and scalar paths of exp and log1p differ in the last
    bit, and blocking moves points between them)."""
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.uniform(-1, 1, (257, 3)).astype(np.float32))
    act = carry(_gaussians(z=0.0, n=300)).activate()
    light = torch.tensor([0.0, 0.5, 2.0])
    whole = tcomb.gaussian_shadow_transmittance(act, pts, light, TCFG,
                                                chunk=64)
    monkeypatch.setattr(tcomb, "_SHADOW_PAIRS", 64 * 10)
    blocked = tcomb.gaussian_shadow_transmittance(act, pts, light, TCFG,
                                                  chunk=64)
    torch.testing.assert_close(blocked, whole, rtol=1e-6, atol=0.0)


def test_tile_rays_clip_matches_jax():
    """tile_rays(tmax_clip=) against JAX's: a clip with finite and inf
    entries, some below the AABB's tmax; only tmax (row 7) changes, and an
    all-inf clip or none gives the unclipped rays bit for bit."""
    cam = g3.Camera.from_fovy(32, 16, 50.0, np.eye(4))
    clip = np.random.default_rng(5).uniform(0.5, 6.0, (16, 32)) \
        .astype(np.float32)
    clip[::3] = np.inf
    want = np.asarray(jax_tile_rays(cam, CFG, tmax_clip=jnp.asarray(clip)))
    got = gt.render.binning.tile_rays(cam, TCFG, "cpu",
                                      tmax_clip=torch.from_numpy(clip))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    plain = gt.render.binning.tile_rays(cam, TCFG, "cpu")
    assert torch.equal(gt.render.binning.tile_rays(
        cam, TCFG, "cpu", tmax_clip=torch.full((16, 32), float("inf"))),
        plain)
    rows = [r for r in range(plain.shape[1]) if r != 7]
    assert torch.equal(got[:, rows], plain[:, rows])
    assert bool((got[:, 7] <= plain[:, 7]).all())
    assert bool((got[:, 7] < plain[:, 7]).any())
    # the pose path's in-graph rows take no clip
    o, d = (torch.from_numpy(np.ascontiguousarray(x)) for x in cam.rays())
    assert torch.equal(gt.render.binning.tile_ray_rows(o, d, TCFG), plain)


def test_render_combined_runs_on_the_models_device():
    """The model's device decides; a CPU model never reaches for CUDA, and
    dataclasses stay as the JAX package has them."""
    jf = {f.name: f.default for f in dataclasses.fields(JaxHybridConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(HybridConfig)}
    assert set(jf) == set(tf)
    for k in jf:
        if k != "attenuation":
            assert jf[k] == tf[k], k
    assert dataclasses.asdict(jf["attenuation"]) == dataclasses.asdict(
        tf["attenuation"])
    out = tcomb.render_combined(carry(_gaussians(n=20)), _wall_scene(),
                                g3.Camera.from_fovy(16, 16, 60.0, np.eye(4)),
                                TCFG, HCFG)
    assert all(v.device.type == "cpu" for v in out.values()
               if isinstance(v, torch.Tensor))
