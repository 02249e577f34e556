"""PyTorch port, the module that holds the tile kernel (render/pallas_forward.py).

The port's plain version of the fused forward composite is fed the SAME
topology and chunks as the JAX package (built by JAX binning, carried as
NumPy), so binning cannot mask the comparison.  Bounds are those of
tests/test_tiled.py:94-106: rgb and transmittance 1e-5, depth 1e-4, hit
counts exact.  The CUDA kernel itself is checked on the card only
(tests/test_torch_cuda.py).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
from gvrt_tpu.render import binning as jb
from gvrt_tpu.render import pallas_forward as jpf
from gvrt_tpu.render import tile_math as jtm
from gvrt_tpu.render.tiled import _camera_mats
from gvrt_tpu_torch.config import resolve_impl
from gvrt_tpu_torch.ops.kernels import particle_response
from gvrt_tpu_torch.render import binning as tb
from gvrt_tpu_torch.render import pallas_forward as tpf
from gvrt_tpu_torch.render import tile_math as ttm
from gvrt_tpu_torch.render.tiled import TiledRenderer

from port_scenes import CFG_T8, camera, jax_scene, torch_cfg


#: one static capacity per binning config (and one scene size), so every
#: scene of a config shares one compiled JAX binning pass; T8 scenes need < 3000 pair slots, so the
#: tail of their chunk array is dead trailing chunks
CAPACITY = {CFG_T8: (8192, 8192), g3.DEFAULT_CONFIG: (8192, 16384)}
_jax_reference = jax.jit(jpf.forward_tiles_reference, static_argnames="cfg")


def _carry_binned(b):
    """JAX BinnedScene -> the port's, without the gradient-reduce plan."""
    return tb.BinnedScene(*(torch.from_numpy(np.array(x)) for x in b[:-1]),
                          red=None)


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX binned scene, JAX rays, carried scene, carried rays, cfg)."""
    kw, res, fov, cfg = SCENES[name]
    model = jax_scene(**kw)
    if name == "saturated":
        model.opacity_logit = model.opacity_logit + 6.0
    cam = camera(res, fov)
    bin_cfg = cfg.replace(transmittance_prod=True)
    w2c, proj = _camera_mats(cam)
    b = jb.bin_gaussians(model.activate(), w2c, proj, res, res, bin_cfg,
                         *CAPACITY[bin_cfg])
    assert int(b.overflow) == 0
    rays = jb.tile_rays(cam, cfg)
    return b, rays, _carry_binned(b), torch.from_numpy(np.array(rays)), cfg


def _assert_acc_close(got, want):
    np.testing.assert_allclose(got[:, 0:3], want[:, 0:3], atol=1e-5)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-5)
    np.testing.assert_allclose(got[:, 3], want[:, 3], atol=1e-4)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])


@pytest.mark.parametrize("prod", [True, False], ids=["prod", "logspace"])
def test_chunk_core_and_update_match_jax(prod):
    """Random chunks of a real scene's parameter rows against real rays."""
    cfg = g3.DEFAULT_CONFIG.replace(transmittance_prod=prod)
    tcfg = torch_cfg(cfg)
    model = jax_scene(400, seed=7)
    rows = np.array(jb.param_rows(model.activate(), cfg))
    rays = np.array(jb.tile_rays(camera(64), cfg))
    rng = np.random.default_rng(0)
    for tile in (5, 6, 9, 10):
        # depth order does not matter to the per-chunk math; the dummy row
        # (identity frame, zero density) stands in for padding slots
        chunk = rows[rng.integers(0, rows.shape[0], cfg.chunk_size)]
        ray_blk = rays[tile]
        r = ray_blk.shape[1]
        t_in = rng.uniform(0.0005, 1.0, (1, r)).astype(np.float32)
        want = jtm.chunk_core(jnp.asarray(ray_blk), jnp.asarray(chunk),
                              jnp.asarray(t_in), cfg)
        got = ttm.chunk_core(torch.from_numpy(ray_blk),
                             torch.from_numpy(chunk),
                             torch.from_numpy(t_in), tcfg)
        for x, y in zip(want, got):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-5)
        acc = np.array(jtm.init_acc(r))
        acc[4] = t_in[0]
        acc[:3] = rng.uniform(0, 1, (3, r))
        want = jtm.chunk_update(jnp.asarray(ray_blk), jnp.asarray(chunk),
                                jnp.asarray(acc), cfg)
        got = ttm.chunk_update(torch.from_numpy(ray_blk),
                               torch.from_numpy(chunk),
                               torch.from_numpy(acc), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


SCENES = {
    # name: (jax model kwargs, resolution, fov, cfg); every T8 scene ends in
    # dead trailing chunks (CAPACITY)
    "t8_g128": (dict(n=300, seed=1), 32, 60.0, CFG_T8),
    "default_logspace": (dict(n=300, seed=2), 32, 60.0,
                         g3.DEFAULT_CONFIG.replace(transmittance_prod=False)),
    "default": (dict(n=300, seed=3), 32, 60.0, g3.DEFAULT_CONFIG),
    # a tiny cluster: most tiles own no chunk
    "empty_tiles": (dict(n=300, seed=5, spread=0.05), 32, 60.0, CFG_T8),
    # large, nearly opaque gaussians filling the view: tiles saturate and
    # skip the rest of their runs.  Scales ~0.15 keep b = M mean small: the
    # cancellation in gro = M o - b, which XLA rounds with FMAs and torch
    # without, then stays far below the 1e-5 bound.
    "saturated": (dict(n=300, seed=6, spread=0.6, scale_range=(-2.2, -1.6)),
                  32, 15.0, CFG_T8),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_forward_tiles_reference_matches_jax_scan(name):
    b, rays, tbinned, trays, cfg = _scene(name)
    want = np.asarray(_jax_reference(b, rays, cfg=cfg))
    got = tpf.forward_tiles_reference(tbinned, trays, torch_cfg(cfg)).numpy()
    _assert_acc_close(got, want)
    ct, nt = np.asarray(b.chunk_tile), rays.shape[0]
    counts = np.asarray(b.tile_counts)
    if cfg is CFG_T8:
        assert (ct == nt).sum() > 0                     # dead trailing chunks
    if name == "empty_tiles":
        empty = counts == 0
        assert empty.sum() > nt // 2
        np.testing.assert_array_equal(
            got[empty], np.broadcast_to(np.asarray(ttm.BACKGROUND)[:, None],
                                        got[empty].shape))
    if name == "saturated":
        saturated = got[:, 4].max(axis=1) <= cfg.min_transmittance
        assert saturated.sum() > nt // 2
        # saturated tiles stop before the end of their chunk runs
        assert (-(-counts[saturated] // cfg.chunk_size)).max() > 1


def test_forward_tiles_reference_matches_interpreted_pallas():
    """One tiny case through the Pallas kernel itself (interpret mode)."""
    cfg = CFG_T8
    model = jax_scene(60, seed=8)
    cam = camera(16)
    w2c, proj = _camera_mats(cam)
    b = jb.bin_gaussians(model.activate(), w2c, proj, 16, 16, cfg, 1024, 1024)
    rays = jb.tile_rays(cam, cfg)
    tbinned, trays = _carry_binned(b), torch.from_numpy(np.array(rays))
    want = np.asarray(jpf.forward_tiles(b, rays, cfg, interpret=True))
    got = tpf.forward_tiles_reference(tbinned, trays, torch_cfg(cfg)).numpy()
    _assert_acc_close(got, want)


def test_tile_forward_on_cpu_is_the_plain_version():
    _, _, tbinned, trays, cfg = _scene("t8_g128")
    cfg = torch_cfg(cfg)
    before = tpf.tile_forward.launches
    got = tpf.tile_forward(tbinned.chunks, trays, tbinned.tile_counts, cfg)
    assert tpf.tile_forward.launches == before
    torch.testing.assert_close(
        got, tpf.forward_tiles_reference(tbinned, trays, cfg), rtol=0, atol=0)


def test_impl_cuda_on_cpu_tensors_raises():
    _, _, tbinned, trays, cfg = _scene("t8_g128")
    cfg = torch_cfg(cfg)
    with pytest.raises(ValueError, match="CUDA"):
        tpf.forward_dispatch(tbinned, trays, cfg, "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        resolve_impl("cuda", torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        TiledRenderer(16, 16, cfg, impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        tpf.forward_dispatch(tbinned, trays, cfg, "pallas")
    assert resolve_impl("auto", torch.device("cpu")) == "torch"


@pytest.mark.parametrize("degree", [8, 5, 4, 3, 2, 1, 0])
def test_response_cutoff_is_conservative(degree):
    """The kernel skips a pair whose gray distance is at least the wrapper's
    D_hi up to three f32 roundings.  D_hi lies within 1e-3 above the exact
    cutoff (the skip has teeth), and the plain f32 response from just below
    D_hi to 1e-3 above it stays 8 ulp under the gate (the card's expf is
    within 2 ulp), so no skipped pair would have been accepted."""
    h = torch_cfg(g3.DEFAULT_CONFIG).hit_min_response
    d_hi = tpf.response_cutoff(degree, h)
    lo, hi = 0.0, 100.0  # the exact cutoff, by bisection in float64
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        resp = float(particle_response(torch.tensor(mid, dtype=torch.float64),
                                       degree))
        lo, hi = (mid, hi) if resp > h else (lo, mid)
    assert hi <= d_hi <= hi * (1.0 + 1e-3)
    first = np.float32(d_hi * (1.0 - 4 * 2.0 ** -23)).view(np.int32) - 1
    last = np.float32(d_hi * (1.0 + 1e-3)).view(np.int32)
    gray = np.arange(first, last + 1, dtype=np.int32).view(np.float32)
    resp = particle_response(torch.from_numpy(gray), degree)
    assert resp.dtype == torch.float32 and len(gray) > 1000
    gate = (np.float32(h).view(np.int32) - 8).view(np.float32)
    assert float(resp.max()) <= gate
    for off in (0.0, -1.0, 1.0):  # no positive gate below 1: no skip
        assert tpf.response_cutoff(degree, off) == math.inf
