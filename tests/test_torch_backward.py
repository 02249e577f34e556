"""PyTorch port, the backward of the tile composite (render/tile_math.py,
render/pallas_vjp.py) against the JAX package.

`chunk_core_bwd` is held against JAX's on the same chunk rows, rays and
cotangents; the plain backward of `render_tiles_ad` (the plain version of
K2, with the plain forward residual) against the VJP of JAX's
`render_tiles_ad` run through the Pallas kernels in interpret mode, on the
same binned scene carried as NumPy.  Tolerance: per output, atol =
max(2e-5 * scale, 1e-7) and rtol = 2e-4 with `scale` its max |value|
(tests/test_backward.py:53-58).  The K2 kernel itself is checked on the card
(tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
from gvrt_tpu.render import binning as jb
from gvrt_tpu.render import pallas_vjp as jpv
from gvrt_tpu.render import tile_math as jtm
from gvrt_tpu.render.tiled import _camera_mats
from gvrt_tpu_torch.render import pallas_forward as tpf
from gvrt_tpu_torch.render import pallas_vjp as tpv
from gvrt_tpu_torch.render import tile_math as ttm

from port_scenes import CFG_T8, assert_grad_close, camera, jax_scene, torch_cfg


@functools.lru_cache(maxsize=None)
def _rows_and_rays():
    cfg = g3.DEFAULT_CONFIG
    model = jax_scene(400, seed=7, scale_range=(-2.3, -1.6))
    rows = np.array(jb.param_rows(model.activate(), cfg))
    rays = np.array(jb.tile_rays(camera(64), cfg))
    return rows, rays


@pytest.mark.parametrize("ray_grads", [False, True], ids=["params", "rays"])
@pytest.mark.parametrize("degree", [2, 4, 8])
@pytest.mark.parametrize("prod", [True, False], ids=["prod", "logspace"])
def test_chunk_core_bwd_matches_jax(prod, degree, ray_grads):
    cfg = g3.DEFAULT_CONFIG.replace(transmittance_prod=prod,
                                    kernel_degree=degree,
                                    ray_gradients=ray_grads)
    rows, rays = _rows_and_rays()
    rng = np.random.default_rng(degree)
    r = rays.shape[2]
    # a chunk of rows around the tile's centre gaussians; the dummy row
    # (identity frame, zero density) stands in for padding slots
    chunk = rows[rng.integers(0, rows.shape[0], cfg.chunk_size)]
    ray_blk = rays[9]
    t_in = rng.uniform(0.0005, 1.0, (1, r)).astype(np.float32)
    bar_tout = rng.normal(size=(1, r)).astype(np.float32)
    bar_rgb = rng.normal(size=(3, r)).astype(np.float32)
    bar_dep = rng.normal(size=(1, r)).astype(np.float32)
    want = jtm.chunk_core_bwd(*(jnp.asarray(x) for x in (
        ray_blk, chunk, t_in, bar_tout, bar_rgb, bar_dep)), cfg)
    got = ttm.chunk_core_bwd(*(torch.from_numpy(x) for x in (
        ray_blk, chunk, t_in, bar_tout, bar_rgb, bar_dep)), torch_cfg(cfg))
    assert len(got) == len(want) == (3 if ray_grads else 2)
    groups = {"M": slice(0, 9), "b": slice(9, 12), "density": slice(12, 13),
              "pad": slice(13, 16), "sh": slice(16, 64)}
    for name, cols in groups.items():
        assert_grad_close(got[0][:, cols].numpy(), np.asarray(want[0])[:, cols],
                          name)
    assert np.abs(np.asarray(want[0])[:, 0:13]).max() > 0
    assert_grad_close(got[1].numpy(), want[1], "bar_tin")
    if ray_grads:
        assert_grad_close(got[2].numpy(), want[2], "bar_rays")
        assert np.abs(np.asarray(want[2])[8:]).max() > 0


SCENES = {
    # name: (jax model kwargs, resolution, field of view, cfg)
    "t8_prod": (dict(n=120, seed=21, scale_range=(-2.3, -1.8)), 16, 60.0,
                CFG_T8),
    "t8_logspace_raygrad": (dict(n=120, seed=22, scale_range=(-2.3, -1.8)),
                            16, 60.0, CFG_T8.replace(transmittance_prod=False,
                                                     ray_gradients=True)),
    # nearly opaque and 32 gaussians per chunk: tiles own runs of several
    # chunks, saturate, and skip the rest of their runs
    "t8_saturated_raygrad": (dict(n=120, seed=23, spread=0.6,
                                  scale_range=(-2.2, -1.6)), 16, 15.0,
                             CFG_T8.replace(chunk_size=32,
                                            ray_gradients=True)),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_tiles_ad_backward_matches_interpreted_pallas(name):
    kw, res, fov, cfg = SCENES[name]
    model = jax_scene(**kw)
    if "saturated" in name:
        model.opacity_logit = model.opacity_logit + 6.0
    cam = camera(res, fov)
    w2c, proj = _camera_mats(cam)
    b = jb.bin_gaussians(model.activate(), w2c, proj, res, res, cfg,
                         1024, 2048)
    assert int(b.overflow) == 0
    rays = jb.tile_rays(cam, cfg)
    num_tiles, _, r = rays.shape
    rng = np.random.default_rng(len(name))
    bar = rng.normal(size=(num_tiles, 8, r)).astype(np.float32)
    bar[:, 5:] = 0.0
    acc_j, vjp = jax.vjp(
        lambda ch, ry: jpv.render_tiles_ad(cfg, True, ch, ry, b.chunk_tile),
        b.chunks, rays)
    bar_pad = np.concatenate([bar, np.zeros_like(bar[:1])])
    want_chunks, want_rays = vjp(jnp.asarray(bar_pad))

    chunks = torch.from_numpy(np.array(b.chunks)).requires_grad_()
    trays = torch.from_numpy(np.array(rays)).requires_grad_()
    counts = torch.from_numpy(np.array(b.tile_counts))
    acc = tpv.render_tiles_ad(chunks, trays, counts, torch_cfg(cfg), "torch")
    acc.backward(torch.from_numpy(bar))
    has = np.asarray(b.tile_counts) > 0
    np.testing.assert_allclose(acc.detach().numpy()[has],
                               np.asarray(acc_j)[:num_tiles][has], atol=1e-5)
    assert_grad_close(chunks.grad.numpy(), want_chunks, "bar_chunks")
    dead = np.asarray(b.chunk_tile) == num_tiles
    assert dead.any() and not chunks.grad.numpy()[dead].any()
    assert_grad_close(trays.grad.numpy(), want_rays, "bar_rays")
    if cfg.ray_gradients:
        assert np.abs(np.asarray(want_rays)).max() > 0
    else:
        assert not trays.grad.numpy().any()  # the documented silent zero
    if "saturated" in name:
        _, t_in = tpv._forward_residual_plain(chunks.detach(), trays.detach(),
                                              counts, torch_cfg(cfg))
        start, count = tpf.tile_chunk_runs(counts, chunks.shape[0],
                                           cfg.chunk_size)
        sat = [int(s) + k for s, c in zip(start, count) for k in range(int(c))
               if float(t_in[int(s) + k].max()) <= cfg.min_transmittance]
        assert sat and not chunks.grad.numpy()[sat].any()


def test_residual_is_defined_for_every_chunk():
    """T_in of the plain residual: T at each chunk start of a run, the
    saturated T after an early-out, 1 for dead trailing chunks; the
    accumulators equal the serving forward's."""
    kw, res, fov, jcfg = SCENES["t8_saturated_raygrad"]
    cfg = torch_cfg(jcfg)
    model = jax_scene(**kw)
    model.opacity_logit = model.opacity_logit + 6.0
    cam = camera(res, fov)
    w2c, proj = _camera_mats(cam)
    b = jb.bin_gaussians(model.activate(), w2c, proj, res, res, jcfg,
                         1024, 2048)
    chunks = torch.from_numpy(np.array(b.chunks))
    rays = torch.from_numpy(np.array(jb.tile_rays(cam, jcfg)))
    counts = torch.from_numpy(np.array(b.tile_counts))
    acc, t_in = tpf.tile_forward_residual(chunks, rays, counts, cfg)
    torch.testing.assert_close(acc, tpf.tile_forward(chunks, rays, counts,
                                                     cfg), rtol=0, atol=0)
    start, count = tpf.tile_chunk_runs(counts, chunks.shape[0],
                                       cfg.chunk_size)
    dead = np.asarray(b.chunk_tile) == rays.shape[0]
    assert dead.any() and bool((t_in[torch.from_numpy(dead)] == 1).all())
    assert bool((t_in.amax(1) <= cfg.min_transmittance).any())
    for t in range(rays.shape[0]):
        s, c = int(start[t]), int(count[t])
        if c:
            assert bool((t_in[s] == 1).all())
            # T never rises along a run; the last entry bounds T_out
            assert bool((t_in[s + 1:s + c] <= t_in[s:s + c - 1]).all())
            assert bool((acc[t, 4] <= t_in[s + c - 1]).all())
