"""PyTorch port, binning: the pair-list topology agrees with the JAX package.

Scenes are built in JAX and carried across (port_scenes.carry).  Integer
outputs are compared exactly; the within-tile order of `pair_gauss` may
differ only between Gaussians whose quantized depths tie or differ by one
level (a last-ulp difference in the depth key, binning.py:376-387).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gvrt_tpu as g3
from gvrt_tpu.render import binning as jb
from gvrt_tpu.render.tiled import _camera_mats
from gvrt_tpu_torch.render import binning as tb

from port_scenes import CFG_T8, camera, carry, jax_scene, torch_cfg

CASES = {
    # name: (n, seed, res, cfg)
    "t8_g128": (160, 1, 32, CFG_T8),
    "default": (400, 2, 64, g3.DEFAULT_CONFIG),
}


def _setup(case):
    n, seed, res, cfg = CASES[case]
    jm = jax_scene(n, seed=seed)
    cam = camera(res)
    w2c, proj = _camera_mats(cam)
    with torch.no_grad():
        ta = carry(jm).activate()
    return (jm.activate(), ta, np.asarray(w2c),
            np.asarray(proj), cam, cfg, torch_cfg(cfg))


@pytest.mark.parametrize("case", sorted(CASES))
def test_frame_cull_table_and_plan_match_jax(case):
    ja, ta, w2c, proj, cam, cfg, tcfg = _setup(case)
    w, h = cam.width, cam.height
    jt = jb.frame_cull_table(ja, jnp.asarray(w2c), jnp.asarray(proj), w, h, cfg)
    tt = tb.frame_cull_table(ta, w2c, proj, w, h, tcfg)
    for f in ("tx0", "ty0", "tx1", "ty1", "valid"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)), err_msg=f)
    np.testing.assert_allclose(tt.depth.detach().numpy(), np.asarray(jt.depth),
                               rtol=1e-6)
    assert (tb.plan_capacity(ta, w2c, proj, w, h, tcfg)
            == jb.plan_capacity(ja, w2c, proj, w, h, cfg))


def _depth_q(ja, w2c, proj, cam, cfg):
    """JAX-side quantized depth per gaussian (binning.py:376-387)."""
    t = jb.frame_cull_table(ja, jnp.asarray(w2c), jnp.asarray(proj),
                            cam.width, cam.height, cfg)
    depth, valid = np.asarray(t.depth), np.asarray(t.valid)
    num_tiles = (cam.width // cfg.tile_size) * (cam.height // cfg.tile_size)
    bits = min(31 - max(1, (num_tiles + 1).bit_length()), 24)
    dmin, dmax = depth[valid].min(), depth[valid].max()
    scale = np.float32(2.0 ** bits - 2.0) / np.maximum(dmax - dmin, np.float32(1e-9))
    return np.clip((np.maximum(depth - dmin, 0) * scale).astype(np.int64),
                   0, 2 ** bits - 1)


@pytest.mark.parametrize("case,band", [("t8_g128", (0, 1, 0)),
                                       ("default", (0, 1, 0)),
                                       ("default", (1, 2, 0)),
                                       ("default", (1, 1, 2))])
def test_bin_topology_matches_jax(case, band):
    ja, ta, w2c, proj, cam, cfg, tcfg = _setup(case)
    w, h = cam.width, cam.height
    off, stride, count = band
    cap = jb.plan_capacity(ja, w2c, proj, w, h, cfg,
                           band=band if count else band[:2])
    jt = jb.bin_topology(ja, jnp.asarray(w2c), jnp.asarray(proj), w, h, cfg,
                         *cap, row_offset=off, row_stride=stride,
                         row_count=count, capacity_reduce=0)
    tt = tb.bin_topology(ta, w2c, proj, w, h, tcfg, *cap, row_offset=off,
                         row_stride=stride, row_count=count)
    # the reduce plan depends on liveness per pre-sort pair, not on the
    # within-tile order: its block layout and local ids equal JAX's
    for f in ("gloc", "out_idx", "first"):
        np.testing.assert_array_equal(getattr(tt.red, f).numpy(),
                                      np.asarray(getattr(jt.red, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tt.red.slot.numpy() < cap[1],
                                  np.asarray(jt.red.slot) < cap[1])
    for f in ("chunk_tile", "chunk_first", "tile_counts", "num_pairs",
              "overflow", "gauss_offsets", "gauss_counts"):
        x, y = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert y.dtype == np.int32, f
        np.testing.assert_array_equal(y, x, err_msg=f)
    assert int(tt.overflow) == 0 and int(tt.num_pairs) > 50

    # same gaussians per tile, in depth order up to one quantization level
    n, g = ta.means.shape[0], tcfg.chunk_size
    dq = _depth_q(ja, w2c, proj, cam, cfg)
    pj, pt = np.asarray(jt.pair_gauss), tt.pair_gauss.numpy()
    assert pt.shape == pj.shape
    for tile in np.unique(np.asarray(jt.chunk_tile)):
        slots = np.nonzero(np.repeat(np.asarray(jt.chunk_tile) == tile, g))[0]
        a, b = pj[slots], pt[slots]
        a, b = a[a < n], b[b < n]
        assert sorted(a.tolist()) == sorted(b.tolist()), tile
        assert (np.diff(dq[b]) >= -1).all(), tile


@pytest.mark.parametrize("band", [(0, 1), (1, 2)], ids=["full", "stride2"])
def test_bin_gaussians_matches_jax(band):
    """`bin_gaussians` (topology, then the gathered chunks): the same
    integer layout as JAX's, and the same forward composite of its chunks
    (rgb, T within 1e-5, hit counts equal); the reduce plan is built only
    when grad is enabled."""
    from gvrt_tpu.render.pallas_forward import forward_tiles_reference
    from gvrt_tpu_torch.render.pallas_forward import forward_dispatch
    ja, ta, w2c, proj, cam, cfg, tcfg = _setup("default")
    w, h = cam.width, cam.height
    cap = jb.plan_capacity(ja, w2c, proj, w, h, cfg, band=band)
    jbin = jb.bin_gaussians(ja, jnp.asarray(w2c), jnp.asarray(proj), w, h,
                            cfg, *cap, *band)
    with torch.no_grad():
        tbin = tb.bin_gaussians(ta, w2c, proj, w, h, tcfg, *cap, *band)
    assert tbin.red is None
    for f in ("chunk_tile", "chunk_first", "tile_counts", "num_pairs",
              "overflow"):
        np.testing.assert_array_equal(getattr(tbin, f).numpy(),
                                      np.asarray(getattr(jbin, f)), err_msg=f)
    rays = jb.band_rays(cam, cfg, band[1])[band[0]]
    want = np.asarray(forward_tiles_reference(jbin, rays, cfg))
    with torch.no_grad():
        got = forward_dispatch(tbin, torch.from_numpy(np.array(rays)), tcfg,
                               "torch").numpy()
    np.testing.assert_allclose(got[:, [0, 1, 2, 4]], want[:, [0, 1, 2, 4]],
                               atol=1e-5)
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    assert tb.bin_gaussians(ta, w2c, proj, w, h, tcfg, *cap,
                            *band).red is not None


def test_overflow_counts_match_jax():
    ja, ta, w2c, proj, cam, cfg, tcfg = _setup("default")
    cap, cap_pad = jb.plan_capacity(ja, w2c, proj, 64, 64, cfg)
    small = (cap // 2 // 64 * 64, cap_pad // 4 // 64 * 64)
    jt = jb.bin_topology(ja, jnp.asarray(w2c), jnp.asarray(proj), 64, 64, cfg,
                         *small, capacity_reduce=0)
    tt = tb.bin_topology(ta, w2c, proj, 64, 64, tcfg, *small)
    assert int(tt.overflow) == int(jt.overflow) > 0
    np.testing.assert_array_equal(tt.chunk_tile.numpy(),
                                  np.asarray(jt.chunk_tile))


@pytest.mark.parametrize("cfg", [CFG_T8, g3.DEFAULT_CONFIG],
                         ids=["t8", "default"])
def test_tile_rays_and_untile_match_jax(cfg):
    cam = camera(32, height=48)
    a = np.asarray(jb.tile_rays(cam, cfg))
    b = tb.tile_rays(cam, torch_cfg(cfg), "cpu")
    assert b.shape == a.shape and b.is_contiguous()
    np.testing.assert_allclose(b.numpy(), a, atol=1e-6)
    img = np.random.default_rng(0).normal(size=a.shape[:1] + (8,) + a.shape[2:])
    img = img.astype(np.float32)
    np.testing.assert_array_equal(
        tb.untile(torch.from_numpy(img), 32, 48, cfg.tile_size).numpy(),
        np.asarray(jb.untile(jnp.asarray(img), 32, 48, cfg.tile_size)))


def test_reduce_plan_past_a_million_and_a_half_gaussians():
    """A training frame of 2M Gaussians takes the full-id-space reduce plan
    (K3's direct sums; the JAX package falls back to float32 prefix sums
    above 1.5M, whose cancellation loses ~2e-3 of a garden-scale
    gradient's norm), and its gradient rows equal a plain sum per
    Gaussian."""
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch.render import param_grads, segreduce
    from gvrt_tpu_torch.render.tiled import _camera_mats as torch_mats
    g = torch.Generator().manual_seed(3)
    model = gt.random_gaussians(g, 2_000_000, extent=30.0, device="cpu")
    with torch.no_grad():
        model.means[:, 2] -= 33.0
    cfg = gt.DEFAULT_CONFIG.replace(tile_size=8)
    cam = gt.Camera.from_fovy(16, 16, 10.0, np.eye(4))
    act = model.activate()
    w2c, proj = torch_mats(cam)
    cap = tb.plan_capacity(act, w2c, proj, 16, 16, cfg)
    topo = tb.bin_topology(act, w2c, proj, 16, 16, cfg, *cap,
                           with_reduce_plan=True)
    assert isinstance(topo.red, segreduce.ReducePlan)
    assert int(topo.overflow) == 0 and int(topo.num_pairs) > 0
    rows = torch.rand((model.num_gaussians + 1, 4), generator=g,
                      dtype=torch.float64).requires_grad_()
    chunks = param_grads.chunked_gather(
        cfg.chunk_size, rows, topo.pair_gauss, topo.pair_pos,
        topo.gauss_offsets, topo.gauss_counts, topo.red, "torch")
    bar = torch.rand(chunks.shape, generator=g, dtype=torch.float64)
    chunks.backward(bar)
    want = torch.zeros_like(rows).index_add_(
        0, topo.pair_gauss.long(), bar.reshape(-1, 4))
    # padding slots name the dummy row N: compare the Gaussians' rows
    np.testing.assert_allclose(rows.grad[:-1].numpy(), want[:-1].numpy(),
                               rtol=1e-12, atol=1e-12)
