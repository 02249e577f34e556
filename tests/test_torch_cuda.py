"""PyTorch port on the card: the CUDA kernels against their plain versions.

Needs an NVIDIA card (the kernels have no CPU mode), so every test is marked
`cuda` and skips without one.  It imports neither JAX nor the JAX package,
so it also runs where those are not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Kernel and plain version see the same binned inputs.  Bounds (the stated
kernel tolerances):
  * K1: rgb and T within 1e-5, depth within 1e-4 and hit counts equal, each
    on at least 99.99% of rays, and max abs <= 5e-3: a sequential product
    against a cumprod can flip a borderline `T > min_transmittance` gate on
    a rare pair.  Its residual T_in: within 1e-5 on 99.99% of entries.
  * K2: relative L2 error <= 1e-4 per column group (M, b, density, SH) and
    for the ray cotangents (the sums over rays run in another order);
    saturated and dead chunks exactly zero; two runs bit-identical.
  * K3: relative L2 error <= 1e-5 (another summation order); bit-identical
    across runs.
  * The whole training step, kernels against plain versions: relative L2
    <= 1e-4 per parameter group.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gvrt_tpu_torch as gt  # noqa: E402
from gvrt_tpu_torch.render import binning  # noqa: E402
from gvrt_tpu_torch.render import pallas_forward as pf  # noqa: E402
from gvrt_tpu_torch.render import pallas_vjp as pv  # noqa: E402
from gvrt_tpu_torch.render import segreduce as sr  # noqa: E402
from gvrt_tpu_torch.render.tiled import _camera_mats  # noqa: E402

pytestmark = pytest.mark.cuda

BASE = gt.DEFAULT_CONFIG
CONFIGS = {
    "t8_g128": BASE.replace(tile_size=8, chunk_size=128),
    "default": BASE,
    "logspace": BASE.replace(transmittance_prod=False),
    "degree_8": BASE.replace(kernel_degree=8),
    "degree_0": BASE.replace(kernel_degree=0),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tile kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _binned(cuda, cfg, n=2000, opacity_shift=0.0, scale_range=(-4.5, -2.5),
            spread=0.8, pad_factor=1):
    g = torch.Generator(device=cuda).manual_seed(n)
    model = gt.random_gaussians(g, n, extent=spread, scale_range=scale_range,
                                device=cuda)
    cam = gt.Camera.from_fovy(96, 96, 60.0, np.eye(4))
    with torch.no_grad():
        model.means[:, 2] -= 3.0
        model.opacity_logit += opacity_shift
        act = model.activate()
        w2c, proj = _camera_mats(cam)
        cap, cap_pad = binning.plan_capacity(act, w2c, proj, 96, 96, cfg)
        topo = binning.bin_topology(act, w2c, proj, 96, 96, cfg, cap,
                                    cap_pad * pad_factor)
        assert int(topo.overflow) == 0
        scene = binning.binned_scene(binning.gather_chunks(act, topo, cfg),
                                     topo)
    return scene, binning.tile_rays(cam, cfg, cuda)


def _assert_kernel_matches_plain(scene, rays, cfg):
    before = pf.tile_forward.launches
    with torch.no_grad():
        got = pf.forward_dispatch(scene, rays, cfg, "cuda")
        want = pf.forward_dispatch(scene, rays, cfg, "torch")
    torch.cuda.synchronize()
    assert pf.tile_forward.launches == before + 1
    d = (got - want).abs()
    assert bool(got.isfinite().all())
    assert float(((d[:, 0:3].amax(1) <= 1e-5) & (d[:, 4] <= 1e-5))
                 .float().mean()) >= 0.9999
    assert float((d[:, 3] <= 1e-4).float().mean()) >= 0.9999
    assert float((d[:, 5] == 0).float().mean()) >= 0.9999
    assert float(d[:, 0:5].max()) <= 5e-3
    return got


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_matches_plain_version(cuda, name):
    scene, rays = _binned(cuda, CONFIGS[name])
    got = _assert_kernel_matches_plain(scene, rays, CONFIGS[name])
    assert float(got[:, 5].mean()) > 1.0


def test_kernel_edge_cases(cuda):
    """Empty tiles, dead trailing chunks and saturated tiles in one scene."""
    scene, rays = _binned(cuda, BASE, n=1500, opacity_shift=6.0,
                          scale_range=(-2.2, -1.6), spread=0.3, pad_factor=3)
    got = _assert_kernel_matches_plain(scene, rays, BASE)
    n_tiles = rays.shape[0]
    empty = scene.tile_counts == 0
    assert int(empty.sum()) > 0
    assert int((scene.chunk_tile == n_tiles).sum()) > 0
    assert int((got[:, 4].amax(1) <= BASE.min_transmittance).sum()) > 0
    bg = torch.tensor(pf.BACKGROUND, device=cuda)[:, None]
    assert bool((got[empty] == bg).all())


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    scene, rays = _binned(cuda, BASE, n=200)
    wide = torch.zeros((4, 256, 64), device=cuda)
    with pytest.raises(ValueError, match="G <= 128"):
        pf.tile_forward(wide, rays, scene.tile_counts,
                        BASE.replace(chunk_size=256))
    with pytest.raises(ValueError, match="int32"):
        pf.tile_forward(scene.chunks, rays, scene.tile_counts.long(), BASE)
    with pytest.raises(ValueError, match="contiguous"):
        pf.tile_forward(scene.chunks, rays.transpose(0, 2).contiguous()
                        .transpose(0, 2), scene.tile_counts, BASE)


def test_renderer_defaults_to_the_card_and_the_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    model = gt.random_gaussians(g, 1000, extent=0.8)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    r = gt.render.TiledRenderer(64, 64)
    assert r.device.type == "cuda" and r.impl == "cuda"
    cam = gt.Camera.from_fovy(64, 64, 60.0, np.eye(4))
    before = (pf.tile_forward.launches, pf.tile_forward_residual.launches)
    with torch.no_grad():  # serving: K1 without the training residual
        out = r.render(model, cam)
    torch.cuda.synchronize()
    assert (pf.tile_forward.launches,
            pf.tile_forward_residual.launches) == (before[0] + 1, before[1])
    assert out["rgb"].is_cuda and bool(out["rgb"].isfinite().all())
    # with grad: the residual variant, and K2 + K3 in the backward
    before = (pf.tile_forward.launches, pf.tile_forward_residual.launches,
              pv.tile_backward.launches, sr.segment_reduce.launches)
    r.render(model, cam)["rgb"].mean().backward()
    torch.cuda.synchronize()
    assert (pf.tile_forward.launches, pf.tile_forward_residual.launches,
            pv.tile_backward.launches, sr.segment_reduce.launches) == (
        before[0], before[1] + 1, before[2] + 1, before[3] + 1)
    assert float(model.means.grad.abs().max()) > 0


def _rel_l2(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


#: bar_chunk column groups of the backward
COL_GROUPS = {"M": slice(0, 9), "b": slice(9, 12), "density": slice(12, 13),
              "sh": slice(16, 64)}


def _bar_acc(scene_rays, seed):
    g = torch.Generator(device=scene_rays.device).manual_seed(seed)
    bar = torch.randn((scene_rays.shape[0], 8, scene_rays.shape[2]),
                      generator=g, device=scene_rays.device)
    bar[:, 5:] = 0.0  # hit counts carry no gradient
    return bar


@pytest.mark.parametrize("name,ray_grads", [("default", True),
                                            ("logspace", False),
                                            ("t8_g128", True),
                                            ("degree_8", False)])
def test_residual_and_backward_kernels_match_plain(cuda, name, ray_grads):
    cfg = CONFIGS[name].replace(ray_gradients=ray_grads)
    scene, rays = _binned(cuda, cfg, pad_factor=2)
    # poison the caching allocator: the kernels' outputs come from
    # torch.empty and must not show what was there before
    torch.full((scene.chunks.numel() * 2,), float("nan"), device=cuda)
    before = (pf.tile_forward_residual.launches, pv.tile_backward.launches)
    acc, t_in = pf.tile_forward_residual(scene.chunks, rays,
                                         scene.tile_counts, cfg)
    acc_p, t_in_p = pv._forward_residual_plain(scene.chunks, rays,
                                               scene.tile_counts, cfg)
    torch.cuda.synchronize()
    assert bool(t_in.isfinite().all())
    assert float(((t_in - t_in_p).abs() <= 1e-5).float().mean()) >= 0.9999
    bar_acc = _bar_acc(rays, 7)
    torch.full((scene.chunks.numel() * 2,), float("nan"), device=cuda)
    got = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                           bar_acc, cfg)
    again = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                             bar_acc, cfg)
    want = pv._backward_plain(scene.chunks, rays, scene.tile_counts, t_in,
                              bar_acc, cfg)
    torch.cuda.synchronize()
    assert (pf.tile_forward_residual.launches, pv.tile_backward.launches) == (
        before[0] + 1, before[1] + 2)
    assert bool(got[0].isfinite().all())
    assert torch.equal(got[0], again[0])
    for group, cols in COL_GROUPS.items():
        assert _rel_l2(got[0][..., cols], want[0][..., cols]) <= 1e-4, group
    assert bool((got[0][..., 13:16] == 0).all())
    dead = scene.chunk_tile == rays.shape[0]
    assert int(dead.sum()) > 0 and bool((got[0][dead] == 0).all())
    if ray_grads:
        assert torch.equal(got[1], again[1])
        assert _rel_l2(got[1], want[1]) <= 1e-4
    else:
        assert got[1] is None and want[1] is None


def test_backward_kernel_zeroes_saturated_chunks(cuda):
    scene, rays = _binned(cuda, BASE, n=1500, opacity_shift=6.0,
                          scale_range=(-2.2, -1.6), spread=0.3, pad_factor=3)
    acc, t_in = pf.tile_forward_residual(scene.chunks, rays,
                                         scene.tile_counts, BASE)
    got, _ = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                              _bar_acc(rays, 8), BASE)
    start, count = pf.tile_chunk_runs(scene.tile_counts,
                                      scene.chunks.shape[0], BASE.chunk_size)
    in_run = torch.zeros(scene.chunks.shape[0], dtype=torch.bool,
                         device=cuda)
    for t in torch.nonzero(count).squeeze(1).tolist():
        in_run[int(start[t]):int(start[t]) + int(count[t])] = True
    saturated = in_run & (t_in.amax(dim=1) <= BASE.min_transmittance)
    assert int(saturated.sum()) > 0
    assert bool((got[saturated] == 0).all())
    assert bool(got.isfinite().all())


def test_segment_reduce_kernel_matches_plain(cuda):
    cfg = BASE
    scene, rays = _binned(cuda, cfg, n=3000)
    assert scene.red is not None
    g = torch.Generator(device=cuda).manual_seed(9)
    bar_flat = torch.randn((scene.chunks.shape[0] * cfg.chunk_size, 64),
                           generator=g, device=cuda)
    n_groups = -(-3001 // sr.GROUP)
    before = sr.segment_reduce.launches
    got = sr.segment_reduce(bar_flat, scene.red, n_groups)
    again = sr.segment_reduce(bar_flat, scene.red, n_groups)
    want = sr.segment_reduce_plain(bar_flat, scene.red, n_groups)
    torch.cuda.synchronize()
    assert sr.segment_reduce.launches == before + 2
    assert torch.equal(got, again)
    assert _rel_l2(got, want) <= 1e-5
    # Gaussians without a live pair get exact zeros
    assert bool((got[want.abs().sum(1) == 0] == 0).all())


@pytest.mark.parametrize("name", ["default", "logspace"])
def test_training_step_gradients_match_plain_path(cuda, name):
    cfg = CONFIGS[name]
    g = torch.Generator(device=cuda).manual_seed(11)
    model = gt.random_gaussians(g, 2000, extent=0.8, device=cuda)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    cam = gt.Camera.from_fovy(96, 96, 60.0, np.eye(4))
    grads = {}
    for impl in ("cuda", "torch"):
        r = gt.render.TiledRenderer(96, 96, cfg, impl=impl, device=cuda)
        r.plan(model, [cam])
        r.bind(model, cam)
        model.zero_grad(set_to_none=True)
        out = r.render_bound(model)
        loss = ((out["rgb"] - 0.3) ** 2).mean() + 1e-2 * out["depth"].mean()
        loss.backward()
        grads[impl] = {k: getattr(model, k).grad.clone()
                       for k in gt.models.gaussians.LEAVES}
    for k, want in grads["torch"].items():
        assert float(want.abs().max()) > 0, k
        assert _rel_l2(grads["cuda"][k], want) <= 1e-4, k
