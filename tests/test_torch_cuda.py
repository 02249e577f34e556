"""PyTorch port on the card: the CUDA tile kernel against its plain version.

Needs an NVIDIA card (the kernel has no CPU mode), so every test is marked
`cuda` and skips without one.  It imports neither JAX nor the JAX package,
so it also runs where those are not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Kernel and plain version see the same binned inputs.  Bounds (the stated
kernel tolerance): rgb and T within 1e-5, depth within 1e-4 and hit counts
equal, each on at least 99.99% of rays, and max abs <= 5e-3: a sequential
product against a cumprod can flip a borderline `T > min_transmittance`
gate on a rare pair.
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
    before = pf.tile_forward.launches
    out = r.render(model, gt.Camera.from_fovy(64, 64, 60.0, np.eye(4)))
    torch.cuda.synchronize()
    assert pf.tile_forward.launches == before + 1
    assert out["rgb"].is_cuda and bool(out["rgb"].isfinite().all())
