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
  * K2: relative L2 error <= 1e-4 per column group (M, b, density, SH), per
    column (each of the 61 nonzero ones whose plain norm is nonzero: a
    group's L2 would hide a small column mapped to the wrong place) and for
    the ray cotangents (the sums over rays run in another order, on the
    tensor cores in 3xTF32); saturated and dead chunks exactly zero; two
    runs bit-identical.
  * K3: relative L2 error <= 1e-5 (another summation order); bit-identical
    across runs.
  * K4: relative L2 error <= 1e-5; bit-identical across runs; every output
    row defined after a NaN-poisoned allocator, the rows past the last live
    compact id exactly zero.  Its table mode: the same, the compact sums
    expanded through the live-id window bit for bit, and the table rows
    outside the window exactly zero.
  * K3 and both modes of K4 on synthetic plans (tests/reduce_layouts.py):
    one Gaussian with thousands of rows, ids with no rows, an all-pad plan,
    a window ending at the table's last row, slots clamped at P_pad - 1,
    overflowed plans; relative L2 <= 1e-5, two runs bit-identical, every
    row finite after a NaN-poisoned allocator.
  * The whole training step, kernels against plain versions, unbanded and
    banded (stride, span, balanced): relative L2 <= 1e-4 per parameter
    group.
  * The pose gradient (d loss / d delta_t, d loss / d delta_r of
    `train.pose.pose_loss`: K1's residual, then K2 with ray cotangents)
    against the plain versions at R = 64 and R = 256, after a NaN-poisoned
    allocator, on a frame with empty corner tiles: relative L2 <= 1e-4,
    finite, nonzero.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gvrt_tpu_torch as gt  # noqa: E402
from gvrt_tpu_torch.render import banded as bd  # noqa: E402
from gvrt_tpu_torch.render import binning  # noqa: E402
from gvrt_tpu_torch.render import pallas_forward as pf  # noqa: E402
from gvrt_tpu_torch.render import pallas_vjp as pv  # noqa: E402
from gvrt_tpu_torch.render import segreduce as sr  # noqa: E402
from gvrt_tpu_torch.render.tiled import _camera_mats  # noqa: E402

import reduce_layouts  # noqa: E402

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
            spread=0.8, pad_factor=1, res=96, mixed_scales=False):
    g = torch.Generator(device=cuda).manual_seed(n)
    model = gt.random_gaussians(g, n, extent=spread, scale_range=scale_range,
                                device=cuda)
    cam = gt.Camera.from_fovy(res, res, 60.0, np.eye(4))
    with torch.no_grad():
        model.means[:, 2] -= 3.0
        model.opacity_logit += opacity_shift
        if mixed_scales:  # scales of ~1e-3 next to ~0.3
            model.scales_log[0::2] = np.log(1e-3)
            model.scales_log[1::2] = np.log(0.3)
            model.scales_log += 0.3 * torch.rand(model.scales_log.shape,
                                                 generator=g, device=cuda)
        act = model.activate()
        w2c, proj = _camera_mats(cam)
        cap, cap_pad = binning.plan_capacity(act, w2c, proj, res, res, cfg)
        topo = binning.bin_topology(act, w2c, proj, res, res, cfg, cap,
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


#: every branch of the kernel's response (degree 2 is the quadratic
#: default), and the log-space transmittance
THRESHOLD_CONFIGS = {
    **{f"degree_{d}": BASE.replace(kernel_degree=d)
       for d in (8, 5, 4, 3, 2, 1, 0)},
    "logspace": BASE.replace(transmittance_prod=False),
}


def _threshold_scene(cuda, cfg, n=2000, res=128, seed=7):
    """Isotropic gaussians each placed so that one chosen ray passes at a
    gray distance within 1e-3 relative of the response cutoff D, on either
    side; the rays of every other tile get origins jittered by ~1e-4, so
    both the shared-origin and the per-lane origin paths of K1 run.  Half
    the gaussians are so small (cutoff disks of ~0.1-0.5 px) that the
    chosen ray is often the only one of its warp near them: there the
    warp's skip turns on that pair alone.  Low overlap and densities in
    [0.4, 0.6] keep T far above min_T and the alpha gate open at the
    cutoff, so the response gate alone decides."""
    rng = np.random.default_rng(seed)
    cam = gt.Camera.from_fovy(res, res, 60.0, np.eye(4))
    rays = binning.tile_rays(cam, cfg, cuda)
    jitter = torch.from_numpy(
        1e-4 * rng.standard_normal(rays[:, 0:3].shape).astype(np.float32))
    rays[0::2, 0:3] += jitter.to(cuda)[0::2]
    num_tiles, _, r = rays.shape
    tile = rng.integers(0, num_tiles, n)
    ray = rng.integers(0, r, n)
    o = rays[tile, 0:3, ray].double().cpu().numpy()
    d = rays[tile, 3:6, ray].double().cpu().numpy()
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    u = np.cross(d, rng.standard_normal((n, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    scale = np.where(np.arange(n) % 2 == 0, rng.uniform(0.005, 0.03, n),
                     rng.uniform(0.0008, 0.003, n))
    cut = gt.ops.kernels.gray_cutoff(cfg.hit_min_response, cfg.kernel_degree)
    rho = scale * np.sqrt(cut * (1.0 + rng.uniform(-1e-3, 1e-3, n)))
    means = o + rng.uniform(2.5, 3.5, (n, 1)) * d + rho[:, None] * u
    g = torch.Generator(device=cuda).manual_seed(seed)
    model = gt.random_gaussians(g, n, device=cuda)
    with torch.no_grad():
        model.means.copy_(torch.from_numpy(means))
        model.scales_log.copy_(torch.from_numpy(
            np.repeat(np.log(scale)[:, None], 3, axis=1)))
        dens = rng.uniform(0.4, 0.6, n)
        model.opacity_logit.copy_(torch.from_numpy(np.log(dens / (1 - dens))))
        act = model.activate()
        w2c, proj = _camera_mats(cam)
        cap, cap_pad = binning.plan_capacity(act, w2c, proj, res, res, cfg)
        topo = binning.bin_topology(act, w2c, proj, res, res, cfg, cap,
                                    cap_pad)
        assert int(topo.overflow) == 0
        scene = binning.binned_scene(binning.gather_chunks(act, topo, cfg),
                                     topo)
    return scene, rays, cut


def _near_cutoff_pairs(scene, rays, cut):
    """(inside, outside, lone): binned pairs of live gaussians whose gray
    distance (float64) lies within 1e-3 relative below / above the cutoff,
    and the inside ones that no other ray of their warp (32 rays, two pixel
    rows) brings within 1e-3 above the cutoff: only the pair's own vote
    keeps the warp from skipping the gaussian there."""
    chunks = scene.chunks.double()
    tr = rays[scene.chunk_tile.clamp_max(rays.shape[0] - 1).long()].double()
    m = chunks[..., 0:9].reshape(*chunks.shape[:2], 3, 3)      # (C, G, 3, 3)
    gro = torch.einsum("cgij,cjr->cgir", m, tr[:, 0:3]) \
        - chunks[..., 9:12, None]
    gu = torch.einsum("cgij,cjr->cgir", m, tr[:, 3:6])
    gray = (torch.linalg.cross(gu, gro, dim=2) ** 2).sum(2) \
        / (gu ** 2).sum(2)
    live = (chunks[..., 12:13] > 0) \
        & (scene.chunk_tile < rays.shape[0])[:, None, None]
    rel = gray / cut - 1.0
    inside = live & (rel < 0) & (rel > -1e-3)
    near = (live & (rel < 1e-3)).unflatten(2, (-1, 32)).sum(3)
    lone = inside & (near == 1).repeat_interleave(32, dim=2)
    return (int(inside.sum()), int((live & (rel >= 0) & (rel < 1e-3)).sum()),
            int(lone.sum()))


@pytest.mark.parametrize("name", sorted(THRESHOLD_CONFIGS))
def test_forward_kernel_threshold_pairs(cuda, name):
    """K1's warp-wide early reject against the plain version where it is
    closest to wrong: many pairs within 1e-3 of the response cutoff, on
    both sides, hit counts equal on every ray."""
    cfg = THRESHOLD_CONFIGS[name]
    scene, rays, cut = _threshold_scene(cuda, cfg)
    inside, outside, lone = _near_cutoff_pairs(scene, rays, cut)
    assert inside >= 300 and outside >= 300 and lone >= 200, (
        inside, outside, lone)
    got = _assert_kernel_matches_plain(scene, rays, cfg)
    with torch.no_grad():
        want = pf.forward_dispatch(scene, rays, cfg, "torch")
    assert torch.equal(got[:, 5], want[:, 5])
    assert float(got[:, 5].sum()) > 1000
    # no ray reached the transmittance cutoff: the response gate decides
    assert float(got[:, 4].amin()) > 2 * cfg.min_transmittance


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
#: the 61 nonzero parameter columns
COLUMNS = [c for c in range(64) if c not in (13, 14, 15)]


def _assert_columns_match(got, want):
    """Each of the 61 columns within relative L2 1e-4 of the plain version
    where its plain norm is nonzero; returns the number of such columns."""
    g = got[..., COLUMNS].reshape(-1, len(COLUMNS))
    w = want[..., COLUMNS].reshape(-1, len(COLUMNS))
    norm = w.norm(dim=0)
    live = norm > 0
    rel = (g - w).norm(dim=0)[live] / norm[live]
    assert float(rel.max()) <= 1e-4, {
        COLUMNS[i]: float(e) for i, e in zip(
            torch.nonzero(live).squeeze(1).tolist(), rel) if e > 1e-4}
    return int(live.sum())


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
    assert _assert_columns_match(got[0], want[0]) == len(COLUMNS)
    assert bool((got[0][..., 13:16] == 0).all())
    dead = scene.chunk_tile == rays.shape[0]
    assert int(dead.sum()) > 0 and bool((got[0][dead] == 0).all())
    if ray_grads:
        assert torch.equal(got[1], again[1])
        assert _rel_l2(got[1], want[1]) <= 1e-4
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("case", ["sparse_one_ray_per_warp",
                                  "mixed_scales"])
def test_backward_kernel_columns_under_stress(cuda, case):
    """K2's columns, one by one, where the product over a warp's rays is
    least like a dense sum: a sparse scene of sub-pixel Gaussians at 64^2
    whose cotangent is nonzero on one ray per warp (one contributing ray
    among 32), and Gaussian scales of ~1e-3 next to ~0.3 (coefficients over
    many magnitudes, which the TF32 hi/lo split must carry)."""
    cfg = BASE.replace(ray_gradients=True)
    if case == "sparse_one_ray_per_warp":
        scene, rays = _binned(cuda, cfg, n=300, scale_range=(-5.0, -4.5),
                              opacity_shift=3.0, res=64)
        bar_acc = _bar_acc(rays, 17)
        g = torch.Generator(device=cuda).manual_seed(18)
        keep = torch.randint(0, 32, (rays.shape[0], rays.shape[2] // 32),
                             generator=g, device=cuda)
        mask = torch.zeros_like(bar_acc[:, 0])
        mask.view(rays.shape[0], -1, 32).scatter_(2, keep[..., None], 1.0)
        bar_acc *= mask[:, None, :]
    else:
        scene, rays = _binned(cuda, cfg, n=2000, mixed_scales=True)
        bar_acc = _bar_acc(rays, 19)
    acc, t_in = pf.tile_forward_residual(scene.chunks, rays,
                                         scene.tile_counts, cfg)
    assert float(acc[:, 5].sum()) > 0
    got = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                           bar_acc, cfg)
    again = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                             bar_acc, cfg)
    want = pv._backward_plain(scene.chunks, rays, scene.tile_counts, t_in,
                              bar_acc, cfg)
    torch.cuda.synchronize()
    assert bool(got[0].isfinite().all()) and torch.equal(got[0], again[0])
    assert _assert_columns_match(got[0], want[0]) > 0
    assert _rel_l2(got[1], want[1]) <= 1e-4


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


def _banded_scene(cuda, n=3000, res=128):
    g = torch.Generator(device=cuda).manual_seed(n)
    model = gt.random_gaussians(g, n, extent=0.8, device=cuda)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    cam = gt.Camera.from_fovy(res, res, 60.0, np.eye(4))
    return model.sorted_for_camera(cam, BASE), cam


def test_compact_reduce_kernel_matches_plain(cuda):
    model, cam = _banded_scene(cuda)
    r = bd.BandedRenderer(128, 128, 2, BASE, span=True, device=cuda)
    for b, topo in enumerate(r.bind(model, cam)):
        red = topo.red
        assert isinstance(red, sr.CompactReducePlan)
        n_groups = red.out_shape.shape[0]
        g = torch.Generator(device=cuda).manual_seed(30 + b)
        bar_flat = torch.randn((topo.pair_gauss.shape[0], 64), generator=g,
                               device=cuda)
        torch.full((2 * n_groups * sr.GROUP * 64,), float("nan"),
                   device=cuda)
        before = sr.segment_reduce_compact.launches
        got = sr.segment_reduce_compact(bar_flat, red, n_groups)
        again = sr.segment_reduce_compact(bar_flat, red, n_groups)
        want = sr.segment_reduce_compact_plain(bar_flat, red, n_groups)
        torch.cuda.synchronize()
        assert sr.segment_reduce_compact.launches == before + 2
        assert torch.equal(got, again) and bool(got.isfinite().all())
        assert _rel_l2(got, want) <= 1e-5
        n_live = int(sr.compact_ids(red).clamp_max(n_groups * sr.GROUP)
                     .unique().numel()) - 1
        assert 0 < n_live < n_groups * sr.GROUP
        assert bool((got[n_live:] == 0).all())


@pytest.mark.parametrize("span,balance,remat",
                         [(False, False, "full"), (True, False, "gather"),
                          (True, True, "none")],
                         ids=["stride_full", "span_gather", "balanced_none"])
def test_banded_step_gradients_match_plain_path(cuda, span, balance, remat):
    model, cam = _banded_scene(cuda, n=2000)
    held = bd.BandedRenderer(128, 128, 2, BASE, remat=remat, span=span,
                             balance=balance, device=cuda)
    held.bind(model, cam)
    grads, launches = {}, {}
    for impl in ("cuda", "torch"):
        r = bd.BandedRenderer(128, 128, 2, BASE, impl=impl, remat=remat,
                              span=span, balance=balance, device=cuda)
        r._bound = held._bound
        model.zero_grad(set_to_none=True)
        before = (sr.segment_reduce_compact.launches,
                  sr.segment_reduce_compact_table.launches)
        out = r.render_bound(model)
        loss = ((out["rgb"] - 0.3) ** 2).mean() + 1e-2 * out["depth"].mean()
        loss.backward()
        torch.cuda.synchronize()
        # K4 in its table mode, once per band
        launches[impl] = (sr.segment_reduce_compact.launches - before[0],
                          sr.segment_reduce_compact_table.launches
                          - before[1])
        grads[impl] = {k: getattr(model, k).grad.clone()
                       for k in gt.models.gaussians.LEAVES}
    assert launches == {"cuda": (0, 2), "torch": (0, 0)}
    for k, want in grads["torch"].items():
        assert float(want.abs().max()) > 0, k
        assert _rel_l2(grads["cuda"][k], want) <= 1e-4, k


#: card case -> (layout case of tests/reduce_layouts.py, twist): "tight"
#: also overflows K3's plan (fewer rows than its groups need), "clamp" gives
#: the cotangents fewer rows than the largest live slot, "last_row" asks
#: table mode for a table that ends with the window's last row
REDUCE_CASES = {
    "heavy": ("heavy", None),
    "no_rows": ("no_rows", None),
    "all_pad": ("all_pad", None),
    "window_start": ("window_start", None),
    "window_to_last_row": ("window_end", "last_row"),
    "clamped_slots": ("no_window", "clamp"),
    "overflow": ("overflow", "tight"),
}


@pytest.mark.parametrize("name", sorted(REDUCE_CASES))
def test_reduce_kernels_on_synthetic_plans(cuda, name):
    case, twist = REDUCE_CASES[name]
    lay = reduce_layouts.layout(11, **reduce_layouts.CASES[case])
    arrays = [torch.from_numpy(a).to(cuda) for a in lay[:4]]
    n, cap, cap_pad = lay[4:]
    full, ovf3 = sr.build_reduce_plan(*arrays, n, cap, cap_pad,
                                      1024 if twist == "tight" else 0)
    compact, ovf4 = sr.build_reduce_plan_compact(
        *arrays, n, cap, cap_pad, *reduce_layouts.compact_sizes(lay, case))
    assert (int(ovf3) > 0) == (twist == "tight")
    assert (int(ovf4) > 0) == (case == "overflow")
    g = torch.Generator(device=cuda).manual_seed(40)
    p_pad = cap_pad // 3 if twist == "clamp" else cap_pad
    bar = torch.randn((p_pad, 64), generator=g, device=cuda)
    if twist == "clamp":
        assert int((compact.slot[compact.slot < cap_pad] >= p_pad).sum()) > 0
    n_rows = n if twist == "last_row" else n + 1
    n_groups = -(-(n + 1) // sr.GROUP)
    n_groups_c = compact.out_shape.shape[0]
    calls = {
        "k3": (sr.segment_reduce,
               lambda: sr.segment_reduce(bar, full, n_groups),
               lambda: sr.segment_reduce_plain(bar, full, n_groups)),
        "k4": (sr.segment_reduce_compact,
               lambda: sr.segment_reduce_compact(bar, compact, n_groups_c),
               lambda: sr.segment_reduce_compact_plain(bar, compact,
                                                       n_groups_c)),
        "k4_table": (sr.segment_reduce_compact_table,
                     lambda: sr.segment_reduce_compact_table(bar, compact,
                                                             n_rows),
                     lambda: sr.segment_reduce_compact_table_plain(
                         bar, compact, n_rows)),
    }
    outs = {}
    for kern, (wrapper, run, plain) in calls.items():
        torch.full((4 * (n + 1) * 64,), float("nan"), device=cuda)
        before = wrapper.launches
        got, again, want = run(), run(), plain()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2, kern
        assert torch.equal(got, again), kern
        assert bool(got.isfinite().all()), kern
        assert _rel_l2(got, want) <= 1e-5, kern
        outs[kern] = got
    # table mode is compact mode's sums expanded through the window, bit
    # for bit, and zero outside the window
    table = outs["k4_table"]
    assert torch.equal(table, sr.expand_compact(outs["k4"], compact, n_rows))
    base, window = int(compact.base[0]), compact.src_range.shape[0]
    assert not bool(table[:base].any()) and \
        not bool(table[base + window:].any())
    if twist == "last_row":
        assert base + window == n_rows
    if case == "all_pad":
        assert not any(bool(o.any()) for o in outs.values())
    else:
        assert all(bool(o.any()) for o in outs.values())


@pytest.mark.parametrize("tile", [8, 16], ids=["R64", "R256"])
def test_pose_gradient_kernels_match_plain(cuda, tile):
    cfg = BASE.replace(tile_size=tile)
    g = torch.Generator(device=cuda).manual_seed(31)
    model = gt.random_gaussians(g, 2000, extent=0.8, device=cuda)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    cam = gt.Camera.from_fovy(96, 96, 60.0, np.eye(4))
    with torch.no_grad():
        target = gt.render.render_image_tiled(model, cam, cfg,
                                              device=cuda)["rgb"]
    bad = gt.train.perturb_cameras([cam], 0.03, seed=1)[0]
    bound = gt.train.pose.bind_pose(model, bad, target, cfg)
    assert int((bound.binned.tile_counts == 0).sum()) > 0
    grads, before = {}, pv.tile_backward.launches
    for impl in ("cuda", "torch"):
        # the kernels' outputs come from torch.empty: poison what they reuse
        torch.full((bound.binned.chunks.numel() * 2,), float("nan"),
                   device=cuda)
        t = torch.tensor([0.01, -0.005, 0.002], device=cuda,
                         requires_grad=True)
        r = torch.tensor([0.002, 0.001, -0.003], device=cuda,
                         requires_grad=True)
        loss = gt.train.pose.pose_loss(bound, t, r, impl)
        grads[impl] = torch.autograd.grad(loss, (t, r))
    torch.cuda.synchronize()
    assert pv.tile_backward.launches == before + 1
    for got, want in zip(grads["cuda"], grads["torch"]):
        assert bool(got.isfinite().all()) and float(want.abs().max()) > 0
        assert _rel_l2(got, want) <= 1e-4
