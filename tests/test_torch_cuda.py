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
    K1 and K2 also at tile 20 (R = 400, the light field's), where the last
    warp of a block holds 16 rays, and at the tile and chunk sizes past
    one block (R = 529, 576, 1024, 1089, 4096; G = 128, 256, 512, 1024),
    where the kernels split a tile's rays into slabs and a chunk into
    pieces or sub-chunks.
  * K2: relative L2 error <= 1e-4 per column group (M, b, density, SH), per
    column (each of the 61 nonzero ones whose plain norm is nonzero: a
    group's L2 would hide a small column mapped to the wrong place) and for
    the ray cotangents (the sums over rays run in another order, on the
    tensor cores in 3xTF32); saturated and dead chunks exactly zero; two
    runs bit-identical.  The ray cotangents also row by row, after a
    NaN-poisoned allocator: each of the 22 nonzero rows (o, d, the 16 SH
    basis rows) within relative L2 1e-4 wherever the plain row is nonzero,
    the two gate rows exactly zero, two runs bit-identical, and bar_chunks
    bit-equal to K2's without ray gradients on the same inputs.
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
  * K1 (serving and residual) and K2 on rays whose tmax is clipped per
    pixel (the combined Gaussian-and-mesh render's rays: a finite clip
    inside the cloud on part of the frame, inf elsewhere) at R = 64 and
    256: K1's limits above with hit counts equal on every ray, no ray that
    did not saturate unclipped with more hits than unclipped; K2's limits
    above.
  * The mesh trace (`hybrid.trace.closest_hit`, `occluded`: on the card
    the kernel csrc/mesh_trace.cu) and a hybrid frame on the card against
    the port on the CPU (the chunk loop): triangle ids, occlusion and
    object ids equal, t within 1e-6 relative, rgb within 1e-5.  The
    kernel also on edge cases (rays through shared edges and vertices,
    duplicate triangles, rays in a triangle's plane, tmax below or at
    tmin, 1000 rays over chunks of 40 lanes), after a NaN-poisoned
    allocator, with u and v within 1e-6; on the combined cell's props at
    1920x1088 against the chunk loop on the same card tensors, ids and
    shadow bits equal on every pixel; and with its warp skip against the
    same kernel without it (a null group-box pointer): bit for bit.
  * The camera-ray kernel (`binning.camera_rays_kernel`) against the plain
    route on the same card (`tile_rays(impl="torch")`: NumPy, the upload,
    `tile_ray_rows`), after a NaN-poisoned allocator: origins bit-equal;
    directions bit-equal on >= 99.999% of components and within one f32
    ulp on all (the f64 sums may run in another order than NumPy's BLAS
    product); every row bit-equal, NaN matching NaN, on every ray whose
    direction is; every entry written.  At 1920x1088 (tile 16), tiles 8,
    20, 32 and 64, non-square images, SH degrees 0-3, an aabb override, an
    identity camera whose centre ray has zero x and y (the +-1e-6 clamp),
    and a tmax clip with finite, inf and NaN entries.  The 300k frame
    through `TiledRenderer.render` on the kernel's rays: K1's hit counts
    equal to K1's on the plain route's rays on every ray whose rows are.
  * The pose gradient (d loss / d delta_t, d loss / d delta_r of
    `train.pose.pose_loss`: K1's residual, then K2 with ray cotangents)
    against the plain versions at R = 64, 256, 576 and 1024 (the last at
    G = 256), after a NaN-poisoned
    allocator, on a frame with empty corner tiles: relative L2 <= 1e-4,
    finite, nonzero; and K2's ray cotangents of that loss row by row as
    above.  A `PoseRefiner` step's posed rays launch their device work
    inside `gvrt.pose.rays` and, on autograd's thread, `gvrt.pose.rays.bwd`
    (both read above 0 by `portbench/program_record.py`).
  * The max-scan kernel (`render/scan.py::max_scan`, binning's run fills)
    against cummax's values on the card: bit for bit, twice, after an
    allocator filled with a sentinel, at lengths 1, 2, a tile -1, +0 and
    +1, 2^20 + 17 and 3e7, on sparse spikes over zeros, negative values,
    long equal runs and a strictly decreasing array, and off 16-byte
    alignment.  `bin_topology` with it against the same call on cummax:
    every topology and reduce-plan field equal, at the 300k frame and the
    5M frame with K3's plan and one contiguous band with the compact plan.
  * Binning's pair expansion (`binning.expand_pairs`, csrc/bin_expand.cu)
    against its plain version on the same card tensors: each slot's
    Gaussian and int32 key, and every topology and reduce-plan field, bit
    for bit, twice, after an allocator filled with a sentinel; the 300k
    and 5M frames with K3's plan, a contiguous band with the compact plan,
    a round-robin band, an overflowing capacity, a frame with no valid
    Gaussian, Gaussians straddling the near plane and Gaussians covering
    every tile; one pair-kernel launch a serving frame and an unbanded
    step.
  * The parameter table's kernels (`rows_vjp.param_table_forward`,
    `param_table_backward`, csrc/param_table.cu) against the plain route
    on the card, after a NaN-poisoned allocator: the table and every
    activated field bit for bit at N = 1, 127, 128, 129, 300k and 5M and on
    extreme leaves (log-scales +-10, opacity logits +-20, quaternions of
    norm 1e-3), the dummy row exact; each leaf's gradient within relative
    L2 1e-6 of `_Rows64`'s plain backward, contiguous, bit-identical
    across runs, the cotangent's row N not read; the 300k and 5M serving
    topologies from the kernel's view equal to the plain view's; a
    `Trainer` step's gradients with the kernels within relative L2 1e-6 of
    the same step on the plain table route; one forward launch a serving
    frame, one of each a step per camera.
  * Data-parallel training across four cards (skips with fewer): four
    NCCL ranks, one a card, take one `Trainer(mesh)` step of a batch of
    four views (tests/port_parallel_worker.py, mode "data_parallel_cuda");
    every leaf within 1e-6 of a one-process batch-4 step's on cuda:0 (the
    gradients' sums run in another order; Adam's first step moves an
    element by its learning rate times the gradient's sign), and the
    ranks' leaves, gradients and loss bit-identical.
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
    "t24_g64": BASE.replace(tile_size=24),
    "t32_g256": BASE.replace(tile_size=32, chunk_size=256),
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
    # any chunk size is taken: G = 256 runs the kernel
    wide_cfg = BASE.replace(chunk_size=256)
    wide, wide_rays = _binned(cuda, wide_cfg, n=200)
    _assert_kernel_matches_plain(wide, wide_rays, wide_cfg)
    scene, rays = _binned(cuda, BASE, n=200)
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


#: the 22 nonzero rows of a (T, 24, R) ray cotangent: o, d and the 16 SH
#: basis rows (rows 6-7, tmin and tmax, carry none)
RAY_ROWS = [i for i in range(24) if i not in (6, 7)]


def _assert_ray_rows_match(got, again, want, without):
    """K2's ray cotangents against the plain version row by row: `got`,
    `again` and `want` are (bar_chunks, bar_rays) of two kernel runs and the
    plain version, `without` the kernel's bar_chunks without ray gradients.
    Returns the number of rows checked (plain norm nonzero)."""
    assert torch.equal(got[0], without), "bar_chunks with ray gradients"
    assert torch.equal(got[1], again[1])
    assert bool(got[1].isfinite().all())
    assert not bool(got[1][:, 6:8].any())
    g = got[1].transpose(0, 1)[RAY_ROWS].reshape(len(RAY_ROWS), -1)
    w = want[1].transpose(0, 1)[RAY_ROWS].reshape(len(RAY_ROWS), -1)
    norm = w.norm(dim=1)
    live = norm > 0
    rel = (g - w).norm(dim=1)[live] / norm[live]
    assert float(rel.max()) <= 1e-4, {
        RAY_ROWS[i]: float(e) for i, e in zip(
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
    _assert_training_kernels_match_plain(scene, rays, cfg, ray_grads)


@pytest.mark.parametrize("ray_grads", [False, True],
                         ids=["no_ray_grads", "ray_grads"])
def test_kernels_at_400_rays_per_tile(cuda, ray_grads):
    """Tile 20, the light field's: R = 400 is no multiple of 32, so lanes
    400-415 of each block's 13th warp hold no ray, vote in the warp-wide
    early reject and fill half of K2's mma.sync fragments with zeros."""
    cfg = BASE.replace(tile_size=20, ray_gradients=ray_grads)
    scene, rays = _binned(cuda, cfg, n=3000, res=120, pad_factor=2)
    assert rays.shape[2] == 400
    torch.full((scene.chunks.numel() * 2,), float("nan"), device=cuda)
    got = _assert_kernel_matches_plain(scene, rays, cfg)
    with torch.no_grad():
        again = pf.forward_dispatch(scene, rays, cfg, "cuda")
    assert torch.equal(got, again)
    assert float(got[:, 5].mean()) > 1.0
    _assert_training_kernels_match_plain(scene, rays, cfg, ray_grads)


#: (tile, chunk, image side): tiles of more rays than one block of K1
#: (1024) or K2 (512) takes, and chunks walked in sub-chunks (K2) or, past
#: 512 gaussians, staged in pieces (K1) with K2's checkpoints two
#: sub-chunks apart
SHAPES = [(23, 64, 92), (24, 64, 96), (32, 64, 96), (33, 64, 99),
          (64, 64, 128), (16, 128, 96), (16, 256, 96), (16, 512, 96),
          (16, 1024, 96), (32, 256, 96)]


@pytest.mark.parametrize("tile,chunk,res", SHAPES,
                         ids=[f"t{t}_g{g}" for t, g, _ in SHAPES])
def test_kernels_at_tile_and_chunk_sizes(cuda, tile, chunk, res):
    """K1 (serving and residual) and K2 (with and without ray gradients)
    at R = 529, 576, 1024, 1089 and 4096 rays per tile and at G = 128, 256,
    512 and 1024 gaussians per chunk, against their plain versions after a
    NaN-poisoned allocator, two runs bit-identical."""
    cfg = BASE.replace(tile_size=tile, chunk_size=chunk, ray_gradients=True)
    scene, rays = _binned(cuda, cfg, n=3000, res=res, pad_factor=2)
    assert rays.shape[2] == tile * tile
    if chunk > 512:  # live rows in two of K1's pieces
        assert int(scene.tile_counts.max()) > 512
    torch.full((scene.chunks.numel() * 2,), float("nan"), device=cuda)
    got = _assert_kernel_matches_plain(scene, rays, cfg)
    with torch.no_grad():
        again = pf.forward_dispatch(scene, rays, cfg, "cuda")
    assert torch.equal(got, again)
    assert float(got[:, 5].mean()) > 1.0
    _assert_training_kernels_match_plain(scene, rays, cfg, True)


def _assert_training_kernels_match_plain(scene, rays, cfg, ray_grads):
    """K1's residual and K2 against their plain versions, each after a
    NaN-poisoned allocator."""
    # poison the caching allocator: the kernels' outputs come from
    # torch.empty and must not show what was there before
    torch.full((scene.chunks.numel() * 2,), float("nan"), device=rays.device)
    before = (pf.tile_forward_residual.launches, pv.tile_backward.launches)
    acc, t_in = pf.tile_forward_residual(scene.chunks, rays,
                                         scene.tile_counts, cfg)
    acc_p, t_in_p = pv._forward_residual_plain(scene.chunks, rays,
                                               scene.tile_counts, cfg)
    torch.cuda.synchronize()
    assert bool(t_in.isfinite().all())
    assert float(((t_in - t_in_p).abs() <= 1e-5).float().mean()) >= 0.9999
    bar_acc = _bar_acc(rays, 7)
    torch.full((scene.chunks.numel() * 2,), float("nan"), device=rays.device)
    got = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                           bar_acc, cfg)
    again = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                             bar_acc, cfg)
    want = pv._backward_plain(scene.chunks, rays, scene.tile_counts, t_in,
                              bar_acc, cfg)
    without = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                               bar_acc, cfg.replace(ray_gradients=False))[0]
    torch.cuda.synchronize()
    assert (pf.tile_forward_residual.launches, pv.tile_backward.launches) == (
        before[0] + 1, before[1] + 3)
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
        assert _assert_ray_rows_match(got, again, want, without) == 22
    else:
        assert got[1] is None and want[1] is None
        assert torch.equal(got[0], without)


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
    torch.full((scene.chunks.numel() * 2,), float("nan"), device=cuda)
    got = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                           bar_acc, cfg)
    again = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                             bar_acc, cfg)
    want = pv._backward_plain(scene.chunks, rays, scene.tile_counts, t_in,
                              bar_acc, cfg)
    without = pv.tile_backward(scene.chunks, rays, scene.tile_counts, t_in,
                               bar_acc, cfg.replace(ray_gradients=False))[0]
    torch.cuda.synchronize()
    assert bool(got[0].isfinite().all()) and torch.equal(got[0], again[0])
    assert _assert_columns_match(got[0], want[0]) > 0
    assert _rel_l2(got[1], want[1]) <= 1e-4
    assert _assert_ray_rows_match(got, again, want, without) == 22


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


@pytest.mark.parametrize("name", ["default", "logspace", "t24_g64",
                                  "t32_g256"])
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


@pytest.mark.parametrize("span,balance,remat,chunk",
                         [(False, False, "full", 64),
                          (True, False, "gather", 64),
                          (True, True, "none", 64), (True, False, "full", 256)],
                         ids=["stride_full", "span_gather", "balanced_none",
                              "span_full_g256"])
def test_banded_step_gradients_match_plain_path(cuda, span, balance, remat,
                                                chunk):
    cfg = BASE.replace(chunk_size=chunk)
    model, cam = _banded_scene(cuda, n=2000)
    held = bd.BandedRenderer(128, 128, 2, cfg, remat=remat, span=span,
                             balance=balance, device=cuda)
    held.bind(model, cam)
    grads, launches = {}, {}
    for impl in ("cuda", "torch"):
        r = bd.BandedRenderer(128, 128, 2, cfg, impl=impl, remat=remat,
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


def _pose_binding(cuda, tile, chunk=64, res=96):
    """A res^2 frame's camera perturbed by sigma_t 0.03, bound against the
    unperturbed frame's image at tile `tile`, chunk `chunk` (empty corner
    tiles)."""
    cfg = BASE.replace(tile_size=tile, chunk_size=chunk)
    g = torch.Generator(device=cuda).manual_seed(31)
    model = gt.random_gaussians(g, 2000, extent=0.8, device=cuda)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    cam = gt.Camera.from_fovy(res, res, 60.0, np.eye(4))
    with torch.no_grad():
        target = gt.render.render_image_tiled(model, cam, cfg,
                                              device=cuda)["rgb"]
    bad = gt.train.perturb_cameras([cam], 0.03, seed=1)[0]
    bound = gt.train.pose.bind_pose(model, bad, target, cfg)
    assert int((bound.binned.tile_counts == 0).sum()) > 0
    return bound


@pytest.mark.parametrize("tile,chunk,res", [(8, 64, 96), (16, 64, 96),
                                            (24, 64, 144), (32, 256, 192)],
                         ids=["R64", "R256", "R576", "R1024_g256"])
def test_pose_gradient_kernels_match_plain(cuda, tile, chunk, res):
    bound = _pose_binding(cuda, tile, chunk, res)
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


@pytest.mark.parametrize("tile", [8, 16], ids=["R64", "R256"])
def test_pose_ray_cotangent_rows_match_plain(cuda, tile):
    """K2's ray cotangents of the pose loss, row by row, on the rays of a
    pose step (moved off the bound pose) and the loss's own cotangent."""
    bound = _pose_binding(cuda, tile)
    binned, cfg = bound.binned, bound.cfg
    rays = gt.train.pose._posed_rays(
        bound.ndc, bound.camera, cfg,
        torch.tensor([0.01, -0.005, 0.002], device=cuda),
        torch.tensor([0.002, 0.001, -0.003], device=cuda)).contiguous()
    acc, t_in = pf.tile_forward_residual(binned.chunks, rays,
                                         binned.tile_counts, cfg)
    leaf = acc.detach().requires_grad_(True)
    loss = ((pf._background_fix(leaf, binned.tile_counts)[:, 0:3]
             - bound.target) ** 2).mean()
    bar_acc = torch.autograd.grad(loss, leaf)[0].contiguous()
    inputs = (binned.chunks, rays, binned.tile_counts, t_in, bar_acc)
    torch.full((binned.chunks.numel() * 2,), float("nan"), device=cuda)
    before = pv.tile_backward.launches
    got = pv.tile_backward(*inputs, cfg)
    again = pv.tile_backward(*inputs, cfg)
    want = pv._backward_plain(*inputs, cfg)
    without = pv.tile_backward(*inputs, cfg.replace(ray_gradients=False))[0]
    torch.cuda.synchronize()
    assert pv.tile_backward.launches == before + 3
    assert float(want[1].abs().max()) > 0
    assert _assert_ray_rows_match(got, again, want, without) == 22


def test_posed_rays_run_inside_their_ranges(cuda):
    """In the profiler's events the posed rays' device work links to host
    ops inside `gvrt.pose.rays` (the forward, on the step's thread) and
    `gvrt.pose.rays.bwd` (the backward, on autograd's thread), so
    `portbench/program_record.py` reads both halves and
    `pose_rays_ms.pose` reads above 0."""
    from types import SimpleNamespace

    from gvrt_tpu_torch.utils import profiling
    from portbench import program_record
    g = torch.Generator(device=cuda).manual_seed(31)
    model = gt.random_gaussians(g, 2000, extent=0.8, device=cuda)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    cam = gt.Camera.from_fovy(96, 96, 60.0, np.eye(4))
    with torch.no_grad():
        image = gt.render.render_image_tiled(model, cam, BASE,
                                             device=cuda)["rgb"]
    bad = gt.train.perturb_cameras([cam], 0.03, seed=1)[0]
    refiner = gt.train.PoseRefiner(model, bad, image, BASE)
    refiner.step()   # builds the kernels
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        profiling.reset()
        torch.ones(1, device=cuda).add_(1.0)
        torch.cuda.synchronize()
        refiner.step()
        refiner.step()
        torch.cuda.synchronize()
    trace = SimpleNamespace(prof=prof)
    fwd, bwd, both = (program_record.launched_ms_per_unit(
        trace, "gvrt.step", names) for names in (
            ["gvrt.pose.rays"], ["gvrt.pose.rays.bwd"],
            ["gvrt.pose.rays", "gvrt.pose.rays.bwd"]))
    assert fwd > 0 and bwd > 0
    assert both == pytest.approx(fwd + bwd, rel=1e-9)
    assert profiling.recorded()["spans"]["gvrt.pose.rays.bwd"]["calls"] == 2


@pytest.mark.parametrize("tile", [8, 16], ids=["R64", "R256"])
def test_kernels_on_clipped_rays(cuda, tile):
    """The combined render's rays: tmax clipped per pixel inside the cloud
    (z = -3 +- 0.8) on the left half, inf on the right half and on every
    fifth row; the accept gate t < tmax then cuts chunk runs short."""
    cfg = BASE.replace(tile_size=tile)
    scene, full = _binned(cuda, cfg, pad_factor=2)
    cam = gt.Camera.from_fovy(96, 96, 60.0, np.eye(4))
    g = torch.Generator(device=cuda).manual_seed(tile)
    clip = 2.6 + 0.8 * torch.rand((96, 96), generator=g, device=cuda)
    clip[:, 48:] = float("inf")
    clip[::5] = float("inf")
    rays = binning.tile_rays(cam, cfg, cuda, tmax_clip=clip)
    assert bool((rays[:, 7] < full[:, 7]).any())
    torch.full((scene.chunks.numel() * 2,), float("nan"), device=cuda)
    got = _assert_kernel_matches_plain(scene, rays, cfg)
    with torch.no_grad():
        want = pf.forward_dispatch(scene, rays, cfg, "torch")
        unclipped = pf.forward_dispatch(scene, full, cfg, "cuda")
    assert torch.equal(got[:, 5], want[:, 5])
    # only a ray that saturated unclipped can accept more pairs clipped
    # (the clip rejects an early, in depth-key order, but far pair)
    gains = got[:, 5] > unclipped[:, 5]
    assert bool((unclipped[:, 4][gains] <= cfg.min_transmittance).all())
    assert bool((got[:, 5] < unclipped[:, 5]).any())
    _assert_training_kernels_match_plain(scene, rays, cfg, False)


def test_mesh_trace_on_the_card_matches_the_cpu(cuda):
    from gvrt_tpu_torch.hybrid import (HybridConfig, HybridRenderer,
                                       cornell_scene)
    from gvrt_tpu_torch.hybrid import trace
    rng = np.random.default_rng(5)
    tri = (rng.uniform(-4, 4, (700, 1, 3))
           + 0.4 * rng.standard_normal((700, 3, 3))).astype(np.float32)
    o = rng.uniform(-6, 6, (5000, 3))
    d = rng.standard_normal((5000, 3))
    d[:500] = np.eye(3)[rng.integers(0, 3, 500)]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.from_numpy(np.concatenate([o, d], 1).astype(np.float32))
    tmin = torch.full((5000,), 0.1)
    tmax = torch.from_numpy(rng.uniform(2, 12, 5000).astype(np.float32))
    for chunk in (256, 512):
        packs = [trace.pack_triangles(tri, chunk, device=dev)
                 for dev in ("cpu", cuda)]
        cpu = trace.closest_hit(rays, packs[0], tmin=tmin, block=512)
        card = trace.closest_hit(rays.to(cuda), packs[1],
                                 tmin=tmin.to(cuda), block=512)
        assert torch.equal(card["tri"].cpu(), cpu["tri"])
        for k in ("t", "u", "v"):
            torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=1e-6,
                                       atol=1e-6)
        assert torch.equal(
            trace.occluded(rays.to(cuda), packs[1], tmin.to(cuda),
                           tmax.to(cuda), block=512).cpu(),
            trace.occluded(rays, packs[0], tmin, tmax, block=512))
    c2w = np.eye(4)
    c2w[:3, 3] = [0.0, 1.0, 3.2]
    cam = gt.Camera.from_fovy(32, 32, 60.0, c2w)
    scene = cornell_scene(with_glass=True)
    hc = HybridConfig(tri_chunk=256)
    a = HybridRenderer(32, 32, hc, device=cuda).render(scene, cam)
    b = HybridRenderer(32, 32, hc, device="cpu").render(scene, cam)
    assert torch.equal(a["object"].cpu(), b["object"])
    torch.testing.assert_close(a["rgb"].cpu(), b["rgb"], rtol=0, atol=1e-5)


# ---- the mesh trace's kernel against the chunk loop --------------------------

def _grid_quads(n=8, z=-2.0):
    """n x n unit-square quads of two triangles each over [0, 1]^2 at depth
    z, every vertex at a multiple of 1/n (exact in float32)."""
    tri = []
    for i in range(n):
        for j in range(n):
            a, b = (i / n, j / n, z), ((i + 1) / n, j / n, z)
            c, d = ((i + 1) / n, (j + 1) / n, z), (i / n, (j + 1) / n, z)
            tri += [[a, b, c], [a, c, d]]
    return np.asarray(tri, np.float32)


def _down_rays(pts, z=0.0):
    """Rays from (x, y, z) straight down -z."""
    pts = np.asarray(pts, np.float32)
    o = np.concatenate([pts, np.full((len(pts), 1), z, np.float32)], 1)
    d = np.tile(np.asarray([0, 0, -1], np.float32), (len(pts), 1))
    return np.concatenate([o, d], 1)


def _trace_case(name):
    """(triangles, rays, tmin, tmax, chunk) of one edge case."""
    rng = np.random.default_rng(11)
    half = [(i / 16, j / 16) for i in range(17) for j in range(17)]
    if name == "edges_vertices":      # through every edge, diagonal, vertex
        tri, rays, chunk = _grid_quads(), _down_rays(half), 40
    elif name == "duplicates":        # each triangle twice: equal t
        tri = np.concatenate([_grid_quads(), _grid_quads()])
        rays, chunk = _down_rays(half + [(0.3, 0.6), (0.9, 0.05)]), 512
    elif name == "parallel":          # in the triangles' plane, or beside
        tri = np.concatenate([_grid_quads(),
                              [[[2, 0, 0], [2, 0, -4], [2, 1, -2]]]])
        y = rng.uniform(0, 1, 64)
        o = np.stack([np.full(64, -1.0), y, np.full(64, -2.0)], 1)
        o[32:, 2] += np.float32(1e-7) * rng.choice([-1, 1], 32)
        d = np.tile([1.0, 0.0, 0.0], (64, 1))
        d[::3] = [0.0, 0.0, -1.0]     # along the vertical triangle's plane
        o[::3] = np.stack([np.full(22, 2.0), y[::3], np.zeros(22)], 1)
        rays, chunk = np.concatenate([o, d], 1).astype(np.float32), 64
    else:                             # a seeded soup, many chunks of 40
        tri = (rng.uniform(-4, 4, (300, 1, 3))
               + 0.4 * rng.standard_normal((300, 3, 3))).astype(np.float32)
        o = rng.uniform(-6, 6, (1000, 3))
        d = rng.standard_normal((1000, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        rays, chunk = np.concatenate([o, d], 1).astype(np.float32), 40
    r = len(rays)
    tmin = np.full(r, 0.1, np.float32)
    tmax = rng.uniform(1.0, 12.0, r).astype(np.float32)
    if name == "tmax_below_tmin":
        tmax[::2] = tmin[::2] - rng.uniform(0.0, 1.0, (r + 1) // 2)
        tmax[1::4] = tmin[1::4]
    return tri, rays, tmin, tmax, chunk


def _trace_on_both(cuda, tri, rays, tmin, tmax, chunk):
    """(kernel's hits and occlusion, after a NaN-poisoned allocator; the
    chunk loop's on the CPU); the kernel launched once for each."""
    from gvrt_tpu_torch.hybrid import trace
    packs = [trace.pack_triangles(tri, chunk, device=dev)
             for dev in ("cpu", cuda)]
    args = [torch.from_numpy(x) for x in (rays, tmin, tmax)]
    want = trace.closest_hit(args[0], packs[0], tmin=args[1], tmax=args[2])
    want_occ = trace.occluded(*args[:1], packs[0], *args[1:])
    card = [x.to(cuda) for x in args]
    before = (trace.closest_hit.launches, trace.occluded.launches)
    torch.full((16 * len(rays) + 4096,), float("nan"), device=cuda)
    got = trace.closest_hit(card[0], packs[1], tmin=card[1], tmax=card[2])
    got_occ = trace.occluded(card[0], packs[1], card[1], card[2])
    torch.cuda.synchronize()
    assert (trace.closest_hit.launches, trace.occluded.launches) == \
        (before[0] + 1, before[1] + 1)
    return got, want, got_occ, want_occ


def _assert_trace_matches(got, want, got_occ, want_occ):
    assert got["tri"].dtype == torch.int64 and got_occ.dtype == torch.bool
    assert torch.equal(got["tri"].cpu(), want["tri"])
    for k in ("t", "u", "v"):
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-6,
                                   atol=1e-6)
    assert torch.equal(got_occ.cpu(), want_occ)


@pytest.mark.parametrize("case", ("edges_vertices", "duplicates",
                                  "parallel", "tmax_below_tmin", "ragged"))
def test_mesh_trace_kernel_edge_cases(cuda, case):
    """The kernel against the chunk loop on the CPU: rays through shared
    edges and vertices, duplicate triangles (the lower packed index wins),
    rays in or beside a triangle's plane, tmax below or at tmin, 1000 rays
    (no multiple of the block) over chunks of 40 lanes (no multiple of a
    warp's group): every id and occlusion bit equal, t, u, v within 1e-6,
    every output written after a NaN-poisoned allocator."""
    got, want, got_occ, want_occ = _trace_on_both(cuda, *_trace_case(case))
    _assert_trace_matches(got, want, got_occ, want_occ)
    hit = want["tri"] >= 0
    assert bool(hit.any()) and bool(want_occ.any())
    if case == "parallel":   # rays in a plane never hit its triangles
        assert set(want["tri"][hit].tolist()) == {128}
        assert not bool(hit[::3].any())


def _orbit_props(cuda, width=1920, height=1088, angle_deg=30.0):
    """The combined cell's props (quad_icosphere in the garden box, as
    `portbench/entries/combined.py` builds them) packed on the card, and
    the orbit camera's primary rays (R, 6) on the card."""
    c, e = np.asarray([0.0, 0.0, -4.0]), 2.0
    scene = gt.hybrid.mesh.PROCEDURAL["quad_icosphere"](c - e, c + e, up=1,
                                                        subdiv=2)
    a = np.radians(angle_deg)
    eye = c + 4.0 * np.asarray([np.sin(a), 0.0, np.cos(a)])
    c2w = gt.io.cameras.look_at_inverse(eye, c, np.asarray([0.0, 1.0, 0.0]))
    cam = gt.Camera.from_fovy(width, height, 60.0, c2w)
    o, d = cam.rays()
    rays = torch.as_tensor(np.concatenate([o, d], -1).reshape(-1, 6),
                           device=cuda)
    return scene, rays


def _shadow_rays(scene, hit, rays):
    """`_shade_local`'s shadow rays to the scene's first light from each
    hit (misses included, as there): (rays, tmin, tmax)."""
    lpos = torch.as_tensor(scene.light_table()[0, :3], device=rays.device)
    pos = rays[:, 0:3] + hit["t"][:, None] * rays[:, 3:6]
    to_l = lpos - pos
    dist = torch.linalg.vector_norm(to_l, dim=-1)
    sdir = to_l / dist.clamp_min(1e-12)[:, None]
    srays = torch.cat([pos + sdir * 0.1, sdir], dim=1)
    return (srays, torch.full_like(dist, 0.1),
            torch.where(dist >= 0.5, dist - 0.5, dist))


def test_mesh_trace_kernel_on_the_combined_frame(cuda):
    """The garden combined frame's 1920x1088 primary rays and their shadow
    rays: the kernel's ids and shadow bits equal the chunk loop's (on the
    same card tensors) on every pixel, t, u, v within 1e-6."""
    from gvrt_tpu_torch.hybrid import trace
    scene, rays = _orbit_props(cuda)
    pack = trace.pack_triangles(scene.tri_pos, 512, device=cuda)
    tmin = torch.full((rays.shape[0],), 1e-3, device=cuda)
    got = trace.closest_hit(rays, pack, tmin=tmin)
    want = trace._closest_hit_plain(rays, pack, tmin=tmin)
    assert torch.equal(got["tri"], want["tri"])
    for k in ("t", "u", "v"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
    hit = got["tri"] >= 0
    assert 0.1 < float(hit.float().mean()) < 0.9
    srays, stmin, stmax = _shadow_rays(scene, got, rays)
    occ = trace.occluded(srays, pack, stmin, stmax)
    assert torch.equal(occ, trace._occluded_plain(srays, pack, stmin, stmax))
    assert 0 < int((occ & hit).sum()) < int(hit.sum())


@pytest.mark.parametrize("case", ("soup", "props"))
def test_mesh_trace_warp_skip_is_exact(cuda, case):
    """The kernel with the warp skip against the same kernel without it
    (a null group-box pointer): every output bit for bit, both queries;
    the skip engaged (the optional counter's share of skipped (warp,
    group) visits above 0)."""
    from gvrt_tpu_torch.hybrid import trace
    if case == "soup":
        tri, rays_np, tmin_np, tmax_np, chunk = _trace_case("ragged")
        rays, tmin, tmax = (torch.from_numpy(x).to(cuda)
                            for x in (rays_np, tmin_np, tmax_np))
    else:
        scene, rays = _orbit_props(cuda, 480, 272)
        tri, chunk = scene.tri_pos, 256
        tmin = torch.full((rays.shape[0],), 1e-3, device=cuda)
        tmax = None
    pack = trace.pack_triangles(tri, chunk, device=cuda)
    for any_hit in (False, True):
        bounds = (tmin, tmax if tmax is not None
                  else torch.full_like(tmin, 50.0)) if any_hit \
            else (tmin, tmax)
        stats = torch.zeros(2, dtype=torch.int64, device=cuda)
        skip = trace._launch(any_hit, rays, *pack[:4], pack.groups, *bounds,
                             stats)
        torch.full((64 * rays.shape[0],), float("nan"), device=cuda)
        full = trace._launch(any_hit, rays, *pack[:4], None, *bounds)
        if any_hit:
            skip, full = (skip,), (full,)
        for a, b in zip(skip, full):
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), \
                any_hit
        visits, skipped = stats.tolist()
        assert visits >= -(-rays.shape[0] // 32) and 0 < skipped <= visits


def test_mesh_trace_counts_only_launches_that_return(cuda, monkeypatch):
    """A query whose launch returns a CUDA error raises and adds nothing to
    `.launches` or `gvrt.mesh.trace.kernel`; one that returns adds one to
    each, also through `_launch` directly."""
    from types import SimpleNamespace

    from gvrt_tpu_torch import _build
    from gvrt_tpu_torch.hybrid import trace
    from gvrt_tpu_torch.utils import profiling
    tri, rays_np, tmin_np, tmax_np, chunk = _trace_case("ragged")
    rays, tmin, tmax = (torch.from_numpy(x).to(cuda)
                        for x in (rays_np, tmin_np, tmax_np))
    pack = trace.pack_triangles(tri, chunk, device=cuda)
    trace.closest_hit(rays, pack, tmin=tmin, tmax=tmax)   # builds it

    def launches():
        return (trace.closest_hit.launches, trace.occluded.launches)
    failing = SimpleNamespace(gvrt_mesh_closest_hit=lambda *a: 1,
                              gvrt_mesh_occluded=lambda *a: 1)
    before = launches()
    profiling.reset()
    with torch.profiler.profile():
        with monkeypatch.context() as m:
            m.setattr(_build, "load", lambda name: failing)
            with pytest.raises(RuntimeError):
                trace.closest_hit(rays, pack, tmin=tmin, tmax=tmax)
            with pytest.raises(RuntimeError):
                trace.occluded(rays, pack, tmin, tmax)
        assert launches() == before
        trace.closest_hit(rays, pack, tmin=tmin, tmax=tmax)
        trace.occluded(rays, pack, tmin, tmax)
        trace._launch(True, rays, *pack[:4], None, tmin, tmax)
        torch.cuda.synchronize()
    counts = profiling.recorded()["counts"]
    profiling.reset()
    assert launches() == (before[0] + 1, before[1] + 2)
    assert counts["gvrt.mesh.trace.kernel"] == 3


# ---- camera rays: the kernel against the plain route -------------------------

def _orbit_camera(width, height, seed, fovy=50.0):
    """A camera at a random place with a random rotation (the kernel's f64
    products see every matrix entry)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(4)
    a, b, c, d = q / np.linalg.norm(q)
    c2w = np.eye(4)
    c2w[:3, :3] = [[a * a + b * b - c * c - d * d, 2 * (b * c - a * d),
                    2 * (b * d + a * c)],
                   [2 * (b * c + a * d), a * a - b * b + c * c - d * d,
                    2 * (c * d - a * b)],
                   [2 * (b * d - a * c), 2 * (c * d + a * b),
                    a * a - b * b - c * c + d * d]]
    c2w[:3, 3] = rng.uniform(-3.0, 3.0, 3)
    return gt.Camera.from_fovy(width, height, fovy, c2w)


def _bit_equal(got, want):
    """Entries equal bit for bit, NaN matching NaN."""
    return ((got.view(torch.int32) == want.view(torch.int32))
            | (got.isnan() & want.isnan()))


def _rays_both_ways(cuda, cam, cfg, **kw):
    """(kernel, plain route) rays of `cam` on the card, the kernel's after a
    NaN-poisoned allocator; the kernel launched once."""
    want = binning.tile_rays(cam, cfg, cuda, impl="torch", **kw)
    before = binning.camera_rays_kernel.launches
    torch.full((2 * want.numel(),), float("nan"), device=cuda)
    got = binning.tile_rays(cam, cfg, cuda, impl="cuda", **kw)
    torch.cuda.synchronize()
    assert binning.camera_rays_kernel.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    return got, want


def _assert_rays_match(got, want):
    same = _bit_equal(got, want)
    assert bool(same[:, 0:3].all()), "origins"
    d_same = same[:, 3:6]
    assert float(d_same.double().mean()) >= 0.99999, "directions"
    ulps = (got[:, 3:6].view(torch.int32).long()
            - want[:, 3:6].view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 1, int(ulps.max())
    rows_same = same.all(dim=1)
    assert bool(rows_same[d_same.all(dim=1)].all()), "rows"
    # every entry written: NaN only where the plain route has it (a clip)
    assert not bool((got.isnan() & ~want.isnan()).any())


RAY_CASES = {  # width, height, tile, SH degree
    "1080p_t16": (1920, 1088, 16, 3),
    "t8_deg0": (96, 48, 8, 0),
    "t20_R400": (200, 120, 20, 3),
    "t32_deg2": (256, 160, 32, 2),
    "t64_R4096_deg1": (256, 192, 64, 1),
}


@pytest.mark.parametrize("name", sorted(RAY_CASES))
def test_camera_ray_kernel_matches_plain_route(cuda, name):
    w, h, tile, deg = RAY_CASES[name]
    cfg = BASE.replace(tile_size=tile, sh_degree=deg)
    got, want = _rays_both_ways(cuda, _orbit_camera(w, h, tile), cfg)
    _assert_rays_match(got, want)
    assert bool(got.isfinite().all())
    # degree d fills (d + 1)^2 basis rows, the rest are zero
    assert bool((got[:, 8 + (deg + 1) ** 2:] == 0).all())


def test_camera_ray_kernel_edge_cases(cuda):
    """An aabb override; an identity camera at tile 5 whose centre ray has
    x = y = 0 exactly (the +-1e-6 direction clamp); a tmax clip with
    finite, inf and NaN entries."""
    box = (-1.0, -2.0, -0.5, 1.5, 0.5, 2.0)
    got, want = _rays_both_ways(cuda, _orbit_camera(160, 96, 3), BASE,
                                aabb=box)
    _assert_rays_match(got, want)
    free, _ = _rays_both_ways(cuda, _orbit_camera(160, 96, 3), BASE)
    assert bool((got[:, 6:8] != free[:, 6:8]).any())

    cam = gt.Camera.from_fovy(45, 35, 60.0, np.eye(4))
    cfg5 = BASE.replace(tile_size=5)
    got, want = _rays_both_ways(cuda, cam, cfg5)
    _assert_rays_match(got, want)
    centre = binning.untile(want, 45, 35, 5)[17, 22]
    assert float(centre[3]) == 0.0 and float(centre[4]) == 0.0
    assert bool(got.isfinite().all())

    cam = _orbit_camera(160, 96, 4)
    g = torch.Generator(device=cuda).manual_seed(4)
    clip = 0.5 + 3.0 * torch.rand((96, 160), generator=g, device=cuda)
    clip[:, 80:] = float("inf")
    clip[::7] = float("nan")
    got, want = _rays_both_ways(cuda, cam, BASE, tmax_clip=clip)
    _assert_rays_match(got, want)
    tmax = binning.untile(got[:, 7:8], 160, 96, 16)[..., 0]
    assert bool(tmax[::7].isnan().all())
    assert int(tmax.isnan().sum()) == tmax[::7].numel()


@pytest.mark.parametrize("angle", (0.0, 45.0, 137.5))
def test_combined_frame_rays_from_the_ray_kernel(cuda, angle):
    """At 1920x1088 on the garden orbit, the combined frame's one ray
    build (the camera-ray kernel, once) gives the mesh pass rows 0:6 equal
    to `Camera.rays()` in float32 bit for bit, and the march rays equal to
    `tile_rays(..., tmax_clip=mesh_t)` on the kernel and on the plain
    route."""
    import json
    from gvrt_tpu_torch.render import combined, tiled
    from portbench.entries.combined import mesh_scene
    from portbench.reference.camera import orbit_view
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs",
                           "garden5m_mesh.json")) as f:
        conf = json.load(f)
    w, h = conf["resolution"]
    view = orbit_view(conf["centre"], conf["camera_distance"], angle,
                      conf["fovy_deg"], w, h)
    cam = gt.Camera.from_fovy(w, h, view.fovy_deg, view.c2w)
    g = torch.Generator(device=cuda).manual_seed(1)
    model = gt.random_gaussians(g, 3000, extent=2.0, device=cuda)
    with torch.no_grad():
        model.means[:, 2] -= 4.0
    r = combined.CombinedRenderer(w, h, mesh_scene(gt, conf), BASE,
                                  gt.hybrid.HybridConfig(), device=cuda)
    seen = {}
    real_mesh, real_march = combined._mesh_pass, tiled.forward_dispatch

    def mesh_pass(dev, hcfg, rays, **kw):
        seen["mesh"] = rays.clone()
        return real_mesh(dev, hcfg, rays, **kw)

    def march(binned, rays, cfg, impl):
        seen["march"] = rays.clone()
        return real_march(binned, rays, cfg, impl)
    combined._mesh_pass, tiled.forward_dispatch = mesh_pass, march
    try:
        before = binning.camera_rays_kernel.launches
        with torch.no_grad():
            out = r.render(model, cam)
        torch.cuda.synchronize()
        launched = binning.camera_rays_kernel.launches - before
    finally:
        combined._mesh_pass, tiled.forward_dispatch = real_mesh, real_march
    assert launched == 1
    o, d = cam.rays()
    want = torch.from_numpy(np.concatenate([o, d], -1)).to(cuda)
    assert torch.equal(seen["mesh"].view(torch.int32),
                       want.view(torch.int32))
    on_mesh = float(out["mesh_t"].isfinite().float().mean())
    assert 0.2 <= on_mesh <= 0.5, on_mesh
    clipped = binning.tile_rays(cam, BASE, cuda, impl="cuda",
                                tmax_clip=out["mesh_t"])
    assert bool(_bit_equal(seen["march"], clipped).all())
    _assert_rays_match(seen["march"], binning.tile_rays(
        cam, BASE, cuda, impl="torch", tmax_clip=out["mesh_t"]))


def _synth_model(cuda):
    """The 300k frame's scene and camera."""
    g = torch.Generator(device=cuda).manual_seed(0)
    n = 300_000
    model = gt.random_gaussians(g, n, extent=1.0, scale_range=(-6.1, -4.4),
                                device=cuda)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
        model.opacity_logit.copy_(-3.5 + 4.0 * torch.rand(
            n, generator=g, device=cuda))
    return model, gt.Camera.from_fovy(1920, 1088, 50.0, np.eye(4))


def test_frame_on_kernel_rays_matches_plain_rays(cuda):
    """The 300k frame at 1920x1088 through `TiledRenderer.render` (its rays
    from the kernel), then K1 on the same topology with the plain route's
    rays: hit counts equal on every ray whose rows are bit-equal."""
    model, cam = _synth_model(cuda)
    r = gt.render.TiledRenderer(1920, 1088)
    before = binning.camera_rays_kernel.launches
    with torch.no_grad():
        out = r.render(model, cam)
        assert binning.camera_rays_kernel.launches == before + 1
        rays_k = r._rays(cam)
        rays_t = binning.tile_rays(cam, BASE, cuda, impl="torch")
        act = model.activate()
        topo = r._topology(act, cam, False)
        binned = binning.binned_scene(
            binning.gather_chunks(act, topo, BASE), topo)
        acc_k = pf.forward_dispatch(binned, rays_k, BASE, "cuda")
        acc_t = pf.forward_dispatch(binned, rays_t, BASE, "cuda")
    assert int(out["overflow"]) == 0
    hits = binning.untile(acc_k, 1920, 1088, 16)[..., 5]
    assert torch.equal(hits, out["hit_count"])
    same = _bit_equal(rays_k, rays_t).all(dim=1)
    assert float(same.double().mean()) >= 0.9999
    assert torch.equal(acc_k[:, 5][same], acc_t[:, 5][same])
    assert float(out["hit_count"].mean()) > 1.0


# ---- the max-scan kernel: binning's run fills --------------------------------

SCAN_TILE = 4096  # csrc/max_scan.cu's kTile: elements a block
SCAN_LENGTHS = [1, 2, SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1, 2**20 + 17,
                3 * 10**7]
SCAN_SENTINEL = -0x5A5A5A5A5A5A5A5B


def _scan_input(case, n):
    """int64 inputs drawn with a fixed seed: binning's sparse non-negative
    run starts over zeros, negative values (the lowest int64 first), long
    equal runs across tile edges, a strictly decreasing array."""
    rng = np.random.default_rng(n)
    if case == "spikes":
        x = np.zeros(n, np.int64)
        at = rng.integers(0, n, max(1, n // 50))
        x[at] = rng.integers(0, 2**40, at.size)
    elif case == "negative":
        x = rng.integers(-2**63, 0, n, dtype=np.int64)
        x[0] = -2**63
    elif case == "runs":
        x = np.repeat(rng.integers(-2**62, 2**62, n // 5003 + 1), 5003)[:n]
    else:
        assert case == "decreasing", case
        x = 2**40 - np.arange(n, dtype=np.int64)
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n", SCAN_LENGTHS)
@pytest.mark.parametrize("case", ["spikes", "negative", "runs", "decreasing"])
def test_max_scan_matches_cummax(cuda, case, n):
    """The kernel's scan bit for bit cummax's values, twice, each after an
    allocator filled with a sentinel; an input 8 bytes off 16-byte
    alignment takes the element loads and gives the same."""
    from gvrt_tpu_torch import _build
    scan = gt.render.scan
    lib = _build.load("max_scan")
    assert [lib.gvrt_max_scan_scratch_words(k) for k in
            (SCAN_TILE, SCAN_TILE + 1)] == [4, 7]
    x = _scan_input(case, n).to(cuda)
    want = torch.cummax(x, 0).values
    before = scan.max_scan.launches
    outs = []
    for _ in range(2):
        torch.full((2 * n + 64,), SCAN_SENTINEL, dtype=torch.int64,
                   device=cuda)
        outs.append(scan.max_scan(x))
    torch.cuda.synchronize()
    assert scan.max_scan.launches == before + (2 if n > 1 else 0)
    for got in outs:
        assert got.dtype == torch.int64 and got.shape == (n,)
        assert torch.equal(got, want)
    if n > 2:
        off = x[1:]
        assert off.data_ptr() % 16 == 8
        assert torch.equal(scan.max_scan(off), torch.cummax(off, 0).values)


def _garden_model(cuda):
    """The 5M garden scene of `chip_smoke.py` and its 1920x1088 camera."""
    g = torch.Generator(device=cuda).manual_seed(0)
    n = 5_000_000
    model = gt.random_gaussians(g, n, extent=2.0, scale_range=(-7.3, -5.3),
                                device=cuda)
    with torch.no_grad():
        model.opacity_logit.copy_(-3.5 + 4.0 * torch.rand(
            n, generator=g, device=cuda))
        model.means[:, 2] -= 4.0
    return model, gt.Camera.from_fovy(1920, 1088, 60.0, np.eye(4))


@pytest.mark.parametrize("name", ["synth300k_reduce", "garden5m_reduce",
                                  "garden5m_band_compact"])
def test_binning_topology_with_max_scan_is_bit_identical(cuda, name,
                                                         monkeypatch):
    """`bin_topology` with its run fills on the kernel against the same call
    with them on cummax (patched in here): every topology and plan field
    equal.  The 300k frame and the 5M frame unbanded with K3's plan (four
    fills), and the first of two contiguous bands of the y-sorted 5M scene
    with the compact plan (three)."""
    model, cam = (_synth_model if name.startswith("synth")
                  else _garden_model)(cuda)
    w, h = cam.width, cam.height
    if name.endswith("compact"):
        model = model.sorted_for_camera(cam, BASE)
    with torch.no_grad():
        act = model.activate()
        w2c, proj = _camera_mats(cam)
        if name.endswith("compact"):
            cap, cap_pad, cl, cr, crg = bd.plan_capacity_banded(
                model, cam, 2, BASE, with_reduce=True, mode="contig")
            tab = binning.frame_cull_table(act, w2c, proj, w, h, BASE)

            def topology():
                return binning.bin_topology_from_table(
                    tab, proj, w, h, BASE, cap, cap_pad, row_offset=0,
                    row_count=h // BASE.tile_size // 2, capacity_reduce=cr,
                    capacity_live=cl, capacity_range=crg)
            plan, fills = sr.CompactReducePlan, 3
        else:
            r = gt.render.TiledRenderer(w, h, BASE, device=cuda)
            r.plan(model, [cam])

            def topology():
                return binning.bin_topology(
                    act, w2c, proj, w, h, BASE, *r.capacity,
                    capacity_reduce=r.capacity_reduce)
            plan, fills = sr.ReducePlan, 4
        before = gt.render.scan.max_scan.launches
        got = topology()
        torch.cuda.synchronize()
        assert gt.render.scan.max_scan.launches == before + fills

        def plain(x):
            return torch.cummax(x, 0).values
        with monkeypatch.context() as m:
            m.setattr(binning, "max_scan", plain)
            m.setattr(sr, "max_scan", plain)
            want = topology()
    assert int(got.overflow) == 0 and int(got.num_pairs) > 0
    assert isinstance(got.red, plan) and isinstance(want.red, plan)
    for field in binning.BinTopology._fields:
        if field == "red":
            for f in plan._fields:
                assert torch.equal(getattr(got.red, f),
                                   getattr(want.red, f)), f"red.{f}"
        else:
            assert torch.equal(getattr(got, field),
                               getattr(want, field)), field


# ---- binning's pair expansion: the kernel against the plain route ------------

EXPAND_CASES = ["synth300k_reduce", "garden5m_reduce", "garden5m_band_compact",
                "synth300k_stride2", "synth300k_overflow", "no_valid",
                "near_plane", "covers_every_tile"]


def _expand_case(cuda, name):
    """A topology closure of one case, its capacity, and what the case
    must show: "overflow", "empty" or "fits"."""
    ts = BASE.tile_size
    if name.startswith("garden"):
        model, cam = _garden_model(cuda)
    else:
        model, cam = _synth_model(cuda)
    w, h = cam.width, cam.height
    nx, ny = w // ts, h // ts
    if name == "no_valid":      # the camera turned away from the scene
        c2w = np.diag([-1.0, 1.0, -1.0, 1.0])
        cam = gt.Camera.from_fovy(w, h, 50.0, c2w)
    if name in ("near_plane", "covers_every_tile"):
        with torch.no_grad():
            # four Gaussians straddling the near plane, or large ones
            # wholly in front whose rects cover the frame
            z, s = (-0.002, -3.0) if name == "near_plane" else (-2.9, -0.7)
            model.means[:4] = torch.tensor([0.0, 0.0, z], device=cuda)
            model.means[:4, 0] += torch.arange(4, device=cuda) * 1e-3
            model.scales_log[:4] = s
            model.opacity_logit[:4] = 2.0
    if name.endswith("compact"):
        model = model.sorted_for_camera(cam, BASE)
    with torch.no_grad():
        act = model.activate()
        w2c, proj = _camera_mats(cam)
        tab = binning.frame_cull_table(act, w2c, proj, w, h, BASE)
    if name in ("near_plane", "covers_every_tile"):
        rect = torch.stack([tab.tx0[:4], tab.ty0[:4], tab.tx1[:4],
                            tab.ty1[:4]], dim=1).cpu()
        assert bool(tab.valid[:4].all())
        assert torch.equal(rect, torch.tensor([[0, 0, nx - 1, ny - 1]] * 4,
                                              dtype=torch.int32))
        near = float(tab.depth[:4].max()) < 0.05
        assert near == (name == "near_plane")
    if name == "no_valid":
        assert not bool(tab.valid.any())
    kw = {}
    if name.endswith("compact"):
        cap, cap_pad, cl, cr, crg = bd.plan_capacity_banded(
            model, cam, 2, BASE, with_reduce=True, mode="contig")
        kw = dict(row_offset=0, row_count=ny // 2, capacity_reduce=cr,
                  capacity_live=cl, capacity_range=crg)
    elif name.endswith("stride2"):
        with torch.no_grad():
            cap, cap_pad = binning.plan_capacity_from_table(
                tab, proj, w, h, BASE, band=(1, 2))
        kw = dict(row_offset=1, row_stride=2)
    else:
        r = gt.render.TiledRenderer(w, h, BASE, device=cuda)
        cap, cap_pad = r.plan(model, [cam])
        kw = dict(capacity_reduce=r.capacity_reduce)
        if name.endswith("overflow"):
            cap = cap // 4 // BASE.chunk_size * BASE.chunk_size
            kw = {}
    expect = ("overflow" if name.endswith("overflow") else
              "empty" if name == "no_valid" else "fits")

    def topology():
        with torch.no_grad():
            return binning.bin_topology_from_table(tab, proj, w, h, BASE, cap,
                                                   cap_pad, **kw)
    return topology, cap, expect


@pytest.mark.parametrize("name", EXPAND_CASES)
def test_pair_expansion_kernel_is_bit_identical(cuda, name, monkeypatch):
    """`bin_topology_from_table` with its expansion on the kernels against
    the same call on the plain version (`_expand_pairs_plain`, patched in
    here) on the same card tensors: the slots' Gaussians and keys, and
    every topology and reduce-plan field, bit for bit, twice, each after
    an allocator filled with a sentinel.  The 300k and 5M frames with K3's
    plan, the first contiguous band of the y-sorted 5M scene with the
    compact plan, a round-robin band, a capacity that overflows, a frame
    with no valid Gaussian, Gaussians straddling the near plane
    (full-screen rects) and Gaussians whose rects cover every tile."""
    topology, cap, expect = _expand_case(cuda, name)
    seen = []
    kernel = binning.expand_pairs

    def spy(*args):
        seen.append((args, kernel(*args)))
        return seen[-1][1]
    monkeypatch.setattr(binning, "expand_pairs", spy)
    got = []
    for _ in range(2):
        torch.full((3 * cap + 64,), SCAN_SENTINEL, dtype=torch.int64,
                   device=cuda)
        before = kernel.launches
        got.append(topology())
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
    monkeypatch.setattr(binning, "expand_pairs", binning._expand_pairs_plain)
    want = topology()
    assert len(seen) == 2
    for args, (pair_g, key) in seen:
        want_g, want_key = binning._expand_pairs_plain(*args)
        assert pair_g.dtype == torch.int64 and key.dtype == torch.int32
        assert torch.equal(pair_g, want_g)
        assert torch.equal(key, want_key)
    if expect == "overflow":
        assert int(want.overflow) > 0
    else:
        assert int(want.overflow) == 0
        assert (int(want.num_pairs) == 0) == (expect == "empty")
    for topo in got:
        assert (topo.red is None) == (want.red is None)
        for field in binning.BinTopology._fields:
            if field == "red":
                for f in (type(want.red)._fields if want.red is not None
                          else ()):
                    assert torch.equal(getattr(topo.red, f),
                                       getattr(want.red, f)), f"red.{f}"
            else:
                assert torch.equal(getattr(topo, field),
                                   getattr(want, field)), field


def test_pair_kernel_launches_once_a_frame_and_a_step(cuda):
    """A serving frame and an unbanded step each launch the pair kernel
    once; the counter `gvrt.binning.expand.kernel` counts the same."""
    from gvrt_tpu_torch.utils import profiling
    g = torch.Generator(device=cuda).manual_seed(24)
    model = gt.random_gaussians(g, 2000, extent=0.8, device=cuda)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    cam = gt.Camera.from_fovy(64, 64, 60.0, np.eye(4))
    r = gt.render.TiledRenderer(64, 64, BASE, device=cuda)
    tr = gt.train.Trainer(64, 64, BASE, gt.train.TrainConfig(),
                          r.plan(model, [cam]), device=cuda)
    state = tr.init(model)
    batch = gt.parallel.camera_batch([cam], BASE, cuda)
    target = 0.3 * torch.ones((1, 64, 64, 3), device=cuda)

    def frame():
        with torch.no_grad():
            r.render(model, cam)

    def delta(fn):
        before = binning.expand_pairs.launches
        fn()
        torch.cuda.synchronize()
        return binning.expand_pairs.launches - before
    frame()
    tr.step(state, batch, target)
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        counts = [delta(frame), delta(lambda: tr.step(state, batch, target))]
    rec = profiling.recorded()
    profiling.reset()
    assert counts == [1, 1]
    assert rec["counts"]["gvrt.binning.expand.kernel"] == 2


# ---- the parameter table: both kernels against the plain route ---------------

TABLE_SIZES = [1, 127, 128, 129, 300_000, 5_000_000]


def _table_model(cuda, n, extreme=False):
    """n Gaussians drawn on the card.  `extreme`: log-scales of +-10,
    opacity logits of +-20 and quaternions of norm 1e-3 on alternate
    Gaussians, with every other leaf as drawn."""
    g = torch.Generator(device=cuda).manual_seed(n)
    model = gt.random_gaussians(g, n, extent=1.0, device=cuda)
    if extreme:
        with torch.no_grad():
            sign = 1.0 - 2.0 * (torch.arange(n, device=cuda) % 2)
            model.scales_log[:, 0] = 10.0 * sign
            model.scales_log[:, 2] = -10.0 * sign
            model.opacity_logit.copy_(20.0 * sign)
            q = model.quats[::2]
            q *= 1e-3 / q.norm(dim=1, keepdim=True)
    return model


def _table_both_ways(model):
    """(kernel, plain route) activated views and tables of `model`, the
    kernel's after a NaN-poisoned allocator; the kernel launched once."""
    from gvrt_tpu_torch.render import rows_vjp
    leaves = model.leaves()
    n = model.num_gaussians
    with torch.no_grad():
        act_p = gt.models.gaussians.activate_leaves(*leaves)
        rows_p = binning.param_rows(act_p, BASE)
        torch.full((2 * 64 * (n + 1),), float("nan"), device=model.device)
        before = rows_vjp.param_table_forward.launches
        act_k, rows_k = rows_vjp.param_table_forward(*leaves)
    torch.cuda.synchronize()
    assert rows_vjp.param_table_forward.launches == before + 1
    return (act_k, rows_k), (act_p, rows_p)


def _assert_table_bit_equal(got, want, n):
    (act_k, rows_k), (act_p, rows_p) = got, want
    assert rows_k.shape == (n + 1, 64) and rows_k.is_contiguous()
    assert bool(_bit_equal(rows_k, rows_p).all()), "rows"
    assert act_k.means is act_p.means
    for field in ("scales", "inv_scales", "rot9", "densities", "sh_flat"):
        k, p = getattr(act_k, field), getattr(act_p, field)
        assert k.shape == p.shape, field
        assert bool(_bit_equal(k, p).all()), field
    assert act_k.sh_flat.data_ptr() == rows_k[:, 16:].data_ptr()
    dummy = torch.zeros(64, device=rows_k.device)
    dummy[[0, 4, 8]] = 1.0
    assert torch.equal(rows_k[n], dummy)


@pytest.mark.parametrize("n", TABLE_SIZES)
def test_param_table_forward_is_bit_equal_to_the_plain_route(cuda, n):
    """`param_table_forward` against `activate_leaves` + `param_rows` on the
    card: the table and every activated field bit for bit, the dummy row
    the identity frame and zeros, every entry written."""
    model = (_garden_model(cuda)[0] if n == 5_000_000
             else _synth_model(cuda)[0] if n == 300_000
             else _table_model(cuda, n))
    got, want = _table_both_ways(model)
    _assert_table_bit_equal(got, want, n)
    assert bool(got[1].isfinite().all())


def test_param_table_forward_on_extreme_leaves(cuda):
    """Log-scales of +-10, opacity logits of +-20 (densities of 1 and
    2e-9) and quaternions of norm 1e-3: still bit for bit."""
    n = 1000
    model = _table_model(cuda, n, extreme=True)
    got, want = _table_both_ways(model)
    _assert_table_bit_equal(got, want, n)
    assert float(got[0].densities.max()) == 1.0
    assert float(got[0].densities.min()) < 1e-8


def _table_cotangent(n, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n + 1, 64), generator=g, device=device)


@pytest.mark.parametrize("n", TABLE_SIZES + ["extreme"])
def test_param_table_backward_matches_the_plain_backward(cuda, n):
    """`param_table_backward` against `_Rows64`'s plain backward on a random
    cotangent: each leaf within relative L2 1e-6 (the SH leaves, copies of
    the cotangent's columns, bit for bit), contiguous in the leaf's shape,
    every entry written after a NaN-poisoned allocator, two runs
    bit-identical, and the cotangent's row N not read."""
    from gvrt_tpu_torch.render import rows_vjp
    extreme = n == "extreme"
    n = 1000 if extreme else n
    model = _table_model(cuda, n, extreme=extreme)
    leaves = tuple(p.detach() for p in model.leaves())
    g = _table_cotangent(n, cuda)
    want = rows_vjp._plain_backward(g, *leaves[:4])
    before = rows_vjp.param_table_backward.launches
    torch.full((2 * 64 * (n + 1),), float("nan"), device=cuda)
    got = rows_vjp.param_table_backward(g, leaves)
    again = rows_vjp.param_table_backward(g, leaves)
    g[n] = float("nan")
    off = rows_vjp.param_table_backward(g, leaves)
    torch.cuda.synchronize()
    assert rows_vjp.param_table_backward.launches == before + 3
    names = gt.models.gaussians.LEAVES
    for name, leaf, k, k2, k3, p in zip(names, leaves, got, again, off, want):
        assert k.shape == leaf.shape and k.is_contiguous(), name
        assert bool(k.isfinite().all()), name
        assert torch.equal(k, k2) and torch.equal(k, k3), name
        assert _rel_l2(k, p) <= 1e-6, (name, _rel_l2(k, p))
    assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])


def test_param_table_kernels_take_16_byte_aligned_leaves(cuda):
    """A leaf that is a contiguous view at an offset that is not a multiple
    of 16 bytes is refused; a cotangent at such an offset is copied first,
    with the gradients of the aligned one."""
    from gvrt_tpu_torch.render import rows_vjp
    n = 129
    leaves = tuple(p.detach() for p in _table_model(cuda, n).leaves())
    shifted = torch.empty(n * 3 + 1, device=cuda)[1:].view(n, 3)
    shifted.copy_(leaves[0])
    with pytest.raises(ValueError, match="16-byte"):
        rows_vjp.param_table_forward(shifted, *leaves[1:])
    with pytest.raises(ValueError, match="16-byte"):
        rows_vjp.param_table_backward(_table_cotangent(n, cuda),
                                      (shifted,) + leaves[1:])
    g = _table_cotangent(n, cuda)
    g_shifted = torch.empty(g.numel() + 1, device=cuda)[1:].view_as(g)
    g_shifted.copy_(g)
    want = rows_vjp.param_table_backward(g, leaves)
    got = rows_vjp.param_table_backward(g_shifted, leaves)
    for name, k, w in zip(gt.models.gaussians.LEAVES, got, want):
        assert torch.equal(k, w), name


@pytest.mark.parametrize("name", ["synth300k", "garden5m"])
def test_serving_topology_from_the_kernel_view_is_bit_identical(cuda, name):
    """The 300k and 5M serving frames binned from the kernel's activated
    view and from the plain route's: every topology field equal."""
    model, cam = (_synth_model if name == "synth300k"
                  else _garden_model)(cuda)
    (act_k, _), (act_p, _) = _table_both_ways(model)
    w, h = cam.width, cam.height
    r = gt.render.TiledRenderer(w, h, BASE, device=cuda)
    r.plan(model, [cam])
    w2c, proj = _camera_mats(cam)
    with torch.no_grad():
        got, want = (binning.bin_topology(act, w2c, proj, w, h, BASE,
                                          *r.capacity,
                                          with_reduce_plan=False)
                     for act in (act_k, act_p))
    assert int(got.overflow) == 0 and int(got.num_pairs) > 0
    for field in binning.BinTopology._fields:
        if field != "red":
            assert torch.equal(getattr(got, field), getattr(want, field)), \
                field


def test_trainer_step_gradients_with_the_table_kernels(cuda, monkeypatch):
    """An unbanded `Trainer` step of two cameras with the table's kernels
    against the same step with the plain table route (every other kernel
    the same): the leaves' gradients within relative L2 1e-6 (the forward
    is bit-equal, so only the table's backward differs), and the kernels
    launched once a camera each way."""
    from gvrt_tpu_torch.render import rows_vjp
    from gvrt_tpu_torch.train import trainer as trainer_mod
    g = torch.Generator(device=cuda).manual_seed(21)
    base = gt.random_gaussians(g, 2000, extent=0.8, device=cuda)
    with torch.no_grad():
        base.means[:, 2] -= 3.0
    cams = [gt.Camera.from_fovy(96, 96, 60.0, np.eye(4)),
            gt.Camera.from_fovy(96, 96, 55.0, np.eye(4))]
    batch = gt.parallel.camera_batch(cams, BASE, cuda)
    targets = 0.3 * torch.ones((2, 96, 96, 3), device=cuda)
    cap = gt.render.TiledRenderer(96, 96, BASE, device=cuda).plan(base, cams)
    grads = {}
    for impl in ("cuda", "torch"):
        model = gt.GaussianModel(*(p.detach().clone()
                                   for p in base.leaves()))
        tr = gt.train.Trainer(96, 96, BASE, gt.train.TrainConfig(), cap,
                              device=cuda)
        with monkeypatch.context() as m:
            if impl == "torch":
                m.setattr(trainer_mod, "frame_params",
                          lambda model, cfg, impl: rows_vjp.frame_params(
                              model, cfg, "torch"))
            before = (rows_vjp.param_table_forward.launches,
                      rows_vjp.param_table_backward.launches)
            tr.step(tr.init(model), batch, targets)
            torch.cuda.synchronize()
            launched = (rows_vjp.param_table_forward.launches - before[0],
                        rows_vjp.param_table_backward.launches - before[1])
        assert launched == ((2, 2) if impl == "cuda" else (0, 0)), impl
        grads[impl] = [p.grad.clone() for p in model.leaves()]
    for name, k, p in zip(gt.models.gaussians.LEAVES, grads["cuda"],
                          grads["torch"]):
        assert float(p.abs().max()) > 0, name
        assert _rel_l2(k, p) <= 1e-6, (name, _rel_l2(k, p))


def test_table_kernels_launch_once_a_frame_and_a_step(cuda):
    """A serving frame launches the forward once and the backward never; an
    unbanded step of one camera and a banded step of two bands launch each
    once; the counters `gvrt.param_table.kernel` and
    `gvrt.param_table.bwd.kernel` count the same, and the plain route's
    two `gvrt.param_table` spans a frame are one."""
    from gvrt_tpu_torch.render import rows_vjp
    from gvrt_tpu_torch.utils import profiling
    g = torch.Generator(device=cuda).manual_seed(22)
    model = gt.random_gaussians(g, 2000, extent=0.8, device=cuda)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    cam = gt.Camera.from_fovy(64, 64, 60.0, np.eye(4))
    r = gt.render.TiledRenderer(64, 64, BASE, device=cuda)
    cap = r.plan(model, [cam])
    tr = gt.train.Trainer(64, 64, BASE, gt.train.TrainConfig(), cap,
                          device=cuda)
    state = tr.init(model)
    batch = gt.parallel.camera_batch([cam], BASE, cuda)
    target = 0.3 * torch.ones((1, 64, 64, 3), device=cuda)
    banded_model = model.sorted_for_camera(cam, BASE)
    bt = gt.train.Trainer(64, 64, BASE, gt.train.TrainConfig(
        span_bands=True), n_bands=2, device=cuda)
    bstate = bt.init(banded_model)

    def launches():
        return (rows_vjp.param_table_forward.launches,
                rows_vjp.param_table_backward.launches)

    def delta(fn):
        before = launches()
        fn()
        torch.cuda.synchronize()
        return tuple(a - b for a, b in zip(launches(), before))

    def frame():
        with torch.no_grad():
            r.render(model, cam)
    frame()
    tr.step(state, batch, target)
    bt.step(bstate, cam, target[0])
    profiling.reset()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        counts = [delta(frame), delta(lambda: tr.step(state, batch, target)),
                  delta(lambda: bt.step(bstate, cam, target[0]))]
    rec = profiling.recorded()
    profiling.reset()
    assert counts == [(1, 0), (1, 1), (1, 1)]
    assert rec["counts"]["gvrt.param_table.kernel"] == 3
    assert rec["counts"]["gvrt.param_table.bwd.kernel"] == 2
    assert rec["spans"]["gvrt.param_table"]["calls"] == 3
    assert rec["spans"]["gvrt.param_table.bwd"]["calls"] == 2


def test_four_nccl_ranks_take_the_batch_step(cuda, tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards: one NCCL rank a card")
    import port_parallel_worker as w
    from gvrt_tpu_torch.models.gaussians import LEAVES
    g = torch.Generator(device="cpu").manual_seed(12)
    model = gt.random_gaussians(g, 2000, extent=0.6, device="cpu")
    with torch.no_grad():
        model.means[:, 2] -= 3.0
    c2w = np.tile(np.eye(4), (1, 4, 1, 1))
    c2w[0, :, 0, 3] = [-0.03, -0.01, 0.01, 0.03]
    targets = np.random.default_rng(13).uniform(
        0.0, 0.5, (1, 4, w.DP_RES, w.DP_RES, 3)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", c2w=c2w, targets=targets,
             **model.to_numpy())
    w.start_ranks("data_parallel_cuda", tmp_path, world=4)()
    outs = [dict(np.load(tmp_path / f"out{r}.npz")) for r in range(4)]
    for r in range(1, 4):
        for key, value in outs[0].items():
            np.testing.assert_array_equal(outs[r][key], value,
                                          err_msg=f"rank {r}: {key}")
    cfg = w.cfg_dp(gt)
    one = model.to(cuda)
    cams = [gt.Camera.from_fovy(w.DP_RES, w.DP_RES, w.DP_FOVY, m)
            for m in c2w[0]]
    cap = gt.render.TiledRenderer(w.DP_RES, w.DP_RES, cfg,
                                  device=cuda).plan(one, cams)
    tr = gt.train.Trainer(w.DP_RES, w.DP_RES, cfg, gt.train.TrainConfig(),
                          cap, device=cuda)
    _, loss = tr.step(tr.init(one), gt.parallel.camera_batch(cams, cfg, cuda),
                      torch.as_tensor(targets[0], device=cuda))
    np.testing.assert_allclose(float(outs[0]["loss0"]), float(loss),
                               rtol=1e-6)
    for name, p in zip(LEAVES, one.leaves()):
        np.testing.assert_allclose(outs[0][f"param0_{name}"],
                                   p.detach().cpu().numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
