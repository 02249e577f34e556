#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, serve,
train, time.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. set-up: the card's name and power limit, TF32 off, the nine kernel
     libraries (tile_forward, tile_backward, camera_rays, max_scan,
     param_table, bin_expand, mesh_trace, segment_reduce,
     segment_reduce_compact) built
     from csrc/ with nvcc, all at once;
 1b. the camera-ray kernel (csrc/camera_rays.cu) at
     1920x1088, tile 16, against the plain route on the card (NumPy rays,
     the upload, tile_ray_rows) after a NaN-poisoned allocator: origins
     bit-equal, directions bit-equal on >= 99.999% of components and
     within one f32 ulp, every row bit-equal on every ray whose direction
     is; the kernel timed with and without a tmax clip beside its byte
     bound, and the plain route's three parts timed in the same call;
 1c. the max-scan kernel (csrc/max_scan.cu, binning's run fills) at the
     pair capacity of the garden serving frame (TiledRenderer.plan of the
     5M scene at its camera), on binning's shape (sparse run starts over
     zeros): against cummax's values after a NaN-poisoned allocator,
     timed beside its byte bound (16 bytes an element) and beside cummax,
     which the port no longer calls on the card;
 1d. the parameter-table kernels (csrc/param_table.cu) at 300k and 5M
     Gaussians, after a NaN-poisoned allocator: the forward's table and
     activated view bit for bit the plain route's (activate_leaves,
     param_rows), the backward's six gradients within relative L2 1e-6 of
     `_Rows64`'s plain backward on a random cotangent; each timed beside
     the plain route and its byte bound (556 and 536 bytes a Gaussian); a
     serving frame (phase 3) must launch the forward once and the
     training window (phase 5) each kernel once a step;
 1e. binning's pair expansion (csrc/bin_expand.cu: run starts, the
     max-scan, each slot's tile, exact cull and int32 key) at the garden
     serving frame's pair capacity, after a NaN-poisoned allocator: the
     slots' Gaussians and keys bit for bit the plain version's
     (`_expand_pairs_plain`) on the same card tensors; the expansion and
     its pair-key kernel timed beside their byte bounds and the plain
     version; a serving frame (phase 3) and the unbanded bind (phase 5)
     must launch the pair kernel once;
 1f. the mesh-trace kernel (csrc/mesh_trace.cu) on the combined cell's
     mesh (quad_icosphere in the garden box, 322 triangles) under its
     first 1920x1088 orbit view and the shadow rays to its light, after a
     NaN-poisoned allocator: ids and shadow bits equal to the chunk
     loop's on the same card tensors on every pixel; closest_hit and
     occluded timed beside the chunk loop, the kernel without its warp
     skip and their bounds from the work the skip left
     (trace_work_bound: the skip's share from the kernel's optional
     counter; all pairs as brute_force_ms); phase 3d's served frame must
     launch each query once;
  2. the tile kernels against their plain PyTorch versions on the same
     binned inputs: small scenes at tile_size=8/chunk_size=128, at the
     defaults with log-space transmittance, with another kernel degree, a
     scene with empty tiles + dead trailing chunks + saturated tiles, and a
     512-tile slice of the full-width frame.  On each: K1 (forward), K1's
     residual variant (T_in) and K2 (the backward, with ray gradients on
     two scenes; per column group and per column), the latter two after a
     NaN-poisoned allocator;
 2b. K1 (serving and residual) and K2 (with and without ray gradients) at
     tile 20, the light field's (R = 400 rays, no multiple of 32), on the
     3000-Gaussian scene at 120^2, after a NaN-poisoned allocator, each
     twice (bit-identical);
 2c. the tile and chunk sizes past one block (SHAPES_SMALL: R = 529, 576,
     1024, 1089, 4096 and G = 128, 256, 512, 1024) on that scene, as in
     2b; then
     the full-width frame at (tile, chunk) (16, 64), (32, 64), (16, 256)
     and (64, 256) (SHAPES_FULL): the serving frame and one training step
     through TiledRenderer, each with its launches counted (the step's
     six gradients against the all-plain path), K1 (serving, residual)
     and K2 (both instances) against their plain versions, timed beside
     their bounds (chain_counts); one optimize_camera_poses step at (32,
     64) (K2's ray-gradient instances at R = 1024) with its launches
     counted, its pose gradient against the plain versions, timed;
  3. the full-width frame (1920x1088, 300k Gaussians, the scene of the
     JAX package's bench.py made from a torch.Generator) through
     TiledRenderer.plan + render under torch.no_grad() (serving: K1 without
     the residual), with the launch counts read around that run; then
     CUDA-event timings of render, render_bound, K1 alone and (once) its
     plain version; then banded serving of the same frame against it
     (render_image_banded with 4 stride bands, 4 span bands on the y-sorted
     model, a 2-band balanced BandedRenderer.render_bound), no K2 or K4;
 3c. the light field of that scene (models/lightfield.py: 4 cameras, 180^2,
     tile 20, 135 degrees) with K1's launches counted, against its plain
     version; K1 timed at one light-field camera's shapes;
 3d. the combined Gaussian-and-mesh frame of that scene at 1920x1088
     (render/combined.py; a quad at z = -3 over the left half, an
     icosphere in front of the right half), served by a CombinedRenderer
     under torch.no_grad(): its rays one launch of the camera-ray kernel,
     the mesh pass's rows of them equal to Camera.rays(), K1 and each
     mesh-trace query (closest_hit, occluded) launched once and nothing
     else, K1 against its plain version on the
     same binned inputs and the per-pixel clipped rays (hit counts equal on
     every ray), rgb = gaussian_rgb + T mesh_rgb, hit counts no higher
     than the unclipped frame's on every ray that did not saturate there,
     lower in sum over the quad, equal off the mesh; the frame, its mesh
     pass, its Gaussian pass and its mesh spans (gvrt.mesh, .trace,
     .shadow, .shade) timed, K1 on the clipped rays timed beside its bound;
 3e. the gradient of mean rgb through the combined frame of the
     3000-Gaussian 128^2 scene: K1's residual, K2 and K3 launched once
     each, all six parameter groups against the all-plain path, finite
     after a NaN-poisoned allocator; K1's residual and K2 on its clipped
     rays against their plain versions;
 3f. Gaussian shadows on that frame against the port on the CPU; the
     shadow pass timed beside its bound;
  4. the serving entry point: the CLI renders 4 orbit frames of that scene
     at 1920x1088 from a PLY, unbanded, with --bands 4 and with --mesh
     quad_icosphere (and benchmarks that for 4 s), and benchmarks
     it with --bands 4; the CLI's `lightfield` from the PLY (4 PNGs and
     ray_dirs.npy);
 4b. the hybrid renderer (hybrid/): the CLI's `hybrid` at 512^2 (one
     frame, then --glass --frames 2), HybridRenderer's 512^2 frame timed
     with its trace calls counted, the mesh trace (closest_hit, occluded)
     timed alone beside its bound, the card's 64^2 frame against the
     CPU's, the miss path with a ZLIB KTX2 cubemap (save_ktx2,
     load_cubemap);
 4c. the native PLY reader (native/): built with g++, the phase-4 PLY
     read bit for bit as the NumPy reader reads it, both timed;
  5. the full-width training window (bench.py's protocol): plan with the
     reduce capacity, one topology refresh with the reduce plan, then 10
     steps of frame_params -> gather_from_rows -> forward_dispatch ->
     L2 loss against 0.3 in tiled space -> backward (K2, K3) -> SGD with
     lr 1e-12, launch counts read around it; then its CUDA-event time and
     the kernels' times at the frame's shapes; K2 with the ray cotangents
     (pose refinement's instances) on the same inputs against its plain
     version, and timed A B B A against the instances without them;
  6. K3 against its plain version and index_add_ on the window's real
     per-slot cotangents;
  7. the whole-step gradient, kernels against plain versions, on a
     3000-Gaussian 128^2 scene and on a 512-tile slice of the full frame;
  8. the training entry point: the CLI trains the PLY for 3 steps at
     1920x1088 against the phase-4 renders and writes a PLY, unbanded and
     with --bands 2 --span-bands --sort-scene;
 8b. pose refinement of the full-width frame: the phase-3 camera perturbed
     (perturb_cameras, sigma_t 0.02, seed 0) against the unperturbed
     frame's rgb, 20 steps of optimize_camera_poses at lr 3e-3 (the loss
     must fall), launch counts read around it (K1 serving once for loss0,
     K1's residual and K2 with ray cotangents once per step); the first
     step's pose gradient, kernels against plain versions; the CUDA-event
     time of one pose step;
 8c. the CLI trains with pose refinement and Adafactor: train --frames 4
     --steps 3 --optimizer adafactor --optimize-poses 10 --perturb-poses
     0.02 against the phase-4 renders;
 8d. the evaluation entry point: the CLI's eval of 4 frames, unbanded,
     then with --bands 4 and --gt-dir on the first: every view compared,
     every one identical;
 8e. multi-device on the one card: the CLI's `train --devices 1` (one NCCL
     rank, the real all-reduce), then two gloo ranks sharing the card
     (device list ["cuda:0", "cuda:0"] named explicitly): the sharded
     batch render of 4 orbit cameras against the unsharded renders, the
     tile-sharded frame against TiledRenderer's, and one Trainer(mesh)
     step with 2 cameras against the unsharded step, with each rank's
     launch counts; no speed-up is claimed (two ranks time-share one card);
  9. K4, in both modes, against its plain versions and index_add_ on the
     two span bands of a 3000-Gaussian 128^2 scene, and the banded step's
     gradients, kernels against plain versions, on stride, span and
     balanced bands;
 10. the garden-scale banded training window (the JAX package's
     scripts/config2_scale.py scene: 5M Gaussians at 1920x1088, 2 span
     bands on the y-sorted model): generation, y-sort, plan and bind
     timed, then 10 Trainer.steps with launch counts (K4 in its table
     mode), step time and peak memory; then K1's residual and K2 against
     their plain versions on band 0's busiest 512 tiles, K1 (serving and
     residual) and K2 timed at band 0's full shapes beside their bounds,
     and K4 on the window's real per-slot cotangents in both modes, timed
     against its plain versions and index_add_, table mode also against
     the two-step route it replaced (compact sums, then the expansion);
 11. the hot spots with no Pallas counterpart (the mesh trace, the
     Gaussian shadow pass) on one line; one JSON line per kernel with its
     launches, error, time and bound
     (K1 and K2 also at garden band 0's shapes; their bounds count the
     gate chain as this run's data needs it, chain_counts, with the
     earlier whole-chain count beside them as bound_ms_chain72; K4's
     launches are both modes', its table mode's numbers in `table_mode`;
     K1's light-field launches and time, and the R = 400 errors; K1's
     combined-frame launches, error, time and bound, and the launches and
     errors of K1's residual, K2 and K3 in the differentiated frame; the
     2c errors at each shape, and times and bounds at each full-width
     shape);
 12. the last line: {"ok": true, "device": {...}}.

It needs no network and stops every process it starts.  Without CUDA, or
run from a directory without the port's package, it exits non-zero before
printing any result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "3dgvrt_lightfield_tpu_torch"

#: H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
#: cores and HBM3 bandwidth, at the full 700 W power limit
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: f32 operations of the gate chain per (gaussian, ray) pair, split as the
#: kernels split it (csrc/tile_common.cuh; FMA = 2).  gro = M o - b, 3 x
#: (dot3 5 + sub 1): once per gaussian of a tile whose rays share one
#: origin, else once per pair
OPS_ORIGIN = 18
#: the prefix, per pair on a live ray: grdu 15, |grdu|^2 5, the cross
#: product 9, cc 5, and the cutoff test cc > D_hi |grdu|^2 (mul, compare) 2
OPS_PREFIX = 36
#: the tail, per pair on a live ray inside the response cutoff D_hi: clamp +
#: division 2, gray distance 1, response (2 mul + exp) 3, alpha 2, depth 7,
#: gates 5
OPS_TAIL = 20
#: the whole chain for every real pair, the count of bounds before the
#: recount (kept beside it as bound_ms_chain72, so times compare with
#: earlier rows): frame 33, |grdu|^2 + reciprocal 7, cross + gray distance
#: 15, response 3, alpha 2, depth 7, gates 5
OPS_PER_PAIR = 72
#: and per composited (accepted, active) pair: SH radiance 3 x 16 FMAs + 3
#: offsets/clamps x 2, weight, T update, rgb/depth/hit accumulation
OPS_PER_HIT = 96 + 6 + 2 + 2 + 10
#: K2 per composited pair, counted from csrc/tile_backward.cu: SH radiance
#: 99, bar_w 10, bar_pre 6, the transmittance chain (bar_t, bar_ae, bar_tb,
#: bar_tin, suffix term, division) 14, response/density 9, gray distance,
#: depth and cross products 17, the local-frame cotangents 42, the 13
#: geometry columns 30, 48 SH column products and the 61 column sums over
#: rays (FMA = 2).  Per pair K2 needs the gate chain as K1 does.
OPS_PER_HIT_BWD = 99 + 10 + 6 + 14 + 9 + 17 + 42 + 30 + 48 + 61
#: K2's ray cotangents per composited pair, counted from
#: csrc/tile_backward.cu (RAYG): the origin and direction rows, 2 x 3 x 3
#: multiply-adds, and the 16 basis rows, 16 x 3 (a multiply-add = 2),
#: counted as operations whatever unit runs them
OPS_PER_HIT_RAYG = 2 * (2 * 3 * 3 + 16 * 3)
#: pose refinement of the full-width frame: Adam steps, lr, translation
#: sigma of the perturbation
POSE_STEPS, POSE_LR, POSE_SIGMA = 20, 3e-3, 0.02
#: visited chunks per batch of chain_counts at the defaults (G = 64, R =
#: 256); fewer at larger G * R
COUNT_BATCH = 512
#: the training window of bench.py: K steps per topology refresh, SGD lr
TRAIN_K, TRAIN_LR, TRAIN_TARGET = 10, 1e-12, 0.3
#: bytes the camera-ray kernel writes a ray: 24 f32 rows
RAY_BYTES = 24 * 4
#: bytes the parameter-table kernels move a Gaussian: the forward reads the
#: six leaves (59 f32) and writes the table row (64) and the activated view
#: (scales, inv_scales, rot9, density: 16); the backward reads the row's
#: cotangent (64) and the four geometric leaves (11) and writes the six
#: gradients (59)
TABLE_FWD_BYTES, TABLE_BWD_BYTES = 4 * (59 + 64 + 16), 4 * (64 + 11 + 59)

#: bytes binning's pair expansion moves at the least: the pair-key kernel
#: reads pair_g and writes the key a slot (12) and reads offsets, the rect,
#: depth_q and 12 cull columns a live Gaussian (76); the whole route adds
#: the zero fill (8) and the max-scan (16) a slot, offsets and counts read a
#: Gaussian (16) and the run start stored a live one (8)
KEYS_BYTES_SLOT, KEYS_BYTES_LIVE = 12, 76
EXPAND_BYTES_SLOT = KEYS_BYTES_SLOT + 8 + 16
EXPAND_BYTES_GAUSS, EXPAND_BYTES_LIVE = 16, KEYS_BYTES_LIVE + 8

FULL_W, FULL_H, FULL_N = 1920, 1088, 300_000
#: the light field's tile (models/lightfield.py): R = 400 rays per tile
LF_TILE = 20
#: phase 2c: (tile, chunk, image side) past one block of K1 (R > 1024) or
#: K2 (R > 512, or its one-pass shared memory) on the 3000-Gaussian scene,
#: the card tests' shapes (tests/test_torch_cuda.py::SHAPES); and (tile,
#: chunk) of the full-width frame, the default first as the yardstick
SHAPES_SMALL = [(23, 64, 92), (24, 64, 96), (32, 64, 96), (33, 64, 99),
                (64, 64, 128), (16, 128, 96), (16, 256, 96), (16, 512, 96),
                (16, 1024, 96), (32, 256, 96)]
SHAPES_FULL = [(16, 64), (32, 64), (16, 256), (64, 256)]
#: phase 2c's pose step: tile 32, G = 64 (K2's ray-gradient instances at
#: R = 1024)
POSE_SHAPE = (32, 64)
#: deadline of the two gloo ranks of phase 8e (they take ~25 s)
MESH_TIMEOUT_S = 300
#: the garden-scale window (scripts/config2_scale.py:49-62): Gaussians,
#: span bands, field of view
GARDEN_N, GARDEN_BANDS, GARDEN_FOVY = 5_000_000, 2, 60.0


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, n=10):
    """Median CUDA-event time of `fn` over n runs, after one warm-up."""
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def event_ms(fn):
    """One CUDA-event timing of fn (for the slow plain versions and the
    multi-step parts): (ms, fn's result)."""
    import torch
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    start_ev.record()
    out = fn()
    end_ev.record()
    end_ev.synchronize()
    return start_ev.elapsed_time(end_ev), out


def compare_images(got, want, label):
    """Light-field images (C, H, W, 3) against the plain version's, under
    compare_acc's rgb limits: within 1e-5 on 99.99% of pixels, max abs
    <= 5e-3, finite."""
    import numpy as np
    d = np.abs(got - want).max(-1)
    frac, max_abs = float((d <= 1e-5).mean()), float(d.max())
    print(json.dumps({"phase": "lightfield_vs_plain", "images": len(got),
                      "frac_within_1e-5": frac, "max_abs_err": max_abs}),
          flush=True)
    if frac < 0.9999 or max_abs > 5e-3 or not np.isfinite(got).all():
        fail(f"the kernel's {label} disagrees with the plain version's")
    return max_abs


def mesh_rank(rank, ply, init, out_dir, device="cuda:0"):
    """One of two gloo ranks sharing `device` (phase 8e: the card), on the
    phase-4 PLY at full width: the sharded batch render of 4 orbit cameras against
    the unsharded renders, the tile-sharded frame against TiledRenderer's,
    and one Trainer(mesh) step with 2 cameras (one per rank) against the
    unsharded step, each with its card time and this rank's launch counts.
    Writes rank{rank}.json into out_dir."""
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch.app import _orbit_cameras
    from gvrt_tpu_torch.config import resolve_impl
    from gvrt_tpu_torch.models.gaussians import LEAVES
    from gvrt_tpu_torch.parallel import init_distributed, make_mesh
    from gvrt_tpu_torch.parallel import sharding as sh
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv
    from gvrt_tpu_torch.render import segreduce as sr
    from gvrt_tpu_torch.render.rows_vjp import frame_params
    from gvrt_tpu_torch.render.tiled import TiledRenderer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (pf.tile_forward, pf.tile_forward_residual, pv.tile_backward,
               sr.segment_reduce)

    def counted(fn):
        for k in kernels:
            k.launches = 0
        ms, res = event_ms(fn)
        return ms, res, {k.__name__: k.launches for k in kernels}

    def clone(m):
        return gt.GaussianModel(*(p.detach().clone() for p in m.leaves()))

    init_distributed(init, 2, rank, backend="gloo", device=device)
    try:
        mesh = make_mesh(2, devices=[device, device])
        dev, base = mesh.device, gt.DEFAULT_CONFIG
        out = {"rank": rank, "backend": mesh.backend,
               "world_size": dist.get_world_size(), "device": str(dev)}
        model = sh.replicate_model(gt.GaussianModel.from_ply(ply, dev), mesh)
        cams = _orbit_cameras(model, 4, FULL_W, FULL_H, 39.6)
        cap = TiledRenderer(FULL_W, FULL_H, base, device=dev).plan(model,
                                                                   cams)
        batch = sh.camera_batch(cams, base, dev)
        with torch.no_grad():
            ms, imgs, n = counted(lambda: sh.render_batch_sharded(
                model, batch, mesh, FULL_W, FULL_H, base, *cap))
            act, rows = frame_params(model, base)
            want = torch.stack([sh._render_one(
                act, rows, batch.w2c[i], batch.proj[i], batch.rays[i],
                FULL_W, FULL_H, base, *cap, resolve_impl("auto", dev))
                for i in range(len(cams))])
            out["batch"] = {"ms": ms, "launches": n,
                            "max_abs": float((imgs - want).abs().max()),
                            "equal": torch.equal(imgs, want)}
            del imgs, want
            cam = gt.Camera.from_fovy(FULL_W, FULL_H, 50.0, np.eye(4))
            capacity = sh.plan_capacity_sharded(model, cam, mesh.size, base)
            ms, frame, n = counted(lambda: sh.render_image_tile_sharded(
                model, cam, mesh, base, capacity=capacity))
            ref = TiledRenderer(FULL_W, FULL_H, base, device=dev).render(
                model, cam)
            out["frame"] = {
                "ms": ms, "launches": n,
                "rgb_max_abs": float((frame[..., 0:3] - ref["rgb"]).abs()
                                     .max()),
                "t_max_abs": float((frame[..., 4] - ref["transmittance"])
                                   .abs().max()),
                "hits_equal": torch.equal(frame[..., 5], ref["hit_count"]),
                "equal_rgb_t": torch.equal(frame[..., 0:3], ref["rgb"])
                and torch.equal(frame[..., 4], ref["transmittance"])}
            del frame, ref
        tc = gt.train.TrainConfig()
        pair = sh.camera_batch(cams[:2], base, dev)
        targets = torch.full((2, FULL_H, FULL_W, 3), TRAIN_TARGET, device=dev)
        sharded = gt.train.Trainer(FULL_W, FULL_H, base, tc, cap, mesh=mesh)
        state = sharded.init(clone(model))
        ms, (state, loss), n = counted(lambda: sharded.step(state, pair,
                                                            targets))
        single = gt.train.Trainer(FULL_W, FULL_H, base, tc, cap, device=dev)
        state_1, loss_1 = single.step(single.init(clone(model)), pair,
                                      targets)
        flat = torch.cat([p.detach().reshape(-1) for p in state[0].leaves()])
        out["step"] = {
            "ms": ms, "launches": n, "loss": float(loss),
            "loss_unsharded": float(loss_1),
            "param_max_abs": {k: float((getattr(state[0], k)
                                        - getattr(state_1[0], k)).detach()
                                       .abs().max()) for k in LEAVES},
            "params_sha256": hashlib.sha256(
                flat.cpu().numpy().tobytes()).hexdigest()}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def check_mesh_ranks(ranks):
    """Phase 8e's checks on both ranks' results: gloo, world size 2; the
    batch render equal to the unsharded one; the frame within 1e-5 of
    TiledRenderer's with equal hit counts; the step's loss within rtol 1e-5
    and every parameter within 1e-6 of the unsharded step, the ranks'
    parameters bit-identical; per rank, K1 once per camera it renders, and
    in the step K1's residual, K2 and K3 once each (its one camera)."""
    problems = []
    want_launches = {
        "batch": {"tile_forward": 2, "tile_forward_residual": 0,
                  "tile_backward": 0, "segment_reduce": 0},
        "frame": {"tile_forward": 1, "tile_forward_residual": 0,
                  "tile_backward": 0, "segment_reduce": 0},
        "step": {"tile_forward": 0, "tile_forward_residual": 1,
                 "tile_backward": 1, "segment_reduce": 1}}
    for r in ranks:
        if (r["backend"], r["world_size"]) != ("gloo", 2):
            problems.append(f"rank {r['rank']}: {r['backend']}, world "
                            f"{r['world_size']}")
        for part, want in want_launches.items():
            if r[part]["launches"] != want:
                problems.append(f"rank {r['rank']} {part} launches "
                                f"{r[part]['launches']}, expected {want}")
        if not r["batch"]["equal"]:
            problems.append(f"rank {r['rank']}: sharded batch differs by "
                            f"{r['batch']['max_abs']}")
        fr = r["frame"]
        if not fr["hits_equal"] or max(fr["rgb_max_abs"],
                                       fr["t_max_abs"]) > 1e-5:
            problems.append(f"rank {r['rank']}: tile-sharded frame {fr}")
        st = r["step"]
        if abs(st["loss"] - st["loss_unsharded"]) > 1e-5 * abs(
                st["loss_unsharded"]) or max(st["param_max_abs"].values()) \
                > 1e-6:
            problems.append(f"rank {r['rank']}: sharded step {st}")
    if ranks[0]["step"]["params_sha256"] != ranks[1]["step"]["params_sha256"]:
        problems.append("the ranks' parameters differ after the step")
    if problems:
        fail("multi-rank phase: " + "; ".join(problems))


def compare_acc(got, want, label):
    """Kernel vs plain accumulators (T, 8, R): per-ray bounds on 99.99% of
    rays, max abs over all rays.  A sequential product against a cumprod can
    flip a borderline `T > min_transmittance` gate on a rare pair."""
    d = (got - want).abs()
    rays = d.shape[0] * d.shape[2]
    frac = {
        "rgb_T": float((((d[:, 0:3].amax(1) <= 1e-5) & (d[:, 4] <= 1e-5))
                        .sum()) / rays),
        "depth": float((d[:, 3] <= 1e-4).sum() / rays),
        "hits": float((d[:, 5] == 0).sum() / rays),
    }
    max_abs = float(d[:, 0:5].max())
    print(json.dumps({"phase": "kernel_vs_plain", "scene": label,
                      "rays": rays, "frac_within": frac,
                      "max_abs_err": max_abs}), flush=True)
    if min(frac.values()) < 0.9999 or max_abs > 5e-3 or not bool(
            got.isfinite().all()):
        fail(f"kernel disagrees with its plain version on {label}")
    return max_abs


def chain_counts(binned, rays, cfg):
    """What this data needs of the gate chain, from the plain version: the
    plain residual forward gives T at the start of every chunk (a ray at or
    below min_transmittance needs nothing more) and the hit counts; every
    visited chunk's real pairs on live rays are then counted, and of them
    those inside the response cutoff D_hi (the kernels' own test, cc <= D_hi
    max(|grdu|^2, 1e-20)), which alone need the chain's tail.  Returns
    {origins, pairs, inside, hits, real_pairs}: origins counts gro
    evaluations (one per gaussian for a tile whose rays share one origin,
    one per pair otherwise); real_pairs is every real pair, live or not."""
    import torch
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv
    chunks, counts = binned.chunks, binned.tile_counts
    acc, t_in = pv._forward_residual_plain(chunks, rays, counts, cfg)
    d_hi = pf.response_cutoff(cfg.kernel_degree, cfg.hit_min_response)
    g, r, dev = cfg.chunk_size, rays.shape[2], rays.device
    start, count = pf.tile_chunk_runs(counts, chunks.shape[0], g)
    count = count.long()
    tile = torch.repeat_interleave(torch.arange(len(count), device=dev),
                                   count)
    k = torch.arange(len(tile), device=dev) - torch.repeat_interleave(
        torch.cumsum(count, 0) - count, count)
    cid = start.long()[tile] + k
    n_real = (counts.long()[tile] - k * g).clamp(0, g)
    shared = (rays[:, 0:3] == rays[:, 0:3, :1]).all(2).all(1)
    n = {"origins": 0, "pairs": 0, "inside": 0}
    batch = max(1, COUNT_BATCH * 64 * 256 // (g * r))
    for b in torch.arange(len(tile), device=dev).split(batch):
        p, ry = chunks[cid[b]], rays[tile[b]]
        live = ((torch.arange(g, device=dev) < n_real[b, None])[..., None]
                & (t_in[cid[b]] > cfg.min_transmittance)[:, None, :])
        m = p[..., 0:9].reshape(-1, g, 3, 3)
        gu = torch.einsum("bgij,bjr->bgir", m, ry[:, 3:6])
        gro = torch.einsum("bgij,bjr->bgir", m, ry[:, 0:3]) \
            - p[..., 9:12, None]
        cc = (torch.linalg.cross(gu, gro, dim=2) ** 2).sum(2)
        inside = ~(cc > d_hi * (gu * gu).sum(2).clamp_min(1e-20))
        per_chunk = live.sum((1, 2))
        n["origins"] += int(torch.where(
            shared[tile[b]], n_real[b] * live.any(2).any(1), per_chunk).sum())
        n["pairs"] += int(per_chunk.sum())
        n["inside"] += int((live & inside).sum())
    n["hits"] = float(acc[:, 5].sum())
    n["real_pairs"] = int(counts.sum()) * r
    return n


def chain_ops(n, per_hit):
    """(needed, chain72) f32 operations: the split chain on what the data
    needs, and the whole chain on every real pair, each with per_hit per
    composited pair."""
    hits = n["hits"] * per_hit
    return (n["origins"] * OPS_ORIGIN + n["pairs"] * OPS_PREFIX
            + n["inside"] * OPS_TAIL + hits,
            n["real_pairs"] * OPS_PER_PAIR + hits)


def bound_ms(binned, rays, acc, cfg, n, extra_bytes=0):
    """K1's least time for this call's work: bytes read/written once over
    HBM bandwidth vs f32 operations over the f32 peak (the larger).  The
    operations are what the data needs (chain_counts); returns (ms, bound
    by, ms with the whole chain on every real pair)."""
    from gvrt_tpu_torch.render.pallas_forward import tile_chunk_runs
    _, count = tile_chunk_runs(binned.tile_counts, binned.chunks.shape[0],
                               cfg.chunk_size)
    chunk_bytes = int(count.sum()) * cfg.chunk_size * 64 * 4
    nbytes = chunk_bytes + rays.numel() * 4 + acc.numel() * 4 + \
        2 * binned.tile_counts.numel() * 4 + extra_bytes
    ops, ops72 = chain_ops(n, OPS_PER_HIT)
    return (*roofline(nbytes, ops), roofline(nbytes, ops72)[0])


def roofline(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def bound_bwd_ms(binned, rays, acc, cfg, n, ray_grads=False):
    """K2's least time: the gate chain as the data needs it (chain_counts)
    and OPS_PER_HIT_BWD per composited pair, against the chunk rows of the
    visited runs, rays, T_in and bar_acc read and bar_chunks written; with
    `ray_grads` also the (T, 24, R) ray cotangents written and
    OPS_PER_HIT_RAYG more per composited pair.  Returns (ms, bound by, ms
    with the whole chain on every real pair)."""
    from gvrt_tpu_torch.render.pallas_forward import tile_chunk_runs
    _, count = tile_chunk_runs(binned.tile_counts, binned.chunks.shape[0],
                               cfg.chunk_size)
    r = rays.shape[2]
    nbytes = (int(count.sum()) * cfg.chunk_size * 64 * 4 + rays.numel() * 4
              + binned.chunks.shape[0] * r * 4 + acc.numel() * 4
              + binned.chunks.numel() * 4 + 2 * binned.tile_counts.numel() * 4
              + (rays.numel() * 4 if ray_grads else 0))
    ops, ops72 = chain_ops(n, OPS_PER_HIT_BWD
                           + (OPS_PER_HIT_RAYG if ray_grads else 0))
    return (*roofline(nbytes, ops), roofline(nbytes, ops72)[0])


def rel_l2(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


#: bar_chunk column groups of the backward
COL_GROUPS = {"M": slice(0, 9), "b": slice(9, 12), "density": slice(12, 13),
              "sh": slice(16, 64)}
#: the 61 nonzero parameter columns
COLUMNS = [c for c in range(64) if c not in (13, 14, 15)]


def column_rel_l2(got, want):
    """{column: relative L2} of each of the 61 parameter columns whose
    plain norm is nonzero (a group's L2 would hide a small column mapped to
    the wrong place)."""
    g = got[..., COLUMNS].reshape(-1, len(COLUMNS))
    w = want[..., COLUMNS].reshape(-1, len(COLUMNS))
    norm = w.norm(dim=0)
    rel = (g - w).norm(dim=0) / norm.clamp_min(1e-30)
    return {c: float(e) for c, e, n in zip(COLUMNS, rel.tolist(),
                                           norm.tolist()) if n > 0}


#: rows of a (T, 24, R) ray block: origin, direction, the two gate rows
#: (tmin, tmax: K2's cotangents there are zero) and the 16 SH basis rows
RAY_ROWS = (["o0", "o1", "o2", "d0", "d1", "d2", "tmin", "tmax"]
            + [f"basis{j}" for j in range(16)])
#: K2's ray cotangents against the plain version, per row: relative L2
RAY_ROW_LIMIT = 1e-4


def ray_row_rel_l2(got, want):
    """{row: relative L2} of each of the 22 cotangent rows of (T, 24, R) ray
    blocks whose plain norm is nonzero (the gate rows 6-7 are checked to be
    exactly zero instead)."""
    g = got.transpose(0, 1).reshape(len(RAY_ROWS), -1)
    w = want.transpose(0, 1).reshape(len(RAY_ROWS), -1)
    norm = w.norm(dim=1)
    rel = (g - w).norm(dim=1) / norm.clamp_min(1e-30)
    return {RAY_ROWS[i]: float(rel[i]) for i in range(len(RAY_ROWS))
            if i not in (6, 7) and float(norm[i]) > 0}


def poison_allocator(torch, nbytes, device):
    """Fill a block of the caching allocator with NaN and free it: a kernel
    output taken from torch.empty that the kernel does not fully write
    then shows NaN."""
    x = torch.full((nbytes // 4 + 1,), float("nan"), device=device)
    del x


def bar_acc_for(torch, rays, seed):
    """A cotangent of the (T, 8, R) accumulators: rows 0-4 (rgb, depth, T)
    drawn from a torch.Generator, hit counts and padding rows zero."""
    g = torch.Generator(device=rays.device).manual_seed(seed)
    bar = torch.randn((rays.shape[0], 8, rays.shape[2]), generator=g,
                      device=rays.device)
    bar[:, 5:] = 0.0
    return bar


def run_mask(torch, tile_counts, num_chunks, g):
    """(C,) bool: chunks that belong to some tile's run."""
    from gvrt_tpu_torch.render.pallas_forward import tile_chunk_runs
    start, count = tile_chunk_runs(tile_counts, num_chunks, g)
    has = count > 0
    edge = torch.zeros(num_chunks + 1, dtype=torch.int64,
                       device=tile_counts.device)
    edge.index_add_(0, start[has].long(), torch.ones_like(start[has].long()))
    edge.index_add_(0, (start + count)[has].long(),
                    -torch.ones_like(start[has].long()))
    return torch.cumsum(edge, 0)[:num_chunks] > 0


def check_training_kernels(torch, binned, rays, cfg, label, seed):
    """K1's residual variant and K2 against their plain versions on one
    binned scene, each after a NaN-poisoned allocator.  With ray gradients
    also the ray cotangents row by row (check_ray_rows).  Returns the
    largest absolute errors of T_in and of K2's outputs, and the largest
    per-row relative L2 of the ray cotangents (None without)."""
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv
    chunks, counts = binned.chunks, binned.tile_counts
    num_chunks, r = chunks.shape[0], rays.shape[2]
    nbytes = 4 * (chunks.numel() + num_chunks * r + rays.numel())
    poison_allocator(torch, nbytes, chunks.device)
    acc, t_in = pf.tile_forward_residual(chunks, rays, counts, cfg)
    _, t_in_p = pv._forward_residual_plain(chunks, rays, counts, cfg)
    torch.cuda.synchronize()
    d_tin = (t_in - t_in_p).abs()
    tin_frac = float((d_tin <= 1e-5).float().mean())
    tin_finite = bool(t_in.isfinite().all())
    bar_acc = bar_acc_for(torch, rays, seed)
    poison_allocator(torch, nbytes, chunks.device)
    got = pv.tile_backward(chunks, rays, counts, t_in, bar_acc, cfg)
    again = pv.tile_backward(chunks, rays, counts, t_in, bar_acc, cfg)
    # the plain backward of the same forward (the kernel's own T_in)
    want = pv._backward_plain(chunks, rays, counts, t_in, bar_acc, cfg)
    rows_max = None
    if cfg.ray_gradients:
        without = pv.tile_backward(chunks, rays, counts, t_in, bar_acc,
                                   cfg.replace(ray_gradients=False))[0]
        rows_max = check_ray_rows(torch, got, again, want, without, label)
    torch.cuda.synchronize()
    errs = {name: {"rel_l2": rel_l2(got[0][..., cols], want[0][..., cols]),
                   "max_abs": float((got[0][..., cols]
                                     - want[0][..., cols]).abs().max())}
            for name, cols in COL_GROUPS.items()}
    cols = column_rel_l2(got[0], want[0])
    if cfg.ray_gradients:
        errs["rays"] = {"rel_l2": rel_l2(got[1], want[1]),
                        "max_abs": float((got[1] - want[1]).abs().max())}
    in_run = run_mask(torch, counts, num_chunks, cfg.chunk_size)
    skipped = ~in_run | (t_in.amax(dim=1) <= cfg.min_transmittance)
    zero_ok = bool((got[0][skipped] == 0).all())
    finite = bool(got[0].isfinite().all()) and (
        got[1] is None or bool(got[1].isfinite().all()))
    same_bits = torch.equal(got[0], again[0]) and (
        got[1] is None or torch.equal(got[1], again[1]))
    k2_abs = max(e["max_abs"] for e in errs.values())
    print(json.dumps({"phase": "training_kernels_vs_plain", "scene": label,
                      "ray_gradients": cfg.ray_gradients,
                      "t_in_frac_within_1e-5": tin_frac,
                      "t_in_finite": tin_finite, "backward": errs,
                      "columns_checked": len(cols),
                      "column_rel_l2_max": max(cols.values(), default=0.0),
                      "skipped_chunks": int(skipped.sum()),
                      "skipped_blocks_zero": zero_ok, "finite": finite,
                      "bit_identical_runs": same_bits}), flush=True)
    if tin_frac < 0.9999 or not tin_finite:
        fail(f"K1's residual disagrees with its plain version on {label}")
    if max(e["rel_l2"] for e in errs.values()) > 1e-4 or not cols or \
            max(cols.values()) > 1e-4:
        fail(f"K2 disagrees with its plain version on {label}: "
             f"{ {c: e for c, e in cols.items() if e > 1e-4} }")
    if not (zero_ok and finite and same_bits):
        fail(f"K2 on {label}: zero blocks {zero_ok}, finite {finite}, "
             f"bit-identical {same_bits}")
    return float(d_tin.max()), k2_abs, rows_max


def check_ray_rows(torch, got, again, want, without, label):
    """K2's ray cotangents against the plain version row by row: `got`,
    `again` and `want` are (bar_chunks, bar_rays) of two kernel runs and the
    plain version, `without` the kernel's bar_chunks without ray gradients
    on the same inputs.  Each of the 22 nonzero rows within RAY_ROW_LIMIT
    relative L2, the gate rows exactly zero, two runs bit-identical,
    bar_chunks bit-equal to `without`.  Returns the largest row error."""
    rows = ray_row_rel_l2(got[1], want[1])
    res = {"rows_checked": len(rows),
           "rows_rel_l2_max": max(rows.values(), default=0.0),
           "gate_rows_zero": not bool(got[1][:, 6:8].any()),
           "rays_bit_identical_runs": torch.equal(got[1], again[1]),
           "chunks_bit_identical_to_without": torch.equal(got[0], without)}
    print(json.dumps({"phase": "ray_cotangent_rows", "scene": label,
                      **res, "rows_rel_l2": rows}), flush=True)
    if len(rows) != 22 or res["rows_rel_l2_max"] > RAY_ROW_LIMIT or not (
            res["gate_rows_zero"] and res["rays_bit_identical_runs"]
            and res["chunks_bit_identical_to_without"]):
        fail(f"K2's ray cotangents on {label}, row by row: {res}")
    return res["rows_rel_l2_max"]


def tile_slice(scene, rays_t, chunk_size):
    """The 512 consecutive tiles around the busiest one of a binned scene:
    (first tile, first chunk, end chunk)."""
    import torch
    from gvrt_tpu_torch.render.pallas_forward import tile_chunk_runs
    start, count = tile_chunk_runs(scene.tile_counts, scene.chunks.shape[0],
                                   chunk_size)
    t0 = min(int(torch.argmax(scene.tile_counts)) // 512 * 512,
             rays_t.shape[0] - 512)
    c0 = int(start[t0])
    c1 = int(start[t0 + 511]) + int(count[t0 + 511])
    return t0, c0, c1


def slice_scene(scene, rays_t, chunk_size):
    """The 512-tile slice of `tile_slice` as a binned scene and its rays."""
    t0, c0, c1 = tile_slice(scene, rays_t, chunk_size)
    part = scene._replace(chunks=scene.chunks[c0:c1].contiguous(),
                          tile_counts=scene.tile_counts[t0:t0 + 512]
                          .contiguous())
    return part, rays_t[t0:t0 + 512].contiguous()


def check_compact_reduce(torch, sr, bar_flat, red, label):
    """K4 against its plain version and index_add_ on one compact plan and
    per-slot cotangents, after a NaN-poisoned allocator: relative L2
    <= 1e-5, two runs bit-identical, every output row finite, the rows of
    ids past the last live one exactly zero.  Returns the check and the
    index_add_ operands (compact ids, pre-gathered rows, output)."""
    n_groups = red.out_shape.shape[0]
    p_pad = bar_flat.shape[0]
    poison_allocator(torch, 2 * n_groups * sr.GROUP * 64 * 4, bar_flat.device)
    got = sr.segment_reduce_compact(bar_flat, red, n_groups)
    again = sr.segment_reduce_compact(bar_flat, red, n_groups)
    plain = sr.segment_reduce_compact_plain(bar_flat, red, n_groups)
    cid = sr.compact_ids(red)
    live = cid < n_groups * sr.GROUP
    idx = cid[live]
    vals = bar_flat[torch.clamp_max(red.slot.long()[live], p_pad - 1)]
    lib = torch.zeros_like(plain)
    lib.index_add_(0, idx, vals)
    torch.cuda.synchronize()
    n_live = int(idx.max()) + 1 if idx.numel() else 0
    check = {"rel_l2_vs_plain": rel_l2(got, plain),
             "rel_l2_vs_index_add": rel_l2(got, lib),
             "max_abs_err": float((got - plain).abs().max()),
             "bit_identical_runs": torch.equal(got, again),
             "finite": bool(got.isfinite().all()),
             "past_live_zero": bool((got[n_live:] == 0).all()),
             "rows": int(red.slot.numel()), "live_rows": int(live.sum()),
             "live_ids": n_live, "cap_live": n_groups * sr.GROUP}
    print(json.dumps({"phase": "segment_reduce_compact_vs_plain",
                      "scene": label, **check}), flush=True)
    if max(check["rel_l2_vs_plain"], check["rel_l2_vs_index_add"]) > 1e-5 \
            or not (check["bit_identical_runs"] and check["finite"]
                    and check["past_live_zero"]) or n_live == 0:
        fail(f"K4 disagrees with its plain version or index_add_ on {label}")
    return check, idx, vals, lib


def reduce_bound_ms(live_rows, out_rows, walked, nb):
    """K3's least time: the live rows gathered once (256 B each, one add
    per float), the (out_rows, 64) table written, and the slot and gloc
    ints of the `walked` blocks that hold live rows (a group's live rows
    are packed from its first block) with the out_idx of every block."""
    return roofline(live_rows * 64 * 4 + out_rows * 64 * 4
                    + walked * 256 * 8 + nb * 4, live_rows * 64)


def check_table_reduce(torch, sr, bar_flat, red, n_rows, label):
    """K4's table mode against its plain version (K4's plain version and
    the expansion) and index_add_ on one compact plan and per-slot
    cotangents, after a NaN-poisoned allocator: relative L2 <= 1e-5, two
    runs bit-identical, every row finite, bit-identical to compact mode's
    sums expanded through the window, the rows outside the window exactly
    zero.  index_add_ sums the gathered rows into a zero (n_rows, 64) table
    by Gaussian id.  Returns the check and the index_add_ operands
    (Gaussian ids, pre-gathered rows, output)."""
    n_groups = red.out_shape.shape[0]
    cap_live, p_pad = n_groups * sr.GROUP, bar_flat.shape[0]
    poison_allocator(torch, 2 * n_rows * 64 * 4, bar_flat.device)
    got = sr.segment_reduce_compact_table(bar_flat, red, n_rows)
    again = sr.segment_reduce_compact_table(bar_flat, red, n_rows)
    plain = sr.segment_reduce_compact_table_plain(bar_flat, red, n_rows)
    expanded = sr.expand_compact(sr.segment_reduce_compact(
        bar_flat, red, n_groups), red, n_rows)
    # compact id -> Gaussian id through the window (-1: outside it)
    src = red.src_range.long()
    base, window = int(red.base[0]), src.shape[0]
    in_live = src < cap_live
    gauss_of = torch.full((cap_live + 1,), -1, dtype=torch.long,
                          device=src.device)
    gauss_of[src[in_live]] = base + torch.nonzero(in_live).squeeze(1)
    gid = gauss_of[torch.clamp_max(sr.compact_ids(red), cap_live)]
    live = gid >= 0
    idx = gid[live]
    vals = bar_flat[torch.clamp_max(red.slot.long()[live], p_pad - 1)]
    lib = torch.zeros_like(plain)
    lib.index_add_(0, idx, vals)
    torch.cuda.synchronize()
    check = {"rel_l2_vs_plain": rel_l2(got, plain),
             "rel_l2_vs_index_add": rel_l2(got, lib),
             "max_abs_err": float((got - plain).abs().max()),
             "bit_identical_runs": torch.equal(got, again),
             "bit_identical_to_compact_expanded": torch.equal(got, expanded),
             "finite": bool(got.isfinite().all()),
             "outside_window_zero": not bool(got[:base].any()) and
             not bool(got[base + window:].any()),
             "rows": int(red.slot.numel()), "live_rows": int(live.sum()),
             "table_rows": n_rows, "window": window, "base": base,
             "cap_live": cap_live}
    print(json.dumps({"phase": "segment_reduce_compact_table_vs_plain",
                      "scene": label, **check}), flush=True)
    if max(check["rel_l2_vs_plain"], check["rel_l2_vs_index_add"]) > 1e-5 \
            or not all(check[k] for k in (
                "bit_identical_runs", "bit_identical_to_compact_expanded",
                "finite", "outside_window_zero")) or not live.any():
        fail(f"K4's table mode disagrees with its plain version or "
             f"index_add_ on {label}")
    return check, idx, vals, lib


def compact_bound_ms(live_rows, n_groups, nb):
    """K4's least time: the live rows gathered once (256 B each, one add
    per float), the (cap_live, 64) table written, each live row's slot and
    local id and each block's k0 read."""
    return roofline(live_rows * 64 * 4 + n_groups * 256 * 64 * 4
                    + live_rows * 8 + nb * 4, live_rows * 64)


def table_bound_ms(live_rows, n_rows, window, nb):
    """K4's table mode's least time: as compact_bound_ms, but the output is
    the (n_rows, 64) parameter table, and the window's src_range is read."""
    return roofline(live_rows * 64 * 4 + n_rows * 64 * 4 + live_rows * 8
                    + window * 4 + nb * 4, live_rows * 64)


def compare_frames(got, want, label):
    """A banded frame against the unbanded one: overflow 0, hit counts
    equal on every ray, rgb and T within 1e-5."""
    d_rgb = float((got["rgb"] - want["rgb"]).abs().max())
    d_t = float((got["transmittance"] - want["transmittance"]).abs().max())
    hits = bool((got["hit_count"] == want["hit_count"]).all())
    print(json.dumps({"phase": "banded_vs_unbanded", "bands": label,
                      "overflow": int(got["overflow"]), "hits_equal": hits,
                      "rgb_max_abs": d_rgb, "t_max_abs": d_t}), flush=True)
    if int(got["overflow"]) or not hits or max(d_rgb, d_t) > 1e-5:
        fail(f"banded frame ({label}) differs from the unbanded one")


def rays_phase(gt, torch, dev, binning, name, power):
    """Phase 1b: the camera-ray kernel against the plain route at full width,
    and both timed; returns the kernels line's numbers."""
    import numpy as np
    t_phase = time.time()
    base = gt.DEFAULT_CONFIG
    a = np.radians(30.0)  # a serving orbit's camera, 30 degrees round
    c2w = np.eye(4)
    c2w[:3, :3] = [[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                   [-np.sin(a), 0.0, np.cos(a)]]
    c2w[:3, 3] = [3.0 * np.sin(a), 0.0, -3.0 + 3.0 * np.cos(a)]
    cam = gt.Camera.from_fovy(FULL_W, FULL_H, 50.0, c2w)
    g = torch.Generator(device=dev).manual_seed(5)
    clip = 2.0 + 2.0 * torch.rand((FULL_H, FULL_W), generator=g, device=dev)
    clip[:, ::3] = float("inf")
    checks = {}
    for label, kw in (("unclipped", {}), ("clipped", {"tmax_clip": clip})):
        want = binning.tile_rays(cam, base, dev, impl="torch", **kw)
        poison_allocator(torch, 4 * want.numel(), dev)
        got = binning.tile_rays(cam, base, dev, impl="cuda", **kw)
        torch.cuda.synchronize()
        same = ((got.view(torch.int32) == want.view(torch.int32))
                | (got.isnan() & want.isnan()))
        d_same = same[:, 3:6]
        ulps = (got[:, 3:6].view(torch.int32).long()
                - want[:, 3:6].view(torch.int32).long()).abs()
        c = {"dir_bit_equal_share": float(d_same.double().mean()),
             "max_dir_ulp": int(ulps.max()),
             "rays_bit_equal_share": float(same.all(1).double().mean()),
             "rows_differ_on_equal_dir": int(
                 (~same.all(1) & d_same.all(1)).sum())}
        checks[label] = c
        if (not bool(same[:, 0:3].all()) or c["dir_bit_equal_share"] < 0.99999
                or c["max_dir_ulp"] > 1 or c["rows_differ_on_equal_dir"]
                or not bool(got.isfinite().all())):
            fail(f"camera-ray kernel ({label}) against the plain route: {c}")
    del want, got, same

    def kernel_ms(n=50, **kw):
        """Device ms a launch over n back-to-back launches."""
        binning.camera_rays_kernel(cam, base, dev, **kw)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            binning.camera_rays_kernel(cam, base, dev, **kw)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    def plain_parts():
        """Host ms of the plain route's three parts, each fenced."""
        t0 = time.perf_counter()
        o, d = cam.rays()
        t1 = time.perf_counter()
        o = torch.as_tensor(np.ascontiguousarray(o), device=dev)
        d = torch.as_tensor(np.ascontiguousarray(d), device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        binning.tile_ray_rows(o, d, base)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return [1e3 * (t1 - t0), 1e3 * (t2 - t1), 1e3 * (t3 - t2)]

    n_rays = FULL_W * FULL_H
    plain = np.median([plain_parts() for _ in range(5)], axis=0)
    res = {"ms": kernel_ms(), "clipped_ms": kernel_ms(tmax_clip=clip),
           "bound_ms": roofline(n_rays * RAY_BYTES, 0)[0],
           "clipped_bound_ms": roofline(n_rays * (RAY_BYTES + 4), 0)[0],
           "bound_by": "bytes",
           "plain_ms": {"numpy": float(plain[0]), "upload": float(plain[1]),
                        "rows": float(plain[2]),
                        "total": float(plain.sum())},
           "checks": checks}
    print(json.dumps({"phase": "camera_rays", "card": name,
                      "power_limit": power, "width": FULL_W,
                      "height": FULL_H, "tile": base.tile_size, **res,
                      "seconds": time.time() - t_phase}), flush=True)
    return res


def scan_phase(gt, torch, dev, name, power):
    """Phase 1c: the max-scan kernel at the garden serving frame's pair
    capacity against cummax's values, and both timed; returns the kernels
    line's numbers."""
    from gvrt_tpu_torch.render import scan
    t_phase = time.time()
    model, cam = garden_scene(gt, torch, dev)
    n = gt.render.TiledRenderer(FULL_W, FULL_H, device=dev).plan(
        model, [cam])[0]
    del model
    # binning's run fills: a run's value scattered at its start, ascending
    g = torch.Generator(device=dev).manual_seed(6)
    at = torch.randint(0, n, (n // 3,), generator=g, device=dev)
    x = torch.zeros(n, dtype=torch.int64, device=dev)
    x.scatter_reduce_(0, at, at, "amax")
    del at
    want = torch.cummax(x, 0).values
    poison_allocator(torch, 16 * n, dev)
    before = scan.max_scan.launches
    got = scan.max_scan(x)
    again = scan.max_scan(x)
    torch.cuda.synchronize()
    if scan.max_scan.launches != before + 2:
        fail("max_scan did not launch its kernel")
    if not (torch.equal(got, want) and torch.equal(again, want)):
        fail(f"max-scan kernel against cummax at n = {n}: "
             f"{int((got != want).sum())} elements differ")
    del got, again, want
    res = {"n": n, "ms": cuda_ms(lambda: scan.max_scan(x), n=20),
           "library_ms": cuda_ms(lambda: torch.cummax(x, 0), n=5),
           "bound_ms": roofline(16 * n, 0)[0], "bound_by": "bytes"}
    print(json.dumps({"phase": "max_scan", "card": name,
                      "power_limit": power, **res,
                      "seconds": time.time() - t_phase}), flush=True)
    return res


def table_phase(gt, torch, dev, name, power):
    """Phase 1d: the parameter-table kernels at 300k and 5M Gaussians (the
    serving frames' scenes) against the plain route on the card, after a
    NaN-poisoned allocator: the forward's table and activated view bit for
    bit, the backward's six gradients within relative L2 1e-6 of
    `_Rows64`'s plain backward on a random cotangent; each kernel timed
    beside the plain route and its byte bound; returns the kernels line's
    numbers."""
    from gvrt_tpu_torch.models.gaussians import activate_leaves
    from gvrt_tpu_torch.render import binning, rows_vjp
    fwd, bwd = rows_vjp.param_table_forward, rows_vjp.param_table_backward
    t_phase = time.time()
    res = {}
    for label, make in (("300k", lambda: bench_scene(gt, torch, dev)),
                        ("5M", lambda: garden_scene(gt, torch, dev)[0])):
        leaves = tuple(p.detach() for p in make().leaves())
        n = leaves[0].shape[0]

        def plain_forward():
            act = activate_leaves(*leaves)
            return act, binning.param_rows(act, gt.DEFAULT_CONFIG)

        def plain_backward():
            return rows_vjp._plain_backward(g, *leaves[:4])

        want = plain_forward()
        poison_allocator(torch, 2 * 4 * 64 * (n + 1), dev)
        before = (fwd.launches, bwd.launches)
        got = fwd(*leaves)
        torch.cuda.synchronize()
        for field in ("scales", "inv_scales", "rot9", "densities",
                      "sh_flat"):
            k, p = getattr(got[0], field), getattr(want[0], field)
            if not torch.equal(k.view(torch.int32), p.view(torch.int32)):
                fail(f"param_table forward at {label}: {field} differs from "
                     f"the plain route")
        if not torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32)):
            fail(f"param_table forward at {label}: the table differs from "
                 f"the plain route")
        del got, want
        g = torch.randn((n + 1, 64), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
        want = plain_backward()
        poison_allocator(torch, 2 * 4 * 64 * (n + 1), dev)
        got = bwd(g, leaves)
        torch.cuda.synchronize()
        if (fwd.launches, bwd.launches) != (before[0] + 1, before[1] + 1):
            fail("the parameter-table kernels did not launch once each")
        errs = [rel_l2(k, p) for k, p in zip(got, want)]
        if max(errs) > 1e-6 or not all(bool(k.isfinite().all())
                                       for k in got):
            fail(f"param_table backward at {label}: relative L2 {errs}")
        del got, want
        r = {"n": n, "backward_rel_l2_max": max(errs)}
        for way, kernel, plain, nbytes in (
                ("forward", lambda: fwd(*leaves), plain_forward,
                 TABLE_FWD_BYTES),
                ("backward", lambda: bwd(g, leaves), plain_backward,
                 TABLE_BWD_BYTES)):
            ms = cuda_ms(kernel, n=20)
            bound = roofline(n * nbytes, 0)[0]
            r[way] = {"ms": ms, "plain_ms": cuda_ms(plain, n=5),
                      "bound_ms": bound, "bound_share": bound / ms}
        res[label] = r
        del leaves, g
    print(json.dumps({"phase": "param_table", "card": name,
                      "power_limit": power, **res,
                      "seconds": time.time() - t_phase}), flush=True)
    return res


def expand_phase(gt, torch, dev, name, power):
    """Phase 1e: binning's pair expansion at the garden serving frame's pair
    capacity, the kernels against the plain version on the same card
    tensors, both timed, and the pair-key kernel timed alone; returns the
    kernels line's numbers."""
    import ctypes
    from gvrt_tpu_torch import _build
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render.tiled import TiledRenderer, _camera_mats
    t_phase = time.time()
    base = gt.DEFAULT_CONFIG
    model, cam = garden_scene(gt, torch, dev)
    cap, cap_pad = TiledRenderer(FULL_W, FULL_H, device=dev).plan(model,
                                                                   [cam])
    with torch.no_grad():
        w2c, proj = _camera_mats(cam)
        tab = binning.frame_cull_table(model.activate(), w2c, proj, FULL_W,
                                       FULL_H, base)
    del model
    kernel, seen = binning.expand_pairs, []
    binning.expand_pairs = lambda *a: seen.append(a) or kernel(*a)
    try:
        binning.bin_topology_from_table(tab, proj, FULL_W, FULL_H, base, cap,
                                        cap_pad, with_reduce_plan=False)
    finally:
        binning.expand_pairs = kernel
    args = seen[0]
    want = binning._expand_pairs_plain(*args)
    poison_allocator(torch, 24 * cap, dev)
    before = kernel.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    if kernel.launches != before + 1:
        fail("expand_pairs did not launch its kernels")
    for label, k, p in (("pair_g", got[0], want[0]), ("key", got[1], want[1])):
        if not torch.equal(k, p):
            fail(f"bin_expand at capacity {cap}: {int((k != p).sum())} "
                 f"{label} entries differ from the plain version")
    del want
    # the pair-key kernel alone, on the filled runs of the call above
    (_, offsets, counts, total, rect, depth_q, cs, v, nx, num_tiles,
     row_offset, row_stride, depth_bits, cull) = args
    pair_g, key = got[0], torch.empty_like(got[1])
    lib = _build.load("bin_expand")
    cols = (ctypes.c_void_p * 12)(*(t.data_ptr() for t in (*cs, *v)))
    stream = torch.cuda.current_stream().cuda_stream

    def pair_keys():
        err = lib.gvrt_bin_pair_keys(
            pair_g.data_ptr(), total.data_ptr(), offsets.data_ptr(),
            *(t.data_ptr() for t in rect), depth_q.data_ptr(), cols,
            key.data_ptr(), cap, nx, num_tiles, row_offset, row_stride,
            depth_bits, *cull, stream)
        if err != 0:
            fail(f"bin_expand pair-key launch failed: CUDA error {err}")
    pair_keys()
    torch.cuda.synchronize()
    if not torch.equal(key, got[1]):
        fail("the pair-key kernel alone differs from expand_pairs' keys")
    n, live = offsets.shape[0], int((counts > 0).sum())
    res = {"capacity": cap, "gaussians": n, "live": live,
           "total": int(total), "ms": cuda_ms(lambda: kernel(*args), n=20),
           "plain_ms": cuda_ms(lambda: binning._expand_pairs_plain(*args),
                               n=5),
           "bound_ms": roofline(EXPAND_BYTES_SLOT * cap
                                + EXPAND_BYTES_GAUSS * n
                                + EXPAND_BYTES_LIVE * live, 0)[0],
           "keys_ms": cuda_ms(pair_keys, n=20),
           "keys_bound_ms": roofline(KEYS_BYTES_SLOT * cap
                                     + KEYS_BYTES_LIVE * live, 0)[0],
           "bound_by": "bytes"}
    print(json.dumps({"phase": "bin_expand", "card": name,
                      "power_limit": power, **res,
                      "seconds": time.time() - t_phase}), flush=True)
    return res


def mesh_trace_phase(gt, torch, dev, name, power):
    """Phase 1f: the mesh-trace kernel (csrc/mesh_trace.cu) on the
    `garden5m_mesh.serve_combined` cell's mesh and rays: the CLI's
    quad_icosphere props in the garden box (322 triangles, one 512-lane
    chunk) under the orbit's first 1920x1088 view and the shadow rays to
    its light.  After a NaN-poisoned allocator, the kernel's ids and shadow
    bits against the chunk loop (`_closest_hit_plain`, `_occluded_plain`)
    on the same card tensors, every pixel; each query timed beside the
    chunk loop, the kernel with its warp skip off and its bound from the
    work done (`trace_work_bound`).  Returns the kernel's line."""
    import numpy as np
    from gvrt_tpu_torch.hybrid import HybridConfig
    from gvrt_tpu_torch.hybrid import pipeline as hpipe
    from gvrt_tpu_torch.hybrid import trace
    t0 = time.time()
    c, e = np.asarray([0.0, 0.0, -4.0]), 2.0
    scene = gt.hybrid.mesh.PROCEDURAL["quad_icosphere"](c - e, c + e, up=1,
                                                        subdiv=2)
    c2w = gt.io.cameras.look_at_inverse(c + [0.0, 0.0, 4.0], c,
                                        np.asarray([0.0, 1.0, 0.0]))
    cam = gt.Camera.from_fovy(FULL_W, FULL_H, 60.0, c2w)
    rays = primary_rays(torch, cam, dev)
    n_rays, n_tris = rays.shape[0], scene.num_tris
    hcfg = HybridConfig()
    dev_scene = hpipe._DeviceScene(scene, hcfg, dev)
    pack = dev_scene.tris
    tmin = torch.full((n_rays,), 1e-3, device=dev)

    poison_allocator(torch, 4 * n_rays * 20, dev)
    hit = trace.closest_hit(rays, pack, tmin=tmin)
    want = trace._closest_hit_plain(rays, pack, tmin=tmin)
    lpos = dev_scene.lights[0, 0:3]
    pos = rays[:, 0:3] + hit["t"][:, None] * rays[:, 3:6]
    dist = torch.linalg.vector_norm(lpos - pos, dim=-1)
    sdir = (lpos - pos) / dist.clamp_min(1e-12)[:, None]
    srays = torch.cat([pos + sdir * 0.1, sdir], dim=1)
    stmin = torch.full_like(dist, 0.1)
    stmax = torch.where(dist >= 0.5, dist - 0.5, dist)
    poison_allocator(torch, 4 * n_rays * 20, dev)
    occ = trace.occluded(srays, pack, stmin, stmax)
    occ_want = trace._occluded_plain(srays, pack, stmin, stmax)
    torch.cuda.synchronize()
    checks = {
        "tri_equal": bool(torch.equal(hit["tri"], want["tri"])),
        "t_max_rel": float(((hit["t"] - want["t"]).abs()
                            / want["t"].abs().clamp_min(1.0)).max()),
        "uv_max_abs": float(max((hit[k] - want[k]).abs().max()
                                for k in ("u", "v"))),
        "occluded_equal": bool(torch.equal(occ, occ_want)),
        "hit_share": float((hit["tri"] >= 0).float().mean()),
        "shadowed_share": float((occ & (hit["tri"] >= 0)).float().mean())}
    if not (checks["tri_equal"] and checks["occluded_equal"]) or \
            checks["t_max_rel"] > 1e-6 or checks["uv_max_abs"] > 1e-6:
        fail(f"the mesh-trace kernel against the chunk loop: {checks}")

    def timed(any_hit, rays, tmin, tmax, query, plain):
        ms = cuda_ms(lambda: query(rays, pack, tmin, tmax), n=20)
        bound = trace_work_bound(torch, any_hit, rays, pack, tmin, tmax,
                                 n_tris)
        return {"ms": ms, "skip_off_ms": cuda_ms(lambda: trace._launch(
                    any_hit, rays, *pack[:4], None, tmin, tmax), n=20),
                "plain_ms": cuda_ms(lambda: plain(rays, pack, tmin, tmax),
                                    n=2),
                **bound, "bound_share": bound["bound_ms"] / ms}

    res = {
        "rays": n_rays, "triangles": n_tris,
        "lanes": int(pack.tri_id.numel()),
        "closest_hit": timed(False, rays, tmin, None, trace.closest_hit,
                             trace._closest_hit_plain),
        "occluded": timed(True, srays, stmin, stmax, trace.occluded,
                          trace._occluded_plain),
        "checks": checks}
    print(json.dumps({"phase": "mesh_trace", **res, "card": name,
                      "power_limit": power, "seconds": time.time() - t0}),
          flush=True)
    return res


def bench_scene(gt, torch, device):
    """bench.py's synthetic scene, drawn from a torch.Generator."""
    g = torch.Generator(device=device).manual_seed(0)
    model = gt.random_gaussians(g, FULL_N, extent=1.0,
                                scale_range=(-6.1, -4.4), device=device)
    with torch.no_grad():
        model.means[:, 2] -= 3.0
        model.opacity_logit.copy_(-3.5 + 4.0 * torch.rand(
            FULL_N, generator=g, device=device))
    return model


def binned_for(gt, model, cam, cfg, pad_factor=1):
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render.tiled import _camera_mats
    import torch
    with torch.no_grad():
        act = model.activate()
        w2c, proj = _camera_mats(cam)
        cap, cap_pad = binning.plan_capacity(act, w2c, proj, cam.width,
                                             cam.height, cfg)
        topo = binning.bin_topology(act, w2c, proj, cam.width, cam.height,
                                    cfg, cap, cap_pad * pad_factor)
        if int(topo.overflow):
            fail("planned capacity overflowed")
        binned = binning.binned_scene(binning.gather_chunks(act, topo, cfg),
                                      topo)
    return binned, binning.tile_rays(cam, cfg, model.device)


def garden_scene(gt, torch, dev):
    """The BASELINE config[2] scene of scripts/config2_scale.py:49-62, drawn
    from a torch.Generator, and its 1920x1088 camera."""
    import numpy as np
    g = torch.Generator(device=dev).manual_seed(0)
    model = gt.random_gaussians(g, GARDEN_N, extent=2.0,
                                scale_range=(-7.3, -5.3), device=dev)
    with torch.no_grad():
        model.opacity_logit.copy_(-3.5 + 4.0 * torch.rand(
            GARDEN_N, generator=g, device=dev))
        model.means[:, 2] -= 4.0
    return model, gt.Camera.from_fovy(FULL_W, FULL_H, GARDEN_FOVY, np.eye(4))


def garden_window(gt, torch, dev, bd, binning, pf, sr, frame_params,
                  reset_launches, launches, event_ms, name, power):
    """The garden-scale banded training window: the JAX package's BASELINE
    config[2] scene (scripts/config2_scale.py:49-62, drawn from a
    torch.Generator), y-sorted, 2 span bands, TrainConfig defaults (Adam,
    remat "full", refresh_every 10); 10 Trainer.steps against 0.3.  Then
    K1's residual and K2 against their plain versions on band 0's busiest
    512 tiles, and K4 on band 0's real per-slot cotangents.  Returns K4's
    times, bound and error, the window's launch counts, the times and
    bounds of K1 and K2 at band 0's shapes (garden_kernel_times) and the
    largest absolute errors of T_in and of K2 on the slice."""
    import numpy as np
    t_phase = time.time()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    timings = {}

    def timed(key, fn):
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        timings[key] = time.time() - t0
        return res

    base = gt.DEFAULT_CONFIG
    model, cam = timed("generate_s", lambda: garden_scene(gt, torch, dev))
    model = timed("sort_s", lambda: model.sorted_for_camera(cam, base))
    tc = gt.train.TrainConfig(span_bands=True)
    trainer = gt.train.Trainer(FULL_W, FULL_H, base, tc,
                               n_bands=GARDEN_BANDS, device=dev)
    capacity = timed("plan_s", lambda: trainer.renderer.plan(model, cam))
    topos = timed("bind_s", lambda: trainer.bind(model, cam))
    state = trainer.init(model)
    target = torch.full((FULL_H, FULL_W, 3), TRAIN_TARGET, device=dev)
    peak_before = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()

    def window():
        nonlocal state
        losses = []
        for _ in range(TRAIN_K):
            state, loss = trainer.step(state, cam, target)
            losses.append(loss)
        return losses

    window_ms, losses = event_ms(window)
    torch.cuda.synchronize()
    window_launches = launches()
    peak_window = torch.cuda.max_memory_allocated()
    gnorm = float(model.means.grad.norm())
    overflow = int(trainer.last_overflow)
    with torch.no_grad():
        mean_hits = float(trainer.renderer.render_bound(model)["hit_count"]
                          .mean())
    reds = [t.red for t in topos]
    print(json.dumps({
        "phase": "garden_window", "gaussians": GARDEN_N,
        "width": FULL_W, "height": FULL_H, "bands": GARDEN_BANDS,
        "mode": trainer.renderer.mode, "remat": trainer.renderer.remat,
        "capacity": list(capacity),
        "capacity_live": trainer.renderer.capacity_live,
        "capacity_reduce": trainer.renderer.capacity_reduce,
        "capacity_range": trainer.renderer.capacity_range,
        "band_bases": [int(r.base[0]) for r in reds],
        "chunk_array_gb": capacity[1] * 64 * 4 / 1e9, **timings,
        "steps": TRAIN_K, "step_ms": window_ms / TRAIN_K,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "mean_hits_per_ray": mean_hits, "overflow": overflow,
        "means_grad_norm": gnorm, "launches": window_launches,
        "memory_before_gb": mem0 / 1e9,
        "peak_setup_gb": peak_before / 1e9,
        "peak_window_gb": peak_window / 1e9,
        "card": name, "power_limit": power}), flush=True)
    print(json.dumps({"metric": "garden_train_step_ms",
                      "ms": window_ms / TRAIN_K,
                      "mrays_per_s": FULL_W * FULL_H / window_ms / 1e3,
                      "card": name, "power_limit": power}), flush=True)
    if overflow or mean_hits < 15 or not all(
            np.isfinite(float(x)) for x in losses) or not gnorm > 0:
        fail(f"garden window: overflow {overflow}, hits {mean_hits:.2f}, "
             f"losses {[float(x) for x in losses]}, grad norm {gnorm}")
    # remat "full": K1's residual twice per band per step (forward and the
    # backward's recompute), K2 and K4 (its table mode) once each; no K3,
    # no serving K1
    want = {"tile_forward": 0, "segment_reduce": 0,
            "tile_forward_residual": 2 * GARDEN_BANDS * TRAIN_K,
            "tile_backward": GARDEN_BANDS * TRAIN_K,
            "segment_reduce_compact": GARDEN_BANDS * TRAIN_K,
            "segment_reduce_compact_table": GARDEN_BANDS * TRAIN_K}
    if window_launches != want:
        fail(f"garden window launches {window_launches}, expected {want}")

    # K4 at the window's shapes: band 0's per-slot cotangents of its share
    # of the window's L1 loss
    topo = topos[0]
    rays = binning.band_rays(cam, base, GARDEN_BANDS, dev, mode="contig")[0]
    with torch.no_grad():
        rows = frame_params(model, base)[1]
        chunks = binning.gather_from_rows(rows, topo, base)
    chunks.requires_grad_()
    acc = pf.forward_dispatch(binning.binned_scene(chunks, topo), rays, base,
                              "cuda")
    img = binning.untile(acc, FULL_W, FULL_H // GARDEN_BANDS, base.tile_size)
    ((img[..., 0:3] - TRAIN_TARGET).abs().sum()
     / (FULL_W * FULL_H * 3)).backward()
    bar = chunks.grad.reshape(-1, 64)
    del rows, acc, img
    # K1's residual and K2 on band 0's deepest 512 tiles (the long reverse
    # walks of the window's sub-pixel, low-opacity Gaussians)
    part, part_rays = slice_scene(
        binning.binned_scene(chunks.detach(), topo), rays, base.chunk_size)
    tin_err, k2_err, _ = check_training_kernels(
        torch, part, part_rays, base, "garden_band0_512_tiles", 15)
    del part, part_rays
    garden_times = garden_kernel_times(torch, pf, chunks.detach(), rays,
                                       topo, base, name, power)
    check, idx, vals, lib = check_compact_reduce(torch, sr, bar, topo.red,
                                                 "garden_window_band0")
    n_groups = topo.red.out_shape.shape[0]
    k4_ms = cuda_ms(lambda: sr.segment_reduce_compact(bar, topo.red,
                                                      n_groups))
    k4_plain_ms = cuda_ms(lambda: sr.segment_reduce_compact_plain(
        bar, topo.red, n_groups), n=3)
    k4_lib_ms = cuda_ms(lambda: lib.index_add_(0, idx, vals))
    k4_b_ms, k4_b_by = compact_bound_ms(check["live_rows"], n_groups,
                                        topo.red.k0.shape[0])
    del idx, vals, lib
    # K4's table mode, the step's route: the (N+1, 64) table gradient,
    # beside the two-step route it replaces (compact sums, then the
    # expansion) and index_add_ by Gaussian id
    n_rows = GARDEN_N + 1
    t_check, t_idx, t_vals, t_lib = check_table_reduce(
        torch, sr, bar, topo.red, n_rows, "garden_window_band0")
    table = {
        "ms": cuda_ms(lambda: sr.segment_reduce_compact_table(
            bar, topo.red, n_rows)),
        "two_step_ms": cuda_ms(lambda: sr.expand_compact(
            sr.segment_reduce_compact(bar, topo.red, n_groups), topo.red,
            n_rows)),
        "plain_ms": cuda_ms(lambda: sr.segment_reduce_compact_table_plain(
            bar, topo.red, n_rows), n=3),
        "library_ms": cuda_ms(lambda: t_lib.index_add_(0, t_idx, t_vals)),
        "max_abs_err": t_check["max_abs_err"],
        "launches": window_launches["segment_reduce_compact_table"]}
    table["bound_ms"], table["bound_by"] = table_bound_ms(
        t_check["live_rows"], n_rows, t_check["window"],
        topo.red.k0.shape[0])
    del t_idx, t_vals, t_lib
    for metric, ms in (("segment_reduce_compact_ms", k4_ms),
                       ("segment_reduce_compact_plain_ms", k4_plain_ms),
                       ("segment_reduce_compact_index_add_ms", k4_lib_ms),
                       ("segment_reduce_compact_table_ms", table["ms"]),
                       ("segment_reduce_compact_two_step_ms",
                        table["two_step_ms"]),
                       ("segment_reduce_compact_table_plain_ms",
                        table["plain_ms"]),
                       ("segment_reduce_compact_table_index_add_ms",
                        table["library_ms"])):
        print(json.dumps({"metric": metric, "ms": ms, "card": name,
                          "power_limit": power}), flush=True)
    print(json.dumps({"phase": "garden_k4", "bound_ms": k4_b_ms,
                      "bound_by": k4_b_by,
                      "table_bound_ms": table["bound_ms"],
                      "table_bound_by": table["bound_by"],
                      "seconds": time.time() - t_phase}), flush=True)
    return (k4_ms, k4_plain_ms, k4_lib_ms, k4_b_ms, k4_b_by,
            check["max_abs_err"], table, window_launches, garden_times,
            tin_err, k2_err)


def garden_kernel_times(torch, pf, chunks, rays, topo, cfg, name, power):
    """K1 (serving and with its residual) and K2 at band 0's full shapes
    (CUDA-event medians, as cuda_ms), each beside its bound from this
    band's chunk runs and hit counts; K2 takes the cotangent of the
    window's L1 loss.  Returns {kernel: (ms, bound ms, bound by, bound
    ms with the whole chain on every real pair)}."""
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render import pallas_vjp as pv
    scene = binning.binned_scene(chunks, topo)
    counts = topo.tile_counts
    with torch.no_grad():
        serve_ms = cuda_ms(lambda: pf.tile_forward(chunks, rays, counts, cfg))
        res_ms = cuda_ms(lambda: pf.tile_forward_residual(chunks, rays,
                                                          counts, cfg))
        acc, t_in = pf.tile_forward_residual(chunks, rays, counts, cfg)
        fixed = pf._background_fix(acc, counts)
        bar = torch.zeros_like(acc)
        bar[:, 0:3] = torch.where((counts > 0)[:, None, None], torch.sign(
            fixed[:, 0:3] - TRAIN_TARGET) / (FULL_W * FULL_H * 3), 0.0)
        k2_ms = cuda_ms(lambda: pv.tile_backward(chunks, rays, counts, t_in,
                                                 bar, cfg))
        n = chain_counts(scene, rays, cfg)
    times = {
        "tile_forward": (serve_ms, *bound_ms(scene, rays, acc, cfg, n)),
        "tile_forward_residual": (res_ms, *bound_ms(
            scene, rays, acc, cfg, n, extra_bytes=t_in.numel() * 4)),
        "tile_backward": (k2_ms, *bound_bwd_ms(scene, rays, acc, cfg, n)),
    }
    print(json.dumps({"phase": "garden_chain_counts", **n}), flush=True)
    for kname, (ms, b_ms, b_by, b72_ms) in times.items():
        print(json.dumps({"metric": f"{kname}_garden_ms", "ms": ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bound_ms_chain72": b72_ms,
                          "chunks": int(chunks.shape[0]),
                          "tiles": int(rays.shape[0]), "card": name,
                          "power_limit": power}), flush=True)
    return times


#: f32 operations per (ray, triangle) pair of the mesh trace, counted from
#: hybrid/trace.py (`_intersect_chunk`, the gates, the argmin): pvec 9,
#: det 5, |det| test 2, reciprocal 1, tvec 3, u 6, qvec 9, v 6, t 6, the
#: barycentric tests 6, the t window and best-hit gates 7, the select 1,
#: the argmin's compare 1.  The kernel rounds the products with fmaf,
#: the chunk loop as fused multiply-adds in f64 (XLA's contraction); the
#: kernel's bound counts f32 work on the pairs its warp skip leaves
#: (trace_work_bound), all pairs being its brute_force_ms.
OPS_TRACE = 9 + 5 + 2 + 1 + 3 + 6 + 9 + 6 + 6 + 6 + 7 + 1 + 1
#: f32 operations per (Gaussian, point) pair of the Gaussian shadow pass,
#: counted from render/combined.py: gro 18, grd 15, |grd|^2 5, cross 9,
#: 1/|grd|^2 2, gray distance 6, t 7, response (degree 4: 3 mul, exp) 4,
#: alpha 2, the accept gates 8, the select 1, log1p 1, the sum 1
OPS_SHADOW = 18 + 15 + 5 + 9 + 2 + 6 + 7 + 4 + 2 + 8 + 1 + 1 + 1
#: the hybrid frames: the CLI's default size, the card-against-CPU size
HYBRID_SIZE, HYBRID_CPU_SIZE = 512, 64
#: cubemap face colours [+X, -X, +Y, -Y, +Z, -Z] of the miss-path check
FACE_COLORS = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
               (1.0, 1.0, 0.0), (1.0, 0.0, 1.0), (0.0, 1.0, 1.0))


def combined_mesh():
    """The mesh of the combined phases: a quad through the middle of the
    cloud's depth (z = -3) over the left half of the image (x < 0, normal
    +z), an icosphere in front of the right half, one light."""
    from gvrt_tpu_torch.hybrid import mesh
    s = mesh.MeshScene()
    pos, idx = mesh._quad([-6, -6, -3.0], [0, -6, -3.0], [0, 6, -3.0],
                          [-6, 6, -3.0])
    s.add_object("quad", pos, idx, mesh.Material(
        base_color=(0.7, 0.7, 0.7, 1.0), metallic=0.0, roughness=0.8))
    v, f, n = mesh._icosphere(0.4, (0.7, 0.0, -1.6), subdiv=2)
    s.add_object("ball", v, f, mesh.Material(
        base_color=(0.8, 0.3, 0.2, 1.0), metallic=0.2, roughness=0.4),
        normals=n)
    s.lights.append(mesh.Light(position=(-0.5, 1.5, 0.0), radius=20.0))
    return s


def trace_bound_ms(n_rays, n_tris, per_pair=OPS_TRACE, pairs=None):
    """The mesh trace's least time: `pairs` (by default n_rays x n_tris
    real triangles, every pair) of `per_pair` f32 operations, against the
    rays read (6 floats, tmin, tmax), the triangles read and the hits
    written (t, tri, u, v) once."""
    return roofline(n_rays * (8 + 4) * 4 + n_tris * 9 * 4,
                    (n_rays * n_tris if pairs is None else pairs) * per_pair)


def trace_work_bound(torch, any_hit, rays, pack, tmin, tmax, n_tris):
    """The mesh-trace kernel's least time for the work it does on these
    inputs, from one more launch with its optional counter: the (warp,
    group) visits its warp skip left, each 32 rays by 32 lanes (a 512-lane
    pack's groups are whole) of OPS_TRACE f32 operations (3 fewer for
    occluded: no best-hit gate, no argmin), against trace_bound_ms's
    bytes; the box tests are not counted.  With the all-pairs figure
    (brute_force_ms, which the skip lets the kernel beat) and the visits
    and skipped ones."""
    from gvrt_tpu_torch.hybrid import trace
    per_pair = OPS_TRACE - 3 if any_hit else OPS_TRACE
    st = torch.zeros(2, dtype=torch.int64, device=rays.device)
    trace._launch(any_hit, rays, *pack[:4], pack.groups, tmin, tmax, st)
    visits, skipped = st.tolist()
    n_rays = rays.shape[0]
    bound = trace_bound_ms(n_rays, n_tris, per_pair, pairs=(
        visits - skipped) * 32 * trace.GROUP)
    return {"bound_ms": bound[0], "bound_by": bound[1],
            "brute_force_ms": trace_bound_ms(n_rays, n_tris, per_pair)[0],
            "visits": visits, "skipped": skipped,
            "skip_share": skipped / max(visits, 1)}


def mesh_span_ms(torch, frame):
    """{"<span>_ms": device ms} of the mesh spans over one call of `frame`
    under the profiler (`utils.profiling`'s record)."""
    from gvrt_tpu_torch.utils import profiling
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        profiling.reset()
        frame()
        torch.cuda.synchronize()
    spans = profiling.recorded()["spans"]
    return {name.replace("gvrt.", "").replace(".", "_") + "_span_ms":
            spans[name]["device_ms"] for name in (
                "gvrt.frame", "gvrt.mesh", "gvrt.mesh.trace",
                "gvrt.mesh.shadow", "gvrt.mesh.shade")}


def primary_rays(torch, cam, dev):
    """A camera's per-pixel rays as (H*W, 6) [o, d] on `dev`."""
    import numpy as np
    o, d = cam.rays()
    return torch.as_tensor(np.concatenate([o, d], -1).reshape(-1, 6),
                           device=dev)


def combined_phases(gt, torch, dev, model, cam, full, full_rays, acc, small,
                    cam128, base, reset_launches, launches, name, power):
    """Phases 3d-3f: the combined Gaussian-and-mesh render on the card.
    3d, the full-width frame of the 300k scene under torch.no_grad(): K1
    launched once, K1 against its plain version on the same binned inputs
    and the clipped rays (hit counts equal on every ray), the composite,
    the clipped hit counts against the unclipped frame's (no higher on a
    ray that did not saturate unclipped; `full`,
    `full_rays`, `acc`: phase 3's binned scene, rays and K1 accumulators),
    the frame's time split into the mesh pass and the Gaussian pass; 3e,
    the gradient of mean rgb through the 3000-Gaussian 128^2 frame (K1's
    residual, K2, K3 once each) against the all-plain path, and K1's
    residual and K2 on its clipped rays against their plain versions; 3f,
    Gaussian shadows on that frame against the port on the CPU, and the
    shadow pass timed.  Returns the numbers of the kernels line and the
    hot spots."""
    from gvrt_tpu_torch.hybrid import HybridConfig
    from gvrt_tpu_torch.hybrid import pipeline as hpipe
    from gvrt_tpu_torch.hybrid import trace
    from gvrt_tpu_torch.models.gaussians import LEAVES
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render import combined as comb
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render.tiled import _camera_mats
    res = {}
    scene = combined_mesh()
    hcfg = HybridConfig()

    # ---- 3d. the combined frame at full width -----------------------------
    t0 = time.time()
    combined = comb.CombinedRenderer(FULL_W, FULL_H, scene, base, hcfg,
                                     device=dev)
    combined.plan(model, [cam])
    reset_launches()
    rays_before = binning.camera_rays_kernel.launches
    trace.closest_hit.launches = trace.occluded.launches = 0
    with torch.no_grad():
        out = combined.render(model, cam)
    torch.cuda.synchronize()
    served = {**launches(), "mesh_closest_hit": trace.closest_hit.launches,
              "mesh_occluded": trace.occluded.launches}
    if binning.camera_rays_kernel.launches - rays_before != 1:
        fail("the combined frame must build its rays in one launch of the "
             "camera-ray kernel")
    once = ("tile_forward", "mesh_closest_hit", "mesh_occluded")
    if any(served[k] != 1 for k in once) or any(
            served[k] for k in served if k not in once):
        fail(f"the combined frame launched {served}: K1 and each mesh-trace "
             f"query once and nothing else expected")
    h, w = FULL_H, FULL_W
    with torch.no_grad():
        rays = binning.tile_rays(cam, base, dev, tmax_clip=out["mesh_t"])
        got = pf.tile_forward(full.chunks, rays, full.tile_counts, base)
        plain_ms, want = event_ms(lambda: pf.forward_tiles_reference(
            full, rays, base))
        err = compare_acc(got, want, "combined_full_width_clipped")
        hits_every_ray = torch.equal(got[:, 5], want[:, 5])
        hits = binning.untile(got[:, 5:6], w, h, base.tile_size)[..., 0]
        hits_u = binning.untile(acc[:, 5:6], w, h, base.tile_size)[..., 0]
        # a ray that saturated unclipped (T at or below min_transmittance
        # ends the walk) may accept more pairs when the clip rejects an
        # early (in depth-key order) but far (in t) one; any other ray
        # accepts a subset of its unclipped pairs
        t_u = binning.untile(acc[:, 4:5], w, h, base.tile_size)[..., 0]
        gains = hits > hits_u
        on_mesh = out["mesh_t"].isfinite()
        quad = on_mesh.clone()
        quad[:, w // 2:] = False
        composite = float((out["rgb"] - (out["gaussian_rgb"]
                           + out["transmittance"][..., None]
                           * out["mesh_rgb"])).abs().max())
        check = {
            "launches": served, "overflow": int(out["overflow"]),
            "hits_equal_every_ray": hits_every_ray,
            "frame_hits_are_the_kernels": torch.equal(out["hit_count"], hits),
            "mesh_pixels": int(on_mesh.sum()), "quad_pixels": int(quad.sum()),
            "clipped_rays": int((rays[:, 7] < full_rays[:, 7]).sum()),
            "pixels_gaining_hits": int(gains.sum()),
            "gains_only_on_saturated_rays": bool(
                (t_u[gains] <= base.min_transmittance).all()),
            "quad_hits": float(hits[quad].sum()),
            "quad_hits_unclipped": float(hits_u[quad].sum()),
            "off_mesh_hits_equal": torch.equal(hits[~on_mesh],
                                               hits_u[~on_mesh]),
            "composite_max_abs": composite,
            "finite": all(bool(out[k].isfinite().all()) for k in (
                "rgb", "gaussian_rgb", "mesh_rgb", "depth",
                "transmittance")),
            "mean_hits_per_ray": float(hits.mean())}
        print(json.dumps({"phase": "combined_full_width", **check}),
              flush=True)
        if not (hits_every_ray and check["frame_hits_are_the_kernels"]
                and check["gains_only_on_saturated_rays"]
                and check["off_mesh_hits_equal"] and check["finite"]
                and check["quad_hits"] < check["quad_hits_unclipped"]
                and check["overflow"] == 0 and composite <= 1e-6
                and check["quad_pixels"] > 0
                and check["mesh_pixels"] > check["quad_pixels"]):
            fail(f"combined frame: {check}")
        # K1 alone on the clipped rays, bounded by what this data needs:
        # chain_counts takes T at each chunk's start from the plain version
        # on these rays, and the kernels test the cutoff without tmax, so
        # the count holds on clipped rays too
        k_ms = cuda_ms(lambda: pf.tile_forward(full.chunks, rays,
                                               full.tile_counts, base))
        n = chain_counts(full, rays, base)
        bnd = bound_ms(full, rays, got, base, n)
        act = model.activate()
        mats = _camera_mats(cam)
        cap = combined.gaussians.capacity
        dev_scene = combined.mesh
        t_mesh = out["mesh_t"]
        prim = primary_rays(torch, cam, dev)
        # the mesh pass's rays: rows 0:6 of the frame's one ray build
        mesh_rays = binning.untile(binning.tile_rays(cam, base, dev)[:, 0:6],
                                   w, h, base.tile_size)
        if not torch.equal(mesh_rays.reshape(-1, 6), prim):
            fail("the mesh pass's rays differ from Camera.rays()")

        def gaussian_pass():
            r = binning.tile_rays(cam, base, dev, tmax_clip=t_mesh)
            b = binning.bin_gaussians(act, *mats, w, h, base, *cap)
            return binning.untile(pf.forward_dispatch(b, r, base, "cuda"), w,
                                  h, base.tile_size)

        times = {
            "frame_ms": cuda_ms(lambda: combined.render(model, cam), n=5),
            "mesh_pass_ms": cuda_ms(lambda: comb._mesh_pass(
                dev_scene, hcfg, mesh_rays), n=5),
            "gaussian_pass_ms": cuda_ms(gaussian_pass, n=5),
            "closest_hit_ms": cuda_ms(lambda: dev_scene.closest_hit(prim),
                                      n=3),
            # the frame's one ray build (the camera-ray kernel), which the
            # mesh pass and the march share
            "frame_rays_ms": cuda_ms(lambda: binning.tile_rays(
                cam, base, dev), n=3),
            # the mesh spans of one frame (device ms between the span's
            # events; `gvrt.mesh.shade` holds `gvrt.mesh.shadow`)
            **mesh_span_ms(torch, lambda: combined.render(model, cam))}
        tb = trace_work_bound(torch, False, prim, dev_scene.tris,
                              torch.full((h * w,), 1e-3, device=dev), None,
                              scene.num_tris)
    res["combined_k1"] = {"launches": served["tile_forward"],
                          "max_abs_err": err, "ms": k_ms,
                          "plain_ms": plain_ms, "bound_ms": bnd[0],
                          "bound_by": bnd[1], "library_ms": None}
    res["combined_trace"] = {"calls_per_frame": 1, "rays": h * w,
                             "launches": {
                                 "closest_hit": served["mesh_closest_hit"],
                                 "occluded": served["mesh_occluded"]},
                             "triangles": scene.num_tris,
                             "ms": times["closest_hit_ms"], **tb}
    res["combined_times"] = times
    print(json.dumps({"phase": "combined_full_width_times", **times,
                      "tile_forward": res["combined_k1"],
                      "closest_hit": res["combined_trace"],
                      "chain_counts": n, "card": name, "power_limit": power,
                      "seconds": time.time() - t0}), flush=True)
    del out, rays, got, want, hits, hits_u, dev_scene, act, prim, t_mesh
    del combined, mesh_rays

    # ---- 3e. the differentiated combined frame ----------------------------
    t0 = time.time()
    m = gt.GaussianModel(*(p.detach().clone() for p in small.leaves()))
    mats = _camera_mats(cam128)
    with torch.no_grad():
        cap_s = binning.plan_capacity(m.activate(), *mats, 128, 128, base)

    def grads(impl):
        m.zero_grad(set_to_none=True)
        o = comb.render_combined(m, scene, cam128, base, impl=impl,
                                 capacity=cap_s)
        o["rgb"].mean().backward()
        return o, {k: getattr(m, k).grad.clone() for k in LEAVES}

    poison_allocator(torch, 1 << 28, dev)
    reset_launches()
    out_k, g_k = grads("cuda")
    torch.cuda.synchronize()
    diffed = launches()
    out_p, g_p = grads("torch")
    rel = {k: rel_l2(g_k[k], g_p[k]) for k in LEAVES}
    finite = all(bool(v.isfinite().all()) for v in g_k.values()) and all(
        bool(out_k[k].isfinite().all()) for k in (
            "rgb", "gaussian_rgb", "mesh_rgb", "depth", "transmittance"))
    want_l = {"tile_forward": 0, "tile_forward_residual": 1,
              "tile_backward": 1, "segment_reduce": 1,
              "segment_reduce_compact": 0, "segment_reduce_compact_table": 0}
    with torch.no_grad():
        act_s = m.activate()
        topo_s = binning.bin_topology(act_s, *mats, 128, 128, base, *cap_s)
        binned_s = binning.binned_scene(
            binning.gather_chunks(act_s, topo_s, base), topo_s)
        rays_s = binning.tile_rays(cam128, base, dev,
                                   tmax_clip=out_k["mesh_t"].detach())
        clipped_s = int((rays_s[:, 7] < binning.tile_rays(
            cam128, base, dev)[:, 7]).sum())
    tin_err, k2_err, _ = check_training_kernels(
        torch, binned_s, rays_s, base, "combined_128px_clipped", 18)
    print(json.dumps({"phase": "combined_gradient", "launches": diffed,
                      "rel_l2": rel, "finite": finite,
                      "clipped_rays": clipped_s,
                      "mesh_pixels": int(out_k["mesh_t"].isfinite().sum()),
                      "card": name, "power_limit": power,
                      "seconds": time.time() - t0}), flush=True)
    if diffed != want_l:
        fail(f"the differentiated combined frame launched {diffed}, "
             f"expected {want_l}")
    if max(rel.values()) > 1e-4 or not finite or not clipped_s or not all(
            float(v.abs().max()) > 0 for v in g_p.values()):
        fail(f"combined frame gradients, kernels against plain: {rel}, "
             f"finite {finite}, clipped rays {clipped_s}")
    res["combined_grad"] = {"launches": diffed, "t_in_max_abs_err": tin_err,
                            "tile_backward_max_abs_err": k2_err,
                            "grad_rel_l2_max": max(rel.values())}
    del out_k, out_p, g_k, g_p, binned_s, rays_s, topo_s, act_s

    # ---- 3f. Gaussian shadows on the small frame --------------------------
    t0 = time.time()
    with torch.no_grad():
        sh_ms, sh = event_ms(lambda: comb.render_combined(
            m, scene, cam128, base, capacity=cap_s, gaussian_shadows=True))
        cpu_m = gt.GaussianModel.from_numpy(m.to_numpy(), device="cpu")
        sh_cpu = comb.render_combined(cpu_m, scene, cam128, base,
                                      capacity=cap_s, gaussian_shadows=True)
        d_mesh = float((sh["mesh_rgb"].cpu() - sh_cpu["mesh_rgb"])
                       .abs().max())
        same_mesh = torch.equal(sh["mesh_t"].isinf().cpu(),
                                sh_cpu["mesh_t"].isinf())
        d_rgb = (sh["rgb"].cpu() - sh_cpu["rgb"]).abs().amax(-1)
        rgb_frac = float((d_rgb <= 1e-5).float().mean())
        hits_frac = float((sh["hit_count"].cpu() == sh_cpu["hit_count"])
                          .float().mean())
        unshadowed = comb.render_combined(m, scene, cam128, base,
                                          capacity=cap_s)
        darkened = int((unshadowed["mesh_rgb"] - sh["mesh_rgb"]).sum(-1)
                       .gt(1e-3).sum())
        # the shadow pass alone: every pixel's surface point (misses too, as
        # the mesh pass shades them) to the light
        dev_scene = hpipe._DeviceScene(scene, hcfg, dev)
        prim = primary_rays(torch, cam128, dev)
        surf = hpipe._surface_attributes(dev_scene, dev_scene.closest_hit(
            prim), prim)
        act_d = m.activate()
        light = dev_scene.lights[0, 0:3]
        pass_ms = cuda_ms(lambda: comb.gaussian_shadow_transmittance(
            act_d, surf["pos"], light, base), n=5)
    pairs = m.num_gaussians * prim.shape[0]
    sb = roofline(prim.shape[0] * 4 * 4 + m.num_gaussians * 13 * 4,
                  pairs * OPS_SHADOW)
    res["shadow"] = {"calls_per_frame": len(scene.lights),
                     "points": prim.shape[0], "gaussians": m.num_gaussians,
                     "pairs_per_light": pairs, "ms": pass_ms,
                     "ns_per_pair": pass_ms * 1e6 / pairs,
                     "bound_ms": sb[0], "bound_by": sb[1]}
    check = {"mesh_rgb_max_abs_vs_cpu": d_mesh,
             "mesh_t_inf_equal": same_mesh,
             "rgb_frac_within_1e-5": rgb_frac,
             "rgb_max_abs_vs_cpu": float(d_rgb.max()),
             "hits_frac_equal": hits_frac, "darkened_pixels": darkened,
             "frame_ms": sh_ms}
    print(json.dumps({"phase": "combined_gaussian_shadows", **check,
                      "shadow_pass": res["shadow"], "card": name,
                      "power_limit": power, "seconds": time.time() - t0}),
          flush=True)
    if d_mesh > 1e-5 or not same_mesh or rgb_frac < 0.9999 or \
            float(d_rgb.max()) > 5e-3 or hits_frac < 0.9999 or \
            not darkened:
        fail(f"Gaussian shadows on the card against the CPU: {check}")
    return res


def hybrid_phase(gt, torch, dev, tmp, name, power):
    """Phase 4b: the hybrid renderer on the card.  The CLI's `hybrid` at its
    default 512^2 (one frame) and `--glass --frames 2`; HybridRenderer's
    512^2 frame timed, with the mesh trace calls of one frame counted and
    the trace timed alone at its primary and shadow rays; the card's frame
    against the port's on the CPU at 64^2; the miss path with a cubemap
    that save_ktx2 wrote (ZLIB) and load_cubemap read.  Returns the hot
    spots' numbers."""
    import numpy as np
    from gvrt_tpu_torch.hybrid import (HybridConfig, HybridRenderer,
                                       cornell_scene, mesh)
    from gvrt_tpu_torch.hybrid import pipeline as hpipe
    from gvrt_tpu_torch.io import ktx
    t0 = time.time()
    runs = {}
    # both CLI runs at once (each spends most of its time starting up)
    procs = {}
    for label, extra, frames in (("default", [], 1),
                                 ("glass_2_frames",
                                  ["--glass", "--frames", "2"], 2)):
        out_dir = os.path.join(tmp, f"hybrid_{label}")
        procs[label] = (subprocess.Popen(
            [sys.executable, "-m", PKG, "hybrid", "--out", out_dir, *extra],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out_dir, frames)
    logs = {}
    try:
        for label, (proc, _, _) in procs.items():
            logs[label] = proc.communicate(timeout=600)[0]
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for label, (proc, out_dir, frames) in procs.items():
        if proc.returncode != 0:
            fail(f"CLI hybrid ({label}) failed:\n{logs[label]}")
        pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        imgs = [gt.io.load_png(os.path.join(out_dir, f)) for f in pngs]
        runs[label] = {"pngs": pngs,
                       "max_level": [int(x.max()) for x in imgs],
                       "shapes": [list(x.shape) for x in imgs]}
        if pngs != [f"hybrid_{i:04d}.png" for i in range(frames)] or \
                not all(int(x.max()) > 0 for x in imgs) or \
                any(x.shape != (HYBRID_SIZE, HYBRID_SIZE, 3) for x in imgs):
            fail(f"CLI hybrid ({label}) wrote {runs[label]}")
    runs["seconds"] = time.time() - t0
    print(json.dumps({"phase": "cli_hybrid", **runs, "card": name,
                      "power_limit": power}), flush=True)

    # HybridRenderer at 512^2 from the CLI's first camera; the trace calls
    # of one frame counted
    scene = cornell_scene(with_mirror=True)
    pts = scene.tri_pos.reshape(-1, 3)
    lo, hi = pts.min(0), pts.max(0)
    center = (lo + hi) / 2
    eye = center + float(np.linalg.norm(hi - lo)) * 0.9 * np.asarray(
        [0.0, 0.15, 1.0])
    c2w = gt.io.cameras.look_at_inverse(eye, center,
                                        np.asarray([0.0, 1.0, 0.0]))
    cam = gt.Camera.from_fovy(HYBRID_SIZE, HYBRID_SIZE, 60.0, c2w)
    hcfg = HybridConfig()
    r = HybridRenderer(HYBRID_SIZE, HYBRID_SIZE, hcfg, device=dev)
    calls = {"closest_hit": 0, "occluded": 0}
    real_occ = hpipe.occluded
    real_ch = hpipe._DeviceScene.closest_hit

    def occ(*a, **kw):
        calls["occluded"] += 1
        return real_occ(*a, **kw)

    def ch(self, rays):
        calls["closest_hit"] += 1
        return real_ch(self, rays)

    hpipe.occluded, hpipe._DeviceScene.closest_hit = occ, ch
    try:
        frame = r.render(scene, cam)
        torch.cuda.synchronize()
    finally:
        hpipe.occluded, hpipe._DeviceScene.closest_hit = real_occ, real_ch
    if not bool(frame["rgb"].isfinite().all()) or not float(
            frame["rgb"].max()) > 0 or not bool((frame["object"] >= 0).any()):
        fail("the hybrid frame at 512^2 is empty or not finite")
    frame_ms = cuda_ms(lambda: r.render(scene, cam), n=5)
    # the trace alone at the frame's primary rays and at its shadow rays
    dev_scene = hpipe._DeviceScene(scene, hcfg, dev)
    prim = primary_rays(torch, cam, dev)
    surf = hpipe._surface_attributes(dev_scene, dev_scene.closest_hit(prim),
                                     prim)
    to_l = dev_scene.lights[0, 0:3] - surf["pos"]
    dist = torch.linalg.vector_norm(to_l, dim=-1)
    sdir = to_l / dist.clamp_min(1e-12)[:, None]
    srays = torch.cat([surf["pos"] + sdir * 0.1, sdir], dim=1)
    stmax = torch.where(dist >= 0.5, dist - 0.5, dist)
    stmin = torch.full_like(dist, 0.1)
    ch_ms = cuda_ms(lambda: dev_scene.closest_hit(prim), n=5)
    occ_ms = cuda_ms(lambda: hpipe.occluded(srays, dev_scene.tris, stmin,
                                            stmax, batch=hcfg.ray_block),
                     n=5)
    n_rays, n_tris = prim.shape[0], scene.num_tris
    ch_b = trace_work_bound(torch, False, prim, dev_scene.tris,
                            torch.full((n_rays,), 1e-3, device=dev), None,
                            n_tris)
    occ_b = trace_work_bound(torch, True, srays, dev_scene.tris, stmin,
                             stmax, n_tris)
    hot = {"frame_ms": frame_ms,
           "closest_hit": {"calls_per_frame": calls["closest_hit"],
                           "rays": n_rays, "triangles": n_tris,
                           "ms": ch_ms, **ch_b},
           "occluded": {"calls_per_frame": calls["occluded"],
                        "rays": n_rays, "triangles": n_tris, "ms": occ_ms,
                        **occ_b}}
    print(json.dumps({"phase": "hybrid_frame", "size": HYBRID_SIZE, **hot,
                      "hit_pixels": int((frame["object"] >= 0).sum()),
                      "card": name, "power_limit": power}), flush=True)

    # the card's frame against the port's on the CPU
    small_cam = gt.Camera.from_fovy(HYBRID_CPU_SIZE, HYBRID_CPU_SIZE, 60.0,
                                    c2w)
    glass = cornell_scene(with_mirror=True, with_glass=True)
    a = HybridRenderer(HYBRID_CPU_SIZE, HYBRID_CPU_SIZE, hcfg,
                       device=dev).render(glass, small_cam, time=0.25)
    b = HybridRenderer(HYBRID_CPU_SIZE, HYBRID_CPU_SIZE, hcfg,
                       device="cpu").render(glass, small_cam, time=0.25)
    d = (a["rgb"].cpu() - b["rgb"]).abs().amax(-1)
    vs_cpu = {"rgb_frac_within_1e-4": float((d <= 1e-4).float().mean()),
              "rgb_max_abs": float(d.max()),
              "object_frac_equal": float((a["object"].cpu() == b["object"])
                                         .float().mean())}

    # the miss path: a cubemap written by save_ktx2 (ZLIB) and read back by
    # load_cubemap behind a small tile, so most pixels miss
    faces = np.broadcast_to(np.asarray(FACE_COLORS, np.float32)[
        :, None, None, :], (6, 16, 16, 3)).copy()
    sky_path = os.path.join(tmp, "sky.ktx2")
    ktx.save_ktx2(sky_path, faces, supercompression="zlib")
    sky = mesh.MeshScene()
    pos, idx = mesh._quad([-0.2, -0.2, -2], [0.2, -0.2, -2], [0.2, 0.2, -2],
                          [-0.2, 0.2, -2])
    sky.add_object("tile", pos, idx, mesh.Material())
    sky.lights.append(mesh.Light(position=(0.0, 0.0, 0.0), radius=10.0))
    sky.env_cube = gt.io.load_cubemap(sky_path)
    sky_cam = gt.Camera.from_fovy(HYBRID_CPU_SIZE, HYBRID_CPU_SIZE, 120.0,
                                  np.eye(4))
    out = HybridRenderer(HYBRID_CPU_SIZE, HYBRID_CPU_SIZE, hcfg,
                         device=dev).render(sky, sky_cam)
    dirs = sky_cam.rays()[1].reshape(-1, 3)
    ax = np.abs(dirs)
    face = np.where((ax[:, 0] >= ax[:, 1]) & (ax[:, 0] >= ax[:, 2]),
                    np.where(dirs[:, 0] >= 0, 0, 1),
                    np.where((ax[:, 1] > ax[:, 0]) & (ax[:, 1] >= ax[:, 2]),
                             np.where(dirs[:, 1] >= 0, 2, 3),
                             np.where(dirs[:, 2] >= 0, 4, 5)))
    miss = out["object"].reshape(-1).cpu().numpy() < 0
    bg_err = float(np.abs(out["rgb"].reshape(-1, 3).cpu().numpy()[miss]
                          - faces[face[miss], 0, 0]).max())
    faces_seen = sorted(set(face[miss].tolist()))
    print(json.dumps({"phase": "hybrid_vs_cpu", "size": HYBRID_CPU_SIZE,
                      **vs_cpu, "cubemap_miss_pixels": int(miss.sum()),
                      "cubemap_faces_seen": faces_seen,
                      "cubemap_max_abs": bg_err, "card": name,
                      "power_limit": power,
                      "seconds": time.time() - t0}), flush=True)
    if vs_cpu["rgb_frac_within_1e-4"] < 0.999 or \
            vs_cpu["object_frac_equal"] < 0.999:
        fail(f"the hybrid frame on the card against the CPU: {vs_cpu}")
    if bg_err > 1e-6 or not miss.any() or miss.all() or len(faces_seen) < 3:
        fail(f"the hybrid miss path: max abs {bg_err} against the "
             f"cubemap's faces, {int(miss.sum())} misses, faces {faces_seen}")
    return hot


def native_ply_phase(ply, name, power):
    """Phase 4c: the native PLY reader builds on this machine (g++) and
    reads the phase-4 PLY bit for bit as the NumPy reader does; both
    timed (host clock, median of 3)."""
    import numpy as np
    from gvrt_tpu_torch.io import ply as tply
    from gvrt_tpu_torch.native import ply_native
    t0 = time.time()
    if not ply_native.available():
        fail("the native PLY reader did not build")
    build_s = time.time() - t0
    times, arrays = {"native": [], "numpy": []}, {}
    for _ in range(3):
        for key, fn in (("native", ply_native.read_ply_arrays),
                        ("numpy", tply.read_ply_arrays)):
            t1 = time.perf_counter()
            arrays[key] = fn(ply)
            times[key].append(1e3 * (time.perf_counter() - t1))
    a, b = arrays["native"], arrays["numpy"]
    same = set(a) == set(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    print(json.dumps({"phase": "native_ply",
                      "library": os.path.relpath(ply_native.library_path(),
                                                 ROOT),
                      "build_s": build_s, "properties": len(a),
                      "rows": int(len(a["x"])), "bit_equal": same,
                      "native_ms": float(np.median(times["native"])),
                      "numpy_ms": float(np.median(times["numpy"])),
                      "card": name, "power_limit": power}),
          flush=True)
    if not same:
        fail("the native PLY reader disagrees with the NumPy reader")


def shapes_phase(gt, torch, dev, small, model, cam, reset_launches,
                 launches, name, power):
    """Phase 2c: K1 (serving and residual) and K2 (with and without ray
    gradients) at the tile and chunk sizes past one block, on the small
    scene (SHAPES_SMALL) and on the full-width frame (SHAPES_FULL): there
    also the serving frame and a training step through TiledRenderer, each
    with its launches counted (the step's gradients against the all-plain
    path), the kernels timed beside their bounds, and at POSE_SHAPE one
    optimize_camera_poses step.  Returns {shape: errors} for the kernels
    line."""
    import numpy as np
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv
    from gvrt_tpu_torch.render.tiled import TiledRenderer
    from gvrt_tpu_torch.train import pose as tpose
    base = gt.DEFAULT_CONFIG
    t_phase = time.time()
    res = {}
    for tile, chunk, side in SHAPES_SMALL:
        cfg = base.replace(tile_size=tile, chunk_size=chunk)
        label = f"t{tile}_g{chunk}"
        cam_s = gt.Camera.from_fovy(side, side, 60.0, np.eye(4))
        binned, rays = binned_for(gt, small, cam_s, cfg)
        if chunk > 512 and int(binned.tile_counts.max()) <= 512:
            fail(f"{label}: no tile holds live rows in two of K1's pieces")
        poison_allocator(torch, 8 * (binned.chunks.numel() + rays.numel()),
                         dev)
        with torch.no_grad():
            got = pf.forward_dispatch(binned, rays, cfg, "cuda")
            again = pf.forward_dispatch(binned, rays, cfg, "cuda")
            want = pf.forward_dispatch(binned, rays, cfg, "torch")
        e = {"rays_per_tile": tile * tile,
             "tile_forward": compare_acc(got, want, label)}
        if not torch.equal(got, again):
            fail(f"K1 at {label}: two runs differ")
        e["tile_forward_residual"], e["tile_backward_ray_gradients"], _ = (
            check_training_kernels(torch, binned, rays,
                                   cfg.replace(ray_gradients=True), label,
                                   20))
        _, e["tile_backward"], _ = check_training_kernels(
            torch, binned, rays, cfg, label, 21)
        res[label] = e
    print(json.dumps({"phase": "shapes_small", "max_abs_err": res,
                      "seconds": time.time() - t_phase}), flush=True)

    targets = {}
    for tile, chunk in SHAPES_FULL:
        t0 = time.time()
        cfg = base.replace(tile_size=tile, chunk_size=chunk)
        label = f"full_t{tile}_g{chunk}"
        line = {"phase": "shapes_full_width", "tile": tile, "chunk": chunk,
                "rays_per_tile": tile * tile}
        # serving through the entry point
        r = TiledRenderer(FULL_W, FULL_H, cfg, device=dev)
        r.plan(model, [cam])
        reset_launches()
        with torch.no_grad():
            out = r.render(model, cam)
        torch.cuda.synchronize()
        line["serve_launches"] = serve = launches()
        if int(out["overflow"]) or not all(
                bool(out[k].isfinite().all())
                for k in ("rgb", "depth", "transmittance")):
            fail(f"{label}: serving frame overflowed or is not finite")
        if serve["tile_forward"] != 1 or any(
                serve[k] for k in ("tile_forward_residual", "tile_backward",
                                   "segment_reduce",
                                   "segment_reduce_compact")):
            fail(f"{label}: serving launches {serve}")
        line["mean_hits_per_ray"] = float(out["hit_count"].mean())
        targets[(tile, chunk)] = out["rgb"]
        with torch.no_grad():
            line["render_ms"] = cuda_ms(lambda: r.render(model, cam))
        # a training step through the entry point: gather, K1's residual,
        # K2, K3 and the parameter-layer VJP, against the all-plain path
        r.bind(model, cam)

        def step(impl):
            rr = TiledRenderer(FULL_W, FULL_H, cfg, capacity=r.capacity,
                               impl=impl, device=dev)
            rr._bound = r._bound
            model.zero_grad(set_to_none=True)
            loss = ((rr.render_bound(model)["rgb"] - TRAIN_TARGET) ** 2).mean()
            loss.backward()
            return {k: getattr(model, k).grad.clone()
                    for k in gt.models.gaussians.LEAVES}

        reset_launches()
        g_k = step("cuda")
        torch.cuda.synchronize()
        line["train_launches"] = train = launches()
        if any(train[k] != 1 for k in ("tile_forward_residual",
                                       "tile_backward", "segment_reduce")) \
                or train["tile_forward"] or train["segment_reduce_compact"]:
            fail(f"{label}: training step launches {train}")
        line["step_ms"] = cuda_ms(lambda: step("cuda"), n=5)
        g_p = step("torch")
        line["grad_rel_l2"] = rel = {k: rel_l2(g_k[k], g_p[k]) for k in g_p}
        if max(rel.values()) > 1e-4 or not all(
                bool(g_k[k].isfinite().all()) and float(g_p[k].abs().max()) > 0
                for k in g_p):
            fail(f"{label}: training step gradients against the all-plain "
                 f"path: {rel}")
        model.zero_grad(set_to_none=True)
        del g_k, g_p, r, out
        # the kernels alone at the frame's shapes, beside their bounds
        binned, rays = binned_for(gt, model, cam, cfg)
        with torch.no_grad():
            k = {"tile_forward_ms": cuda_ms(lambda: pf.tile_forward(
                binned.chunks, rays, binned.tile_counts, cfg))}
            acc = pf.tile_forward(binned.chunks, rays, binned.tile_counts, cfg)
            k["tile_forward_plain_ms"], plain = event_ms(
                lambda: pf.forward_tiles_reference(binned, rays, cfg))
            e = {"tile_forward": compare_acc(acc, plain, label)}
            del plain
            k["tile_forward_residual_ms"] = cuda_ms(
                lambda: pf.tile_forward_residual(binned.chunks, rays,
                                                 binned.tile_counts, cfg))
            acc_t, t_in = pf.tile_forward_residual(binned.chunks, rays,
                                                   binned.tile_counts, cfg)
            bar = bar_acc_for(torch, rays, 22)
            for key, c in (("tile_backward_ms", cfg),
                           ("tile_backward_ray_gradients_ms",
                            cfg.replace(ray_gradients=True))):
                k[key] = cuda_ms(lambda: pv.tile_backward(
                    binned.chunks, rays, binned.tile_counts, t_in, bar, c))
            del acc_t, t_in, bar
            e["tile_forward_residual"], e["tile_backward_ray_gradients"], \
                e["rows_rel_l2_max"] = check_training_kernels(
                    torch, binned, rays, cfg.replace(ray_gradients=True),
                    label, 23)
            # check_ray_rows held the instances without ray gradients to
            # the same bar_chunks bit for bit
            e["tile_backward"] = e["tile_backward_ray_gradients"]
            n = chain_counts(binned, rays, cfg)
            t_in_bytes = binned.chunks.shape[0] * rays.shape[2] * 4
            for key, b in (
                    ("tile_forward", bound_ms(binned, rays, acc, cfg, n)),
                    ("tile_forward_residual", bound_ms(
                        binned, rays, acc, cfg, n, extra_bytes=t_in_bytes)),
                    ("tile_backward", bound_bwd_ms(binned, rays, acc, cfg,
                                                   n)),
                    ("tile_backward_ray_gradients", bound_bwd_ms(
                        binned, rays, acc, cfg, n, ray_grads=True))):
                k[key + "_bound_ms"], k[key + "_bound_by"] = b[0], b[1]
        line.update({"chunks": int(binned.chunks.shape[0]),
                     "tiles": int(rays.shape[0]), "chain_counts": n,
                     "kernels": k, "max_abs_err": e})
        del binned, rays, acc
        torch.cuda.empty_cache()
        line.update({"card": name, "power_limit": power,
                     "seconds": time.time() - t0})
        print(json.dumps(line), flush=True)
        res[label] = {**e, **k}

    # one pose step at POSE_SHAPE: K1 once for loss0, K1's residual and K2
    # with ray cotangents (R = 1024) once
    t0 = time.time()
    cfg = base.replace(tile_size=POSE_SHAPE[0], chunk_size=POSE_SHAPE[1])
    target = targets[POSE_SHAPE]
    bad = gt.train.perturb_cameras([cam], POSE_SIGMA, seed=0)[0]
    reset_launches()
    _, reports = gt.train.optimize_camera_poses(
        model, [bad], [target], cfg, steps=1, lr=POSE_LR, verbose=False)
    torch.cuda.synchronize()
    pose_launches = launches()
    want = {"tile_forward": 1, "tile_forward_residual": 1, "tile_backward": 1,
            "segment_reduce": 0, "segment_reduce_compact": 0,
            "segment_reduce_compact_table": 0}
    if pose_launches != want:
        fail(f"pose step at {POSE_SHAPE}: launches {pose_launches}, "
             f"expected {want}")
    bound = tpose.bind_pose(model, bad, target, cfg)

    def pose_grads(impl):
        poison_allocator(torch, 8 * bound.binned.chunks.numel(), dev)
        t = torch.zeros(3, device=dev, requires_grad=True)
        r = torch.zeros(3, device=dev, requires_grad=True)
        return [x.detach() for x in torch.autograd.grad(
            tpose.pose_loss(bound, t, r, impl), (t, r))]

    g_k, g_p = pose_grads("cuda"), pose_grads("torch")
    rel = {"t": rel_l2(g_k[0], g_p[0]), "r": rel_l2(g_k[1], g_p[1])}
    if not all(np.isfinite(v) for v in reports[0].values()) or max(
            rel.values()) > 1e-4 or not all(
            bool(x.isfinite().all()) and float(x.abs().max()) > 0
            for x in g_k + g_p):
        fail(f"pose step at {POSE_SHAPE}: {reports[0]}, gradient {rel}")
    t_s = torch.zeros(3, device=dev, requires_grad=True)
    r_s = torch.zeros(3, device=dev, requires_grad=True)
    opt = torch.optim.Adam([t_s, r_s], lr=POSE_LR, eps=1e-8)

    def pose_step():
        opt.zero_grad(set_to_none=True)
        tpose.pose_loss(bound, t_s, r_s, "cuda").backward()
        opt.step()

    pose = {"shape": list(POSE_SHAPE), **reports[0],
            "launches": pose_launches, "grad_rel_l2": rel,
            "pose_step_ms": cuda_ms(pose_step)}
    print(json.dumps({"phase": "shapes_pose_step", **pose, "card": name,
                      "power_limit": power, "seconds": time.time() - t0}),
          flush=True)
    res["pose_t32_g64"] = pose
    del bound, opt, targets
    torch.cuda.empty_cache()
    return res


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs on the card only")
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        fail(f"{PKG}/ is not beside this script: run it from the repository")
    sys.path.insert(0, ROOT)
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch import _build
    from gvrt_tpu_torch.render import banded as bd
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv
    from gvrt_tpu_torch.render import segreduce as sr
    from gvrt_tpu_torch.render import rows_vjp
    from gvrt_tpu_torch.render.rows_vjp import frame_params
    from gvrt_tpu_torch.render.tiled import TiledRenderer, _camera_mats

    def reset_launches():
        for fn in (pf.tile_forward, pf.tile_forward_residual,
                   pv.tile_backward, sr.segment_reduce,
                   sr.segment_reduce_compact,
                   sr.segment_reduce_compact_table):
            fn.launches = 0

    def table_launches(before=(0, 0)):
        """(forward, backward) launches of the parameter-table kernels
        since `before`."""
        return (rows_vjp.param_table_forward.launches - before[0],
                rows_vjp.param_table_backward.launches - before[1])

    def launches():
        """Each wrapper's count; K4's two modes also summed as K4's."""
        return {"tile_forward": pf.tile_forward.launches,
                "tile_forward_residual": pf.tile_forward_residual.launches,
                "tile_backward": pv.tile_backward.launches,
                "segment_reduce": sr.segment_reduce.launches,
                "segment_reduce_compact": sr.segment_reduce_compact.launches
                + sr.segment_reduce_compact_table.launches,
                "segment_reduce_compact_table":
                    sr.segment_reduce_compact_table.launches}

    # ---- 1. set-up -------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    name, power = [s.strip() for s in card.split(",", 1)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    _build.build()
    print(json.dumps({"phase": "build", "libraries": list(_build.SIGNATURES),
                      "seconds": time.time() - t0}), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    t_all = time.time()

    # ---- 1b. the camera-ray kernel ---------------------------------------
    rays_res = rays_phase(gt, torch, dev, binning, name, power)

    # ---- 1c. the max-scan kernel -----------------------------------------
    scan_res = scan_phase(gt, torch, dev, name, power)

    # ---- 1d. the parameter-table kernels ---------------------------------
    table_res = table_phase(gt, torch, dev, name, power)

    # ---- 1e. binning's pair expansion --------------------------------------
    expand_res = expand_phase(gt, torch, dev, name, power)

    # ---- 1f. the mesh trace's kernel ---------------------------------------
    trace_res = mesh_trace_phase(gt, torch, dev, name, power)

    # ---- 2. kernels against plain versions ------------------------------
    def add_training_errs(errs):
        tin_errs.append(errs[0])
        k2_errs.append(errs[1])
        if len(errs) > 2 and errs[2] is not None:
            ray_row_errs.append(errs[2])

    errs, tin_errs, k2_errs, ray_row_errs = [], [], [], []
    g = torch.Generator(device=dev).manual_seed(1)
    small = gt.random_gaussians(g, 3000, extent=0.8, device=dev)
    with torch.no_grad():
        small.means[:, 2] -= 3.0
    cam128 = gt.Camera.from_fovy(128, 128, 60.0, np.eye(4))
    base = gt.DEFAULT_CONFIG
    for i, (label, cfg, ray_grads) in enumerate((
            ("t8_g128", base.replace(tile_size=8, chunk_size=128), True),
            ("default_logspace", base.replace(transmittance_prod=False),
             False),
            ("kernel_degree_2", base.replace(kernel_degree=2), False))):
        binned, rays = binned_for(gt, small, cam128, cfg)
        with torch.no_grad():
            got = pf.forward_dispatch(binned, rays, cfg, "cuda")
            want = pf.forward_dispatch(binned, rays, cfg, "torch")
        errs.append(compare_acc(got, want, label))
        torch.cuda.synchronize()
        add_training_errs(check_training_kernels(
            torch, binned, rays, cfg.replace(ray_gradients=ray_grads), label,
            10 + i))

    # empty tiles + dead trailing chunks + saturated tiles
    g = torch.Generator(device=dev).manual_seed(2)
    blob = gt.random_gaussians(g, 2000, extent=0.3, scale_range=(-2.2, -1.6),
                               device=dev)
    with torch.no_grad():
        blob.means[:, 2] -= 3.0
        blob.opacity_logit += 6.0
    cam256 = gt.Camera.from_fovy(256, 256, 60.0, np.eye(4))
    binned, rays = binned_for(gt, blob, cam256, base, pad_factor=3)
    with torch.no_grad():
        got = pf.forward_dispatch(binned, rays, base, "cuda")
        want = pf.forward_dispatch(binned, rays, base, "torch")
    n_tiles = rays.shape[0]
    empty = int((binned.tile_counts == 0).sum())
    dead = int((binned.chunk_tile == n_tiles).sum())
    saturated = int((got[:, 4].amax(1) <= base.min_transmittance).sum())
    if not (empty and dead and saturated):
        fail(f"edge scene lacks a case: empty={empty} dead={dead} "
             f"saturated={saturated}")
    errs.append(compare_acc(got, want, "empty_dead_saturated"))
    torch.cuda.synchronize()
    add_training_errs(check_training_kernels(
        torch, binned, rays, base.replace(ray_gradients=True),
        "empty_dead_saturated", 13))

    # 512-tile slice of the full-width frame
    model = bench_scene(gt, torch, dev)
    cam = gt.Camera.from_fovy(FULL_W, FULL_H, 50.0, np.eye(4))
    full, full_rays = binned_for(gt, model, cam, base)
    part, part_rays = slice_scene(full, full_rays, base.chunk_size)
    with torch.no_grad():
        got = pf.forward_dispatch(part, part_rays, base, "cuda")
        want = pf.forward_dispatch(part, part_rays, base, "torch")
    errs.append(compare_acc(got, want, "full_width_512_tiles"))
    torch.cuda.synchronize()
    add_training_errs(check_training_kernels(
        torch, part, part_rays, base, "full_width_512_tiles", 14))

    # ---- 2b. K1 and K2 at R = 400 (tile 20, the light field's) -----------
    t20 = base.replace(tile_size=LF_TILE)
    cam120 = gt.Camera.from_fovy(120, 120, 60.0, np.eye(4))
    binned, rays = binned_for(gt, small, cam120, t20)
    if rays.shape[2] != LF_TILE * LF_TILE:
        fail(f"tile {LF_TILE} gave {rays.shape[2]} rays per tile")
    poison_allocator(torch, 8 * (binned.chunks.numel() + rays.numel()), dev)
    with torch.no_grad():
        got = pf.forward_dispatch(binned, rays, t20, "cuda")
        again = pf.forward_dispatch(binned, rays, t20, "cuda")
        want = pf.forward_dispatch(binned, rays, t20, "torch")
    r400 = {"tile_forward": compare_acc(got, want, "t20_R400")}
    if not torch.equal(got, again):
        fail("K1 at R = 400: two runs differ")
    r400["tile_forward_residual"], r400["tile_backward"], _ = (
        check_training_kernels(torch, binned, rays, t20, "t20_R400", 16))
    _, r400["tile_backward_ray_gradients"], r400_rows = (
        check_training_kernels(torch, binned, rays,
                               t20.replace(ray_gradients=True),
                               "t20_R400_ray_gradients", 17))
    ray_row_errs.append(r400_rows)
    print(json.dumps({"phase": "r400", "rays_per_tile": rays.shape[2],
                      "tiles": rays.shape[0], "max_abs_err": r400}),
          flush=True)
    errs.append(r400["tile_forward"])
    add_training_errs((r400["tile_forward_residual"],
                       max(r400["tile_backward"],
                           r400["tile_backward_ray_gradients"])))
    del binned, rays, got, again, want

    # ---- 2c. tile and chunk sizes past one block --------------------------
    shapes = shapes_phase(gt, torch, dev, small, model, cam, reset_launches,
                          launches, name, power)

    # ---- 3. full width, through the serving entry point ------------------
    renderer = TiledRenderer(FULL_W, FULL_H, base, device=dev)
    t0 = time.time()
    renderer.plan(model, [cam])
    plan_s = time.time() - t0
    reset_launches()
    rays_before = binning.camera_rays_kernel.launches
    scan_before = gt.render.scan.max_scan.launches
    expand_before = binning.expand_pairs.launches
    table_before = table_launches()
    with torch.no_grad():  # serving: K1 without the training residual
        out = renderer.render(model, cam)
    torch.cuda.synchronize()
    serve_launches = launches()
    serve_ray_launches = binning.camera_rays_kernel.launches - rays_before
    serve_scan_launches = gt.render.scan.max_scan.launches - scan_before
    serve_expand_launches = binning.expand_pairs.launches - expand_before
    if serve_expand_launches != 1:
        fail(f"a serving frame launched the pair kernel "
             f"{serve_expand_launches} times, not once")
    serve_table_launches = table_launches(table_before)
    if serve_table_launches != (1, 0):
        fail(f"a serving frame launched the parameter-table kernels "
             f"{serve_table_launches} times, not (1, 0)")
    if serve_ray_launches != 1:
        fail(f"a serving frame made its rays in {serve_ray_launches} "
             f"camera-ray launches")
    if serve_scan_launches != 3:
        fail(f"a serving frame filled its runs in {serve_scan_launches} "
             f"max-scan launches, not 3")
    mean_hits = float(out["hit_count"].mean())
    print(json.dumps({"phase": "full_width", "width": FULL_W,
                      "height": FULL_H, "gaussians": FULL_N,
                      "capacity": list(renderer.capacity),
                      "plan_s": plan_s, "num_pairs": int(out["num_pairs"]),
                      "overflow": int(out["overflow"]),
                      "mean_hits_per_ray": mean_hits,
                      "launches": serve_launches}), flush=True)
    if int(out["overflow"]) != 0:
        fail("full-width frame overflowed its plan")
    if not all(bool(v.isfinite().all()) for k, v in out.items()
               if k in ("rgb", "depth", "transmittance")):
        fail("full-width frame is not finite")
    if mean_hits < 15:
        fail(f"mean hits/ray {mean_hits:.2f} < 15")
    if serve_launches["tile_forward"] < 1:
        fail("the serving path did not launch the tile kernel")
    if any(serve_launches[k] for k in ("tile_forward_residual",
                                       "tile_backward", "segment_reduce",
                                       "segment_reduce_compact")):
        fail(f"a serving frame launched training kernels: {serve_launches}")

    rays_n = FULL_W * FULL_H

    def report(metric, ms, rays=rays_n):
        print(json.dumps({"metric": metric, "ms": ms,
                          "mrays_per_s": rays / (ms * 1e-3) / 1e6,
                          "card": name, "power_limit": power}), flush=True)

    with torch.no_grad():
        report("render_ms", cuda_ms(lambda: renderer.render(model, cam)))
        renderer.bind(model, cam)
        report("render_bound_ms",
               cuda_ms(lambda: renderer.render_bound(model)))
        k_ms = cuda_ms(lambda: pf.tile_forward(full.chunks, full_rays,
                                               full.tile_counts, base))
        report("tile_forward_ms", k_ms)
        acc = pf.tile_forward(full.chunks, full_rays, full.tile_counts, base)
        plain_ms, plain = event_ms(
            lambda: pf.forward_tiles_reference(full, full_rays, base))
        report("tile_forward_plain_ms", plain_ms)
        full_err = float((acc - plain)[:, 0:5].abs().max())
        full_n = chain_counts(full, full_rays, base)
        print(json.dumps({"phase": "full_frame_chain_counts", **full_n}),
              flush=True)
        k1_bound = bound_ms(full, full_rays, acc, base, full_n)
        del plain
    torch.cuda.synchronize()

    # ---- 3b. banded serving of the full-width frame ------------------------
    t0 = time.time()
    reset_launches()
    with torch.no_grad():
        compare_frames(bd.render_image_banded(model, cam, 4, base, device=dev),
                       out, "4_stride")
        sorted_model = model.sorted_for_camera(cam, base)
        want_sorted = TiledRenderer(FULL_W, FULL_H, base, device=dev).render(
            sorted_model, cam)
        compare_frames(bd.render_image_banded(sorted_model, cam, 4, base,
                                              span=True, device=dev),
                       want_sorted, "4_span_sorted")
        balanced = bd.BandedRenderer(FULL_W, FULL_H, 2, base, span=True,
                                     balance=True, device=dev)
        balanced.bind(sorted_model, cam)
        compare_frames(balanced.render_bound(sorted_model), want_sorted,
                       "2_balanced_sorted")
    torch.cuda.synchronize()
    band_launches = launches()
    print(json.dumps({"phase": "banded_serving", "launches": band_launches,
                      "band_specs": balanced.band_specs,
                      "seconds": time.time() - t0}), flush=True)
    if band_launches["tile_forward"] < 4 + 4 + 2 or any(
            band_launches[k] for k in ("tile_forward_residual",
                                       "tile_backward",
                                       "segment_reduce_compact")):
        fail(f"banded serving launches: {band_launches}")
    del sorted_model, want_sorted, balanced

    # ---- 3c. the light field of the 300k scene ---------------------------
    from gvrt_tpu_torch.models import lightfield as lfm
    t0 = time.time()
    lf = lfm.LightFieldConfig()
    reset_launches()
    lf_ms, lf_out = event_ms(lambda: lfm.compute_light_field(model, lf,
                                                            device=dev))
    lf_launches = launches()
    lf_plain = lfm.compute_light_field(model, lf, impl="torch", device=dev)
    lf_err = compare_images(lf_out["images"], lf_plain["images"],
                            "light field")
    if lf_launches["tile_forward"] < lf.num_cameras or any(
            lf_launches[k] for k in ("tile_forward_residual",
                                     "tile_backward", "segment_reduce",
                                     "segment_reduce_compact")):
        fail(f"light-field launches {lf_launches}")
    if lf_out["images"].shape != (lf.num_cameras, lf.height, lf.width, 3) \
            or not lf_out["images"].max() > 0:
        fail(f"light field: images {lf_out['images'].shape}, max "
             f"{lf_out['images'].max()}")
    # K1 alone at one light-field camera's shapes (R = 400)
    lf_cfg = base.replace(tile_size=lf.tile_size)
    lf_scene, lf_rays = binned_for(gt, model, lf_out["cameras"][0], lf_cfg)
    with torch.no_grad():
        lf_k_ms = cuda_ms(lambda: pf.tile_forward(
            lf_scene.chunks, lf_rays, lf_scene.tile_counts, lf_cfg))
        lf_acc = pf.tile_forward(lf_scene.chunks, lf_rays,
                                 lf_scene.tile_counts, lf_cfg)
        lf_k_plain_ms, _ = event_ms(lambda: pf.forward_tiles_reference(
            lf_scene, lf_rays, lf_cfg))
        lf_n = chain_counts(lf_scene, lf_rays, lf_cfg)
        lf_bound = bound_ms(lf_scene, lf_rays, lf_acc, lf_cfg, lf_n)
        _, lf_runs = pf.tile_chunk_runs(lf_scene.tile_counts,
                                        lf_scene.chunks.shape[0],
                                        lf_cfg.chunk_size)
        lf_n.update(tiles=int(lf_rays.shape[0]),
                    visited_chunks=int(lf_runs.sum()),
                    longest_run=int(lf_runs.max()))
    lightfield = {"launches": lf_launches["tile_forward"],
                  "max_abs_err": lf_err, "ms": lf_k_ms,
                  "plain_ms": lf_k_plain_ms, "bound_ms": lf_bound[0],
                  "bound_by": lf_bound[1], "library_ms": None}
    print(json.dumps({"phase": "lightfield", "cameras": lf.num_cameras,
                      "size": lf.width, "tile": lf.tile_size,
                      "fov_deg": lf.fov_deg, "launches": lf_launches,
                      "compute_ms": lf_ms, "tile_forward": lightfield,
                      "camera0_chain_counts": lf_n,
                      "card": name, "power_limit": power,
                      "seconds": time.time() - t0}), flush=True)
    del lf_plain, lf_scene, lf_rays, lf_acc

    # ---- 3d-3f. the combined Gaussian-and-mesh render --------------------
    comb_res = combined_phases(gt, torch, dev, model, cam, full, full_rays,
                               acc, small, cam128, base, reset_launches,
                               launches, name, power)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 4. the CLI on a PLY -----------------------------------------
        ply = os.path.join(tmp, "bench_scene.ply")
        model.to_ply(ply)
        out_dir = os.path.join(tmp, "renders")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "render", "--ply", ply, "--width",
             str(FULL_W), "--height", str(FULL_H), "--frames", "4",
             "--out", out_dir], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            fail(f"CLI render failed:\n{proc.stdout}\n{proc.stderr}")
        pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        if len(pngs) != 4:
            fail(f"CLI wrote {pngs}")
        for f in pngs:
            img = gt.io.load_png(os.path.join(out_dir, f))
            if img.shape != (FULL_H, FULL_W, 3) or int(img.max()) == 0:
                fail(f"{f}: shape {img.shape}, max {img.max()}")
        print(json.dumps({"phase": "cli_render", "frames": len(pngs),
                          "seconds": time.time() - t0}), flush=True)
        # the same frames in 4 stride bands: the same 8-bit images
        band_dir = os.path.join(tmp, "renders_banded")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "render", "--ply", ply, "--width",
             str(FULL_W), "--height", str(FULL_H), "--frames", "4",
             "--bands", "4", "--out", band_dir], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"CLI render --bands failed:\n{proc.stdout}\n{proc.stderr}")
        png_diff = max(int(np.abs(
            gt.io.load_png(os.path.join(band_dir, f)).astype(np.int64)
            - gt.io.load_png(os.path.join(out_dir, f)).astype(np.int64))
            .max()) for f in pngs)
        print(json.dumps({"phase": "cli_render_bands", "frames": len(pngs),
                          "max_level_diff": png_diff,
                          "seconds": time.time() - t0}), flush=True)
        if png_diff != 0:
            fail(f"CLI render --bands 4 differs from the unbanded renders by "
                 f"{png_diff} levels")
        t0 = time.time()
        fps_file = os.path.join(tmp, "fps_bands.txt")
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "benchmark", "--ply", ply, "--width",
             str(FULL_W), "--height", str(FULL_H), "--bands", "4", "-bw",
             "0.5", "-br", "2", "-bt", fps_file], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0 or "rays/s" not in proc.stdout or \
                not os.path.exists(fps_file):
            fail(f"CLI benchmark --bands failed:\n{proc.stdout}\n"
                 f"{proc.stderr}")
        print(json.dumps({"phase": "cli_benchmark_bands", "output": [
            line for line in proc.stdout.splitlines() if "/s" in line],
            "seconds": time.time() - t0}), flush=True)
        # the same frames with mesh props inserted (--mesh): the combined
        # frame served through CombinedRenderer; then its benchmark loop
        t0 = time.time()
        mesh_dir = os.path.join(tmp, "renders_mesh")
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "render", "--ply", ply, "--width",
             str(FULL_W), "--height", str(FULL_H), "--frames", "4",
             "--mesh", "quad_icosphere", "--out", mesh_dir], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"CLI render --mesh failed:\n{proc.stdout}\n{proc.stderr}")
        mesh_levels = [int(np.abs(
            gt.io.load_png(os.path.join(mesh_dir, f)).astype(np.int64)
            - gt.io.load_png(os.path.join(out_dir, f)).astype(np.int64))
            .max()) for f in pngs]
        fps_file = os.path.join(tmp, "fps_mesh.txt")
        bench = subprocess.run(
            [sys.executable, "-m", PKG, "benchmark", "--ply", ply, "--width",
             str(FULL_W), "--height", str(FULL_H), "--mesh",
             "quad_icosphere", "-bw", "1", "-br", "4", "-bt", fps_file],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        print(json.dumps({"phase": "cli_render_mesh", "frames": sorted(
            os.listdir(mesh_dir)), "max_level_diff_vs_plain": mesh_levels,
            "benchmark": [line for line in bench.stdout.splitlines()
                          if "/s" in line], "seconds": time.time() - t0}),
            flush=True)
        if sorted(os.listdir(mesh_dir)) != pngs or max(mesh_levels) == 0:
            fail(f"CLI render --mesh wrote {os.listdir(mesh_dir)}, level "
                 f"differences {mesh_levels} from the frames without it")
        if bench.returncode != 0 or "rays/s" not in bench.stdout:
            fail(f"CLI benchmark --mesh failed:\n{bench.stdout}\n"
                 f"{bench.stderr}")
        # the light field from the PLY: 4 PNGs and the ray directions
        t0 = time.time()
        lf_dir = os.path.join(tmp, "lightfield")
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "lightfield", "--ply", ply, "--out",
             lf_dir], cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"CLI lightfield failed:\n{proc.stdout}\n{proc.stderr}")
        lf_pngs = sorted(f for f in os.listdir(lf_dir) if f.endswith(".png"))
        lf_dirs = np.load(os.path.join(lf_dir, "ray_dirs.npy"))
        lf_levels = max(int(np.abs(
            gt.io.load_png(os.path.join(lf_dir, f)).astype(np.int64)
            - gt.io.image.to_uint8(img).astype(np.int64)).max())
            for f, img in zip(lf_pngs, lf_out["images"]))
        print(json.dumps({"phase": "cli_lightfield", "pngs": lf_pngs,
                          "ray_dirs_shape": list(lf_dirs.shape),
                          "max_level_diff_vs_in_process": lf_levels,
                          "seconds": time.time() - t0}), flush=True)
        if lf_pngs != [f"sampling_cam{i:04d}.png" for i in range(4)] or \
                lf_dirs.shape != (4, 180, 180, 3):
            fail(f"CLI lightfield wrote {lf_pngs}, ray_dirs "
                 f"{lf_dirs.shape}")

        # ---- 4b. the hybrid renderer; 4c. the native PLY reader ----------
        hybrid_res = hybrid_phase(gt, torch, dev, tmp, name, power)
        native_ply_phase(ply, name, power)

        # ---- 5. the full-width training window ---------------------------
        trainer_r = TiledRenderer(FULL_W, FULL_H, base, device=dev)
        trainer_r.plan(model, [cam])
        train_model = gt.GaussianModel(*(p.detach().clone()
                                         for p in model.leaves()))
        w2c, proj = _camera_mats(cam)
        ts = base.tile_size
        target_tiled = torch.full((full_rays.shape[0], 3, ts * ts),
                                  TRAIN_TARGET, device=dev)
        captured = []

        def make_topo(m):
            with torch.no_grad():
                return binning.bin_topology(
                    m.activate(), w2c, proj, FULL_W, FULL_H, base,
                    *trainer_r.capacity,
                    capacity_reduce=trainer_r.capacity_reduce)

        def train_window(m, capture=False):
            """bench.py's train_k: a topology refresh, then TRAIN_K exact
            gradient steps against it; the loss in tiled space."""
            topo = make_topo(m)
            first = None
            for i in range(TRAIN_K):
                rows = frame_params(m, base)[1]
                chunks = binning.gather_from_rows(rows, topo, base, "cuda")
                if capture and i == 0:
                    chunks.register_hook(
                        lambda grad: captured.append(grad.reshape(-1, 64)))
                acc_t = pf.forward_dispatch(binning.binned_scene(chunks, topo),
                                            full_rays, base, "cuda")
                loss = ((acc_t[:, 0:3] - target_tiled) ** 2).mean()
                loss.backward()
                if i == 0:
                    first = (loss.detach(), acc_t[:, 5].detach().mean(),
                             m.means.grad.norm())
                with torch.no_grad():
                    for p in m.leaves():
                        p -= TRAIN_LR * p.grad
                        p.grad = None
            return topo, first

        reset_launches()
        scan_before = gt.render.scan.max_scan.launches
        expand_before = binning.expand_pairs.launches
        table_before = table_launches()
        topo, (loss0, hits0, gnorm0) = train_window(train_model, capture=True)
        torch.cuda.synchronize()
        train_launches = launches()
        train_table_launches = table_launches(table_before)
        if train_table_launches != (TRAIN_K, TRAIN_K):
            fail(f"the training window launched the parameter-table kernels "
                 f"{train_table_launches} times, not {TRAIN_K} each")
        bind_scan_launches = gt.render.scan.max_scan.launches - scan_before
        if bind_scan_launches != 4:
            fail(f"the unbanded bind filled its runs in "
                 f"{bind_scan_launches} max-scan launches, not 4")
        bind_expand_launches = binning.expand_pairs.launches - expand_before
        if bind_expand_launches != 1:
            fail(f"the unbanded bind launched the pair kernel "
                 f"{bind_expand_launches} times, not once")
        overflow = int(topo.overflow)
        print(json.dumps({"phase": "train_window", "steps": TRAIN_K,
                          "capacity": list(trainer_r.capacity),
                          "capacity_reduce": trainer_r.capacity_reduce,
                          "overflow": overflow, "loss": float(loss0),
                          "mean_hits_per_ray": float(hits0),
                          "means_grad_norm": float(gnorm0),
                          "launches": train_launches}), flush=True)
        if overflow != 0:
            fail("the training topology overflowed its plan")
        if float(hits0) < 15:
            fail(f"training frame: mean hits/ray {float(hits0):.2f} < 15")
        if not np.isfinite(float(loss0)) or not float(gnorm0) > 0:
            fail(f"training step: loss {float(loss0)}, grad norm "
                 f"{float(gnorm0)}")
        for k in ("tile_forward_residual", "tile_backward", "segment_reduce"):
            if train_launches[k] < TRAIN_K:
                fail(f"{k} launched {train_launches[k]} < {TRAIN_K} times in "
                     f"the training window")
        if train_launches["segment_reduce_compact"]:
            fail("the unbanded training window launched K4")
        window_ms, _ = event_ms(lambda: train_window(train_model))
        report("train_step_ms", window_ms / TRAIN_K)

        # the training kernels alone, at the frame's shapes
        with torch.no_grad():
            chunks_t = binning.gather_from_rows(
                frame_params(train_model, base)[1], topo, base, "cuda")
            scene_t = binning.binned_scene(chunks_t, topo)
            res_ms = cuda_ms(lambda: pf.tile_forward_residual(
                chunks_t, full_rays, topo.tile_counts, base))
            report("tile_forward_residual_ms", res_ms)
            acc_t, t_in = pf.tile_forward_residual(chunks_t, full_rays,
                                                   topo.tile_counts, base)
            res_plain_ms, (acc_p, t_in_p) = event_ms(
                lambda: pv._forward_residual_plain(chunks_t, full_rays,
                                                   topo.tile_counts, base))
            report("tile_forward_residual_plain_ms", res_plain_ms)
            res_err = max(float((t_in - t_in_p).abs().max()),
                          float((acc_t - acc_p)[:, 0:5].abs().max()))
            train_n = chain_counts(scene_t, full_rays, base)
            res_bound = bound_ms(scene_t, full_rays, acc_t, base, train_n,
                                 extra_bytes=t_in.numel() * 4)
            del acc_p, t_in_p
            # the loss's own cotangent of the accumulators
            bar = torch.zeros_like(acc_t)
            fixed = pf._background_fix(acc_t, topo.tile_counts)
            bar[:, 0:3] = torch.where(
                (topo.tile_counts > 0)[:, None, None],
                2.0 * (fixed[:, 0:3] - target_tiled) / target_tiled.numel(),
                0.0)
            k2_ms = cuda_ms(lambda: pv.tile_backward(
                chunks_t, full_rays, topo.tile_counts, t_in, bar, base))
            report("tile_backward_ms", k2_ms)
            bar_k2, _ = pv.tile_backward(chunks_t, full_rays,
                                         topo.tile_counts, t_in, bar, base)
            k2_plain_ms, (bar_p, _) = event_ms(
                lambda: pv._backward_plain(chunks_t, full_rays,
                                           topo.tile_counts, t_in, bar, base))
            report("tile_backward_plain_ms", k2_plain_ms)
            k2_full = {grp: rel_l2(bar_k2[..., cols], bar_p[..., cols])
                       for grp, cols in COL_GROUPS.items()}
            k2_cols = column_rel_l2(bar_k2, bar_p)
            k2_err = float((bar_k2 - bar_p).abs().max())
            print(json.dumps({"phase": "tile_backward_full_width",
                              "rel_l2": k2_full,
                              "columns_checked": len(k2_cols),
                              "column_rel_l2_max": max(k2_cols.values()),
                              "max_abs_err": k2_err}), flush=True)
            if max(k2_full.values()) > 1e-4 or max(k2_cols.values()) > 1e-4:
                fail("K2 disagrees with its plain version at full width")
            k2_bound = bound_bwd_ms(scene_t, full_rays, acc_t, base,
                                    train_n)
            del bar_p

            # K2 with the ray cotangents on the same inputs: against its
            # plain version, then A B B A against the instances without
            rg = base.replace(ray_gradients=True)
            poison_allocator(torch, 4 * (chunks_t.numel()
                                         + 2 * full_rays.numel()), dev)
            bar_k2r, bar_rays_k = pv.tile_backward(
                chunks_t, full_rays, topo.tile_counts, t_in, bar, rg)
            again_r = pv.tile_backward(
                chunks_t, full_rays, topo.tile_counts, t_in, bar, rg)
            k2r_plain_ms, (bar_pr, bar_rays_p) = event_ms(
                lambda: pv._backward_plain(chunks_t, full_rays,
                                           topo.tile_counts, t_in, bar, rg))
            ray_row_errs.append(check_ray_rows(
                torch, (bar_k2r, bar_rays_k), again_r, (bar_pr, bar_rays_p),
                bar_k2, "full_width_ray_gradients"))
            k2r = {"rel_l2_rays": rel_l2(bar_rays_k, bar_rays_p),
                   "rel_l2_chunks": rel_l2(bar_k2r, bar_pr),
                   "max_abs_err": max(
                       float((bar_rays_k - bar_rays_p).abs().max()),
                       float((bar_k2r - bar_pr).abs().max())),
                   "chunks_bit_identical_to_without": torch.equal(bar_k2r,
                                                                  bar_k2),
                   "finite": bool(bar_rays_k.isfinite().all()),
                   "rows_rel_l2_max": ray_row_errs[-1],
                   "plain_ms": k2r_plain_ms}
            del bar_k2r, bar_rays_k, bar_pr, bar_rays_p, again_r
            ab = {"without": [], "with": []}
            for key in ("without", "with", "with", "without"):
                cfg_k = rg if key == "with" else base
                ab[key].append(cuda_ms(lambda: pv.tile_backward(
                    chunks_t, full_rays, topo.tile_counts, t_in, bar,
                    cfg_k)))
            k2r["ms"] = float(np.mean(ab["with"]))
            k2r["ms_without"] = float(np.mean(ab["without"]))
            k2r["bound_ms"], k2r["bound_by"], _ = bound_bwd_ms(
                scene_t, full_rays, acc_t, base, train_n, ray_grads=True)
            print(json.dumps({"phase": "tile_backward_ray_gradients",
                              "abba_ms": ab, **k2r, "card": name,
                              "power_limit": power}), flush=True)
            if max(k2r["rel_l2_rays"], k2r["rel_l2_chunks"]) > 1e-4 or \
                    not k2r["finite"]:
                fail(f"K2 with ray cotangents disagrees with its plain "
                     f"version at full width: {k2r}")

            # ---- 6. K3 on the window's real cotangents -------------------
            bar_flat = captured[0].contiguous()
            red = topo.red
            n_rows = FULL_N + 1
            n_groups = -(-n_rows // sr.GROUP)
            k3 = sr.segment_reduce(bar_flat, red, n_groups)
            k3_again = sr.segment_reduce(bar_flat, red, n_groups)
            k3_plain = sr.segment_reduce_plain(bar_flat, red, n_groups)
            live = red.gloc.reshape(-1) < sr.GROUP
            gid = torch.where(live, (red.out_idx.long()[:, None] * sr.GROUP
                                     + red.gloc.long()).reshape(-1), 0)
            vals = torch.where(live[:, None], bar_flat[torch.clamp_max(
                red.slot.long(), bar_flat.shape[0] - 1)], 0.0)
            lib_out = torch.zeros_like(k3_plain)
            lib_out.index_add_(0, gid, vals)
            torch.cuda.synchronize()
            k3_err = float((k3 - k3_plain).abs().max())
            k3_check = {"rel_l2_vs_plain": rel_l2(k3, k3_plain),
                        "rel_l2_vs_index_add": rel_l2(k3, lib_out),
                        "max_abs_err": k3_err,
                        "bit_identical_runs": torch.equal(k3, k3_again),
                        "rows": int(red.slot.numel()),
                        "live_rows": int(live.sum()),
                        "finite": bool(k3.isfinite().all())}
            print(json.dumps({"phase": "segment_reduce_vs_plain",
                              **k3_check}), flush=True)
            if max(k3_check["rel_l2_vs_plain"],
                   k3_check["rel_l2_vs_index_add"]) > 1e-5 or \
                    not k3_check["bit_identical_runs"] or \
                    not k3_check["finite"]:
                fail("K3 disagrees with its plain version or index_add_")
            k3_ms = cuda_ms(lambda: sr.segment_reduce(bar_flat, red,
                                                      n_groups))
            report("segment_reduce_ms", k3_ms)
            k3_plain_ms = cuda_ms(lambda: sr.segment_reduce_plain(
                bar_flat, red, n_groups), n=3)
            report("segment_reduce_plain_ms", k3_plain_ms)
            k3_lib_ms = cuda_ms(lambda: lib_out.index_add_(0, gid, vals))
            report("segment_reduce_index_add_ms", k3_lib_ms)
            # the function needs only the live rows (256 B gathered, one add
            # per float), the table written, and the slot and gloc ints of
            # the blocks that hold live rows (a group's live rows are packed
            # from its first block) with the out_idx of every block
            nb = red.gloc.shape[0]
            n_live = k3_check["live_rows"]
            walked = int((red.gloc[:, 0] < sr.GROUP).sum())
            k3_b_ms, k3_b_by = reduce_bound_ms(n_live, k3.shape[0], walked,
                                               nb)
            print(json.dumps({"phase": "segment_reduce_bound",
                              "live_rows": n_live, "planned_rows":
                              int(red.slot.numel()), "walked_blocks": walked,
                              "blocks": nb}), flush=True)
            del vals, lib_out, k3_plain, bar_k2
        torch.cuda.synchronize()

        # ---- 7. whole-step gradient: kernels against plain versions -------
        def leaf_grads(m, loss_fn):
            m.zero_grad(set_to_none=True)
            loss_fn(m).backward()
            return {k: getattr(m, k).grad.clone()
                    for k in gt.models.gaussians.LEAVES}

        def compare_grads(label, fn):
            got, want = fn("cuda"), fn("torch")
            rel = {k: rel_l2(got[k], want[k]) for k in want}
            print(json.dumps({"phase": "step_gradient_vs_plain",
                              "scene": label, "rel_l2": rel}), flush=True)
            if max(rel.values()) > 1e-4 or not all(
                    float(w.abs().max()) > 0 for w in want.values()):
                fail(f"whole-step gradient on {label}: {rel}")

        r128 = TiledRenderer(128, 128, base, device=dev)
        r128.plan(small, [cam128])
        r128.bind(small, cam128)

        def small_grads(impl):
            r = TiledRenderer(128, 128, base, capacity=r128.capacity,
                              impl=impl, device=dev)
            r._bound = r128._bound
            return leaf_grads(small, lambda m: (
                (r.render_bound(m)["rgb"] - TRAIN_TARGET) ** 2).mean())

        compare_grads("3000_gaussians_128px", small_grads)
        st0, sc0, sc1 = tile_slice(scene_t, full_rays, base.chunk_size)
        slice_rays = full_rays[st0:st0 + 512].contiguous()

        def slice_grads(impl):
            def loss_fn(m):
                chunks = binning.gather_from_rows(frame_params(m, base)[1],
                                                  topo, base, impl)
                part_s = binning.binned_scene(
                    chunks[sc0:sc1], topo._replace(
                        tile_counts=topo.tile_counts[st0:st0 + 512]))
                acc_s = pf.forward_dispatch(part_s, slice_rays, base, impl)
                return ((acc_s[:, 0:3] - TRAIN_TARGET) ** 2).mean()
            return leaf_grads(train_model, loss_fn)

        compare_grads("full_width_512_tiles", slice_grads)

        # ---- 8. the CLI trains the PLY against the phase-4 renders --------
        tuned = os.path.join(tmp, "tuned.ply")
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "train", "--ply", ply, "--width",
             str(FULL_W), "--height", str(FULL_H), "--frames", "4",
             "--steps", "3", "--batch", "1", "--images-dir", out_dir,
             "--out", tuned], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            fail(f"CLI train failed:\n{proc.stdout}\n{proc.stderr}")
        psnrs = [float(line.split("psnr")[1]) for line in
                 proc.stdout.splitlines() if "psnr" in line]
        loaded = gt.GaussianModel.from_ply(tuned, device="cpu")
        print(json.dumps({"phase": "cli_train", "psnr": psnrs,
                          "gaussians": loaded.num_gaussians,
                          "seconds": time.time() - t0}), flush=True)
        if not psnrs or not all(np.isfinite(psnrs)) or \
                loaded.num_gaussians != FULL_N:
            fail(f"CLI train: psnr {psnrs}, {loaded.num_gaussians} "
                 f"gaussians\n{proc.stdout}")
        # banded: 2 span bands on the y-sorted scene
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "train", "--ply", ply, "--width",
             str(FULL_W), "--height", str(FULL_H), "--frames", "4",
             "--steps", "3", "--batch", "1", "--bands", "2", "--span-bands",
             "--sort-scene", "--images-dir", out_dir, "--out", tuned],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"CLI train --bands failed:\n{proc.stdout}\n{proc.stderr}")
        psnrs = [float(line.split("psnr")[1]) for line in
                 proc.stdout.splitlines() if "psnr" in line]
        loaded = gt.GaussianModel.from_ply(tuned, device="cpu")
        print(json.dumps({"phase": "cli_train_bands", "psnr": psnrs,
                          "gaussians": loaded.num_gaussians,
                          "seconds": time.time() - t0}), flush=True)
        if not psnrs or not all(np.isfinite(psnrs)) or \
                loaded.num_gaussians != FULL_N:
            fail(f"CLI train --bands: psnr {psnrs}, {loaded.num_gaussians} "
                 f"gaussians\n{proc.stdout}")

        # ---- 8b. pose refinement of the full-width frame -----------------
        from gvrt_tpu_torch.train import pose as tpose
        t0 = time.time()
        bad = gt.train.perturb_cameras([cam], POSE_SIGMA, seed=0)[0]
        reset_launches()
        _, reports = gt.train.optimize_camera_poses(
            model, [bad], [out["rgb"]], base, steps=POSE_STEPS, lr=POSE_LR,
            verbose=False)
        torch.cuda.synchronize()
        pose_launches = launches()
        pose_rep = reports[0]
        bound = tpose.bind_pose(model, bad, out["rgb"], base)

        def pose_grads(impl):
            """d loss / d (delta_t, delta_r) at the first step (delta 0)."""
            poison_allocator(torch, 4 * (bound.binned.chunks.numel()
                                         + 2 * full_rays.numel()), dev)
            t = torch.zeros(3, device=dev, requires_grad=True)
            r = torch.zeros(3, device=dev, requires_grad=True)
            return [x.detach() for x in torch.autograd.grad(
                tpose.pose_loss(bound, t, r, impl), (t, r))]

        g_k = pose_grads("cuda")
        pose_plain_ms, g_p = event_ms(lambda: pose_grads("torch"))
        pose_rel = {"t": rel_l2(g_k[0], g_p[0]), "r": rel_l2(g_k[1], g_p[1])}
        t_s = torch.zeros(3, device=dev, requires_grad=True)
        r_s = torch.zeros(3, device=dev, requires_grad=True)
        pose_opt = torch.optim.Adam([t_s, r_s], lr=POSE_LR, eps=1e-8)

        def pose_step():
            pose_opt.zero_grad(set_to_none=True)
            tpose.pose_loss(bound, t_s, r_s, "cuda").backward()
            pose_opt.step()

        pose_step_ms = cuda_ms(pose_step)
        print(json.dumps({
            "phase": "pose_refine", "steps": POSE_STEPS, "lr": POSE_LR,
            "sigma_t": POSE_SIGMA, **pose_rep, "launches": pose_launches,
            "launches_per_step": {
                k: pose_launches[k] / POSE_STEPS
                for k in ("tile_forward_residual", "tile_backward")},
            "grad_kernel": [x.tolist() for x in g_k],
            "grad_plain": [x.tolist() for x in g_p],
            "grad_rel_l2": pose_rel, "grad_plain_ms": pose_plain_ms,
            "empty_tiles": int((bound.binned.tile_counts == 0).sum()),
            "seconds": time.time() - t0}), flush=True)
        report("pose_step_ms", pose_step_ms)
        want = {"tile_forward": 1, "tile_forward_residual": POSE_STEPS,
                "tile_backward": POSE_STEPS, "segment_reduce": 0,
                "segment_reduce_compact": 0,
                "segment_reduce_compact_table": 0}
        if pose_launches != want:
            fail(f"pose refinement launches {pose_launches}, expected {want}")
        if not all(np.isfinite(pose_rep[k]) for k in pose_rep) or \
                not pose_rep["loss1"] < pose_rep["loss0"]:
            fail(f"pose refinement did not lower the loss: {pose_rep}")
        if not all(bool(x.isfinite().all()) and float(x.abs().max()) > 0
                   for x in g_k + g_p) or max(pose_rel.values()) > 1e-4:
            fail(f"pose gradient, kernels against plain versions: "
                 f"{pose_rel}, {g_k}, {g_p}")
        del bound, pose_opt, t_s, r_s

        # ---- 8c. the CLI trains with pose refinement and Adafactor -------
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "train", "--ply", ply, "--width",
             str(FULL_W), "--height", str(FULL_H), "--frames", "4",
             "--steps", "3", "--batch", "1", "--images-dir", out_dir,
             "--optimizer", "adafactor", "--optimize-poses", "10",
             "--perturb-poses", "0.02", "--out", tuned], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"CLI train --optimize-poses --optimizer adafactor failed:\n"
                 f"{proc.stdout}\n{proc.stderr}")
        psnrs = [float(line.split("psnr")[1]) for line in
                 proc.stdout.splitlines() if "psnr" in line]
        summary = [line for line in proc.stdout.splitlines()
                   if line.startswith("pose-opt:")]
        print(json.dumps({"phase": "cli_train_pose_adafactor",
                          "pose_opt": summary, "psnr": psnrs,
                          "seconds": time.time() - t0}), flush=True)
        if not summary or "cameras improved" not in summary[0] or \
                not psnrs or not all(np.isfinite(psnrs)):
            fail(f"CLI train with pose refinement and Adafactor: "
                 f"{summary}, psnr {psnrs}\n{proc.stdout}")

        # ---- 8d. the CLI's eval, unbanded and banded ----------------------
        t0 = time.time()
        evals = {}
        for label, extra in (("unbanded", []),
                             ("bands4", ["--bands", "4", "--gt-dir"])):
            eval_dir = os.path.join(tmp, f"eval_{label}")
            args = extra + [evals["unbanded"][0]] if extra else []
            proc = subprocess.run(
                [sys.executable, "-m", PKG, "eval", "--ply", ply, "--width",
                 str(FULL_W), "--height", str(FULL_H), "--frames", "4",
                 "--out", eval_dir, *args], cwd=ROOT, capture_output=True,
                text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"CLI eval ({label}) failed:\n{proc.stdout}\n"
                     f"{proc.stderr}")
            evals[label] = (eval_dir, proc.stdout)
        views = [line for line in evals["bands4"][1].splitlines()
                 if line.startswith("r_") and "PSNR=" in line]
        pngs = sorted(os.listdir(evals["unbanded"][0]))
        same = [bool(np.array_equal(
            gt.io.load_png(os.path.join(evals["unbanded"][0], f)),
            gt.io.load_png(os.path.join(evals["bands4"][0], f))))
            for f in pngs]
        print(json.dumps({"phase": "cli_eval", "views": views,
                          "identical": same,
                          "seconds": time.time() - t0}), flush=True)
        if pngs != [f"r_{i}.png" for i in range(4)] or len(views) != 4 or \
                not all("PSNR=inf" in v for v in views) or not all(same):
            fail(f"CLI eval --bands 4 against the unbanded views: {views}, "
                 f"identical {same}")

        # ---- 8e. multi-device on the one card -----------------------------
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", PKG, "train", "--ply", ply, "--width",
             str(FULL_W), "--height", str(FULL_H), "--frames", "4",
             "--steps", "3", "--batch", "1", "--images-dir", out_dir,
             "--devices", "1", "--out", tuned], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            fail(f"CLI train --devices 1 failed:\n{proc.stdout}\n"
                 f"{proc.stderr}")
        psnrs = [float(line.split("psnr")[1]) for line in
                 proc.stdout.splitlines() if "psnr" in line]
        ranks_line = [line for line in proc.stdout.splitlines()
                      if line.startswith("ranks:")]
        loaded = gt.GaussianModel.from_ply(tuned, device="cpu")
        print(json.dumps({"phase": "cli_train_devices1", "ranks": ranks_line,
                          "psnr": psnrs, "gaussians": loaded.num_gaussians,
                          "seconds": time.time() - t0}), flush=True)
        if ranks_line != ["ranks: 1 (nccl)"] or not psnrs or not all(
                np.isfinite(psnrs)) or loaded.num_gaussians != FULL_N:
            fail(f"CLI train --devices 1: {ranks_line}, psnr {psnrs}, "
                 f"{loaded.num_gaussians} gaussians\n{proc.stdout}")
        t0 = time.time()
        mesh_dir = os.path.join(tmp, "mesh")
        os.makedirs(mesh_dir)
        from gvrt_tpu_torch.app import _free_port
        ctx = torch.multiprocessing.spawn(
            mesh_rank, args=(ply, f"tcp://localhost:{_free_port()}",
                             mesh_dir), nprocs=2, join=False)
        deadline = time.monotonic() + MESH_TIMEOUT_S
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"the two ranks did not finish in {MESH_TIMEOUT_S} s")
        ranks = []
        for r in range(2):
            with open(os.path.join(mesh_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        print(json.dumps({"phase": "mesh_one_card", "ranks": ranks,
                          "card": name, "power_limit": power,
                          "seconds": time.time() - t0}), flush=True)
        check_mesh_ranks(ranks)
    del model, full, renderer, trainer_r, train_model, topo, scene_t
    del chunks_t, acc_t, t_in, bar, captured, bar_flat, out, acc
    torch.cuda.empty_cache()

    # ---- 9. K4 and the banded step on a small scene -----------------------
    t0 = time.time()
    small_sorted = small.sorted_for_camera(cam128, base)
    span128 = bd.BandedRenderer(128, 128, 2, base, span=True, device=dev)
    k4_errs, k4_table_errs = [], []
    for b, topo_b in enumerate(span128.bind(small_sorted, cam128)):
        g = torch.Generator(device=dev).manual_seed(20 + b)
        bar_b = torch.randn((topo_b.pair_gauss.shape[0], 64), generator=g,
                            device=dev)
        k4_errs.append(check_compact_reduce(
            torch, sr, bar_b, topo_b.red,
            f"3000_gaussians_128px_span_band{b}")[0]["max_abs_err"])
        k4_table_errs.append(check_table_reduce(
            torch, sr, bar_b, topo_b.red, small_sorted.num_gaussians + 1,
            f"3000_gaussians_128px_span_band{b}")[0]["max_abs_err"])

    def banded_grads(span, balance, remat):
        m = small_sorted if span else small
        held = bd.BandedRenderer(128, 128, 2, base, remat=remat, span=span,
                                 balance=balance, device=dev)
        held.bind(m, cam128)

        def grads(impl):
            r = bd.BandedRenderer(128, 128, 2, base, impl=impl, remat=remat,
                                  span=span, balance=balance, device=dev)
            r._bound = held._bound
            return leaf_grads(m, lambda mm: (
                (r.render_bound(mm)["rgb"] - TRAIN_TARGET) ** 2).mean())
        return grads

    for label, args in (("2_stride_full", (False, False, "full")),
                        ("2_span_gather", (True, False, "gather")),
                        ("2_balanced_none", (True, True, "none"))):
        compare_grads(f"3000_gaussians_128px_banded_{label}",
                      banded_grads(*args))
    print(json.dumps({"phase": "banded_small", "seconds": time.time() - t0}),
          flush=True)

    # ---- 10. the garden-scale banded training window ----------------------
    (k4_ms, k4_plain_ms, k4_lib_ms, k4_b_ms, k4_b_by, k4_err, k4_table,
     garden_launches, garden_times, *garden_errs) = garden_window(
        gt, torch, dev, bd, binning, pf, sr, frame_params,
        reset_launches, launches, event_ms, name, power)
    k4_err = max(k4_errs + [k4_err])
    k4_table["max_abs_err"] = max(k4_table_errs + [k4_table["max_abs_err"]])
    add_training_errs(garden_errs)

    # ---- 11. kernels -----------------------------------------------------
    def entry(kname, src, replaces, n_launch, err, ms, p_ms, bnd, lib,
              **extra):
        line = {"name": kname, "route": "cuda",
                "source": f"{PKG}/csrc/{src}", "replaces": replaces,
                "launches": n_launch, "max_abs_err": err, "ms": ms,
                "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": lib, **extra}
        if len(bnd) > 2:  # the gate chain's kernels: the earlier count too
            line["bound_ms_chain72"] = bnd[2]
        if kname in garden_times:  # also at garden band 0's shapes
            g_ms, g_b_ms, g_b_by, g_b72_ms = garden_times[kname]
            line["garden_band0"] = {"ms": g_ms, "bound_ms": g_b_ms,
                                    "bound_by": g_b_by,
                                    "bound_ms_chain72": g_b72_ms}
        return line

    def at_shapes(kname):
        """Phase 2c's numbers of one kernel: its max abs error at each
        shape, and its time and bound at each full-width shape."""
        return {"max_abs_err": {lb: e[kname] for lb, e in shapes.items()
                                if kname in e},
                "full_width": {lb: {"ms": e[kname + "_ms"],
                                    "bound_ms": e[kname + "_bound_ms"],
                                    "bound_by": e[kname + "_bound_by"]}
                               for lb, e in shapes.items()
                               if kname + "_ms" in e}}

    # the hot spots with no Pallas counterpart (the mesh trace's kernel and
    # plain PyTorch), per frame
    comb_grad = comb_res["combined_grad"]
    print(json.dumps({"phase": "hot_spots", "card": name,
                      "power_limit": power,
                      "hybrid_frame_ms": hybrid_res["frame_ms"],
                      "hybrid_closest_hit": hybrid_res["closest_hit"],
                      "hybrid_occluded": hybrid_res["occluded"],
                      "combined_frame": comb_res["combined_times"],
                      "combined_closest_hit": comb_res["combined_trace"],
                      "gaussian_shadow_transmittance": comb_res["shadow"]}),
          flush=True)
    vjp = "3dgvrt_lightfield_tpu/render/pallas_vjp.py"
    print(json.dumps({"kernels": [
        # the light field's run beside: its launches and K1 at its shapes
        entry("tile_forward", "tile_forward.cu", f"{vjp}:74",
              serve_launches["tile_forward"], max(errs + [full_err]), k_ms,
              plain_ms, k1_bound, None, lightfield=lightfield,
              r400_max_abs_err=r400["tile_forward"],
              combined=comb_res["combined_k1"],
              shapes=at_shapes("tile_forward")),
        entry("tile_forward_residual", "tile_forward.cu", f"{vjp}:74",
              train_launches["tile_forward_residual"],
              max(tin_errs + [res_err]), res_ms, res_plain_ms,
              res_bound, None,
              r400_max_abs_err=r400["tile_forward_residual"],
              combined={"launches": comb_grad["launches"][
                  "tile_forward_residual"],
                  "max_abs_err": comb_grad["t_in_max_abs_err"]},
              shapes=at_shapes("tile_forward_residual")),
        # the ray-cotangent instances beside: launches on the pose path
        entry("tile_backward", "tile_backward.cu", f"{vjp}:99",
              train_launches["tile_backward"], max(k2_errs + [k2_err]),
              k2_ms, k2_plain_ms, k2_bound, None,
              r400_max_abs_err=max(r400["tile_backward"],
                                   r400["tile_backward_ray_gradients"]),
              combined={"launches": comb_grad["launches"]["tile_backward"],
                        "max_abs_err": comb_grad[
                            "tile_backward_max_abs_err"]},
              shapes=at_shapes("tile_backward"),
              ray_gradients={
                  "shapes": at_shapes("tile_backward_ray_gradients"),
                  "pose_step_at_shape": shapes["pose_t32_g64"],
                  "launches": pose_launches["tile_backward"],
                  "max_abs_err": k2r["max_abs_err"],
                  "rows_rel_l2_max": max(ray_row_errs),
                  "ms": k2r["ms"],
                  "ms_without": k2r["ms_without"],
                  "plain_ms": k2r["plain_ms"],
                  "bound_ms": k2r["bound_ms"],
                  "bound_by": k2r["bound_by"], "library_ms": None}),
        entry("segment_reduce", "segment_reduce.cu",
              "3dgvrt_lightfield_tpu/render/segreduce.py:129",
              train_launches["segment_reduce"], k3_err, k3_ms, k3_plain_ms,
              (k3_b_ms, k3_b_by), k3_lib_ms,
              combined={"launches": comb_grad["launches"][
                  "segment_reduce"]}),
        # launches of both modes; the times and bound of compact mode (the
        # JAX kernel's function), table mode's (the step's route) beside
        entry("segment_reduce_compact", "segment_reduce_compact.cu",
              "3dgvrt_lightfield_tpu/render/segreduce.py:278",
              garden_launches["segment_reduce_compact"],
              max(k4_err, k4_table["max_abs_err"]), k4_ms, k4_plain_ms,
              (k4_b_ms, k4_b_by), k4_lib_ms, table_mode=k4_table),
        # no TPU kernel: the JAX package makes its rays in NumPy
        {"name": "camera_rays", "route": "cuda",
         "source": f"{PKG}/csrc/camera_rays.cu", "replaces": None,
         "launches": serve_ray_launches, "max_dir_ulp": max(
             c["max_dir_ulp"] for c in rays_res["checks"].values()),
         "ms": rays_res["ms"], "plain_ms": rays_res["plain_ms"]["total"],
         "bound_ms": rays_res["bound_ms"], "bound_by": "bytes",
         "library_ms": None, "clipped_ms": rays_res["clipped_ms"],
         "clipped_bound_ms": rays_res["clipped_bound_ms"]},
        # no TPU kernel: the JAX package's run fills are XLA's cummax; the
        # plain version is cummax itself, timed as the library call
        {"name": "max_scan", "route": "cuda",
         "source": f"{PKG}/csrc/max_scan.cu", "replaces": None,
         "launches": {"serving_frame": serve_scan_launches,
                      "unbanded_bind": bind_scan_launches},
         "n": scan_res["n"], "ms": scan_res["ms"],
         "bound_ms": scan_res["bound_ms"], "bound_by": "bytes",
         "library_ms": scan_res["library_ms"]},
        # no TPU kernel: the JAX package expands its pairs with XLA ops; the
        # plain version is the port's torch route, times at the garden frame
        {"name": "bin_expand", "route": "cuda",
         "source": f"{PKG}/csrc/bin_expand.cu", "replaces": None,
         "launches": {"serving_frame": serve_expand_launches,
                      "unbanded_bind": bind_expand_launches},
         **expand_res, "library_ms": None},
        # no TPU kernel: the JAX package builds its table with XLA ops and
        # its backward by autodiff; the plain versions are the port's
        # eager routes, times at 5M (300k beside)
        *({"name": f"param_table_{way}", "route": "cuda",
           "source": f"{PKG}/csrc/param_table.cu", "replaces": None,
           "launches": {"serving_frame": serve_table_launches[i],
                        "training_window": train_table_launches[i]},
           "n": table_res["5M"]["n"], **table_res["5M"][way],
           "bound_by": "bytes", "library_ms": None,
           "at_300k": table_res["300k"][way]}
          for i, way in enumerate(("forward", "backward"))),
        # no TPU kernel: the JAX package traces its meshes with plain jnp;
        # the plain versions are the port's chunk loop, at the combined
        # cell's mesh and rays
        {"name": "mesh_trace", "route": "cuda",
         "source": f"{PKG}/csrc/mesh_trace.cu", "replaces": None,
         "launches": comb_res["combined_trace"]["launches"],
         **{q: trace_res[q] for q in ("closest_hit", "occluded")},
         "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"phase": "done", "seconds_after_build":
                      time.time() - t_all}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
