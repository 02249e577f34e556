#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, serve,
train, time.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. set-up: the card's name and power limit, TF32 off, the four kernel
     libraries (tile_forward, tile_backward, segment_reduce,
     segment_reduce_compact) built from csrc/ with nvcc, all at once;
  2. the tile kernels against their plain PyTorch versions on the same
     binned inputs: small scenes at tile_size=8/chunk_size=128, at the
     defaults with log-space transmittance, with another kernel degree, a
     scene with empty tiles + dead trailing chunks + saturated tiles, and a
     512-tile slice of the full-width frame.  On each: K1 (forward), K1's
     residual variant (T_in) and K2 (the backward, with ray gradients on
     two scenes; per column group and per column), the latter two after a
     NaN-poisoned allocator;
  3. the full-width frame (1920x1088, 300k Gaussians, the scene of the
     JAX package's bench.py made from a torch.Generator) through
     TiledRenderer.plan + render under torch.no_grad() (serving: K1 without
     the residual), with the launch counts read around that run; then
     CUDA-event timings of render, render_bound, K1 alone and (once) its
     plain version; then banded serving of the same frame against it
     (render_image_banded with 4 stride bands, 4 span bands on the y-sorted
     model, a 2-band balanced BandedRenderer.render_bound), no K2 or K4;
  4. the serving entry point: the CLI renders 4 orbit frames of that scene
     at 1920x1088 from a PLY, unbanded and with --bands 4, and benchmarks
     it with --bands 4;
  5. the full-width training window (bench.py's protocol): plan with the
     reduce capacity, one topology refresh with the reduce plan, then 10
     steps of rows64_from_model -> gather_from_rows -> forward_dispatch ->
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
 11. one JSON line per kernel with its launches, error, time and bound
     (K1 and K2 also at garden band 0's shapes; their bounds count the
     gate chain as this run's data needs it, chain_counts, with the
     earlier whole-chain count beside them as bound_ms_chain72; K4's
     launches are both modes', its table mode's numbers in `table_mode`);
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
#: FMAs, and the 16 basis rows, 16 x 3 FMAs (FMA = 2)
OPS_PER_HIT_RAYG = 2 * (2 * 3 * 3 + 16 * 3)
#: pose refinement of the full-width frame: Adam steps, lr, translation
#: sigma of the perturbation
POSE_STEPS, POSE_LR, POSE_SIGMA = 20, 3e-3, 0.02
#: visited chunks per batch of chain_counts
COUNT_BATCH = 512
#: the training window of bench.py: K steps per topology refresh, SGD lr
TRAIN_K, TRAIN_LR, TRAIN_TARGET = 10, 1e-12, 0.3

FULL_W, FULL_H, FULL_N = 1920, 1088, 300_000
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
    for b in torch.arange(len(tile), device=dev).split(COUNT_BATCH):
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
    binned scene, each after a NaN-poisoned allocator.  Returns the
    largest absolute errors of T_in and of K2's outputs."""
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
    return float(d_tin.max()), k2_abs


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


def garden_window(gt, torch, dev, bd, binning, pf, sr, rows64_from_model,
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
        rows = rows64_from_model(model, base)
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
    tin_err, k2_err = check_training_kernels(
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
    from gvrt_tpu_torch.render.rows_vjp import rows64_from_model
    from gvrt_tpu_torch.render.tiled import TiledRenderer, _camera_mats

    def reset_launches():
        for fn in (pf.tile_forward, pf.tile_forward_residual,
                   pv.tile_backward, sr.segment_reduce,
                   sr.segment_reduce_compact,
                   sr.segment_reduce_compact_table):
            fn.launches = 0

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

    def event_ms(fn):
        """One CUDA-event timing of fn (for the slow plain versions)."""
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        out = fn()
        end_ev.record()
        end_ev.synchronize()
        return start_ev.elapsed_time(end_ev), out

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

    # ---- 2. kernels against plain versions ------------------------------
    def add_training_errs(errs_pair):
        tin_errs.append(errs_pair[0])
        k2_errs.append(errs_pair[1])

    errs, tin_errs, k2_errs = [], [], []
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

    # ---- 3. full width, through the serving entry point ------------------
    renderer = TiledRenderer(FULL_W, FULL_H, base, device=dev)
    t0 = time.time()
    renderer.plan(model, [cam])
    plan_s = time.time() - t0
    reset_launches()
    with torch.no_grad():  # serving: K1 without the training residual
        out = renderer.render(model, cam)
    torch.cuda.synchronize()
    serve_launches = launches()
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
                rows = rows64_from_model(m, base)
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
        topo, (loss0, hits0, gnorm0) = train_window(train_model, capture=True)
        torch.cuda.synchronize()
        train_launches = launches()
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
                rows64_from_model(train_model, base), topo, base, "cuda")
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
            bar_k2r, bar_rays_k = pv.tile_backward(
                chunks_t, full_rays, topo.tile_counts, t_in, bar, rg)
            k2r_plain_ms, (bar_pr, bar_rays_p) = event_ms(
                lambda: pv._backward_plain(chunks_t, full_rays,
                                           topo.tile_counts, t_in, bar, rg))
            k2r = {"rel_l2_rays": rel_l2(bar_rays_k, bar_rays_p),
                   "rel_l2_chunks": rel_l2(bar_k2r, bar_pr),
                   "max_abs_err": max(
                       float((bar_rays_k - bar_rays_p).abs().max()),
                       float((bar_k2r - bar_pr).abs().max())),
                   "chunks_bit_identical_to_without": torch.equal(bar_k2r,
                                                                  bar_k2),
                   "finite": bool(bar_rays_k.isfinite().all()),
                   "plain_ms": k2r_plain_ms}
            del bar_k2r, bar_rays_k, bar_pr, bar_rays_p
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
                chunks = binning.gather_from_rows(rows64_from_model(m, base),
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
        gt, torch, dev, bd, binning, pf, sr, rows64_from_model,
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

    vjp = "3dgvrt_lightfield_tpu/render/pallas_vjp.py"
    print(json.dumps({"kernels": [
        entry("tile_forward", "tile_forward.cu", f"{vjp}:74",
              serve_launches["tile_forward"], max(errs + [full_err]), k_ms,
              plain_ms, k1_bound, None),
        entry("tile_forward_residual", "tile_forward.cu", f"{vjp}:74",
              train_launches["tile_forward_residual"],
              max(tin_errs + [res_err]), res_ms, res_plain_ms,
              res_bound, None),
        # the ray-cotangent instances beside: launches on the pose path
        entry("tile_backward", "tile_backward.cu", f"{vjp}:99",
              train_launches["tile_backward"], max(k2_errs + [k2_err]),
              k2_ms, k2_plain_ms, k2_bound, None, ray_gradients={
                  "launches": pose_launches["tile_backward"],
                  "max_abs_err": k2r["max_abs_err"], "ms": k2r["ms"],
                  "ms_without": k2r["ms_without"],
                  "plain_ms": k2r["plain_ms"],
                  "bound_ms": k2r["bound_ms"],
                  "bound_by": k2r["bound_by"], "library_ms": None}),
        entry("segment_reduce", "segment_reduce.cu",
              "3dgvrt_lightfield_tpu/render/segreduce.py:129",
              train_launches["segment_reduce"], k3_err, k3_ms, k3_plain_ms,
              (k3_b_ms, k3_b_by), k3_lib_ms),
        # launches of both modes; the times and bound of compact mode (the
        # JAX kernel's function), table mode's (the step's route) beside
        entry("segment_reduce_compact", "segment_reduce_compact.cu",
              "3dgvrt_lightfield_tpu/render/segreduce.py:278",
              garden_launches["segment_reduce_compact"],
              max(k4_err, k4_table["max_abs_err"]), k4_ms, k4_plain_ms,
              (k4_b_ms, k4_b_by), k4_lib_ms, table_mode=k4_table),
    ]}), flush=True)
    print(json.dumps({"phase": "done", "seconds_after_build":
                      time.time() - t_all}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
