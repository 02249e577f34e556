#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, serve,
train, time.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. set-up: the card's name and power limit, TF32 off, the three kernel
     libraries (tile_forward, tile_backward, segment_reduce) built from
     csrc/ with nvcc, all at once;
  2. the tile kernels against their plain PyTorch versions on the same
     binned inputs: small scenes at tile_size=8/chunk_size=128, at the
     defaults with log-space transmittance, with another kernel degree, a
     scene with empty tiles + dead trailing chunks + saturated tiles, and a
     512-tile slice of the full-width frame.  On each: K1 (forward), K1's
     residual variant (T_in) and K2 (the backward, with ray gradients on
     two scenes), the latter two after a NaN-poisoned allocator;
  3. the full-width frame (1920x1088, 300k Gaussians, the scene of the
     JAX package's bench.py made from a torch.Generator) through
     TiledRenderer.plan + render under torch.no_grad() (serving: K1 without
     the residual), with the launch counts read around that run; then
     CUDA-event timings of render, render_bound, K1 alone and (once) its
     plain version;
  4. the serving entry point: the CLI renders 4 orbit frames of that scene
     at 1920x1088 from a PLY;
  5. the full-width training window (bench.py's protocol): plan with the
     reduce capacity, one topology refresh with the reduce plan, then 10
     steps of rows64_from_model -> gather_from_rows -> forward_dispatch ->
     L2 loss against 0.3 in tiled space -> backward (K2, K3) -> SGD with
     lr 1e-12, launch counts read around it; then its CUDA-event time and
     the kernels' times at the frame's shapes;
  6. K3 against its plain version and index_add_ on the window's real
     per-slot cotangents;
  7. the whole-step gradient, kernels against plain versions, on a
     3000-Gaussian 128^2 scene and on a 512-tile slice of the full frame;
  8. the training entry point: the CLI trains the PLY for 3 steps at
     1920x1088 against the phase-4 renders and writes a PLY;
  9. one JSON line per kernel with its launches, error, time and bound;
 10. the last line: {"ok": true, "device": {...}}.

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
#: f32 operations of the tile kernel per evaluated (gaussian, ray) pair:
#: frame 33, |grdu|^2 + reciprocal 7, cross + gray distance 15, response
#: (2 mul + exp) 3, alpha 2, depth 7, gates 5 (FMA = 2)
OPS_PER_PAIR = 72
#: and per composited (accepted, active) pair: SH radiance 3 x 16 FMAs + 3
#: offsets/clamps x 2, weight, T update, rgb/depth/hit accumulation
OPS_PER_HIT = 96 + 6 + 2 + 2 + 10
#: K2 per composited pair, counted from csrc/tile_backward.cu: SH radiance
#: 99, bar_w 10, bar_pre 6, the transmittance chain (bar_t, bar_ae, bar_tb,
#: bar_tin, suffix term, division) 14, response/density 9, gray distance,
#: depth and cross products 17, the local-frame cotangents 42, the 13
#: geometry columns 30, 48 SH column products and the 61 column sums over
#: rays (FMA = 2).  Per real pair K2 recomputes the gate chain: OPS_PER_PAIR.
OPS_PER_HIT_BWD = 99 + 10 + 6 + 14 + 9 + 17 + 42 + 30 + 48 + 61
#: the training window of bench.py: K steps per topology refresh, SGD lr
TRAIN_K, TRAIN_LR, TRAIN_TARGET = 10, 1e-12, 0.3

FULL_W, FULL_H, FULL_N = 1920, 1088, 300_000


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


def bound_ms(binned, rays, acc, cfg, extra_bytes=0):
    """Least time for this call's work: bytes read/written once over HBM
    bandwidth vs f32 operations over the f32 peak (the larger)."""
    from gvrt_tpu_torch.render.pallas_forward import tile_chunk_runs
    _, count = tile_chunk_runs(binned.tile_counts, binned.chunks.shape[0],
                               cfg.chunk_size)
    r = rays.shape[2]
    chunk_bytes = int(count.sum()) * cfg.chunk_size * 64 * 4
    nbytes = chunk_bytes + rays.numel() * 4 + acc.numel() * 4 + \
        2 * binned.tile_counts.numel() * 4 + extra_bytes
    pairs = int(binned.tile_counts.sum()) * r
    hits = float(acc[:, 5].sum())
    ops = pairs * OPS_PER_PAIR + hits * OPS_PER_HIT
    return roofline(nbytes, ops)


def roofline(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def bound_bwd_ms(binned, rays, acc, cfg):
    """K2's least time: the gate chain per real pair and OPS_PER_HIT_BWD per
    composited pair (hit counts of the forward) against the chunk rows of
    the visited runs, rays, T_in and bar_acc read and bar_chunks written."""
    from gvrt_tpu_torch.render.pallas_forward import tile_chunk_runs
    _, count = tile_chunk_runs(binned.tile_counts, binned.chunks.shape[0],
                               cfg.chunk_size)
    r = rays.shape[2]
    nbytes = (int(count.sum()) * cfg.chunk_size * 64 * 4 + rays.numel() * 4
              + binned.chunks.shape[0] * r * 4 + acc.numel() * 4
              + binned.chunks.numel() * 4 + 2 * binned.tile_counts.numel() * 4)
    ops = (int(binned.tile_counts.sum()) * r * OPS_PER_PAIR
           + float(acc[:, 5].sum()) * OPS_PER_HIT_BWD)
    return roofline(nbytes, ops)


def rel_l2(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


#: bar_chunk column groups of the backward
COL_GROUPS = {"M": slice(0, 9), "b": slice(9, 12), "density": slice(12, 13),
              "sh": slice(16, 64)}


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
                      "skipped_chunks": int(skipped.sum()),
                      "skipped_blocks_zero": zero_ok, "finite": finite,
                      "bit_identical_runs": same_bits}), flush=True)
    if tin_frac < 0.9999 or not tin_finite:
        fail(f"K1's residual disagrees with its plain version on {label}")
    if max(e["rel_l2"] for e in errs.values()) > 1e-4:
        fail(f"K2 disagrees with its plain version on {label}")
    if not (zero_ok and finite and same_bits):
        fail(f"K2 on {label}: zero blocks {zero_ok}, finite {finite}, "
             f"bit-identical {same_bits}")
    return float(d_tin.max()), k2_abs


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
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv
    from gvrt_tpu_torch.render import segreduce as sr
    from gvrt_tpu_torch.render.rows_vjp import rows64_from_model
    from gvrt_tpu_torch.render.tiled import TiledRenderer, _camera_mats

    def reset_launches():
        for fn in (pf.tile_forward, pf.tile_forward_residual,
                   pv.tile_backward, sr.segment_reduce):
            fn.launches = 0

    def launches():
        return {"tile_forward": pf.tile_forward.launches,
                "tile_forward_residual": pf.tile_forward_residual.launches,
                "tile_backward": pv.tile_backward.launches,
                "segment_reduce": sr.segment_reduce.launches}

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

    def tile_slice(scene, rays_t):
        """The 512 consecutive tiles around the busiest one, with their
        chunk range."""
        start, count = pf.tile_chunk_runs(scene.tile_counts,
                                          scene.chunks.shape[0],
                                          base.chunk_size)
        t0 = min(int(torch.argmax(scene.tile_counts)) // 512 * 512,
                 rays_t.shape[0] - 512)
        c0 = int(start[t0])
        c1 = int(start[t0 + 511]) + int(count[t0 + 511])
        return t0, c0, c1

    t0, c0, c1 = tile_slice(full, full_rays)
    part = full._replace(chunks=full.chunks[c0:c1].contiguous(),
                         tile_counts=full.tile_counts[t0:t0 + 512].contiguous())
    part_rays = full_rays[t0:t0 + 512].contiguous()
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
    if serve_launches["tile_forward_residual"] or \
            serve_launches["tile_backward"]:
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
        b_ms, b_by = bound_ms(full, full_rays, acc, base)
        del plain
    torch.cuda.synchronize()

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
            res_b_ms, res_b_by = bound_ms(scene_t, full_rays, acc_t, base,
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
            k2_err = float((bar_k2 - bar_p).abs().max())
            print(json.dumps({"phase": "tile_backward_full_width",
                              "rel_l2": k2_full, "max_abs_err": k2_err}),
                  flush=True)
            if max(k2_full.values()) > 1e-4:
                fail("K2 disagrees with its plain version at full width")
            k2_b_ms, k2_b_by = bound_bwd_ms(scene_t, full_rays, acc_t, base)
            del bar_p

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
            k3_b_ms, k3_b_by = roofline(
                n_live * 64 * 4 + k3.numel() * 4 + walked * sr.GROUP * 8
                + nb * 4, n_live * 64)
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
        st0, sc0, sc1 = tile_slice(scene_t, full_rays)
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

    # ---- 9. kernels ------------------------------------------------------
    def entry(kname, src, replaces, n_launch, err, ms, p_ms, bnd, lib):
        return {"name": kname, "route": "cuda",
                "source": f"{PKG}/csrc/{src}", "replaces": replaces,
                "launches": n_launch, "max_abs_err": err, "ms": ms,
                "plain_ms": p_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": lib}

    vjp = "3dgvrt_lightfield_tpu/render/pallas_vjp.py"
    print(json.dumps({"kernels": [
        entry("tile_forward", "tile_forward.cu", f"{vjp}:74",
              serve_launches["tile_forward"], max(errs + [full_err]), k_ms,
              plain_ms, (b_ms, b_by), None),
        entry("tile_forward_residual", "tile_forward.cu", f"{vjp}:74",
              train_launches["tile_forward_residual"],
              max(tin_errs + [res_err]), res_ms, res_plain_ms,
              (res_b_ms, res_b_by), None),
        entry("tile_backward", "tile_backward.cu", f"{vjp}:99",
              train_launches["tile_backward"], max(k2_errs + [k2_err]),
              k2_ms, k2_plain_ms, (k2_b_ms, k2_b_by), None),
        entry("segment_reduce", "segment_reduce.cu",
              "3dgvrt_lightfield_tpu/render/segreduce.py:129",
              train_launches["segment_reduce"], k3_err, k3_ms, k3_plain_ms,
              (k3_b_ms, k3_b_by), k3_lib_ms),
    ]}), flush=True)
    print(json.dumps({"phase": "done", "seconds_after_build":
                      time.time() - t_all}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
