#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU: build, check, serve, time.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. set-up: the card's name and power limit, TF32 off, the tile kernel
     built from csrc/ with nvcc;
  2. the tile kernel against its plain PyTorch version on the same binned
     inputs: small scenes at tile_size=8/chunk_size=128, at the defaults
     with log-space transmittance, with another kernel degree, a scene with
     empty tiles + dead trailing chunks + saturated tiles, and a 512-tile
     slice of the full-width frame;
  3. the full-width frame (1920x1088, 300k Gaussians, the scene of the
     JAX package's bench.py made from a torch.Generator) through
     TiledRenderer.plan + render, with the kernel's launch count read around
     that run; then CUDA-event timings of render, render_bound, the kernel
     alone and (once) the plain version;
  4. the serving entry point: the CLI renders 4 orbit frames of that scene
     at 1920x1088 from a PLY;
  5. one JSON line per kernel with its launches, error, time and bound;
  6. the last line: {"ok": true, "device": {...}}.

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


def bound_ms(binned, rays, acc, cfg):
    """Least time for this call's work: bytes read/written once over HBM
    bandwidth vs f32 operations over the f32 peak (the larger)."""
    from gvrt_tpu_torch.render.pallas_forward import tile_chunk_runs
    _, count = tile_chunk_runs(binned.tile_counts, binned.chunks.shape[0],
                               cfg.chunk_size)
    r = rays.shape[2]
    chunk_bytes = int(count.sum()) * cfg.chunk_size * 64 * 4
    nbytes = chunk_bytes + rays.numel() * 4 + acc.numel() * 4 + \
        2 * binned.tile_counts.numel() * 4
    pairs = int(binned.tile_counts.sum()) * r
    hits = float(acc[:, 5].sum())
    ops = pairs * OPS_PER_PAIR + hits * OPS_PER_HIT
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


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
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render.tiled import TiledRenderer

    # ---- 1. set-up -------------------------------------------------------
    card = card_line()
    print(card, flush=True)
    name, power = [s.strip() for s in card.split(",", 1)]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    _build.build()
    print(json.dumps({"phase": "build", "seconds": time.time() - t0}),
          flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    t_all = time.time()

    # ---- 2. kernel against plain version --------------------------------
    errs = []
    g = torch.Generator(device=dev).manual_seed(1)
    small = gt.random_gaussians(g, 3000, extent=0.8, device=dev)
    with torch.no_grad():
        small.means[:, 2] -= 3.0
    cam128 = gt.Camera.from_fovy(128, 128, 60.0, np.eye(4))
    base = gt.DEFAULT_CONFIG
    for label, cfg in (("t8_g128", base.replace(tile_size=8, chunk_size=128)),
                       ("default_logspace",
                        base.replace(transmittance_prod=False)),
                       ("kernel_degree_2", base.replace(kernel_degree=2))):
        binned, rays = binned_for(gt, small, cam128, cfg)
        with torch.no_grad():
            got = pf.forward_dispatch(binned, rays, cfg, "cuda")
            want = pf.forward_dispatch(binned, rays, cfg, "torch")
        errs.append(compare_acc(got, want, label))
        torch.cuda.synchronize()

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

    # 512-tile slice of the full-width frame
    model = bench_scene(gt, torch, dev)
    cam = gt.Camera.from_fovy(FULL_W, FULL_H, 50.0, np.eye(4))
    full, full_rays = binned_for(gt, model, cam, base)
    start, count = pf.tile_chunk_runs(full.tile_counts, full.chunks.shape[0],
                                      base.chunk_size)
    # the 512 consecutive tiles around the busiest one
    t0 = min(int(torch.argmax(full.tile_counts)) // 512 * 512,
             full_rays.shape[0] - 512)
    c0 = int(start[t0])
    c1 = int(start[t0 + 511]) + int(count[t0 + 511])
    part = full._replace(chunks=full.chunks[c0:c1].contiguous(),
                         tile_counts=full.tile_counts[t0:t0 + 512].contiguous())
    part_rays = full_rays[t0:t0 + 512].contiguous()
    with torch.no_grad():
        got = pf.forward_dispatch(part, part_rays, base, "cuda")
        want = pf.forward_dispatch(part, part_rays, base, "torch")
    errs.append(compare_acc(got, want, "full_width_512_tiles"))
    torch.cuda.synchronize()

    # ---- 3. full width, through the serving entry point ------------------
    renderer = TiledRenderer(FULL_W, FULL_H, base, device=dev)
    t0 = time.time()
    renderer.plan(model, [cam])
    plan_s = time.time() - t0
    pf.tile_forward.launches = 0
    out = renderer.render(model, cam)
    torch.cuda.synchronize()
    launches = pf.tile_forward.launches
    mean_hits = float(out["hit_count"].mean())
    print(json.dumps({"phase": "full_width", "width": FULL_W,
                      "height": FULL_H, "gaussians": FULL_N,
                      "capacity": list(renderer.capacity),
                      "plan_s": plan_s, "num_pairs": int(out["num_pairs"]),
                      "overflow": int(out["overflow"]),
                      "mean_hits_per_ray": mean_hits,
                      "tile_forward_launches": launches}), flush=True)
    if int(out["overflow"]) != 0:
        fail("full-width frame overflowed its plan")
    if not all(bool(v.isfinite().all()) for k, v in out.items()
               if k in ("rgb", "depth", "transmittance")):
        fail("full-width frame is not finite")
    if mean_hits < 15:
        fail(f"mean hits/ray {mean_hits:.2f} < 15")
    if launches < 1:
        fail("the serving path did not launch the tile kernel")

    rays_n = FULL_W * FULL_H

    def report(metric, ms):
        print(json.dumps({"metric": metric, "ms": ms,
                          "mrays_per_s": rays_n / (ms * 1e-3) / 1e6,
                          "card": name, "power_limit": power}), flush=True)

    report("render_ms", cuda_ms(lambda: renderer.render(model, cam)))
    renderer.bind(model, cam)
    report("render_bound_ms", cuda_ms(lambda: renderer.render_bound(model)))
    with torch.no_grad():
        k_ms = cuda_ms(lambda: pf.tile_forward(full.chunks, full_rays,
                                               full.tile_counts, base))
        report("tile_forward_ms", k_ms)
        acc = pf.tile_forward(full.chunks, full_rays, full.tile_counts, base)
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        plain = pf.forward_tiles_reference(full, full_rays, base)
        end_ev.record()
        end_ev.synchronize()
        plain_ms = start_ev.elapsed_time(end_ev)
        report("tile_forward_plain_ms", plain_ms)
        full_err = float((acc - plain)[:, 0:5].abs().max())
        b_ms, b_by = bound_ms(full, full_rays, acc, base)
    torch.cuda.synchronize()

    # ---- 4. the CLI on a PLY ---------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
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

    # ---- 5. kernels ------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "tile_forward",
        "route": "cuda",
        "source": f"{PKG}/csrc/tile_forward.cu",
        "replaces": "3dgvrt_lightfield_tpu/render/pallas_vjp.py:74",
        "launches": launches,
        "max_abs_err": max(errs + [full_err]),
        "ms": k_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"phase": "done", "seconds_after_build":
                      time.time() - t_all}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
