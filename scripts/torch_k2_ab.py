#!/usr/bin/env python3
"""A/B timing of versions of the fused tile backward (K2) on one card.

Each SRC is a version of `csrc/tile_backward.cu` (for example the parent
commit's, unpacked with `git archive` into a git-ignored directory, and the
working tree's; a sibling `tile_common.cuh` is included).  Every SRC is
compiled with nvcc as `_build.py` compiles it, plus `-Xptxas -v` (each
template instance's registers, spills and stack are printed), and loaded
with ctypes in this one process; K2's wrapper `pallas_vjp.tile_backward`
then launches each library in turn on the same inputs:

  * `300k`: the full-width training frame of `chip_smoke.py` (1920x1088,
    the 300k-Gaussian bench scene, default config), its T_in from K1's
    residual variant and the cotangent of an L2 loss against 0.3;
  * `garden`: band 0 of `chip_smoke.py`'s garden window (5M Gaussians,
    y-sorted, 2 span bands at 1920x1088), with the same kind of cotangent;
  * `pose`: the 300k frame's camera perturbed as `chip_smoke.py` perturbs
    it, bound by `train.pose.bind_pose` against the unperturbed frame's
    image, its rays at the base pose and the cotangent of `pose_loss`;
  * `300k:T:G`: the 300k frame binned at tile T and chunk size G (for
    example `300k:20:64`, the light field's R = 400, at 1920x1080: the
    frame is cut to whole tiles).

For each frame and each of --rounds rounds the SRCs are timed in the order
given, then in reverse (A B B A), each a CUDA-event median of --n launches;
one JSON line per timing, then per SRC the mean over its timings and its
outputs against the first SRC's (relative L2 per column group, max abs,
bit equality with the first SRC's and between two runs).

With --ray-gradients the ray-gradient instances (`RAYG`) are timed instead,
and per SRC the line also holds: whether bar_chunks is bit-equal to the
first SRC's and to the same SRC's without ray gradients; bar_rays' relative
L2 per row (o, d and the 16 basis rows) against the first SRC's and against
the plain version (`pallas_vjp._backward_plain`, run once per frame), with
the largest of the latter and its limit of 1e-4; its max abs against the
first SRC's; whether the two gate rows are exactly zero.

    python3 scripts/torch_k2_ab.py [--rounds 2] [--n 20] [--frames 300k,garden]
        [--ray-gradients] SRC.cu [SRC.cu ...]

(`--frames ""` only builds and prints the registers and spills.)
"""

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(srcs, out_dir):
    """nvcc every SRC into out_dir with `_build.py`'s flags and -Xptxas -v,
    all processes started together; returns [(library path, the kernel
    lines of ptxas' report)] in the order of srcs."""
    from gvrt_tpu_torch import _build
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for src in srcs:
        path = os.path.join(out_dir, f"libk2_{source_key(src)}.so")
        if os.path.exists(path + ".log"):  # built by an earlier run
            procs.append((src, path, None))
            continue
        procs.append((src, path, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", path,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = []
    for src, path, proc in procs:
        if proc is not None:
            log = proc.communicate(timeout=900)[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc {src}:\n{log}")
            with open(path + ".log", "w") as f:
                f.write(log)
        with open(path + ".log") as f:
            out.append((path, ptxas_report(f.read())))
    return out


def source_key(src):
    """Hash of a SRC and the shared header beside it."""
    h = hashlib.sha256()
    for name in (src, os.path.join(os.path.dirname(src), "tile_common.cuh")):
        with open(name, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]


def ptxas_report(log):
    """One line per template instance <DEG, PROD, RAYG[, SPLIT]>: registers
    and spills."""
    report, inst = [], None
    for line in log.splitlines():
        m = re.search(r"kernelIL(i?n?\d+)ELb(\d)ELb(\d)E(?:Lb(\d)E)?", line)
        if m:
            inst = "<{}>".format(", ".join(
                [m.group(1).replace("in", "-").lstrip("i")]
                + [x for x in m.group(2, 3, 4) if x is not None]))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and inst:
            report.append(f"{inst}: {line.split(':', 1)[1].strip()}; "
                          f"{spill}")
            inst = None
    return report


def load(path):
    from gvrt_tpu_torch import _build
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in _build.SIGNATURES["tile_backward"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def loss_cotangent(torch, pf, acc, tile_counts, target):
    """bar_acc of mean((rgb - target)^2) over the tiles' rays."""
    bar = torch.zeros_like(acc)
    fixed = pf._background_fix(acc, tile_counts)
    n = acc.shape[0] * 3 * acc.shape[2]
    bar[:, 0:3] = torch.where((tile_counts > 0)[:, None, None],
                              2.0 * (fixed[:, 0:3] - target) / n, 0.0)
    return bar


def frame_300k(gt, torch, dev, tile=None, chunk=None):
    import numpy as np
    import chip_smoke
    cfg = gt.DEFAULT_CONFIG
    if tile is not None:
        cfg = cfg.replace(tile_size=tile, chunk_size=chunk)
    model = chip_smoke.bench_scene(gt, torch, dev)
    # whole tiles: 1920x1080 at tile 20
    ts = cfg.tile_size
    cam = gt.Camera.from_fovy(chip_smoke.FULL_W // ts * ts,
                              chip_smoke.FULL_H // ts * ts, 50.0, np.eye(4))
    scene, rays = chip_smoke.binned_for(gt, model, cam, cfg)
    return scene.chunks, rays, scene.tile_counts, cfg, 0.3


def frame_garden(gt, torch, dev):
    import chip_smoke
    from gvrt_tpu_torch.render import banded as bd
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render.rows_vjp import frame_params
    cfg = gt.DEFAULT_CONFIG
    model, cam = chip_smoke.garden_scene(gt, torch, dev)
    model = model.sorted_for_camera(cam, cfg)
    r = bd.BandedRenderer(chip_smoke.FULL_W, chip_smoke.FULL_H,
                          chip_smoke.GARDEN_BANDS, cfg, span=True, device=dev)
    r.plan(model, cam)
    topo = r.bind(model, cam)[0]
    rays = r._bound[1][0]
    with torch.no_grad():
        chunks = binning.gather_from_rows(frame_params(model, cfg)[1], topo,
                                          cfg)
    return chunks, rays, topo.tile_counts, cfg, 0.3


def frame_pose(gt, torch, dev):
    import numpy as np
    import chip_smoke
    from gvrt_tpu_torch.train import pose
    cfg = gt.DEFAULT_CONFIG
    model = chip_smoke.bench_scene(gt, torch, dev)
    cam = gt.Camera.from_fovy(chip_smoke.FULL_W, chip_smoke.FULL_H, 50.0,
                              np.eye(4))
    with torch.no_grad():
        target = gt.render.render_image_tiled(model, cam, cfg,
                                              device=dev)["rgb"]
        bad = gt.train.perturb_cameras([cam], chip_smoke.POSE_SIGMA,
                                       seed=0)[0]
        bound = pose.bind_pose(model, bad, target, cfg)
        zero = torch.zeros(3, device=dev)
        rays = pose._posed_rays(bound.ndc, bound.camera, bound.cfg, zero,
                                zero).contiguous()
    return (bound.binned.chunks, rays, bound.binned.tile_counts, cfg,
            bound.target)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--frames", default="300k,garden")
    ap.add_argument("--ray-gradients", action="store_true",
                    help="time the instances with ray cotangents")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_k2_ab: needs a CUDA card")
    import chip_smoke
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch import _build
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv

    card = chip_smoke.card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    out_dir = os.path.join(ROOT, "build", "k2ab")
    libs = []
    built = build([os.path.abspath(src) for src in args.srcs], out_dir)
    for src, (path, report) in zip(args.srcs, built):
        libs.append(load(path))
        print(json.dumps({"src": src, "ptxas": report}), flush=True)

    def run(i, *inputs):
        _build._libs["tile_backward"] = libs[i]
        return pv.tile_backward(*inputs)

    makers = {"300k": frame_300k, "garden": frame_garden, "pose": frame_pose}
    for frame in filter(None, args.frames.split(",")):
        name, *shape = frame.split(":")
        chunks, rays, counts, cfg, target = makers[name](
            gt, torch, dev, *map(int, shape))
        with torch.no_grad():
            acc, t_in = pf.tile_forward_residual(chunks, rays, counts, cfg)
            bar = loss_cotangent(torch, pf, acc, counts, target)
        base = (chunks, rays, counts, t_in, bar)
        inputs = base + (cfg.replace(ray_gradients=args.ray_gradients),)
        times = {i: [] for i in range(len(libs))}
        for rnd in range(args.rounds):
            order = list(range(len(libs)))
            for i in order + order[::-1]:
                ms = chip_smoke.cuda_ms(lambda: run(i, *inputs), n=args.n)
                times[i].append(ms)
                print(json.dumps({"frame": frame, "round": rnd,
                                  "src": args.srcs[i], "ms": ms}), flush=True)
        ref = run(0, *inputs)
        plain = (pv._backward_plain(*inputs)[1] if args.ray_gradients
                 else None)
        for i, src in enumerate(args.srcs):
            got = run(i, *inputs)
            again = run(i, *inputs)
            torch.cuda.synchronize()
            line = {
                "frame": frame, "src": src, "ray_gradients":
                    args.ray_gradients,
                "mean_ms": sum(times[i]) / len(times[i]), "ms": times[i],
                "rel_l2_vs_first": {
                    k: chip_smoke.rel_l2(got[0][..., c], ref[0][..., c])
                    for k, c in chip_smoke.COL_GROUPS.items()},
                "max_abs_vs_first": float((got[0] - ref[0]).abs().max()),
                "bit_identical_to_first": torch.equal(got[0], ref[0]),
                "bit_identical_runs": torch.equal(got[0], again[0])}
            if args.ray_gradients:
                without = run(i, *base, cfg)[0]
                rows = chip_smoke.ray_row_rel_l2(got[1], plain)
                line.update({
                    "chunks_bit_identical_to_without": torch.equal(got[0],
                                                                   without),
                    "rays_bit_identical_to_first": torch.equal(got[1],
                                                               ref[1]),
                    "rays_bit_identical_runs": torch.equal(got[1], again[1]),
                    "rays_rel_l2_vs_first": chip_smoke.ray_row_rel_l2(
                        got[1], ref[1]),
                    "rays_max_abs_vs_first": float(
                        (got[1] - ref[1]).abs().max()),
                    "rays_rel_l2_vs_plain": rows,
                    "rays_rel_l2_vs_plain_max": max(rows.values()),
                    "rays_rel_l2_limit": chip_smoke.RAY_ROW_LIMIT,
                    "gate_rows_zero": not bool(got[1][:, 6:8].any())})
                del without
            line.update({"chunks": int(chunks.shape[0]),
                         "tiles": int(rays.shape[0]), "card": card})
            print(json.dumps(line), flush=True)
        del chunks, rays, counts, acc, t_in, bar, base, inputs, ref, got
        del again, plain
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
