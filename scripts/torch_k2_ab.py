#!/usr/bin/env python3
"""A/B timing of versions of the fused tile backward (K2) on one card.

Each SRC is a version of `csrc/tile_backward.cu` (for example the parent
commit's, unpacked with `git archive` into a git-ignored directory, and the
working tree's).  Every SRC is compiled with nvcc as `_build.py` compiles it,
plus `-Xptxas -v` (its registers, spills and stack are printed), and loaded
with ctypes in this one process; K2's wrapper `pallas_vjp.tile_backward`
then launches each library in turn on the same inputs:

  * `300k`: the full-width training frame of `chip_smoke.py` (1920x1088,
    the 300k-Gaussian bench scene, default config), its T_in from K1's
    residual variant and the cotangent of an L2 loss against 0.3;
  * `garden`: band 0 of `chip_smoke.py`'s garden window (5M Gaussians,
    y-sorted, 2 span bands at 1920x1088), with the same kind of cotangent.

For each frame and each of --rounds rounds the SRCs are timed in the order
given, then in reverse (A B B A), each a CUDA-event median of --n launches;
one JSON line per timing, then per SRC the mean over its timings and its
outputs against the first SRC's (relative L2 per column group, max abs,
bit equality with the first SRC's and between two runs).

    python3 scripts/torch_k2_ab.py [--rounds 2] [--n 20] [--frames 300k,garden]
        SRC.cu [SRC.cu ...]

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


def build(src, out_dir):
    """nvcc SRC into out_dir with `_build.py`'s flags and -Xptxas -v;
    returns (library path, the kernel lines of ptxas' report)."""
    from gvrt_tpu_torch import _build
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:12]
    path = os.path.join(out_dir, f"libk2_{key}.so")
    os.makedirs(out_dir, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", path, src], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src}:\n{proc.stdout}\n{proc.stderr}")
    # one line per template instance <DEG, PROD, RAYG>: registers and spills
    report, inst = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"kernelIL(i?n?\d+)ELb(\d)ELb(\d)E", line)
        if m:
            inst = "<{}, {}, {}>".format(m.group(1).replace("in", "-")
                                         .lstrip("i"), *m.group(2, 3))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and inst:
            report.append(f"{inst}: {line.split(':', 1)[1].strip()}; "
                          f"{spill}")
            inst = None
    return path, report


def load(path):
    from gvrt_tpu_torch import _build
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in _build.SIGNATURES["tile_backward"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def loss_cotangent(torch, pf, acc, tile_counts):
    """bar_acc of mean((rgb - 0.3)^2) over the tiles' rays."""
    bar = torch.zeros_like(acc)
    fixed = pf._background_fix(acc, tile_counts)
    n = acc.shape[0] * 3 * acc.shape[2]
    bar[:, 0:3] = torch.where((tile_counts > 0)[:, None, None],
                              2.0 * (fixed[:, 0:3] - 0.3) / n, 0.0)
    return bar


def frame_300k(gt, torch, dev):
    import numpy as np
    import chip_smoke
    cfg = gt.DEFAULT_CONFIG
    model = chip_smoke.bench_scene(gt, torch, dev)
    cam = gt.Camera.from_fovy(chip_smoke.FULL_W, chip_smoke.FULL_H, 50.0,
                              np.eye(4))
    scene, rays = chip_smoke.binned_for(gt, model, cam, cfg)
    return scene.chunks, rays, scene.tile_counts, cfg


def frame_garden(gt, torch, dev):
    import chip_smoke
    from gvrt_tpu_torch.render import banded as bd
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render.rows_vjp import rows64_from_model
    cfg = gt.DEFAULT_CONFIG
    model, cam = chip_smoke.garden_scene(gt, torch, dev)
    model = model.sorted_for_camera(cam, cfg)
    r = bd.BandedRenderer(chip_smoke.FULL_W, chip_smoke.FULL_H,
                          chip_smoke.GARDEN_BANDS, cfg, span=True, device=dev)
    r.plan(model, cam)
    topo = r.bind(model, cam)[0]
    rays = r._bound[1][0]
    with torch.no_grad():
        chunks = binning.gather_from_rows(rows64_from_model(model, cfg), topo,
                                          cfg)
    return chunks, rays, topo.tile_counts, cfg


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("srcs", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--frames", default="300k,garden")
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
    for src in args.srcs:
        path, report = build(os.path.abspath(src), out_dir)
        libs.append(load(path))
        print(json.dumps({"src": src, "ptxas": report}), flush=True)

    def run(i, *inputs):
        _build._libs["tile_backward"] = libs[i]
        return pv.tile_backward(*inputs)

    makers = {"300k": frame_300k, "garden": frame_garden}
    for frame in filter(None, args.frames.split(",")):
        chunks, rays, counts, cfg = makers[frame](gt, torch, dev)
        with torch.no_grad():
            acc, t_in = pf.tile_forward_residual(chunks, rays, counts, cfg)
            bar = loss_cotangent(torch, pf, acc, counts)
        inputs = (chunks, rays, counts, t_in, bar, cfg)
        times = {i: [] for i in range(len(libs))}
        for rnd in range(args.rounds):
            order = list(range(len(libs)))
            for i in order + order[::-1]:
                ms = chip_smoke.cuda_ms(lambda: run(i, *inputs), n=args.n)
                times[i].append(ms)
                print(json.dumps({"frame": frame, "round": rnd,
                                  "src": args.srcs[i], "ms": ms}), flush=True)
        ref = run(0, *inputs)[0]
        for i, src in enumerate(args.srcs):
            got = run(i, *inputs)[0]
            again = run(i, *inputs)[0]
            torch.cuda.synchronize()
            print(json.dumps({
                "frame": frame, "src": src,
                "mean_ms": sum(times[i]) / len(times[i]), "ms": times[i],
                "rel_l2_vs_first": {
                    k: chip_smoke.rel_l2(got[..., c], ref[..., c])
                    for k, c in chip_smoke.COL_GROUPS.items()},
                "max_abs_vs_first": float((got - ref).abs().max()),
                "bit_identical_to_first": torch.equal(got, ref),
                "bit_identical_runs": torch.equal(got, again),
                "chunks": int(chunks.shape[0]), "tiles": int(rays.shape[0]),
                "card": card}), flush=True)
        del chunks, rays, counts, acc, t_in, bar, inputs, ref, got, again
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
