#!/usr/bin/env python3
"""A/B timing of versions of the gradient reduces K3 and K4 on one card.

Each `--k3` SRC is a version of `csrc/segment_reduce.cu`, each `--k4` SRC a
version of `csrc/segment_reduce_compact.cu` (for example the parent
commit's, unpacked with `git archive` into a git-ignored directory, and the
working tree's; a sibling `segment_rows.cuh` is included where the source
includes it).  Every SRC is compiled with nvcc as `_build.py` compiles it,
plus `-Xptxas -v` (registers, spills and stack are printed), and loaded with
ctypes in this one process; the wrappers of `render/segreduce.py` then
launch each library in turn on the same inputs:

  * `300k`: the full-width training frame of `chip_smoke.py` (1920x1088,
    the 300k-Gaussian bench scene, default config): its full-space reduce
    plan (K3's) and a compact plan of the same pairs (K4's, no window);
  * `garden`: band 0 of `chip_smoke.py`'s garden window (5M Gaussians,
    y-sorted, 2 span bands at 1920x1088): its compact plan (K4's, with the
    live-id window) and a full-space plan of the same pairs (K3's);

each with the per-slot cotangents that K2 gives for an L2 (300k) or L1
(garden) loss against 0.3.  Per frame it prints the plans' sizes (rows,
live rows, cap_live, window, table rows) and the live rows per id (mean,
p99, max), then times, for each kernel, the SRCs in the order given and in
reverse (A B B A) for --rounds rounds, each a CUDA-event median of --n
launches:

  * `k3`: `segment_reduce`;
  * `k4`: `segment_reduce_compact` (compact mode);
  * `k4_table`: the (N+1, 64) parameter-table gradient.  A version with
    the table mode (`gvrt_segment_reduce_compact_table`) launches it; one
    without runs compact mode and then `segreduce.expand_compact`, the
    parent's two-step route.  The expansion alone is timed once per frame.

Then per kernel and SRC: the mean time, the bound (`chip_smoke.py`'s
formulas), and the output against the first SRC's (bit equality, max abs)
and two runs' bit equality, after a NaN-poisoned allocator.

    python3 scripts/torch_reduce_ab.py [--rounds 2] [--n 20]
        [--frames 300k,garden] [--k3 SRC.cu ...] [--k4 SRC.cu ...]
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

LIBS = {"k3": "segment_reduce", "k4": "segment_reduce_compact"}


def build(src, out_dir):
    """nvcc SRC into out_dir with `_build.py`'s flags and -Xptxas -v;
    returns (library path, the kernel lines of ptxas' report)."""
    from gvrt_tpu_torch import _build
    digest = hashlib.sha256()
    for path in [src] + sorted(
            os.path.join(os.path.dirname(src), f)
            for f in os.listdir(os.path.dirname(src)) if f.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
    path = os.path.join(out_dir, f"libreduce_{digest.hexdigest()[:12]}.so")
    os.makedirs(out_dir, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", path, src], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src}:\n{proc.stdout}\n{proc.stderr}")
    report, kernel = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?(segment_reduce"
                      r"(?:_compact)?(?:_table)?_kernel)E", line)
        if m:
            kernel = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and kernel:
            report.append(f"{kernel}: {line.split(':', 1)[1].strip()}; "
                          f"{spill}")
            kernel = None
    return path, report


def load(path, name):
    """The library with the C signatures of `name` that it exports set."""
    from gvrt_tpu_torch import _build
    lib = ctypes.CDLL(path)
    for fn, (argtypes, restype) in _build.SIGNATURES[name].items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    return lib


def pair_gauss_presort(torch, topo):
    """Pre-sort pair -> Gaussian id, from the topology's per-Gaussian pair
    ranges (as `binning.bin_topology_from_table` builds it)."""
    from gvrt_tpu_torch.render import binning
    counts = topo.gauss_counts.long()
    n = counts.shape[0]
    return binning._scatter_max_fill(
        topo.pair_pos.shape[0], topo.gauss_offsets.long(),
        torch.arange(n, device=counts.device), counts > 0)


def other_plan(torch, topo, compact):
    """The plan of the other kind over the topology's pairs: the full-space
    plan sized for every pre-cull pair, or a compact plan of every live
    Gaussian with no window."""
    from gvrt_tpu_torch.render import segreduce as sr
    pair_g = pair_gauss_presort(torch, topo)
    n = topo.gauss_counts.shape[0]
    cap, cap_pad = topo.pair_pos.shape[0], topo.pair_gauss.shape[0]
    args = (pair_g, topo.pair_pos, topo.gauss_offsets, topo.gauss_counts, n,
            cap, cap_pad)
    if not compact:
        red, ovf = sr.build_reduce_plan(*args)
    else:
        survivors = int((topo.pair_pos < cap_pad).sum())
        cap_live = -(-n // sr.GROUP) * sr.GROUP
        red, ovf = sr.build_reduce_plan_compact(
            *args, cap_live, sr.plan_rows_compact(survivors))
    if int(ovf):
        raise RuntimeError(f"the rebuilt plan overflowed by {int(ovf)}")
    return red


def k2_cotangent(torch, chunks, rays, counts, cfg, l1):
    """K2's per-slot cotangents of mean (L2) or sum/size (L1) of the rgb
    error against 0.3."""
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv
    with torch.no_grad():
        acc, t_in = pf.tile_forward_residual(chunks, rays, counts, cfg)
        fixed = pf._background_fix(acc, counts)
        err = fixed[:, 0:3] - 0.3
        n = acc.shape[0] * 3 * acc.shape[2]
        bar = torch.zeros_like(acc)
        bar[:, 0:3] = torch.where((counts > 0)[:, None, None],
                                  torch.sign(err) / n if l1 else 2 * err / n,
                                  0.0)
        return pv.tile_backward(chunks, rays, counts, t_in, bar,
                                cfg)[0].reshape(-1, 64).contiguous()


def frame_300k(gt, torch, dev):
    import numpy as np
    import chip_smoke
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render.rows_vjp import frame_params
    from gvrt_tpu_torch.render.tiled import TiledRenderer, _camera_mats
    cfg = gt.DEFAULT_CONFIG
    w, h = chip_smoke.FULL_W, chip_smoke.FULL_H
    model = chip_smoke.bench_scene(gt, torch, dev)
    cam = gt.Camera.from_fovy(w, h, 50.0, np.eye(4))
    r = TiledRenderer(w, h, cfg, device=dev)
    r.plan(model, [cam])
    w2c, proj = _camera_mats(cam)
    with torch.no_grad():
        topo = binning.bin_topology(model.activate(), w2c, proj, w, h, cfg,
                                    *r.capacity,
                                    capacity_reduce=r.capacity_reduce)
        chunks = binning.gather_from_rows(frame_params(model, cfg)[1],
                                          topo, cfg)
    rays = binning.tile_rays(cam, cfg, dev)
    bar = k2_cotangent(torch, chunks, rays, topo.tile_counts, cfg, l1=False)
    return bar, topo.red, other_plan(torch, topo, compact=True), \
        model.num_gaussians + 1


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
    bar = k2_cotangent(torch, chunks, rays, topo.tile_counts, cfg, l1=True)
    del chunks
    return bar, other_plan(torch, topo, compact=False), topo.red, \
        model.num_gaussians + 1


def per_id(torch, ids, n_ids):
    """Live rows per id over the ids with at least one: mean, p99, max."""
    cnt = torch.bincount(ids, minlength=n_ids)
    has = cnt[cnt > 0].float()
    return {"ids_with_rows": int(has.numel()),
            "rows_per_id_mean": float(has.mean()),
            "rows_per_id_p99": float(torch.quantile(has, 0.99)),
            "rows_per_id_max": int(has.max())}


def plan_stats(torch, sr, full, compact, n_rows):
    """Sizes and rows per id of both plans; the bounds of the three
    functions (chip_smoke.py's formulas)."""
    import chip_smoke
    live3 = full.gloc.reshape(-1) < sr.GROUP
    gid = (full.out_idx.long()[:, None] * sr.GROUP
           + full.gloc.long()).reshape(-1)[live3]
    nb3 = full.gloc.shape[0]
    walked = int((full.gloc[:, 0] < sr.GROUP).sum())
    n_groups3 = -(-n_rows // sr.GROUP)
    cid = sr.compact_ids(compact)
    cap_live = compact.out_shape.shape[0] * sr.GROUP
    live4 = cid < cap_live
    nb4 = compact.k0.shape[0]
    window = compact.src_range.shape[0]
    n3, n4 = int(live3.sum()), int(live4.sum())
    bounds = {
        "k3": chip_smoke.reduce_bound_ms(n3, n_groups3 * sr.GROUP, walked,
                                         nb3),
        "k4": chip_smoke.compact_bound_ms(n4, cap_live // sr.GROUP, nb4),
        "k4_table": chip_smoke.table_bound_ms(n4, n_rows, window, nb4)}
    stats = {
        "k3_plan": {"rows": int(full.slot.numel()), "live_rows": n3,
                    "walked_blocks": walked, "blocks": nb3,
                    **per_id(torch, gid, n_groups3 * sr.GROUP)},
        "k4_plan": {"rows": int(compact.slot.numel()), "live_rows": n4,
                    "cap_live": cap_live, "window": window,
                    "base": int(compact.base[0]), "table_rows": n_rows,
                    **per_id(torch, cid[live4], cap_live)},
        "bounds_ms": {k: v[0] for k, v in bounds.items()},
        "bound_by": {k: v[1] for k, v in bounds.items()}}
    return stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k3", nargs="*", default=[])
    ap.add_argument("--k4", nargs="*", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--frames", default="300k,garden")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_reduce_ab: needs a CUDA card")
    import chip_smoke
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch import _build
    from gvrt_tpu_torch.render import segreduce as sr

    card = chip_smoke.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    out_dir = os.path.join(ROOT, "build", "reduce_ab")
    libs = {"k3": [], "k4": []}
    for kern, srcs in (("k3", args.k3), ("k4", args.k4)):
        for src in srcs:
            path, report = build(os.path.abspath(src), out_dir)
            libs[kern].append(load(path, LIBS[kern]))
            print(json.dumps({"kernel": kern, "src": src, "ptxas": report}),
                  flush=True)
    srcs = {"k3": args.k3, "k4": args.k4, "k4_table": args.k4}

    def runner(kern, i, bar, full, compact, n_rows):
        """One call of version i of `kern` on the frame's inputs."""
        lib = libs["k3" if kern == "k3" else "k4"][i]
        _build._libs[LIBS["k3" if kern == "k3" else "k4"]] = lib
        n_groups_c = compact.out_shape.shape[0]
        if kern == "k3":
            return sr.segment_reduce(bar, full, -(-n_rows // sr.GROUP))
        if kern == "k4":
            return sr.segment_reduce_compact(bar, compact, n_groups_c)
        if hasattr(lib, "gvrt_segment_reduce_compact_table"):
            return sr.segment_reduce_compact_table(bar, compact, n_rows)
        return sr.expand_compact(sr.segment_reduce_compact(
            bar, compact, n_groups_c), compact, n_rows)

    makers = {"300k": frame_300k, "garden": frame_garden}
    for frame in filter(None, args.frames.split(",")):
        bar, full, compact, n_rows = makers[frame](gt, torch, dev)
        stats = plan_stats(torch, sr, full, compact, n_rows)
        print(json.dumps({"frame": frame, "p_pad": bar.shape[0], **stats,
                          "card": card}), flush=True)
        inputs = (bar, full, compact, n_rows)
        if libs["k4"]:
            _build._libs["segment_reduce_compact"] = libs["k4"][0]
            sums = sr.segment_reduce_compact(bar, compact,
                                             compact.out_shape.shape[0])
            print(json.dumps({
                "frame": frame, "expansion_alone_ms": chip_smoke.cuda_ms(
                    lambda: sr.expand_compact(sums, compact, n_rows),
                    n=args.n), "card": card}), flush=True)
            del sums
        for kern in ("k3", "k4", "k4_table"):
            n_src = len(srcs[kern])
            if not n_src:
                continue
            times = {i: [] for i in range(n_src)}
            for rnd in range(args.rounds):
                order = list(range(n_src))
                for i in order + order[::-1]:
                    ms = chip_smoke.cuda_ms(lambda: runner(kern, i, *inputs),
                                            n=args.n)
                    times[i].append(ms)
                    print(json.dumps({"frame": frame, "kernel": kern,
                                      "round": rnd, "src": srcs[kern][i],
                                      "ms": ms}), flush=True)
            chip_smoke.poison_allocator(torch, 4 * n_rows * 64 * 4, dev)
            ref = runner(kern, 0, *inputs)
            for i, src in enumerate(srcs[kern]):
                chip_smoke.poison_allocator(torch, 4 * n_rows * 64 * 4, dev)
                got = runner(kern, i, *inputs)
                again = runner(kern, i, *inputs)
                torch.cuda.synchronize()
                print(json.dumps({
                    "frame": frame, "kernel": kern, "src": src,
                    "mean_ms": sum(times[i]) / len(times[i]),
                    "ms": times[i], "bound_ms": stats["bounds_ms"][kern],
                    "max_abs_vs_first": float((got - ref).abs().max()),
                    "bit_identical_to_first": torch.equal(got, ref),
                    "bit_identical_runs": torch.equal(got, again),
                    "finite": bool(got.isfinite().all()),
                    "card": card}), flush=True)
                del got, again
            del ref
        del bar, full, compact, inputs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
