#!/usr/bin/env python3
"""A/B timing of the forward tile kernel (K1) on one card: versions of its
source in one process, or whole checkouts in interleaved processes.

Source mode, when every argument is a `.cu` file: each SRC is a version of
`csrc/tile_forward.cu` (for example the parent commit's, unpacked with `git
archive` into a git-ignored directory, and the working tree's; a sibling
`tile_common.cuh` is included).  Every SRC is compiled with nvcc as
`_build.py` compiles it, plus `-Xptxas -v` (each template instance's
registers, spills and stack are printed), and loaded with ctypes in this one
process; K1's wrappers `pallas_forward.tile_forward` (serving) and
`tile_forward_residual` (training, with T_in) then launch each library in
turn on the same inputs:

  * `300k`: the full-width frame of `chip_smoke.py` (1920x1088, the
    300k-Gaussian bench scene, default config);
  * `garden`: band 0 of `chip_smoke.py`'s garden window (5M Gaussians,
    y-sorted, 2 span bands at 1920x1088);
  * `300k:T:G`: the 300k frame binned at tile T and chunk size G.

For each frame, variant and each of --rounds rounds the SRCs are timed in
the order given, then in reverse (A B B A), each a CUDA-event median of --n
launches; one JSON line per timing, then per SRC and variant the mean over
its timings and its outputs (acc, and T_in for the residual) against the
first SRC's: bit equality and max abs (and the sums of acc's rows 6 and 7,
zero in K1, where a counting copy may keep per-ray counts).  Every SRC
must have the current wrapper's interface of `gvrt_tile_forward`; compare
sources of an older interface in checkout mode.
`--sass DIR` also writes `cuobjdump -sass` of each SRC's default instance
(degree 4, product transmittance, without SPLIT) to DIR.

    python3 scripts/torch_k1_ab.py [--rounds 2] [--n 20] [--frames 300k,garden]
        [--sass DIR] SRC.cu [SRC.cu ...]

(`--frames ""` only builds and prints the registers and spills.)

Checkout mode, when every argument is a directory: each ROOT is a checkout
of the repository.  For each of --rounds rounds every ROOT runs in a process
of its own, in the order given: it imports that checkout's package and
`chip_smoke.py`, draws the 300k frame, binds a `TiledRenderer` to it and
prints one JSON line with the CUDA-event medians of --n runs of K1 alone
(`tile_forward`), of `render_bound`, and, where the checkout has it, of K1's
training variant (`tile_forward_residual`), all under `torch.no_grad()`.
Interleaving the checkouts spreads the card's drift over all of them.

    python3 scripts/torch_k1_ab.py [--rounds 3] [--n 100] ROOT [ROOT ...]
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: mangled K1 instance: tile_forward_kernel<DEG, PROD>
_INSTANCE = re.compile(r"tile_forward_kernelILi(n?\d+)ELb(\d)E(?:Lb(\d)E)?")


def child(root, n):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render.tiled import TiledRenderer

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = gt.DEFAULT_CONFIG
    w, h = chip_smoke.FULL_W, chip_smoke.FULL_H
    model = chip_smoke.bench_scene(gt, torch, dev)
    cam = gt.Camera.from_fovy(w, h, 50.0, np.eye(4))
    r = TiledRenderer(w, h, cfg, device=dev)
    r.plan(model, [cam])
    with torch.no_grad():
        r.bind(model, cam)
        topo, rays = r._bound
        chunks = binning.gather_chunks(model.activate(), topo, cfg)
        k1 = chip_smoke.cuda_ms(lambda: pf.tile_forward(
            chunks, rays, topo.tile_counts, cfg), n=n)
        bound = chip_smoke.cuda_ms(lambda: r.render_bound(model), n=n)
        line = {"root": root, "tile_forward_ms": k1, "render_bound_ms": bound}
        if hasattr(pf, "tile_forward_residual"):  # checkouts with training
            line["tile_forward_residual_ms"] = chip_smoke.cuda_ms(
                lambda: pf.tile_forward_residual(chunks, rays,
                                                 topo.tile_counts, cfg), n=n)
    print(json.dumps({**line, "card": chip_smoke.card_line()}), flush=True)


def checkouts(args):
    roots = [os.path.abspath(root) for root in args.roots]
    for _ in range(args.rounds):
        for root in roots:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", "--n", str(args.n), root],
                           cwd=root, check=True, timeout=600)


def build(src, out_dir):
    """nvcc SRC into out_dir with `_build.py`'s flags and -Xptxas -v;
    returns (library path, the kernel lines of ptxas' report)."""
    from gvrt_tpu_torch import _build
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:12]
    path = os.path.join(out_dir, f"libk1_{key}.so")
    os.makedirs(out_dir, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                           "-o", path, src], capture_output=True, text=True,
                          timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src}:\n{proc.stdout}\n{proc.stderr}")
    # one line per template instance <DEG, PROD>: registers and spills
    report, inst, spill = [], None, ""
    for line in (proc.stdout + proc.stderr).splitlines():
        m = _INSTANCE.search(line)
        if m:  # <DEG, PROD[, SPLIT]>
            inst = "<{}>".format(", ".join(
                [m.group(1).replace("n", "-")]
                + [x for x in m.group(2, 3) if x is not None]))
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and inst:
            report.append(f"{inst}: {line.split(':', 1)[1].strip()}; "
                          f"{spill}")
            inst = None
    return path, report


def sass(path, src, out_dir):
    """cuobjdump -sass of the <4, true> instance (without SPLIT where the
    source has it) of a built library."""
    from gvrt_tpu_torch import _build
    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    proc = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300)
    text = proc.stdout
    # keep the function whose header names the default instance
    parts = re.split(r"(?=\n\s*Function : )", text)
    keep = [p for p in parts
            if re.search(r"tile_forward_kernelILi4ELb1E(?:Lb0E)?EE", p)]
    os.makedirs(out_dir, exist_ok=True)
    # named after the library, whose name holds the source's hash
    name = os.path.join(out_dir, os.path.basename(path) + ".sass")
    with open(name, "w") as f:
        f.write(keep[0] if keep else text)
    n_instr = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+[A-Z@]",
                             keep[0] if keep else ""))
    return name, n_instr


def load(path):
    import ctypes
    from gvrt_tpu_torch import _build
    lib = ctypes.CDLL(path)
    argtypes, restype = _build.SIGNATURES["tile_forward"]["gvrt_tile_forward"]
    lib.gvrt_tile_forward.argtypes = argtypes
    lib.gvrt_tile_forward.restype = restype
    return lib


def sources(args):
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_k1_ab: needs a CUDA card")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    import gvrt_tpu_torch as gt
    import torch_k2_ab
    from gvrt_tpu_torch import _build
    from gvrt_tpu_torch.render import pallas_forward as pf

    card = chip_smoke.card_line()
    dev = torch.device("cuda", torch.cuda.current_device())
    out_dir = os.path.join(ROOT, "build", "k1ab_libs")
    libs = []
    for src in args.roots:
        path, report = build(os.path.abspath(src), out_dir)
        libs.append(load(path))
        line = {"src": src, "ptxas": report}
        if args.sass:
            line["sass_file"], line["sass_instructions"] = sass(
                path, src, args.sass)
        print(json.dumps(line), flush=True)

    variants = {"serving": pf.tile_forward,
                "residual": pf.tile_forward_residual}

    def run(i, variant, *inputs):
        _build._libs["tile_forward"] = libs[i]
        out = variants[variant](*inputs)
        return out if isinstance(out, tuple) else (out,)

    makers = {"300k": torch_k2_ab.frame_300k,
              "garden": torch_k2_ab.frame_garden}
    for frame in filter(None, args.frames.split(",")):
        name, *shape = frame.split(":")
        inputs = makers[name](gt, torch, dev, *map(int, shape))[:4]
        for variant in variants:
            times = {i: [] for i in range(len(libs))}
            with torch.no_grad():
                for rnd in range(args.rounds):
                    order = list(range(len(libs)))
                    for i in order + order[::-1]:
                        ms = chip_smoke.cuda_ms(
                            lambda: run(i, variant, *inputs), n=args.n)
                        times[i].append(ms)
                        print(json.dumps({"frame": frame, "variant": variant,
                                          "round": rnd, "src": args.roots[i],
                                          "ms": ms}), flush=True)
                ref = run(0, variant, *inputs)
                for i, src in enumerate(args.roots):
                    got = run(i, variant, *inputs)
                    again = run(i, variant, *inputs)
                    torch.cuda.synchronize()
                    names = ("acc", "t_in")[:len(got)]
                    print(json.dumps({
                        "frame": frame, "variant": variant, "src": src,
                        "mean_ms": sum(times[i]) / len(times[i]),
                        "ms": times[i],
                        "bit_identical_to_first": {
                            k: torch.equal(g, r)
                            for k, g, r in zip(names, got, ref)},
                        "max_abs_vs_first": {
                            k: float((g - r).abs().max())
                            for k, g, r in zip(names, got, ref)},
                        "bit_identical_runs": all(
                            torch.equal(g, a) for g, a in zip(got, again)),
                        "hits": float(got[0][:, 5].sum()),
                        "acc_rows_6_7": [float(got[0][:, 6].sum()),
                                         float(got[0][:, 7].sum())],
                        "chunks": int(inputs[0].shape[0]),
                        "tiles": int(inputs[1].shape[0]), "card": card}),
                        flush=True)
            del ref, got, again
        del inputs
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", metavar="SRC|ROOT")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--frames", default="300k,garden")
    ap.add_argument("--sass", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.roots[0], args.n)
    if all(r.endswith(".cu") for r in args.roots):
        args.rounds = 2 if args.rounds is None else args.rounds
        args.n = 20 if args.n is None else args.n
        return sources(args)
    if not all(os.path.isdir(r) for r in args.roots):
        sys.exit("torch_k1_ab: give .cu sources or checkout directories")
    args.rounds = 3 if args.rounds is None else args.rounds
    args.n = 100 if args.n is None else args.n
    return checkouts(args)


if __name__ == "__main__":
    main()
