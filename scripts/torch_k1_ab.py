#!/usr/bin/env python3
"""A/B timing of the serving tile kernel (K1) and of `render_bound` across
checkouts of the PyTorch port, on one card.

Each ROOT is a checkout of the repository (for example the parent commit
and the working tree, each unpacked with `git archive` into a git-ignored
directory).  For each of --rounds rounds every ROOT runs in a process of
its own, in the order given: it imports that checkout's package and
`chip_smoke.py`, draws chip_smoke.py's full-width frame (1920x1088, the
300k-Gaussian bench scene), binds a `TiledRenderer` to it and prints one
JSON line with the CUDA-event medians of --n runs of K1 alone
(`tile_forward`), of `render_bound`, and, where the checkout has it, of K1's
training variant (`tile_forward_residual`), all under `torch.no_grad()`.
Interleaving the checkouts spreads the card's drift over all of them.

    python3 scripts/torch_k1_ab.py [--rounds 3] [--n 100] ROOT [ROOT ...]
"""

import argparse
import json
import os
import subprocess
import sys


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.roots[0], args.n)
    roots = [os.path.abspath(root) for root in args.roots]
    for _ in range(args.rounds):
        for root in roots:
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", "--n", str(args.n), root],
                           cwd=root, check=True, timeout=600)


if __name__ == "__main__":
    main()
