#!/usr/bin/env python3
"""Where the time of a serving frame, a training step, the garden-scale
banded step, the garden serving frame or a pose step of the PyTorch port
goes, on the card, read from the program's own spans and counters.

Runs one path on chip_smoke.py's scenes at 1920x1088 under
`utils.profiling.trace(DIR)` for a few frames or steps after a warm-up:
  * serving (default): `TiledRenderer.render` under no_grad on the 300k
    bench scene, a new camera each frame (a viewer moving sideways), so
    every frame bins and makes its rays;
  * --train: the unbanded `Trainer.step` (batch 1, its camera batch made
    once) against a constant target;
  * --garden: the banded `Trainer.step` on the 5M garden scene, y-sorted,
    2 span bands, refresh every 10 steps (a bind in the stretch);
  * --garden-serve: the serving frame on the 5M garden scene, unbanded,
    a new camera each frame as in serving;
  * --pose: `optimize_camera_poses` of the frame's camera perturbed as
    chip_smoke.py perturbs it, against the unperturbed render.
It prints JSON lines: the card; the program's span table per frame or
step (calls, host ms, self host ms, device ms; largest host time first)
and its counters per unit; the device's idle share over the traced
stretch, 1 - the union of the kernel intervals over the stretch's wall
time; the longest idle gaps, each labelled by the innermost `gvrt.` span
open over it; and the top kernels by device time.  DIR keeps the Chrome
trace (`trace.json`) and the span table (`span_table.json`).

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_frame_profile.py [--train | --garden |
        --garden-serve | --pose] \
        [--units N] [--out DIR]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.trace import _union_us  # noqa: E402

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def report(logdir, wall_s, card):
    """Print the span table, the counters, the idle share, the longest
    idle gaps and the top kernels of the trace in `logdir`."""
    with open(os.path.join(logdir, "span_table.json")) as f:
        table = json.load(f)
    units = (table["units"].get("gvrt.frame")
             or table["units"].get("gvrt.step") or 1)
    for name, row in sorted(table["spans"].items(),
                            key=lambda kv: -kv[1]["host_ms"]):
        print(json.dumps({
            "span": name, "calls_per_unit": row["calls"] / units,
            "host_ms": row["host_ms"] / units,
            "self_host_ms": row["self_host_ms"] / units,
            "device_ms": None if row["device_ms"] is None
            else row["device_ms"] / units}), flush=True)
    print(json.dumps({"units": table["units"], "counts_per_unit": {
        k: v / units for k, v in table["counts"].items()}}), flush=True)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels, ranges, by_name = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t, d, name = float(e["ts"]), float(e["dur"]), str(e.get("name"))
        if e.get("cat") in DEVICE_CATS:
            kernels.append((t, t + d))
            by_name[name] = by_name.get(name, 0.0) + d
        elif e.get("cat") == "user_annotation" and name.startswith("gvrt."):
            ranges.append((t, d, name))
    busy, gaps = _union_us(kernels)
    print(json.dumps({"wall_ms": 1e3 * wall_s, "busy_ms": busy / 1e3,
                      "idle_share": 1.0 - busy / 1e6 / wall_s,
                      "card": card}), flush=True)
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:8]:
        mid = 0.5 * (s + e)
        inner = [(d, n) for t, d, n in ranges if t <= mid <= t + d]
        print(json.dumps({"idle_gap_ms": (e - s) / 1e3,
                          "span": min(inner)[1] if inner else None}),
              flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(json.dumps({"kernel": name[:90],
                          "device_ms_per_unit": us / 1e3 / units}),
              flush=True)


def serving(gt, torch, chip_smoke, dev, garden_scale=False):
    import numpy as np
    cfg = gt.DEFAULT_CONFIG
    w, h = chip_smoke.FULL_W, chip_smoke.FULL_H
    if garden_scale:
        model = chip_smoke.garden_scene(gt, torch, dev)[0]
        fovy = chip_smoke.GARDEN_FOVY
    else:
        model, fovy = chip_smoke.bench_scene(gt, torch, dev), 50.0
    r = gt.render.TiledRenderer(w, h, cfg, device=dev)
    frame = [0]

    def camera():
        c2w = np.eye(4)
        c2w[0, 3] = 0.002 * frame[0]
        frame[0] += 1
        return gt.Camera.from_fovy(w, h, fovy, c2w)

    r.plan(model, [camera()])

    def unit():
        with torch.no_grad():
            out = r.render(model, camera())
        out["rgb"].sum().item()   # the viewer waits for its image
    return unit


def training(gt, torch, chip_smoke, dev):
    import numpy as np
    cfg = gt.DEFAULT_CONFIG
    w, h = chip_smoke.FULL_W, chip_smoke.FULL_H
    model = chip_smoke.bench_scene(gt, torch, dev)
    cam = gt.Camera.from_fovy(w, h, 50.0, np.eye(4))
    cap = gt.render.TiledRenderer(w, h, cfg, device=dev).plan(model, [cam])
    trainer = gt.train.Trainer(w, h, cfg, gt.train.TrainConfig(), cap,
                               device=dev)
    state = [trainer.init(model)]
    batch = gt.parallel.camera_batch([cam], cfg, dev)
    target = torch.full((1, h, w, 3), chip_smoke.TRAIN_TARGET, device=dev)

    def unit():
        state[0], _ = trainer.step(state[0], batch, target)
    return unit


def garden(gt, torch, chip_smoke, dev):
    cfg = gt.DEFAULT_CONFIG
    w, h = chip_smoke.FULL_W, chip_smoke.FULL_H
    model, cam = chip_smoke.garden_scene(gt, torch, dev)
    model = model.sorted_for_camera(cam, cfg)
    trainer = gt.train.Trainer(w, h, cfg, gt.train.TrainConfig(
        span_bands=True), n_bands=chip_smoke.GARDEN_BANDS, device=dev)
    state = [trainer.init(model)]
    target = torch.full((h, w, 3), chip_smoke.TRAIN_TARGET, device=dev)

    def unit():
        state[0], _ = trainer.step(state[0], cam, target)
    return unit


def pose(gt, torch, chip_smoke, dev):
    import numpy as np
    cfg = gt.DEFAULT_CONFIG
    w, h = chip_smoke.FULL_W, chip_smoke.FULL_H
    model = chip_smoke.bench_scene(gt, torch, dev)
    cam = gt.Camera.from_fovy(w, h, 50.0, np.eye(4))
    with torch.no_grad():
        target = gt.render.render_image_tiled(model, cam, cfg,
                                              device=dev)["rgb"]
    bad = gt.train.perturb_cameras([cam], chip_smoke.POSE_SIGMA, seed=0)[0]
    steps = [1]

    def unit():
        # one refinement of `steps` pose steps (the bind, then the steps)
        gt.train.optimize_camera_poses(model, [bad], [target], cfg,
                                       steps=steps[0], verbose=False)
    return unit, steps


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    path = p.add_mutually_exclusive_group()
    path.add_argument("--train", action="store_true")
    path.add_argument("--garden", action="store_true")
    path.add_argument("--garden-serve", action="store_true")
    path.add_argument("--pose", action="store_true")
    p.add_argument("--units", type=int, default=0,
                   help="frames or steps traced (default 8 frames, 20 "
                        "steps, 12 garden steps, 8 garden frames, 20 pose "
                        "steps)")
    p.add_argument("--out", default="", help="directory of the trace")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch.utils import profiling

    card = chip_smoke.card_line()
    print(json.dumps({"card": card}), flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    name = ("train" if args.train else "garden" if args.garden else
            "garden_serve" if args.garden_serve else
            "pose" if args.pose else "serve")
    logdir = args.out or os.path.join(ROOT, "chiprun_out", "frame_profile",
                                      name)
    if args.pose:
        unit, steps = pose(gt, torch, chip_smoke, dev)
        unit()   # warm-up: builds the kernels
        steps[0], runs = args.units or 20, 1
    else:
        make = {"serve": serving, "train": training, "garden": garden,
                "garden_serve": lambda *a: serving(*a, garden_scale=True)}
        unit = make[name](gt, torch, chip_smoke, dev)
        for _ in range(2):   # warm-up: builds the kernels, binds
            unit()
        runs = args.units or {"serve": 8, "train": 20, "garden": 12,
                              "garden_serve": 8}[name]
    torch.cuda.synchronize()
    with profiling.trace(logdir):
        t0 = time.perf_counter()
        for _ in range(runs):
            unit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report(logdir, wall, card)


if __name__ == "__main__":
    main()
