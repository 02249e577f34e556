#!/usr/bin/env python3
"""Where the time of one serving frame of the PyTorch port goes, on the card.

Renders chip_smoke.py's full-width frame (1920x1088, the 300k-Gaussian bench
scene) and prints JSON lines:
  * per-stage CUDA-event medians: cull table, topology (pair expansion,
    fine cull, sort, chunk layout), parameter table, gather, tile kernel,
    untile, and the whole `TiledRenderer.render`;
  * the device-busy share of `render` from a torch.profiler trace (kernel
    time over wall time) and the top CUDA kernels by total device time.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_frame_profile.py
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render.tiled import TiledRenderer, _camera_mats

    card = chip_smoke.card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = gt.DEFAULT_CONFIG
    w, h = chip_smoke.FULL_W, chip_smoke.FULL_H
    model = chip_smoke.bench_scene(gt, torch, dev)
    cam = gt.Camera.from_fovy(w, h, 50.0, np.eye(4))
    r = TiledRenderer(w, h, cfg, device=dev)
    r.plan(model, [cam])
    w2c, proj = _camera_mats(cam)
    rays = r._rays(cam)

    with torch.no_grad():
        act = model.activate()
        tab = binning.frame_cull_table(act, w2c, proj, w, h, cfg)
        topo = binning.bin_topology_from_table(tab, proj, w, h, cfg,
                                               *r.capacity)
        rows = binning.param_rows(act, cfg)
        chunks = binning.gather_from_rows(rows, topo, cfg)
        acc = pf.tile_forward(chunks, rays, topo.tile_counts, cfg)
        stages = {
            "activate": lambda: model.activate(),
            "frame_cull_table": lambda: binning.frame_cull_table(
                act, w2c, proj, w, h, cfg),
            "bin_topology_from_table": lambda: binning.bin_topology_from_table(
                tab, proj, w, h, cfg, *r.capacity),
            "param_rows": lambda: binning.param_rows(act, cfg),
            "gather_from_rows": lambda: binning.gather_from_rows(rows, topo,
                                                                 cfg),
            "tile_forward": lambda: pf.tile_forward(chunks, rays,
                                                    topo.tile_counts, cfg),
            "untile": lambda: binning.untile(acc, w, h, cfg.tile_size)
            .contiguous(),
            "render": lambda: r.render(model, cam),
        }
        for name, fn in stages.items():
            print(json.dumps({"stage": name, "ms": chip_smoke.cuda_ms(fn),
                              "card": card}), flush=True)

        r.render(model, cam)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                r.render(model, cam)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(json.dumps({"profile": "render x3", "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1.0 - busy_ms / wall_ms,
                      "card": card}), flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:20]:
        print(json.dumps({"kernel": e.key[:90], "calls": e.count,
                          "device_ms_per_frame": e.device_time_total / 3e3}),
              flush=True)


if __name__ == "__main__":
    main()
