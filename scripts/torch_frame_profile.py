#!/usr/bin/env python3
"""Where the time of one serving frame, or one training step, of the
PyTorch port goes, on the card.

Uses chip_smoke.py's full-width frame (1920x1088, the 300k-Gaussian bench
scene) and prints JSON lines:
  * per-stage CUDA-event medians.  Serving (default): cull table, topology
    (pair expansion, fine cull, sort, chunk layout), parameter table,
    gather, tile kernel, untile, and the whole `TiledRenderer.render`.
    Training (--train): the topology refresh with its reduce plan,
    rows64_from_model forward and backward, the gather, K1 with its
    residual, the loss and its cotangent, K2, K3, and the whole step of
    chip_smoke.py's training window (forward, backward, SGD).  The
    garden-scale banded step (--garden, chip_smoke.py's 5M window): per band
    the gather, K1 with its residual, K2, K4's compact mode, K4's table
    mode (the step's route to the parameter-table gradient) and the
    two-step route it replaced (compact mode, then the expansion back to
    the table), then rows64_from_model forward and backward, Adam, and the
    whole Trainer.step.  A pose step (--pose, chip_smoke.py's pose
    refinement: the frame's camera perturbed, the unperturbed rgb as
    target): bind_pose, the in-graph rays and their backward, K1 with its
    residual, K2 with ray cotangents, and the whole step (loss, backward,
    Adam on the 6-DOF delta);
  * the device-busy share from a torch.profiler trace of 3 frames or steps
    (kernel time over wall time) and the top CUDA kernels by device time.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/torch_frame_profile.py [--train | --garden | --pose]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def profile(torch, card, fn, label):
    """Device-busy share and top kernels of 3 runs of fn under the
    profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(json.dumps({"profile": f"{label} x3", "wall_ms": wall_ms,
                      "device_busy_ms": busy_ms,
                      "idle_share": 1.0 - busy_ms / wall_ms,
                      "card": card}), flush=True)
    for e in sorted(events, key=lambda e: -e.device_time_total)[:20]:
        print(json.dumps({"kernel": e.key[:90], "calls": e.count,
                          "device_ms_per_run": e.device_time_total / 3e3}),
              flush=True)


def train_stages(torch, card, model, cam, cfg):
    """Stage split of chip_smoke.py's training step at full width."""
    import chip_smoke
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv
    from gvrt_tpu_torch.render import segreduce as sr
    from gvrt_tpu_torch.render.rows_vjp import rows64_from_model
    from gvrt_tpu_torch.render.tiled import TiledRenderer, _camera_mats

    w, h = chip_smoke.FULL_W, chip_smoke.FULL_H
    r = TiledRenderer(w, h, cfg, device=model.device)
    r.plan(model, [cam])
    w2c, proj = _camera_mats(cam)
    rays = r._rays(cam)
    target = torch.full((rays.shape[0], 3, rays.shape[2]),
                        chip_smoke.TRAIN_TARGET, device=model.device)

    def topology():
        with torch.no_grad():
            return binning.bin_topology(model.activate(), w2c, proj, w, h,
                                        cfg, *r.capacity,
                                        capacity_reduce=r.capacity_reduce)

    topo = topology()
    n_groups = -(-(model.num_gaussians + 1) // sr.GROUP)

    def step():
        rows = rows64_from_model(model, cfg)
        chunks = binning.gather_from_rows(rows, topo, cfg, "cuda")
        acc = pf.forward_dispatch(binning.binned_scene(chunks, topo), rays,
                                  cfg, "cuda")
        ((acc[:, 0:3] - target) ** 2).mean().backward()
        with torch.no_grad():
            for p in model.leaves():
                p -= chip_smoke.TRAIN_LR * p.grad
                p.grad = None

    rows = rows64_from_model(model, cfg)
    with torch.no_grad():
        chunks = binning.gather_from_rows(rows, topo, cfg, "cuda")
        acc, t_in = pf.tile_forward_residual(chunks, rays, topo.tile_counts,
                                             cfg)
        bar = torch.zeros_like(acc)
        bar[:, 0:3] = 2.0 * (acc[:, 0:3] - target) / target.numel()
        bar_chunks, _ = pv.tile_backward(chunks, rays, topo.tile_counts,
                                         t_in, bar, cfg)
    bar_flat = bar_chunks.reshape(-1, 64)
    bar_rows = torch.randn_like(rows)
    stages = {
        "topology_with_reduce_plan": topology,
        "rows64_from_model": lambda: rows64_from_model(model, cfg),
        "rows64_backward": lambda: torch.autograd.grad(
            rows, model.leaves(), bar_rows, retain_graph=True),
        "gather_from_rows": lambda: binning.gather_from_rows(
            rows.detach(), topo, cfg, "cuda"),
        "tile_forward_residual": lambda: pf.tile_forward_residual(
            chunks, rays, topo.tile_counts, cfg),
        "tile_backward": lambda: pv.tile_backward(
            chunks, rays, topo.tile_counts, t_in, bar, cfg),
        "segment_reduce": lambda: sr.segment_reduce(bar_flat, topo.red,
                                                    n_groups),
        "train_step": step,
    }
    for name, fn in stages.items():
        print(json.dumps({"stage": name, "ms": chip_smoke.cuda_ms(fn),
                          "card": card}), flush=True)
    profile(torch, card, step, "train_step")


def pose_stages(torch, card, model, cam, cfg):
    """Stage split of chip_smoke.py's pose step at full width."""
    import chip_smoke
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv
    from gvrt_tpu_torch.train import pose as tpose

    dev = model.device
    with torch.no_grad():
        target = gt.render.render_image_tiled(model, cam, cfg,
                                              device=dev)["rgb"]
    bad = gt.train.perturb_cameras([cam], chip_smoke.POSE_SIGMA, seed=0)[0]
    bound = tpose.bind_pose(model, bad, target, cfg)
    b, rcfg = bound.binned, bound.cfg
    t = torch.zeros(3, device=dev, requires_grad=True)
    r = torch.zeros(3, device=dev, requires_grad=True)
    rays = tpose._posed_rays(bound.ndc, bad, rcfg, t, r)
    bar_rays = torch.randn_like(rays)
    with torch.no_grad():
        acc, t_in = pf.tile_forward_residual(b.chunks, rays.detach(),
                                             b.tile_counts, rcfg)
        bar = torch.zeros_like(acc)
        bar[:, 0:3] = 2.0 * (acc[:, 0:3] - bound.target) / \
            bound.target.numel()
    opt = torch.optim.Adam([t, r], lr=chip_smoke.POSE_LR, eps=1e-8)

    def step():
        opt.zero_grad(set_to_none=True)
        tpose.pose_loss(bound, t, r, "cuda").backward()
        opt.step()

    stages = {
        "bind_pose": lambda: tpose.bind_pose(model, bad, target, cfg),
        "posed_rays": lambda: tpose._posed_rays(bound.ndc, bad, rcfg,
                                                t.detach(), r.detach()),
        "posed_rays_backward": lambda: torch.autograd.grad(
            rays, (t, r), bar_rays, retain_graph=True),
        "tile_forward_residual": lambda: pf.tile_forward_residual(
            b.chunks, rays.detach(), b.tile_counts, rcfg),
        "tile_backward_ray_gradients": lambda: pv.tile_backward(
            b.chunks, rays.detach(), b.tile_counts, t_in, bar, rcfg),
        "pose_step": step,
    }
    for name, fn in stages.items():
        print(json.dumps({"stage": name, "ms": chip_smoke.cuda_ms(fn),
                          "card": card}), flush=True)
    profile(torch, card, step, "pose_step")


def garden_stages(torch, card, dev):
    """Stage split of chip_smoke.py's garden-scale banded training step."""
    import chip_smoke
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch.render import binning
    from gvrt_tpu_torch.render import pallas_forward as pf
    from gvrt_tpu_torch.render import pallas_vjp as pv
    from gvrt_tpu_torch.render import param_grads as pg
    from gvrt_tpu_torch.render import segreduce as sr
    from gvrt_tpu_torch.render.rows_vjp import rows64_from_model

    cfg = gt.DEFAULT_CONFIG
    w, h, nb = chip_smoke.FULL_W, chip_smoke.FULL_H, chip_smoke.GARDEN_BANDS
    model, cam = chip_smoke.garden_scene(gt, torch, dev)
    model = model.sorted_for_camera(cam, cfg)
    trainer = gt.train.Trainer(w, h, cfg, gt.train.TrainConfig(
        span_bands=True), n_bands=nb, device=dev)
    topos = trainer.bind(model, cam)
    state = trainer.init(model)
    target = torch.full((h, w, 3), chip_smoke.TRAIN_TARGET, device=dev)
    rays = binning.band_rays(cam, cfg, nb, dev, mode="contig")
    rows = rows64_from_model(model, cfg)
    stages = {
        "rows64_from_model": lambda: rows64_from_model(model, cfg),
        "rows64_backward": lambda: torch.autograd.grad(
            rows, model.leaves(), torch.ones_like(rows), retain_graph=True),
    }
    for b, topo in enumerate(topos):
        with torch.no_grad():
            chunks = binning.gather_from_rows(rows, topo, cfg, "cuda")
            acc, t_in = pf.tile_forward_residual(chunks, rays[b],
                                                 topo.tile_counts, cfg)
            bar = torch.zeros_like(acc)
            bar[:, 0:3] = torch.sign(acc[:, 0:3] - 0.3) / (w * h * 3)
            bar_flat = pv.tile_backward(chunks, rays[b], topo.tile_counts,
                                        t_in, bar, cfg)[0].reshape(-1, 64)
        n_groups = topo.red.out_shape.shape[0]
        stages.update({
            f"band{b}_gather": lambda topo=topo: binning.gather_from_rows(
                rows.detach(), topo, cfg, "cuda"),
            f"band{b}_tile_forward_residual": lambda b=b, c=chunks, t=topo:
                pf.tile_forward_residual(c, rays[b], t.tile_counts, cfg),
            f"band{b}_tile_backward": lambda b=b, c=chunks, t=topo, ti=t_in,
                ba=bar: pv.tile_backward(c, rays[b], t.tile_counts, ti, ba,
                                         cfg),
            f"band{b}_segment_reduce_compact": lambda f=bar_flat, t=topo,
                n=n_groups: sr.segment_reduce_compact(f, t.red, n),
            f"band{b}_compact_table": lambda f=bar_flat, t=topo:
                pg._bwd_segreduce_compact(rows.shape[0], t.red, f, "cuda"),
            f"band{b}_compact_two_step": lambda f=bar_flat, t=topo,
                n=n_groups: sr.expand_compact(sr.segment_reduce_compact(
                    f, t.red, n), t.red, rows.shape[0]),
        })

    def adam():
        for p in model.leaves():
            p.grad = torch.zeros_like(p)
        state[1].step()

    def step():
        trainer.step(state, cam, target)

    stages.update({"adam_step": adam, "trainer_step": step})
    for name, fn in stages.items():
        print(json.dumps({"stage": name, "ms": chip_smoke.cuda_ms(fn),
                          "card": card}), flush=True)
    print(json.dumps({"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "card": card}), flush=True)
    profile(torch, card, step, "garden_trainer_step")


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
    if "--garden" in sys.argv[1:]:
        return garden_stages(torch, card, dev)
    cfg = gt.DEFAULT_CONFIG
    w, h = chip_smoke.FULL_W, chip_smoke.FULL_H
    model = chip_smoke.bench_scene(gt, torch, dev)
    cam = gt.Camera.from_fovy(w, h, 50.0, np.eye(4))
    if "--train" in sys.argv[1:]:
        return train_stages(torch, card, model, cam, cfg)
    if "--pose" in sys.argv[1:]:
        return pose_stages(torch, card, model, cam, cfg)
    r = TiledRenderer(w, h, cfg, device=dev)
    r.plan(model, [cam])
    w2c, proj = _camera_mats(cam)
    rays = r._rays(cam)

    with torch.no_grad():
        act = model.activate()
        tab = binning.frame_cull_table(act, w2c, proj, w, h, cfg)
        # a serving frame builds no gradient-reduce plan
        topo = binning.bin_topology_from_table(tab, proj, w, h, cfg,
                                               *r.capacity,
                                               with_reduce_plan=False)
        rows = binning.param_rows(act, cfg)
        chunks = binning.gather_from_rows(rows, topo, cfg)
        acc = pf.tile_forward(chunks, rays, topo.tile_counts, cfg)
        stages = {
            "activate": lambda: model.activate(),
            "frame_cull_table": lambda: binning.frame_cull_table(
                act, w2c, proj, w, h, cfg),
            "bin_topology_from_table": lambda: binning.bin_topology_from_table(
                tab, proj, w, h, cfg, *r.capacity, with_reduce_plan=False),
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

        profile(torch, card, lambda: r.render(model, cam), "render")


if __name__ == "__main__":
    main()
