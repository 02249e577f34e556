"""Headless viewer / CLI of the PyTorch port.

Subcommands (the JAX package's CLI, as far as this port reaches):

  render     orbit or dataset-camera renders -> PNG sequence
  benchmark  warmup + timed fps loop, CSV out   (-b -bw -br -bf -bt)
  info       device / scene info
  train      Adam fine-tune on one card (self-distillation or --images-dir)

Everything runs on the card unless ``--device cpu`` is given.

Run as:  python -m 3dgvrt_lightfield_tpu_torch <subcommand> [...]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch


def _orbit_cameras(model, n_frames, width, height, fovy, radius_scale=2.5,
                   znear=0.005, zfar=20.0):
    """Circle of cameras around the scene (DYNAMIC_CAMERA's rotating pose,
    VulkanFullRT.cpp:1311-1329, generalized to the scene bounding sphere)."""
    from .io.cameras import Camera, look_at_inverse
    pos = model.means.detach().cpu().numpy()
    lo, hi = pos.min(0), pos.max(0)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo) / 2) * radius_scale
    cams = []
    for i in range(n_frames):
        theta = 2 * math.pi * i / max(n_frames, 1)
        eye = center + radius * np.asarray(
            [math.cos(theta), math.sin(theta), 0.4])
        c2w = look_at_inverse(eye, center, np.asarray([0.0, 0.0, 1.0]))
        cams.append(Camera.from_fovy(width, height, fovy, c2w, znear, zfar,
                                     name=f"orbit_{i:04d}"))
    return cams


def _load_model(args):
    from .models.gaussians import GaussianModel
    model = GaussianModel.from_ply(args.ply, device=args.device)
    if getattr(args, "filter_abnormal", False):
        model = model.filtered()
    return model


def _cameras(args, model):
    if getattr(args, "camera_json", None):
        from .io.cameras import load_nerf_cameras
        return load_nerf_cameras(args.camera_json, args.width, args.height)
    return _orbit_cameras(model, getattr(args, "frames", 8), args.width,
                          args.height, args.fovy)


def _common(p):
    p.add_argument("--ply", required=True, help="3DGS .ply scene")
    p.add_argument("--width", "-w", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--fovy", type=float, default=39.6,
                   help="degrees (Define.h FOV_Y default)")
    p.add_argument("--camera-json", help="NeRF transforms_*.json")
    p.add_argument("--impl", default="auto", choices=["auto", "cuda", "torch"],
                   help="tile composite: the CUDA kernel, or its plain "
                        "PyTorch version (auto: the kernel on CUDA)")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; pass cpu for the CPU)")
    p.add_argument("--filter-abnormal", action="store_true",
                   help="drop abnormal particles (enclosing-pass filter)")


def _dump_poses(cams, path):
    """Camera-pose dump (hotkey P analog, VulkanRTBase.cpp:1753-1760)."""
    import json
    poses = [{"name": c.name or str(i),
              "width": c.width, "height": c.height,
              "fovy_deg": float(getattr(c, "fovy_deg", 0.0)),
              "camera_to_world": np.asarray(c.view_inverse).tolist()}
             for i, c in enumerate(cams)]
    with open(path, "w") as f:
        json.dump(poses, f, indent=1)
    print(path)


def _save_hit_counts(hit_count, path):
    """Per-pixel hit-count dump (ENABLE_HIT_COUNTS,
    VulkanFullRT.cpp:2180-2195 writes rayHitCountsOutput.txt)."""
    arr = hit_count.cpu().numpy()
    with open(path, "w") as f:
        for row in arr:
            f.write(" ".join(str(int(v)) for v in row) + "\n")


def cmd_render(args):
    from .config import DEFAULT_CONFIG
    from .io.image import save_png
    from .render.tiled import TiledRenderer
    model = _load_model(args)
    cams = _cameras(args, model)[: args.frames]
    r = TiledRenderer(args.width, args.height, DEFAULT_CONFIG,
                      impl=args.impl, device=args.device)
    r.plan(model, cams[: min(4, len(cams))])
    os.makedirs(args.out, exist_ok=True)
    if args.dump_poses:
        _dump_poses(cams, os.path.join(args.out, "camera_poses.json"))
    for i, cam in enumerate(cams):
        with torch.no_grad():
            out = r.render(model, cam)
        path = os.path.join(args.out, f"{cam.name or i}.png")
        save_png(path, out["rgb"].cpu().numpy())
        print(path)
        if args.hit_counts:
            _save_hit_counts(out["hit_count"],
                             os.path.join(args.out, "rayHitCountsOutput.txt"))


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def cmd_benchmark(args):
    from .config import DEFAULT_CONFIG
    from .render.tiled import TiledRenderer
    from .utils.benchmark import run_benchmark, save_results
    model = _load_model(args)
    cam = _cameras(args, model)[0]
    r = TiledRenderer(args.width, args.height, DEFAULT_CONFIG,
                      impl=args.impl, device=args.device)
    r.plan(model, [cam])

    def frame():
        with torch.no_grad():
            r.render(model, cam)
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)

    res = run_benchmark(frame, warmup=args.benchwarmup,
                        duration=args.benchruntime,
                        output_frames=args.benchframes,
                        device=_device_name(r.device))
    save_results(res, args.benchfilename, frame_times=args.benchframetimes)
    rays = args.width * args.height
    print(f"rays/s : {rays * res.fps / 1e6:.2f}M")


def cmd_info(args):
    from .config import resolve_device
    print("torch:", torch.__version__)
    dev = resolve_device(args.device)
    print("device:", dev, _device_name(dev))
    if args.ply:
        model = _load_model(args)
        pos = model.means.detach().cpu().numpy()
        print(f"gaussians: {model.num_gaussians}")
        print(f"aabb: {pos.min(0)} .. {pos.max(0)}")
        keep = model.abnormal_mask().cpu().numpy()
        print(f"abnormal particles: {(~keep).sum()}")


#: train options of the JAX CLI whose paths are not ported yet
_NOT_PORTED = {
    "bands": "banded training, ROADMAP.md section 1 item 8",
    "span_bands": "banded training, ROADMAP.md section 1 item 8",
    "balance_bands": "banded training, ROADMAP.md section 1 item 8",
    "sort_scene": "sorted_for_camera, ROADMAP.md section 1 item 8",
    "optimize_poses": "pose refinement, ROADMAP.md section 1 item 9",
    "perturb_poses": "pose refinement, ROADMAP.md section 1 item 9",
    "devices": "the sharded trainer, ROADMAP.md section 1 item 11",
}


def cmd_train(args):
    from .config import DEFAULT_CONFIG
    from .io.image import load_png
    from .parallel import camera_batch
    from .render.tiled import TiledRenderer
    from .train import TrainConfig, Trainer
    from .utils.metrics import psnr
    for opt, where in _NOT_PORTED.items():
        if getattr(args, opt):
            raise SystemExit(f"train --{opt.replace('_', '-')}: not ported "
                             f"yet ({where})")
    if args.optimizer != "adam" or args.banded_remat != "full":
        raise SystemExit(f"train --optimizer {args.optimizer} / "
                         f"--banded-remat {args.banded_remat}: not ported yet "
                         f"(ROADMAP.md section 1 items 8-9)")
    model = _load_model(args)
    cams = _cameras(args, model)
    if args.images_dir:
        targets, kept = [], []
        for cam in cams:
            path = os.path.join(args.images_dir, cam.name + ".png")
            if os.path.exists(path):
                targets.append(load_png(path).astype(np.float32) / 255.0)
                kept.append(cam)
        cams = kept
    else:
        # self-distillation: fit to the model's own renders
        r = TiledRenderer(args.width, args.height, DEFAULT_CONFIG,
                          impl=args.impl, device=args.device)
        r.plan(model, cams[:4])
        with torch.no_grad():
            targets = [r.render(model, c)["rgb"].cpu().numpy() for c in cams]
    planner = TiledRenderer(args.width, args.height, DEFAULT_CONFIG,
                            impl=args.impl, device=args.device)
    capacity = planner.plan(model, cams[: min(8, len(cams))])
    tc = TrainConfig(total_steps=args.steps, optimizer=args.optimizer)
    trainer = Trainer(args.width, args.height, DEFAULT_CONFIG, tc, capacity,
                      impl=args.impl, device=args.device)
    state = trainer.init(model)
    start_step = 0
    if args.ckpt_dir:
        from .train import restore_checkpoint
        state, restored = restore_checkpoint(args.ckpt_dir, state)
        if restored is not None:
            start_step = restored + 1
            print(f"resumed from checkpoint step {restored}")
    dev = trainer.device
    rng = np.random.default_rng(0)
    # held-out PSNR on cams[0], which the training pool EXCLUDES
    eval_r = TiledRenderer(args.width, args.height, DEFAULT_CONFIG,
                           capacity=capacity, impl=args.impl, device=dev)
    train_pool = np.arange(1, len(cams)) if len(cams) > 1 else np.arange(1)
    bsz = min(args.batch, len(train_pool))
    for step in range(start_step, args.steps):
        idx = rng.choice(train_pool, size=bsz, replace=False)
        batch = camera_batch([cams[i] for i in idx], DEFAULT_CONFIG, dev)
        tgt = torch.stack([torch.as_tensor(targets[i], device=dev)
                           for i in idx])
        state, loss = trainer.step(state, batch, tgt)
        if step % max(1, args.steps // 20) == 0:
            with torch.no_grad():
                out = eval_r.render(state[0], cams[0])
            p = psnr(out["rgb"].cpu().numpy() * 255.0,
                     np.asarray(targets[0]) * 255.0)
            print(f"step {step}: loss {float(loss):.6f} psnr {p:.2f}")
        if args.ckpt_dir and args.ckpt_every and \
                (step + 1) % args.ckpt_every == 0:
            from .train import save_checkpoint
            save_checkpoint(args.ckpt_dir, state, step)
    if args.ckpt_dir:
        from .train import save_checkpoint
        save_checkpoint(args.ckpt_dir, state, args.steps - 1)
    state[0].to_ply(args.out)
    print(f"saved fine-tuned model to {args.out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="3dgvrt_lightfield_tpu_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render orbit/dataset views to PNG")
    _common(pr)
    pr.add_argument("--out", default="results/output")
    pr.add_argument("--frames", type=int, default=8)
    pr.add_argument("--hit-counts", action="store_true",
                    help="dump per-pixel hit counts (ENABLE_HIT_COUNTS)")
    pr.add_argument("--dump-poses", action="store_true",
                    help="write camera_poses.json (hotkey P analog)")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("benchmark", help="timed fps loop (-b)")
    _common(pb)
    pb.add_argument("--benchwarmup", "-bw", type=float, default=1.0)
    pb.add_argument("--benchruntime", "-br", type=float, default=10.0)
    pb.add_argument("--benchframes", "-bf", type=int, default=-1)
    pb.add_argument("--benchfilename", "-bt", default="fps.txt")
    pb.add_argument("--benchframetimes", action="store_true", default=True)
    pb.add_argument("--frames", type=int, default=1)
    pb.set_defaults(fn=cmd_benchmark)

    pt = sub.add_parser("train", help="Adam fine-tune on one card")
    _common(pt)
    pt.add_argument("--images-dir", help="target PNGs named per camera")
    pt.add_argument("--steps", type=int, default=200)
    pt.add_argument("--batch", type=int, default=1)
    pt.add_argument("--frames", type=int, default=16)
    pt.add_argument("--out", default="finetuned.ply")
    pt.add_argument("--optimizer", default="adam",
                    choices=["adam", "adafactor"],
                    help="adafactor is not ported yet")
    pt.add_argument("--ckpt-dir", help="checkpoint/resume directory")
    pt.add_argument("--ckpt-every", type=int, default=50,
                    help="save a checkpoint every N steps")
    # options of the JAX CLI whose paths are not ported yet: kept in the
    # parser, refused at run time
    pt.add_argument("--bands", type=int, default=0, help="not ported yet")
    pt.add_argument("--span-bands", action="store_true",
                    help="not ported yet")
    pt.add_argument("--balance-bands", action="store_true",
                    help="not ported yet")
    pt.add_argument("--sort-scene", action="store_true",
                    help="not ported yet")
    pt.add_argument("--banded-remat", default="full",
                    choices=["full", "gather", "none"],
                    help="not ported yet (banded training)")
    pt.add_argument("--devices", type=int, default=0, help="not ported yet")
    pt.add_argument("--optimize-poses", type=int, default=0,
                    metavar="STEPS", help="not ported yet")
    pt.add_argument("--perturb-poses", type=float, default=0.0,
                    metavar="SIGMA", help="not ported yet")
    pt.set_defaults(fn=cmd_train)

    pi = sub.add_parser("info", help="device + scene info")
    pi.add_argument("--ply")
    pi.add_argument("--device", default=None)
    pi.add_argument("--filter-abnormal", action="store_true")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
