"""Headless viewer / CLI of the PyTorch port.

Subcommands (the JAX package's CLI, as far as this port reaches):

  render     orbit or dataset-camera renders -> PNG sequence
  benchmark  warmup + timed fps loop, CSV out   (-b -bw -br -bf -bt)
  eval       render dataset cameras + PSNR/SSIM vs ground truth (EVAL_QUALITY)
  lightfield Gaussian light-field precompute    (GAUSSIAN_LIGHT_FIELD)
  info       device / scene info
  hybrid     mesh G-buffer + ray-traced lighting demo (VulkanHybrid):
             a glTF scene or the procedural cornell box -> PNG sequence
  train      Adam or Adafactor fine-tune (self-distillation or
             --images-dir), optionally after refining the camera poses
             (--optimize-poses, --perturb-poses)

`--bands N` renders and trains in N sequential tile-row bands (bounded
memory for garden-scale scenes, `render/banded.py`).  `render` and
`benchmark` take `--mesh NAME|PATH.glb`: opaque mesh objects inserted into
the scene, served with it in one frame (`render/combined.py`).
`train --devices N` shards each camera batch over N ranks, one per card
(`parallel/`).
Everything runs on the card unless ``--device cpu`` is given.

Run as:  python -m 3dgvrt_lightfield_tpu_torch <subcommand> [...]
"""

from __future__ import annotations

import argparse
import math
import os
import sys

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
    p.add_argument("--bands", type=int, default=0,
                   help="render in N sequential tile-row bands (bounded "
                        "memory for garden-scale scenes; render/banded.py)")
    p.add_argument("--span-bands", action="store_true",
                   help="contiguous tile-row bands + live-id windows "
                        "(training only; pairs best with a y-sorted model, "
                        "GaussianModel.sorted_for_camera)")
    p.add_argument("--balance-bands", action="store_true",
                   help="pair-balanced span bands: rows at the survivor-"
                        "pair quantiles, per-band capacities (implies "
                        "--span-bands; training only)")


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


def _mesh_renderer(args, model, cams):
    """The `CombinedRenderer` of `--mesh`, planned over up to 4 cameras.

    NAME is a procedural scene of `hybrid.mesh.PROCEDURAL`, placed in the
    model's bounds with z up (the orbit's up axis); PATH.glb (or .gltf)
    goes through `hybrid.load_gltf`."""
    from .config import DEFAULT_CONFIG
    from .hybrid import load_gltf
    from .hybrid.mesh import PROCEDURAL
    from .render.combined import CombinedRenderer
    if args.bands:
        raise SystemExit("--mesh renders unbanded frames: drop --bands")
    if args.mesh in PROCEDURAL:
        pos = model.means.detach().cpu().numpy()
        scene = PROCEDURAL[args.mesh](pos.min(0), pos.max(0), up=2)
    elif args.mesh.endswith((".glb", ".gltf")) and os.path.isfile(args.mesh):
        scene = load_gltf(args.mesh)
    else:
        raise SystemExit(f"--mesh {args.mesh!r}: neither a procedural scene "
                         f"({', '.join(PROCEDURAL)}) nor a .glb/.gltf file")
    r = CombinedRenderer(args.width, args.height, scene, DEFAULT_CONFIG,
                         impl=args.impl, device=args.device)
    r.plan(model, cams[: min(4, len(cams))])
    return r


def _mesh_flag(p):
    p.add_argument("--mesh", metavar="NAME|PATH.glb",
                   help="insert opaque mesh objects: a procedural scene "
                        "placed in the scene's bounds (quad_icosphere: a "
                        "floor and a ball, one light) or a glTF file")


class _BandedFrames:
    """Per-frame banded rendering with a shared (max-merged) capacity plan
    and the overflow -> re-plan-once contract of TiledRenderer.render;
    shared by `render`, `benchmark` and `eval`.  Frames render under
    no_grad."""

    def __init__(self, model, cams, requested_bands, impl):
        from .config import DEFAULT_CONFIG
        from .render.banded import plan_capacity_banded, resolve_bands_common
        self.cfg, self.impl = DEFAULT_CONFIG, impl
        # resolve from the cameras' heights: pose files may carry a height
        # other than --height
        self.n_bands = resolve_bands_common([c.height for c in cams],
                                            requested_bands, self.cfg)
        # plan over up to 4 representative cameras, like the unbanded path
        self.capacity = (0, 0)
        for c in cams[: min(4, len(cams))]:
            self._merge(plan_capacity_banded(model, c, self.n_bands,
                                             self.cfg))

    def _merge(self, cap):
        self.capacity = (max(self.capacity[0], cap[0]),
                         max(self.capacity[1], cap[1]))

    @torch.no_grad()
    def render(self, model, cam):
        from .render.banded import plan_capacity_banded, render_image_banded
        out = render_image_banded(model, cam, self.n_bands, self.cfg,
                                  capacity=self.capacity, impl=self.impl,
                                  device=model.device)
        if int(out["overflow"]) > 0:
            # capacity overflow drops pairs: re-plan for this camera
            # (max-merged) and re-render once
            self._merge(plan_capacity_banded(model, cam, self.n_bands,
                                             self.cfg))
            print(f"overflow -> re-planned capacity {self.capacity}",
                  file=sys.stderr)
            out = render_image_banded(model, cam, self.n_bands, self.cfg,
                                      capacity=self.capacity, impl=self.impl,
                                      device=model.device)
        return out


def cmd_render(args):
    from .config import DEFAULT_CONFIG
    from .io.image import save_png
    from .render.tiled import TiledRenderer
    from .utils.evaluate import save_hit_counts
    model = _load_model(args)
    cams = _cameras(args, model)[: args.frames]
    if args.mesh:
        r = _mesh_renderer(args, model, cams)
    elif args.bands:
        r = _BandedFrames(model, cams, args.bands, args.impl)
    else:
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
            save_hit_counts(out["hit_count"],
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
    if args.mesh:
        r = _mesh_renderer(args, model, [cam])
    elif args.bands:
        # the banded bounded-memory frame: what --bands is for at scale
        r = _BandedFrames(model, [cam], args.bands, args.impl)
    else:
        r = TiledRenderer(args.width, args.height, DEFAULT_CONFIG,
                          impl=args.impl, device=args.device)
        r.plan(model, [cam])

    def frame():
        with torch.no_grad():
            r.render(model, cam)
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    res = run_benchmark(frame, warmup=args.benchwarmup,
                        duration=args.benchruntime,
                        output_frames=args.benchframes,
                        device=_device_name(model.device))
    save_results(res, args.benchfilename, frame_times=args.benchframetimes)
    rays = args.width * args.height
    print(f"rays/s : {rays * res.fps / 1e6:.2f}M")


def cmd_eval(args):
    from .utils.evaluate import evaluate_dirs, render_eval_set
    model = _load_model(args)
    cams = _cameras(args, model)[: args.frames]
    # --bands renders through the bounded-memory banded renderer, as
    # render and benchmark do
    renderer = (_BandedFrames(model, cams, args.bands, args.impl)
                if args.bands else None)
    paths = render_eval_set(model, cams, args.out, impl=args.impl,
                            renderer=renderer, device=model.device)
    print(f"rendered {len(paths)} views to {args.out}")
    if args.gt_dir:
        evaluate_dirs(args.gt_dir, [args.out])


def cmd_info(args):
    from .config import resolve_device
    print("torch:", torch.__version__)
    dev = resolve_device(args.device)
    print("device:", dev, _device_name(dev))
    if args.ply:
        model = _load_model(args)
        lo, hi = (x.detach().cpu().numpy() for x in model.scene_aabb())
        print(f"gaussians: {model.num_gaussians}")
        print(f"aabb: {lo} .. {hi}")
        keep = model.abnormal_mask().cpu().numpy()
        print(f"abnormal particles: {(~keep).sum()}")


def cmd_hybrid(args):
    """VulkanHybrid analog: glTF (or procedural) mesh + RT lighting demo."""
    from .hybrid import (HybridConfig, HybridRenderer, cornell_scene,
                         load_gltf)
    from .io.cameras import Camera, look_at_inverse
    from .io.image import save_png
    if args.gltf:
        scene = load_gltf(args.gltf)
    else:
        scene = cornell_scene(with_mirror=True, with_glass=args.glass)
    cfg = HybridConfig(shadow_rays=not args.no_shadows,
                       reflection=not args.no_reflection,
                       refraction=not args.no_refraction)
    r = HybridRenderer(args.width, args.height, cfg, device=args.device)
    lo = scene.tri_pos.reshape(-1, 3).min(0)
    hi = scene.tri_pos.reshape(-1, 3).max(0)
    center = (lo + hi) / 2
    radius = float(np.linalg.norm(hi - lo)) * 0.9
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.frames):
        theta = 2 * math.pi * i / max(args.frames, 1)
        eye = center + radius * np.asarray(
            [math.sin(theta) * 0.35, 0.15, math.cos(theta)])
        c2w = look_at_inverse(eye, center, np.asarray([0.0, 1.0, 0.0]))
        cam = Camera.from_fovy(args.width, args.height, args.fovy, c2w)
        out = r.render(scene, cam, time=i / 24.0)
        path = os.path.join(args.out, f"hybrid_{i:04d}.png")
        save_png(path, out["rgb"].cpu().numpy())
        print(path)


class _BandedEval:
    """Held-topology banded eval renderer with a bind cache: topologies are
    rebound when the camera changes, after `refresh_every` renders, or when
    the held window overflows (the trainer's own staleness contract)."""

    def __init__(self, renderer, refresh_every: int):
        self._r, self._refresh = renderer, refresh_every
        self._key, self._age = None, 0

    @torch.no_grad()
    def render(self, model, cam):
        key = cam.content_key()
        if self._key != key or self._age >= self._refresh:
            self._r.bind(model, cam)
            self._key, self._age = key, 0
        self._age += 1
        out = self._r.render_bound(model)
        if int(out["overflow"]) > 0:
            # capacity outgrown by drift: bind re-plans eagerly
            self._r.bind(model, cam)
            self._age = 1
            out = self._r.render_bound(model)
        return out


def cmd_lightfield(args):
    from .models.lightfield import (LightFieldConfig, compute_light_field,
                                    save_light_field)
    model = _load_model(args)
    # largest tile size <= 20 that divides the image (180 -> 20, 96 -> 16...)
    tile = next(t for t in (20, 16, 12, 10, 8, 6, 5, 4, 2, 1)
                if args.size % t == 0)
    lf = LightFieldConfig(num_cameras=args.cameras, width=args.size,
                          height=args.size, tile_size=tile)
    res = compute_light_field(model, lf, impl=args.impl, device=model.device)
    print("\n".join(save_light_field(args.out, res)))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _train_rank(rank, args, init_method, devices):
    """One rank of `train --devices N`: join the process group (from
    torchrun's environment when `init_method` is None), then train on this
    rank's share of every camera batch."""
    import torch.distributed as dist
    from .parallel import init_distributed, make_mesh
    init_distributed(init_method, args.devices if init_method else None,
                     rank if init_method else None,
                     device=devices[rank] if devices else None)
    try:
        mesh = make_mesh(args.devices, devices=devices)
        args.device = str(mesh.device)
        _train(args, mesh)
    finally:
        dist.destroy_process_group()


def _train_sharded(args):
    """train --devices N: N ranks, one per card (NCCL), or N gloo ranks on
    the CPU with --device cpu.  Under torchrun this process is one rank of
    a world that must hold N; else the ranks are spawned here."""
    if args.bands:
        raise SystemExit("train --devices shards the camera batch; banded "
                         "training (--bands) runs on one card")
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    world = os.environ.get("WORLD_SIZE")
    if world:
        if int(world) != args.devices:
            raise SystemExit(f"train --devices {args.devices} in a world of "
                             f"{world} ranks")
        return _train_rank(int(os.environ["RANK"]), args, None,
                           ["cpu"] * args.devices if cpu else None)
    if not cpu and args.devices > torch.cuda.device_count():
        raise SystemExit(f"train --devices {args.devices}: "
                         f"{torch.cuda.device_count()} CUDA card(s) visible; "
                         f"each rank takes a card of its own")
    devices = ["cpu" if cpu else f"cuda:{r}" for r in range(args.devices)]
    init = f"tcp://localhost:{_free_port()}"
    if args.devices == 1:
        return _train_rank(0, args, init, devices)
    torch.multiprocessing.spawn(_train_rank, args=(args, init, devices),
                                nprocs=args.devices)


def cmd_train(args):
    if args.devices:
        return _train_sharded(args)
    return _train(args)


def _train(args, mesh=None):
    """The fine-tune, on one card or as one rank of `mesh`: then only the
    mesh's first rank prints and writes checkpoints and the PLY."""
    from .config import DEFAULT_CONFIG
    from .io.image import load_png
    from .parallel import camera_batch, replicate_model
    from .render.banded import (BandedRenderer, render_image_banded,
                                resolve_bands_common)
    from .render.tiled import TiledRenderer
    from .train import TrainConfig, Trainer
    from .utils.metrics import psnr
    lead = mesh is None or mesh.index == 0
    say = print if lead else (lambda *a, **k: None)
    model = _load_model(args)
    if mesh is not None:
        say(f"ranks: {mesh.size} ({mesh.backend})")
        model = replicate_model(model, mesh)
    cams = _cameras(args, model)
    if args.images_dir:
        targets, kept = [], []
        for cam in cams:
            path = os.path.join(args.images_dir, cam.name + ".png")
            if os.path.exists(path):
                targets.append(load_png(path).astype(np.float32) / 255.0)
                kept.append(cam)
        cams = kept
    elif args.bands:
        # self-distillation at garden scale: banded renders
        nb = resolve_bands_common([c.height for c in cams], args.bands,
                                  DEFAULT_CONFIG)
        with torch.no_grad():
            targets = [render_image_banded(
                model, c, nb, DEFAULT_CONFIG, impl=args.impl,
                device=model.device)["rgb"].cpu().numpy() for c in cams]
    else:
        # self-distillation: fit to the model's own renders
        r = TiledRenderer(args.width, args.height, DEFAULT_CONFIG,
                          impl=args.impl, device=args.device)
        r.plan(model, cams[:4])
        with torch.no_grad():
            targets = [r.render(model, c)["rgb"].cpu().numpy() for c in cams]
    if args.optimize_poses:
        # pose refinement: optionally perturb the dataset poses (the
        # recovery demo), then recover each camera's 6-DOF delta through the
        # ray cotangents before fine-tuning the Gaussians.  On a mesh the
        # first rank refines and hands every rank its cameras
        from .train import optimize_camera_poses, perturb_cameras
        reports = None
        if lead:
            if args.perturb_poses:
                cams = perturb_cameras(cams, args.perturb_poses)
                print(f"perturbed {len(cams)} poses by sigma_t="
                      f"{args.perturb_poses} (recovery demo)")
            cams, reports = optimize_camera_poses(
                model, cams, targets, DEFAULT_CONFIG,
                steps=args.optimize_poses, impl=args.impl)
        if mesh is not None and mesh.group is not None:
            import torch.distributed as dist
            shared = [cams, reports]
            dist.broadcast_object_list(
                shared, dist.get_global_rank(mesh.group, 0), mesh.group)
            cams, reports = shared
        improved = sum(1 for r in reports if r["loss1"] < r["loss0"])
        say(f"pose-opt: {improved}/{len(reports)} cameras improved, "
            f"mean loss {np.mean([r['loss0'] for r in reports]):.3e} -> "
            f"{np.mean([r['loss1'] for r in reports]):.3e}")
    span = args.span_bands or args.balance_bands
    tc = TrainConfig(total_steps=args.steps, optimizer=args.optimizer,
                     banded_remat=args.banded_remat, span_bands=span,
                     balance_bands=args.balance_bands)
    if args.sort_scene:
        # scene prep for span banding's live-id windows: a one-time y-sort
        # against the first camera
        model = model.sorted_for_camera(cams[0], DEFAULT_CONFIG)
    if args.bands:
        # the garden-scale path: banded training, one camera per step, held
        # per-band topologies.  Dims come from the cameras (pose files may
        # carry their own resolution)
        dims = {(c.width, c.height) for c in cams}
        if len(dims) != 1:
            raise SystemExit(f"train --bands needs one camera resolution, "
                             f"got {sorted(dims)}")
        (args.width, args.height), = dims
        if args.balance_bands:
            # balanced bands have variable row counts: any n <= tile rows
            n_bands = max(1, min(args.bands,
                                 args.height // DEFAULT_CONFIG.tile_size))
        else:
            n_bands = resolve_bands_common([c.height for c in cams],
                                           args.bands, DEFAULT_CONFIG)
        trainer = Trainer(args.width, args.height, DEFAULT_CONFIG, tc,
                          impl=args.impl, n_bands=n_bands,
                          device=model.device)
        capacity = None
    else:
        planner = TiledRenderer(args.width, args.height, DEFAULT_CONFIG,
                                impl=args.impl, device=args.device)
        capacity = planner.plan(model, cams[: min(8, len(cams))])
        trainer = Trainer(args.width, args.height, DEFAULT_CONFIG, tc,
                          capacity, mesh=mesh, impl=args.impl,
                          device=args.device)
    state = trainer.init(model)
    start_step = 0
    if args.ckpt_dir:
        from .train import restore_checkpoint
        state, restored = restore_checkpoint(args.ckpt_dir, state)
        if restored is not None:
            start_step = restored + 1
            say(f"resumed from checkpoint step {restored}")
    dev = trainer.device
    rng = np.random.default_rng(0)
    # held-out PSNR on cams[0], which the training pool EXCLUDES
    if args.bands:
        eval_r = _BandedEval(
            BandedRenderer(args.width, args.height, trainer.n_bands,
                           DEFAULT_CONFIG, impl=args.impl, span=span,
                           balance=args.balance_bands, device=dev),
            tc.refresh_every)
    else:
        eval_r = TiledRenderer(args.width, args.height, DEFAULT_CONFIG,
                               capacity=capacity, impl=args.impl, device=dev)
    train_pool = np.arange(1, len(cams)) if len(cams) > 1 else np.arange(1)
    bsz = min(args.batch, len(train_pool))
    if mesh is not None and bsz % mesh.size:
        raise SystemExit(f"train --devices {mesh.size}: a batch of {bsz} "
                         f"cameras does not split over the ranks (--batch)")
    for step in range(start_step, args.steps):
        idx = rng.choice(train_pool, size=bsz, replace=False)
        if args.bands:
            # banded steps take one camera at a time (held topologies are
            # per camera)
            i = int(idx[0])
            state, loss = trainer.step(
                state, cams[i], torch.as_tensor(targets[i], device=dev))
        else:
            batch = camera_batch([cams[i] for i in idx], DEFAULT_CONFIG, dev,
                                 impl=args.impl)
            tgt = torch.stack([torch.as_tensor(targets[i], device=dev)
                               for i in idx])
            state, loss = trainer.step(state, batch, tgt)
        if lead and step % max(1, args.steps // 20) == 0:
            with torch.no_grad():
                out = eval_r.render(state[0], cams[0])
            p = psnr(out["rgb"].cpu().numpy() * 255.0,
                     np.asarray(targets[0]) * 255.0)
            print(f"step {step}: loss {float(loss):.6f} psnr {p:.2f}")
        if lead and args.ckpt_dir and args.ckpt_every and \
                (step + 1) % args.ckpt_every == 0:
            from .train import save_checkpoint
            save_checkpoint(args.ckpt_dir, state, step)
    if not lead:
        return
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
    _mesh_flag(pr)
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("benchmark", help="timed fps loop (-b)")
    _common(pb)
    pb.add_argument("--benchwarmup", "-bw", type=float, default=1.0)
    pb.add_argument("--benchruntime", "-br", type=float, default=10.0)
    pb.add_argument("--benchframes", "-bf", type=int, default=-1)
    pb.add_argument("--benchfilename", "-bt", default="fps.txt")
    pb.add_argument("--benchframetimes", action="store_true", default=True)
    pb.add_argument("--frames", type=int, default=1)
    _mesh_flag(pb)
    pb.set_defaults(fn=cmd_benchmark)

    pe = sub.add_parser("eval", help="EVAL_QUALITY: render + PSNR/SSIM")
    _common(pe)
    pe.add_argument("--out", default="results/evaluations/output")
    pe.add_argument("--gt-dir", help="ground-truth PNG directory")
    pe.add_argument("--frames", type=int, default=10 ** 6)
    pe.set_defaults(fn=cmd_eval)

    pl = sub.add_parser("lightfield", help="GAUSSIAN_LIGHT_FIELD precompute")
    _common(pl)
    pl.add_argument("--out", default="results/lightfield")
    pl.add_argument("--cameras", type=int, default=4)
    pl.add_argument("--size", type=int, default=180)
    pl.set_defaults(fn=cmd_lightfield)

    pt = sub.add_parser("train", help="Adam or Adafactor fine-tune")
    _common(pt)
    pt.add_argument("--images-dir", help="target PNGs named per camera")
    pt.add_argument("--steps", type=int, default=200)
    pt.add_argument("--batch", type=int, default=1)
    pt.add_argument("--frames", type=int, default=16)
    pt.add_argument("--out", default="finetuned.ply")
    pt.add_argument("--optimizer", default="adam",
                    choices=["adam", "adafactor"])
    pt.add_argument("--ckpt-dir", help="checkpoint/resume directory")
    pt.add_argument("--ckpt-every", type=int, default=50,
                    help="save a checkpoint every N steps")
    pt.add_argument("--banded-remat", default="full",
                    choices=["full", "gather", "none"],
                    help="per-band recompute ladder for --bands training "
                         "(render/banded.py)")
    pt.add_argument("--sort-scene", action="store_true",
                    help="pre-sort the model by image row for the first "
                         "camera (scene prep for --span-bands live-id "
                         "windows; one-time cost)")
    pt.add_argument("--devices", type=int, default=0,
                    help="shard each camera batch over N ranks, one per card "
                         "(with --device cpu: N gloo ranks on the CPU)")
    pt.add_argument("--optimize-poses", type=int, default=0,
                    metavar="STEPS",
                    help="refine every camera pose for STEPS Adam steps "
                         "through the ray gradients before fine-tuning")
    pt.add_argument("--perturb-poses", type=float, default=0.0,
                    metavar="SIGMA",
                    help="jitter the poses first (translation sigma, "
                         "rotation sigma/3): the pose-recovery demo")
    pt.set_defaults(fn=cmd_train)

    ph = sub.add_parser("hybrid",
                        help="mesh G-buffer + RT lighting demo (VulkanHybrid)")
    ph.add_argument("--gltf", help=".gltf/.glb scene (default: cornell box)")
    ph.add_argument("--width", "-w", type=int, default=512)
    ph.add_argument("--height", type=int, default=512)
    ph.add_argument("--fovy", type=float, default=60.0)
    ph.add_argument("--frames", type=int, default=1)
    ph.add_argument("--out", default="results/hybrid")
    ph.add_argument("--glass", action="store_true",
                    help="refractive right sphere in the cornell demo")
    ph.add_argument("--no-shadows", action="store_true")
    ph.add_argument("--no-reflection", action="store_true")
    ph.add_argument("--no-refraction", action="store_true")
    ph.add_argument("--device", default=None,
                    help="torch device (default cuda; pass cpu for the CPU)")
    ph.set_defaults(fn=cmd_hybrid)

    pi = sub.add_parser("info", help="device + scene info")
    pi.add_argument("--ply")
    pi.add_argument("--device", default=None)
    pi.add_argument("--filter-abnormal", action="store_true")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
