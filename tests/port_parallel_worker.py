"""One rank of a run of the port's multi-device code, for the parity tests
of `tests/test_torch_parallel.py`, `tests/test_torch_lightfield.py`,
`tests/test_torch_data_parallel.py` and `tests/test_torch_tracing.py`
(gloo ranks on the CPU), and of `tests/test_torch_cuda.py` (NCCL ranks,
one a card: the modes ending in "_cuda").

Each test starts one run through `start_ranks`: `world` processes of this
script, joined by a `file://` rendezvous under the test's own directory
(so concurrent test workers never meet), with a timeout for the run.  The
inputs (scene leaves, camera poses, training targets) come from the test
in `inputs.npz`; rank r writes its results to `out{r}.npz`.  The worker
imports torch and the port only.

    python tests/port_parallel_worker.py MODE WORKDIR RANK WORLD
"""

import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the batch and training scene: 16^2 at tile 8 (tests/test_parallel_train.py)
RES, BATCH = 16, 4
#: the tile-sharded frame: 32^2 at tile 8, chunk 64 (tests/test_tile_sharding)
TILE_RES = 32
TRAIN_TARGET = 0.3
OPTIMIZERS = ("adam", "adafactor")
#: the light field's sharded run (tests/test_lightfield.py's config)
LF_SIZE, LF_TILE = 40, 8
#: the data-parallel steps: 64^2 at tile 16, chunk 64, one view a rank
DP_RES, DP_FOVY = 64, 50.0


def cfg_batch(gt):
    return gt.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=128)


def cfg_tile(gt):
    return gt.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=64)


def cameras(gt, c2ws, res):
    return [gt.Camera.from_fovy(res, res, 60.0, c2w) for c2w in c2ws]


def start_ranks(mode, workdir, world=2, timeout=240):
    """Start `world` ranks of this script; returns `finish()`, which waits
    for them and raises if one failed or the run outlasted `timeout`
    seconds from its start (every rank is then killed).  The caller can
    work meanwhile."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    deadline = time.monotonic() + timeout
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(workdir),
         str(r), str(world)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for r in range(world)]

    def finish():
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        if any(codes):
            raise RuntimeError(f"{mode} ranks exited {codes}:\n"
                               + "\n".join(logs))
    return finish


def _parallel(gt, mesh, inputs):
    """Sharded batch renders, the tile-sharded frame and its gradients, and
    one Trainer(mesh) step per optimizer."""
    import torch
    from gvrt_tpu_torch.parallel import sharding as sh
    from gvrt_tpu_torch.render.rows_vjp import frame_params
    from gvrt_tpu_torch.render.tiled import TiledRenderer
    leaves = {k: inputs[k] for k in gt.models.gaussians.LEAVES}
    out = {}
    model = sh.replicate_model(gt.GaussianModel.from_numpy(leaves, "cpu"),
                               mesh)
    cfg = cfg_batch(gt)
    cams = cameras(gt, inputs["c2w"], RES)
    cap = TiledRenderer(RES, RES, cfg, device="cpu").plan(model, cams)
    batch = sh.camera_batch(cams, cfg, "cpu")
    with torch.no_grad():
        out["batch"] = sh.render_batch_sharded(model, batch, mesh, RES, RES,
                                               cfg, *cap).numpy()
        act, rows = frame_params(model, cfg)
        out["batch_unsharded"] = torch.stack([sh._render_one(
            act, rows, batch.w2c[i], batch.proj[i], batch.rays[i], RES, RES,
            cfg, *cap, "torch") for i in range(BATCH)]).numpy()

    tcfg = cfg_tile(gt)
    cam = gt.Camera.from_fovy(TILE_RES, TILE_RES, 60.0, np.eye(4))
    capacity = sh.plan_capacity_sharded(model, cam, mesh.size, tcfg)
    img = sh.render_image_tile_sharded(model, cam, mesh, tcfg,
                                       capacity=capacity)
    out["tile_image"] = img.detach().numpy()
    ((img[..., 0:3] - TRAIN_TARGET) ** 2).mean().backward()
    sh.average_gradients(model, mesh)
    for k in gt.models.gaussians.LEAVES:
        out[f"tile_grad_{k}"] = getattr(model, k).grad.numpy()

    targets = torch.as_tensor(inputs["targets"])
    for opt in OPTIMIZERS:
        m = gt.GaussianModel.from_numpy(leaves, "cpu")
        tr = gt.train.Trainer(RES, RES, cfg,
                              gt.train.TrainConfig(optimizer=opt), cap,
                              mesh=mesh, device="cpu")
        state, loss = tr.step(tr.init(m), batch, targets)
        out[f"{opt}_loss"] = np.float32(loss)
        for k in gt.models.gaussians.LEAVES:
            out[f"{opt}_{k}"] = getattr(state[0], k).detach().numpy()
    return out


def cfg_dp(gt):
    return gt.DEFAULT_CONFIG.replace(tile_size=16, chunk_size=64)


def _data_parallel(gt, mesh, inputs):
    """`Trainer(mesh)` steps, as `train --devices N` takes them: each step
    a batch of the inputs' views (c2w (steps, B, 4, 4)) with its targets
    ((steps, B, H, W, 3)); after step k the loss, each leaf's averaged
    gradient and each leaf."""
    import torch
    from gvrt_tpu_torch.models.gaussians import LEAVES
    from gvrt_tpu_torch.parallel import sharding as sh
    from gvrt_tpu_torch.render.tiled import TiledRenderer
    leaves = {k: inputs[k] for k in LEAVES}
    model = sh.replicate_model(gt.GaussianModel.from_numpy(leaves, "cpu"),
                               mesh)
    cfg = cfg_dp(gt)
    steps = [[gt.Camera.from_fovy(DP_RES, DP_RES, DP_FOVY, c2w)
              for c2w in views] for views in inputs["c2w"]]
    cap = TiledRenderer(DP_RES, DP_RES, cfg, device=mesh.device).plan(
        model, [c for views in steps for c in views])
    tr = gt.train.Trainer(DP_RES, DP_RES, cfg, gt.train.TrainConfig(), cap,
                          mesh=mesh)
    state = tr.init(model)
    out = {}
    for k, cams in enumerate(steps):
        batch = sh.camera_batch(cams, cfg, mesh.device)
        targets = torch.as_tensor(inputs["targets"][k], device=mesh.device)
        state, loss = tr.step(state, batch, targets)
        out[f"loss{k}"] = np.float32(loss.cpu())
        for name, p in zip(LEAVES, model.leaves()):
            out[f"grad{k}_{name}"] = p.grad.cpu().numpy().copy()
            out[f"param{k}_{name}"] = p.detach().cpu().numpy().copy()
    return out


def _tracing(gt, mesh, inputs):
    """The data-parallel steps under `utils.profiling.trace()`: the
    program's record of them, as JSON."""
    import json
    import tempfile
    from gvrt_tpu_torch.utils import profiling
    with tempfile.TemporaryDirectory() as logdir, profiling.trace(logdir):
        _data_parallel(gt, mesh, inputs)
    return {"record": np.array(json.dumps(profiling.recorded()))}


def _lightfield(gt, mesh, inputs):
    leaves = {k: inputs[k] for k in gt.models.gaussians.LEAVES}
    model = gt.GaussianModel.from_numpy(leaves, "cpu")
    lf = gt.models.LightFieldConfig(width=LF_SIZE, height=LF_SIZE,
                                    tile_size=LF_TILE)
    res = gt.models.compute_light_field(model, lf, mesh=mesh)
    return {"images": res["images"], "ray_dirs": res["ray_dirs"]}


MODES = {"parallel": _parallel, "lightfield": _lightfield,
         "data_parallel": _data_parallel, "tracing": _tracing,
         "data_parallel_cuda": _data_parallel}


def main(mode, workdir, rank, world):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch.parallel import init_distributed, make_mesh
    devices = ([f"cuda:{r}" for r in range(world)] if mode.endswith("_cuda")
               else ["cpu"] * world)
    init_distributed(f"file://{os.path.join(workdir, 'rendezvous')}", world,
                     rank, device=devices[rank])
    try:
        mesh = make_mesh(world, devices=devices)
        inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = MODES[mode](gt, mesh, inputs)
        np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
