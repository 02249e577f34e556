"""One rank of a 2-rank gloo run of the port's multi-device code, for the
parity tests of `tests/test_torch_parallel.py` and
`tests/test_torch_lightfield.py`.

Each test module starts one run through `start_ranks`: two processes of this
script on the CPU, joined by a `file://` rendezvous under the test's own
directory (so concurrent test workers never meet), each with its own
timeout.  The inputs (scene leaves, camera poses, training targets) come
from the test in `inputs.npz`; rank r writes its results to `out{r}.npz`.
The worker imports torch and the port only.

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
        act = model.activate()
        out["batch_unsharded"] = torch.stack([sh._render_one(
            act, batch.w2c[i], batch.proj[i], batch.rays[i], RES, RES, cfg,
            *cap, "torch") for i in range(BATCH)]).numpy()

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


def _lightfield(gt, mesh, inputs):
    leaves = {k: inputs[k] for k in gt.models.gaussians.LEAVES}
    model = gt.GaussianModel.from_numpy(leaves, "cpu")
    lf = gt.models.LightFieldConfig(width=LF_SIZE, height=LF_SIZE,
                                    tile_size=LF_TILE)
    res = gt.models.compute_light_field(model, lf, mesh=mesh)
    return {"images": res["images"], "ray_dirs": res["ray_dirs"]}


def main(mode, workdir, rank, world):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed(f"file://{os.path.join(workdir, 'rendezvous')}", world,
                     rank, device="cpu")
    try:
        mesh = make_mesh(world, devices=["cpu"] * world)
        inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = {"parallel": _parallel, "lightfield": _lightfield}[mode](
            gt, mesh, inputs)
        np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
