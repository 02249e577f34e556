"""The port's multi-device rendering and training on two gloo ranks, against
the JAX package on its 8-device virtual CPU mesh (tests/conftest.py).

One 2-rank run of tests/port_parallel_worker.py per module (its own
rendezvous and timeout) renders a sharded camera batch, a tile-sharded
frame with its gradients, and takes one `Trainer(mesh)` step per
optimizer; the JAX side runs meanwhile in this process on `make_mesh(2)`
with impl="scan".  Tolerances: images 1e-5 (tests/test_parallel_train.py,
tests/test_tile_sharding.py); gradients 2e-4 of each leaf's largest
(tests/test_tile_sharding.py:65-91); the step's loss rtol 1e-5, means and
sh_dc atol 1e-6 (tests/test_parallel_train.py:90-111).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gvrt_tpu as g3
from gvrt_tpu.parallel import (camera_batch, make_mesh,
                               plan_capacity_sharded, render_batch_sharded,
                               render_image_tile_sharded)
from gvrt_tpu.render.tiled import TiledRenderer
from gvrt_tpu.train import TrainConfig, Trainer
from gvrt_tpu_torch.models.gaussians import LEAVES
from gvrt_tpu_torch.parallel import (data_parallel_mesh, init_distributed,
                                     make_mesh as torch_make_mesh)
from gvrt_tpu_torch.parallel.distributed import local_batch_slice

import port_parallel_worker as w
from port_scenes import carry, jax_scene, one_torch_thread  # noqa: F401

CFG = g3.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=128)
CFG_TILE = g3.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=64)
#: the leaves tests/test_tile_sharding.py compares
GRAD_LEAVES = ("means", "scales_log", "quats", "opacity_logit", "sh_dc")


def _c2ws():
    c2w = np.tile(np.eye(4), (w.BATCH, 1, 1))
    c2w[:, 0, 3] = 0.1 * np.arange(w.BATCH)
    return c2w


def _jax_side(model, targets):
    """The JAX package's sharded batch render, tile-sharded frame and its
    gradients, and one sharded Trainer step per optimizer, on make_mesh(2)."""
    mesh = make_mesh(2)
    cams = w.cameras(g3, _c2ws(), w.RES)
    capacity = TiledRenderer(w.RES, w.RES, CFG, impl="scan").plan(model,
                                                                  cams)
    batch = camera_batch(cams, CFG)
    ref = {"batch": np.asarray(render_batch_sharded(
        model, batch, mesh, w.RES, w.RES, CFG, *capacity, impl="scan"))}
    cam = g3.Camera.from_fovy(w.TILE_RES, w.TILE_RES, 60.0, np.eye(4))
    cap_tile = plan_capacity_sharded(model, cam, 2, CFG_TILE)

    def loss(m):
        img = render_image_tile_sharded(m, cam, mesh, CFG_TILE, impl="scan",
                                        capacity=cap_tile)
        return jnp.mean((img[..., 0:3] - w.TRAIN_TARGET) ** 2), img

    # jitted: the eager gradient of the shard_map takes ten times longer
    (_, img), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(model)
    ref["tile_image"] = np.asarray(img)
    for k in GRAD_LEAVES:
        ref[f"tile_grad_{k}"] = np.asarray(getattr(grads, k))
    for opt in w.OPTIMIZERS:
        tr = Trainer(w.RES, w.RES, CFG, TrainConfig(optimizer=opt), capacity,
                     mesh=mesh, impl="scan")
        state, loss_v = tr.step(tr.init(model), batch, jnp.asarray(targets))
        ref[f"{opt}_loss"] = float(loss_v)
        for k in ("means", "sh_dc"):
            ref[f"{opt}_{k}"] = np.asarray(getattr(state[0], k))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, [rank 0's, rank 1's]) of one 2-rank run."""
    work = tmp_path_factory.mktemp("two_ranks")
    model = jax_scene(64, seed=4, spread=0.7)
    targets = np.random.default_rng(0).uniform(
        0.2, 0.5, (w.BATCH, w.RES, w.RES, 3)).astype(np.float32)
    np.savez(work / "inputs.npz", c2w=_c2ws(), targets=targets,
             **{k: np.asarray(getattr(model, k)) for k in LEAVES})
    finish = w.start_ranks("parallel", work)
    try:
        ref = _jax_side(model, targets)
    finally:
        finish()
    return ref, [dict(np.load(work / f"out{r}.npz")) for r in range(2)]


def test_render_batch_sharded_matches_unsharded_and_jax(runs):
    ref, (r0, r1) = runs
    assert r0["batch"].shape == (w.BATCH, w.RES, w.RES, 8)
    np.testing.assert_array_equal(r0["batch"], r0["batch_unsharded"])
    np.testing.assert_array_equal(r0["batch"], r1["batch"])
    for ch in (slice(0, 3), slice(4, 5)):
        np.testing.assert_allclose(r0["batch"][..., ch], ref["batch"][..., ch],
                                   atol=1e-5)


def test_render_image_tile_sharded_matches_jax(runs):
    ref, (r0, r1) = runs
    np.testing.assert_array_equal(r0["tile_image"], r1["tile_image"])
    np.testing.assert_allclose(r0["tile_image"][..., 0:3],
                               ref["tile_image"][..., 0:3], atol=1e-5)
    np.testing.assert_allclose(r0["tile_image"][..., 4],
                               ref["tile_image"][..., 4], atol=1e-5)


def test_tile_sharded_gradients_match_jax(runs):
    ref, (r0, r1) = runs
    for k in GRAD_LEAVES:
        a, b = r0[f"tile_grad_{k}"], ref[f"tile_grad_{k}"]
        np.testing.assert_array_equal(a, r1[f"tile_grad_{k}"], err_msg=k)
        scale = np.abs(b).max() + 1e-8
        assert np.abs(b).max() > 0, k
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("opt", w.OPTIMIZERS)
def test_sharded_trainer_step_matches_jax(runs, opt):
    ref, (r0, r1) = runs
    np.testing.assert_allclose(float(r0[f"{opt}_loss"]), ref[f"{opt}_loss"],
                               rtol=1e-5)
    for k in ("means", "sh_dc"):
        np.testing.assert_allclose(r0[f"{opt}_{k}"], ref[f"{opt}_{k}"],
                                   atol=1e-6, err_msg=k)
    # every rank took the same step
    assert r0[f"{opt}_loss"] == r1[f"{opt}_loss"]
    for k in LEAVES:
        np.testing.assert_array_equal(r0[f"{opt}_{k}"], r1[f"{opt}_{k}"],
                                      err_msg=k)


def test_local_batch_slice_partitions():
    sls = [local_batch_slice(8, axis_size=4, index=i) for i in range(4)]
    seen = sorted(sum((list(range(s.start, s.stop)) for s in sls), []))
    assert seen == list(range(8))
    # the single process is the whole world
    assert local_batch_slice(6) == slice(0, 6)
    with pytest.raises(ValueError, match="does not split"):
        local_batch_slice(3, axis_size=2, index=0)


def test_init_distributed_single_process_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False


def test_data_parallel_mesh_covers_all_ranks():
    mesh = data_parallel_mesh(devices=["cpu"])
    assert (mesh.size, mesh.index, mesh.axis) == (1, 0, "cam")
    assert mesh.group is None and mesh.device.type == "cpu"


def test_make_mesh_refuses_more_ranks_than_the_world():
    with pytest.raises(ValueError, match="the world has 1"):
        torch_make_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="2 devices named for a mesh of 1"):
        torch_make_mesh(1, devices=["cpu", "cpu"])


def test_cli_train_under_torchrun(tmp_path):
    """`train --devices 2` as two ranks of torchrun's world (gloo on the
    CPU): the world must hold --devices ranks, and rank 0 alone prints
    and writes the PLY."""
    ply = str(tmp_path / "scene.ply")
    carry(jax_scene(64, seed=4, spread=0.7)).to_ply(ply)
    env = dict(os.environ, PYTHONPATH=w.REPO, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", "-m", "3dgvrt_lightfield_tpu_torch",
            "train", "--device", "cpu", "--ply", ply, "--width", "16",
            "--height", "16", "--frames", "3", "--batch", "2", "--steps", "1"]
    out = str(tmp_path / "tuned.ply")
    proc = subprocess.run(base + ["--devices", "2", "--out", out],
                          capture_output=True, text=True, cwd=w.REPO, env=env,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("ranks: 2 (gloo)") == 1
    assert proc.stdout.count("saved fine-tuned model") == 1
    assert os.path.exists(out)
    proc = subprocess.run(base + ["--devices", "3", "--out", out],
                          capture_output=True, text=True, cwd=w.REPO, env=env,
                          timeout=240)
    assert proc.returncode != 0
    assert "train --devices 3 in a world of 2 ranks" in proc.stderr
