"""PyTorch port, the training slice as a whole, on the CPU.

* Per-leaf gradients of an L2 (+ depth) loss through
  `TiledRenderer.render_bound` (on JAX's own topology, carried as NumPy)
  and through `render` (each package bins for itself) against `jax.grad`
  with impl="scan".  Tolerance per leaf: atol = max(2e-5 * scale, 1e-7),
  rtol = 2e-4, `scale` the leaf's max |grad| (tests/test_backward.py:53-58),
  on scenes of scales >= ~0.1 (ROADMAP.md section 3, the FMA note).
* One Adam step schedule of `make_optimizer` against optax on the same
  gradients: parameters within 1e-6 relative.
* A 3-step `Trainer` run whose loss falls, a checkpoint round trip, and the
  `train` CLI on a tiny scene (also with `--optimize-poses
  --perturb-poses --optimizer adafactor`; `--devices` is still refused).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gvrt_tpu as g3
import gvrt_tpu_torch as gt
from gvrt_tpu.render.tiled import TiledRenderer as JaxTiledRenderer
from gvrt_tpu.train.trainer import TrainConfig as JaxTrainConfig
from gvrt_tpu.train.trainer import make_optimizer as jax_make_optimizer
from gvrt_tpu_torch.app import main as cli_main
from gvrt_tpu_torch.models.gaussians import LEAVES
from gvrt_tpu_torch.render import binning as tb
from gvrt_tpu_torch.render import segreduce as tsr
from gvrt_tpu_torch.train import (TrainConfig, Trainer, latest_step,
                                  make_optimizer, restore_checkpoint,
                                  save_checkpoint)
from gvrt_tpu_torch.parallel import camera_batch

from port_scenes import (CFG_T8, assert_grad_close, camera, carry, jax_scene,
                         torch_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scene(seed):
    return jax_scene(200, seed=seed, spread=0.6, scale_range=(-2.3, -1.6))


def _jax_loss(out):
    return (jnp.mean((out["rgb"] - 0.25) ** 2)
            + 1e-2 * jnp.mean(out["depth"]))


def _torch_loss(out):
    return ((out["rgb"] - 0.25) ** 2).mean() + 1e-2 * out["depth"].mean()


def _carry_topology(topo):
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    red = tsr.ReducePlan(*(t(x) for x in topo.red))
    return tb.BinTopology(*(t(x) for x in topo[:-1]), red=red)


@pytest.mark.parametrize("prod", [True, False], ids=["prod", "logspace"])
def test_render_bound_grads_match_jax_scan(prod):
    cfg = g3.DEFAULT_CONFIG.replace(transmittance_prod=prod)
    jm = _scene(41)
    cam = camera(32)
    jr = JaxTiledRenderer(32, 32, cfg, impl="scan")
    jr.plan(jm, [cam])
    topo = jr.bind(jm, cam)
    want = jax.grad(lambda m: _jax_loss(jr.render_bound(m)))(jm)

    tm = carry(jm)
    tr = gt.render.TiledRenderer(32, 32, torch_cfg(cfg), device="cpu")
    tr._bound = (_carry_topology(topo), tr._rays(cam))
    _torch_loss(tr.render_bound(tm)).backward()
    for k in LEAVES:
        assert np.abs(np.asarray(getattr(want, k))).max() > 0, k
        assert_grad_close(getattr(tm, k).grad.numpy(), getattr(want, k), k)


def test_render_grads_match_jax_scan():
    jm = _scene(42)
    cam = camera(32)
    jr = JaxTiledRenderer(32, 32, CFG_T8, impl="scan")
    cap = jr.plan(jm, [cam])
    want = jax.grad(lambda m: _jax_loss(jr.render(m, cam)))(jm)

    tm = carry(jm)
    tr = gt.render.TiledRenderer(32, 32, torch_cfg(CFG_T8), capacity=cap,
                                 device="cpu")
    out = tr.render(tm, cam)
    assert out["rgb"].requires_grad and int(out["overflow"]) == 0
    _torch_loss(out).backward()
    for k in LEAVES:
        assert_grad_close(getattr(tm, k).grad.numpy(), getattr(want, k), k)
    # without grad the frame is the serving one: no reduce plan is built
    with torch.no_grad():
        out = tr.render(tm, cam)
    assert not out["rgb"].requires_grad


def test_adam_steps_match_optax():
    tc = TrainConfig(total_steps=4, lr_means=1e-2)
    jtc = JaxTrainConfig(total_steps=4, lr_means=1e-2)
    jm = _scene(43)
    opt_j = jax_make_optimizer(jtc)
    state_j = opt_j.init(jm)
    tm = carry(jm)
    opt_t = make_optimizer(tc, tm)
    rng = np.random.default_rng(5)
    for step in range(3):
        grads = {k: rng.normal(size=np.shape(getattr(jm, k))).astype(
            np.float32) * 10.0 ** (-step) for k in LEAVES}
        updates, state_j = opt_j.update(
            type(jm)(**{k: jnp.asarray(v) for k, v in grads.items()}),
            state_j, jm)
        jm = optax.apply_updates(jm, updates)
        for k in LEAVES:
            getattr(tm, k).grad = torch.from_numpy(grads[k])
        opt_t.step()
        for k in LEAVES:
            want = np.asarray(getattr(jm, k))
            np.testing.assert_allclose(getattr(tm, k).detach().numpy(), want,
                                       rtol=1e-6, atol=1e-6 * np.abs(
                                           want).max(), err_msg=k)
    assert opt_t.updates() == 3
    assert opt_t.param_groups[0]["lr"] == pytest.approx(
        1e-2 * 0.01 ** (2 / 4))


def _trainer_setup(tmp_res=32):
    cfg = torch_cfg(CFG_T8)
    tm = carry(_scene(44))
    cams = [camera(tmp_res, fov) for fov in (55.0, 60.0, 65.0)]
    target_model = carry(_scene(44))
    with torch.no_grad():
        target_model.sh_dc += 0.3
    r = gt.render.TiledRenderer(tmp_res, tmp_res, cfg, device="cpu")
    cap = r.plan(tm, cams)
    with torch.no_grad():
        targets = torch.stack([r.render(target_model, c)["rgb"]
                               for c in cams])
    return cfg, tm, cams, targets, cap


def test_trainer_loss_falls():
    cfg, tm, cams, targets, cap = _trainer_setup()
    trainer = Trainer(32, 32, cfg, TrainConfig(total_steps=3), cap,
                      device="cpu")
    state = trainer.init(tm)
    batch = camera_batch(cams[:2], cfg, "cpu")
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, batch, targets[:2])
        losses.append(float(loss))
    assert losses[2] < losses[1] < losses[0], losses


def test_trainer_refuses_what_is_not_ported():
    cfg = torch_cfg(CFG_T8)
    with pytest.raises(NotImplementedError, match='"Multi-device"'):
        Trainer(32, 32, cfg, mesh=object(), device="cpu")
    # Adafactor is accepted (tests/test_torch_adafactor.py)
    trainer = Trainer(32, 32, cfg, TrainConfig(optimizer="adafactor"),
                      device="cpu")
    assert isinstance(trainer.init(carry(_scene(44)))[1],
                      gt.train.trainer.GroupAdafactor)
    # banded training is ported (tests/test_torch_banded.py)
    assert Trainer(32, 32, cfg, n_bands=2, device="cpu").n_bands == 2


def test_checkpoint_round_trip(tmp_path):
    cfg, tm, cams, targets, cap = _trainer_setup()
    trainer = Trainer(32, 32, cfg, TrainConfig(total_steps=3), cap,
                      device="cpu")
    state = trainer.init(tm)
    batch = camera_batch(cams[:1], cfg, "cpu")
    state, _ = trainer.step(state, batch, targets[:1])
    ckpt = str(tmp_path / "ckpt")
    assert latest_step(ckpt) is None
    path = save_checkpoint(ckpt, state, 0)
    assert os.path.isdir(path) and latest_step(ckpt) == 0
    saved = {k: getattr(tm, k).detach().clone() for k in LEAVES}
    moments = state[1].state_dict()["state"][0]["exp_avg"].clone()
    state, _ = trainer.step(state, batch, targets[:1])
    save_checkpoint(ckpt, state, 1)
    assert latest_step(ckpt) == 1
    state, step = restore_checkpoint(ckpt, state, step=0)
    assert step == 0
    for k in LEAVES:
        torch.testing.assert_close(getattr(tm, k).detach(), saved[k],
                                   rtol=0, atol=0)
    torch.testing.assert_close(state[1].state_dict()["state"][0]["exp_avg"],
                               moments, rtol=0, atol=0)
    assert state[1].updates() == 1
    _, step = restore_checkpoint(ckpt, state)
    assert step == 1 and state[1].updates() == 2
    assert sorted(os.listdir(ckpt)) == ["latest.txt", "step_00000000",
                                        "step_00000001"]


def test_cli_train_cpu(tmp_path):
    ply = str(tmp_path / "scene.ply")
    model = carry(jax_scene(150, seed=45, spread=0.5))
    model.to_ply(ply)
    # targets: 8-bit renders of the scene with its colours shifted, named
    # per orbit camera (self-distillation would start at loss 0)
    with torch.no_grad():
        model.sh_dc += 0.2
    model.to_ply(str(tmp_path / "target.ply"))
    cli_main(["render", "--device", "cpu", "--ply",
              str(tmp_path / "target.ply"), "--width", "32", "--height", "32",
              "--frames", "3", "--out", str(tmp_path / "targets")])
    out = str(tmp_path / "tuned.ply")
    env = dict(os.environ, PYTHONPATH=REPO)
    base = [sys.executable, "-m", "3dgvrt_lightfield_tpu_torch", "train",
            "--device", "cpu", "--ply", ply, "--width", "32", "--height",
            "32", "--frames", "3", "--batch", "1"]
    proc = subprocess.run(base + ["--steps", "2", "--out", out, "--ckpt-dir",
                                  str(tmp_path / "ckpt"), "--images-dir",
                                  str(tmp_path / "targets")],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    psnrs = [float(line.split("psnr")[1]) for line in proc.stdout.splitlines()
             if "psnr" in line]
    assert psnrs and all(np.isfinite(psnrs))
    tuned = gt.GaussianModel.from_ply(out, device="cpu")
    assert tuned.num_gaussians == 150
    assert latest_step(str(tmp_path / "ckpt")) == 1
    # pose refinement before the fine-tune, then Adafactor
    proc = subprocess.run(base + ["--steps", "1", "--optimize-poses", "3",
                                  "--perturb-poses", "0.02", "--optimizer",
                                  "adafactor", "--out", out, "--images-dir",
                                  str(tmp_path / "targets")],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "pose-opt:" in proc.stdout and "cameras improved" in proc.stdout
    # the sharded trainer is still refused
    proc = subprocess.run(base + ["--steps", "1", "--devices", "2"],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=300)
    assert proc.returncode != 0 and "not ported yet" in proc.stderr
    assert '"Multi-device"' in proc.stderr
