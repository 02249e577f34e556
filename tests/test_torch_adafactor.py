"""PyTorch port, Adafactor (train/trainer.py::GroupAdafactor) against optax.

The JAX package builds its Adafactor per parameter group as optax 0.2.6's
`adafactor(learning_rate=lr, multiply_by_parameter_scale=False)`, the means
on the decayed schedule (train/trainer.py:66-79 there).  The port writes
that rule by hand; here it is held to optax on the same gradients:
parameters within 1e-6 relative after each of three steps, one of which
makes `clip_by_block_rms` bite, and the factored branch (which no model
leaf takes) on a synthetic (256, 130) leaf, updates within 1e-6 relative.
Then a `Trainer` run whose loss falls and a checkpoint round trip.
"""

import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gvrt_tpu.train.trainer import TrainConfig as JaxTrainConfig
from gvrt_tpu.train.trainer import make_optimizer as jax_make_optimizer
import gvrt_tpu_torch as gt
from gvrt_tpu_torch.models.gaussians import LEAVES
from gvrt_tpu_torch.parallel import camera_batch
from gvrt_tpu_torch.train import (TrainConfig, Trainer, make_optimizer,
                                  restore_checkpoint, save_checkpoint)
from gvrt_tpu_torch.train import trainer as ttrainer

from port_scenes import CFG_T8, camera, carry, jax_scene, torch_cfg
from port_scenes import one_torch_thread  # noqa: F401 (autouse)


def _scene(seed):
    return jax_scene(200, seed=seed, spread=0.6, scale_range=(-2.3, -1.6))


def test_adafactor_steps_match_optax():
    tc = TrainConfig(total_steps=4, lr_means=1e-2, optimizer="adafactor")
    jtc = JaxTrainConfig(total_steps=4, lr_means=1e-2, optimizer="adafactor")
    jm = _scene(46)
    opt_j = jax_make_optimizer(jtc)
    state_j = opt_j.init(jm)
    tm = carry(jm)
    opt_t = make_optimizer(tc, tm)
    assert isinstance(opt_t, ttrainer.GroupAdafactor)
    rng = np.random.default_rng(6)
    # step 1 scales every update to ~rms 1; step 2's gradients are 10x
    # larger, so its rms is ~1.3 and clip_by_block_rms(1.0) bites
    for step, scale in enumerate((1.0, 10.0, 0.1)):
        grads = {k: (rng.normal(size=np.shape(getattr(jm, k))) * scale)
                 .astype(np.float32) for k in LEAVES}
        updates, state_j = opt_j.update(
            type(jm)(**{k: jnp.asarray(v) for k, v in grads.items()}),
            state_j, jm)
        jm = optax.apply_updates(jm, updates)
        before = tm.scales_log.detach().clone()
        for k in LEAVES:
            getattr(tm, k).grad = torch.from_numpy(grads[k])
        opt_t.step()
        for k in LEAVES:
            want = np.asarray(getattr(jm, k))
            np.testing.assert_allclose(getattr(tm, k).detach().numpy(), want,
                                       rtol=1e-6, atol=1e-6 * np.abs(
                                           want).max(), err_msg=k)
        rms = float((tm.scales_log.detach() - before).pow(2).mean().sqrt()
                    / tc.lr_scales)
        if step == 1:
            assert rms == pytest.approx(1.0, rel=1e-4), rms
    assert opt_t.updates() == 3
    assert opt_t.param_groups[0]["lr"] == pytest.approx(
        1e-2 * 0.01 ** (2 / 4))


def test_factored_branch_matches_optax():
    """A leaf whose two largest dimensions reach 128 keeps row and column
    second moments; three steps of `scale_by_factored_rms` against optax's."""
    rng = np.random.default_rng(7)
    shape = (256, 130)
    opt = optax.scale_by_factored_rms()
    param = jnp.zeros(shape, jnp.float32)
    state_j = opt.init(param)
    state_t = {}
    for scale in (1.0, 3.0, 0.5):
        g = (rng.normal(size=shape) * scale).astype(np.float32)
        want, state_j = opt.update(jnp.asarray(g), state_j, param)
        got = ttrainer.scale_by_factored_rms(torch.from_numpy(g), state_t)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    assert "v" not in state_t
    assert tuple(state_t["v_row"].shape) == np.shape(state_j.v_row)
    assert tuple(state_t["v_col"].shape) == np.shape(state_j.v_col)
    assert state_t["step"] == 3


def test_every_model_leaf_is_unfactored():
    """Under optax's rule no GaussianModel leaf has a second dimension of
    at least 128, so each keeps a full second moment (v of the leaf's
    shape, no row/column factors), in optax and in the port."""
    jm = _scene(47)
    state = optax.scale_by_factored_rms().init(jm)
    tm = carry(jm)
    opt_t = make_optimizer(TrainConfig(optimizer="adafactor"), tm)
    for k in LEAVES:
        g = torch.ones_like(getattr(tm, k))
        getattr(tm, k).grad = g
        assert np.shape(getattr(state.v, k)) == tuple(g.shape), k
        assert np.shape(getattr(state.v_row, k)) == (1,), k
        assert ttrainer._factored_dims(tuple(g.shape)) is None, k
    opt_t.step()
    for k in LEAVES:
        assert set(opt_t.state[getattr(tm, k)]) == {"step", "v"}, k


def _setup():
    cfg = torch_cfg(CFG_T8)
    tm = carry(_scene(48))
    cams = [camera(32, fov) for fov in (55.0, 60.0)]
    target_model = carry(_scene(48))
    with torch.no_grad():
        target_model.sh_dc += 0.3
    r = gt.render.TiledRenderer(32, 32, cfg, device="cpu")
    cap = r.plan(tm, cams)
    with torch.no_grad():
        targets = torch.stack([r.render(target_model, c)["rgb"]
                               for c in cams])
    tc = TrainConfig(total_steps=3, optimizer="adafactor")
    trainer = Trainer(32, 32, cfg, tc, cap, device="cpu")
    return trainer, tm, camera_batch(cams, cfg, "cpu"), targets


def test_adafactor_trainer_loss_falls():
    trainer, tm, batch, targets = _setup()
    state = trainer.init(tm)
    assert isinstance(state[1], ttrainer.GroupAdafactor)
    losses = []
    for _ in range(3):
        state, loss = trainer.step(state, batch, targets)
        losses.append(float(loss))
    assert losses[2] < losses[1] < losses[0], losses


def test_adafactor_checkpoint_round_trip(tmp_path):
    trainer, tm, batch, targets = _setup()
    state = trainer.init(tm)
    state, _ = trainer.step(state, batch, targets)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, state, 0)
    saved = {k: getattr(tm, k).detach().clone() for k in LEAVES}
    v = state[1].state[tm.means]["v"].clone()
    state, _ = trainer.step(state, batch, targets)
    assert state[1].updates() == 2
    state, step = restore_checkpoint(ckpt, state)
    assert step == 0 and state[1].updates() == 1
    for k in LEAVES:
        torch.testing.assert_close(getattr(tm, k).detach(), saved[k],
                                   rtol=0, atol=0)
    torch.testing.assert_close(state[1].state[tm.means]["v"], v, rtol=0,
                               atol=0)
    assert os.path.isdir(os.path.join(ckpt, "step_00000000"))
    # the restored optimizer steps on as the original did
    state, loss = trainer.step(state, batch, targets)
    assert np.isfinite(float(loss)) and state[1].updates() == 2
