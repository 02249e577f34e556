"""Fine-tuning loop: Adam on all Gaussian parameter groups, on one card.

Counterpart of the JAX package's `train/trainer.py` for the single-card,
non-banded step: per-group learning rates of the standard 3DGS recipe
(position lr scaled by the scene extent with exponential decay; SH rest at
dc/20), an L1/L2 loss over a camera batch, and a differentiable render
through binning, the gather (K3 in its backward) and the tile kernels (K1
with its residual, K2).

Not ported yet, and refused with NotImplementedError rather than dropped:
banded training (`n_bands > 1`, ROADMAP.md section 1 item 8), the sharded
step (`mesh`, item 11) and Adafactor (`optimizer="adafactor"`, item 9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import DEFAULT_CONFIG, RenderConfig, resolve_device
from ..models.gaussians import GaussianModel
from ..parallel.sharding import CameraBatch, _render_one
from ..render.pallas_forward import resolve_impl


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's TrainConfig: the same fields and defaults."""
    lr_means: float = 1.6e-4          # x scene_extent, exp-decayed
    lr_means_final_scale: float = 0.01
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    lr_opacity: float = 0.05
    lr_sh_dc: float = 2.5e-3
    lr_sh_rest: float = 2.5e-3 / 20.0
    total_steps: int = 1000
    l1_weight: float = 1.0
    l2_weight: float = 0.0
    scene_extent: float = 1.0
    #: banded training: rebuild the held per-band topologies every N steps
    refresh_every: int = 10
    #: band-scan recompute policy for banded training
    banded_remat: str = "full"
    #: "adam" (ported) | "adafactor" (not yet)
    optimizer: str = "adam"
    #: span banding for n_bands > 1
    span_bands: bool = False
    #: pair-balanced span bands (requires span_bands)
    balance_bands: bool = False


class GroupAdam(torch.optim.Adam):
    """Per-parameter-group Adam (eps 1e-15) with the means group's learning
    rate on optax's `exponential_decay(lr_means * scene_extent, total_steps,
    lr_means_final_scale)`: lr * rate ** (updates / total_steps), not
    staircase, where `updates` counts the steps taken before this one."""

    def __init__(self, model: GaussianModel, tc: TrainConfig):
        self.means_lr0 = tc.lr_means * tc.scene_extent
        self.decay_rate, self.decay_steps = (tc.lr_means_final_scale,
                                             tc.total_steps)
        lrs = {"means": self.means_lr0, "scales_log": tc.lr_scales,
               "quats": tc.lr_quats, "opacity_logit": tc.lr_opacity,
               "sh_dc": tc.lr_sh_dc, "sh_rest": tc.lr_sh_rest}
        super().__init__([{"params": [getattr(model, k)], "lr": lr,
                           "name": k} for k, lr in lrs.items()], eps=1e-15)

    def updates(self) -> int:
        """Steps taken so far (the Adam step count of the means)."""
        state = self.state.get(self.param_groups[0]["params"][0], {})
        return int(state.get("step", 0))

    @torch.no_grad()
    def step(self, closure=None):
        self.param_groups[0]["lr"] = self.means_lr0 * self.decay_rate ** (
            self.updates() / self.decay_steps)
        return super().step(closure)


def _check_optimizer(tc: TrainConfig):
    if tc.optimizer != "adam":
        raise NotImplementedError(
            f"optimizer {tc.optimizer!r} is not ported yet: Adafactor is "
            f"ROADMAP.md section 1 item 9")


def make_optimizer(tc: TrainConfig, model: GaussianModel) -> GroupAdam:
    """Per-parameter-group Adam over the model's six leaves."""
    _check_optimizer(tc)
    return GroupAdam(model, tc)


def _batch_loss(act, cams: CameraBatch, targets: torch.Tensor, width, height,
                cfg, cap, cap_pad, impl, tc: TrainConfig) -> torch.Tensor:
    losses = []
    for i in range(cams.rays.shape[0]):
        img = _render_one(act, cams.w2c[i], cams.proj[i], cams.rays[i],
                          width, height, cfg, cap, cap_pad, impl)
        diff = img[..., 0:3] - targets[i]
        losses.append(tc.l1_weight * diff.abs().mean()
                      + tc.l2_weight * (diff * diff).mean())
    return torch.stack(losses).mean()


class Trainer:
    """Adam fine-tuner over a camera batch on one card.

    Usage:
        t = Trainer(width, height, cfg, tc, capacity)
        state = t.init(model)             # (model, optimizer)
        state, loss = t.step(state, camera_batch, targets)

    `step` updates the model's parameters in place and returns the same
    state with the loss of the batch (before the update).
    """

    def __init__(self, width: int, height: int,
                 cfg: RenderConfig = DEFAULT_CONFIG,
                 tc: TrainConfig = TrainConfig(),
                 capacity: tuple = (0, 0), mesh: Optional[object] = None,
                 impl: str = "auto", n_bands: int = 1, device=None):
        if n_bands > 1:
            raise NotImplementedError(
                "banded training (n_bands > 1) is not ported yet: ROADMAP.md "
                "section 1 item 8")
        if mesh is not None:
            raise NotImplementedError(
                "the sharded train step (mesh) is not ported yet: ROADMAP.md "
                "section 1 item 11")
        _check_optimizer(tc)
        self.width, self.height, self.cfg, self.tc = width, height, cfg, tc
        self.cap, self.cap_pad = capacity
        self.device = resolve_device(device)
        self.impl = resolve_impl(impl, self.device)

    def init(self, model: GaussianModel):
        return (model, make_optimizer(self.tc, model))

    def step(self, state, cams: CameraBatch, targets: torch.Tensor):
        model, optimizer = state
        optimizer.zero_grad(set_to_none=True)
        loss = _batch_loss(model.activate(), cams, targets, self.width,
                           self.height, self.cfg, self.cap, self.cap_pad,
                           self.impl, self.tc)
        loss.backward()
        optimizer.step()
        return (model, optimizer), loss.detach()
