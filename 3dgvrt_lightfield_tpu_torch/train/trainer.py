"""Fine-tuning loop: Adam or Adafactor on all Gaussian parameter groups.

Counterpart of the JAX package's `train/trainer.py`: per-group learning
rates of the standard 3DGS recipe (position lr scaled by the scene extent
with exponential decay; SH rest at dc/20) and an L1/L2 loss.  Three steps:

  * `n_bands == 1`: a camera batch, each camera binned per step, rendered
    through the gather (K3 in its backward) and the tile kernels (K1 with
    its residual, K2);
  * with a `mesh` (`parallel/sharding.py`), the same step sharded over
    ranks: each renders its slice of the camera batch, then the gradients
    and the loss are all-reduced to their averages (the JAX step's
    `pmean`s) and every rank takes the same optimizer step;
  * `n_bands > 1`, the garden-scale path on one card: one camera per step
    through the banded renderer (`render/banded.py`), against per-band
    topologies held for `refresh_every` steps, with the compact gradient
    reduce (K4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import (DEFAULT_CONFIG, RenderConfig, resolve_device,
                      resolve_impl)
from ..models.gaussians import GaussianModel
from ..parallel.sharding import (CameraBatch, Mesh, _render_one,
                                average_gradients, local_cameras)
from ..render.banded import BandedRenderer
from ..render.rows_vjp import frame_params
from ..utils.profiling import span


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
    #: "adam" | "adafactor" (factored second moments where a leaf has two
    #: dimensions >= 128; every GaussianModel leaf takes the unfactored rule)
    optimizer: str = "adam"
    #: span banding for n_bands > 1
    span_bands: bool = False
    #: pair-balanced span bands (requires span_bands)
    balance_bands: bool = False


def _param_groups(model: GaussianModel, tc: TrainConfig):
    """The six leaves as parameter groups with their learning rates (the
    means' is the schedule's start; `_MeansDecay` moves it)."""
    lrs = {"means": tc.lr_means * tc.scene_extent, "scales_log": tc.lr_scales,
           "quats": tc.lr_quats, "opacity_logit": tc.lr_opacity,
           "sh_dc": tc.lr_sh_dc, "sh_rest": tc.lr_sh_rest}
    return [{"params": [getattr(model, k)], "lr": lr, "name": k}
            for k, lr in lrs.items()]


class _MeansDecay:
    """The means group's learning rate on optax's `exponential_decay(
    lr_means * scene_extent, total_steps, lr_means_final_scale)`: lr * rate
    ** (updates / total_steps), not staircase, where `updates` counts the
    steps taken before this one."""

    def _init_decay(self, tc: TrainConfig):
        self.means_lr0 = tc.lr_means * tc.scene_extent
        self.decay_rate, self.decay_steps = (tc.lr_means_final_scale,
                                             tc.total_steps)

    def updates(self) -> int:
        """Steps taken so far (the step count of the means)."""
        state = self.state.get(self.param_groups[0]["params"][0], {})
        return int(state.get("step", 0))

    def _decay_means_lr(self):
        self.param_groups[0]["lr"] = self.means_lr0 * self.decay_rate ** (
            self.updates() / self.decay_steps)


class GroupAdam(_MeansDecay, torch.optim.Adam):
    """Per-parameter-group Adam (eps 1e-15), the means on the decayed
    schedule."""

    def __init__(self, model: GaussianModel, tc: TrainConfig):
        self._init_decay(tc)
        super().__init__(_param_groups(model, tc), eps=1e-15)

    @torch.no_grad()
    @span("gvrt.optimizer")
    def step(self, closure=None):
        self._decay_means_lr()
        return super().step(closure)


#: optax 0.2.6 `scale_by_factored_rms` defaults (the JAX package's
#: `adafactor(learning_rate=lr, multiply_by_parameter_scale=False)`)
_DECAY_EXPONENT, _EPS, _MIN_DIM_TO_FACTOR = 0.8, 1e-30, 128


def _factored_dims(shape):
    """optax's `_factored_dims`: the (second-largest, largest) axes when the
    second-largest dimension is at least 128, else None (unfactored)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def scale_by_factored_rms(grad: torch.Tensor, state: dict) -> torch.Tensor:
    """One step of optax's `scale_by_factored_rms` on one leaf: updates the
    leaf's state (step, and v or v_row/v_col) in place, returns the scaled
    gradient.  The decay is 1 - (step + 1) ** -0.8 in f32, as optax forms
    it."""
    dims = _factored_dims(tuple(grad.shape))
    if "step" not in state:
        if dims is None:
            state["v"] = torch.zeros_like(grad)
        else:
            d1, d0 = dims
            state["v_row"] = grad.new_zeros(np.delete(grad.shape, d0).tolist())
            state["v_col"] = grad.new_zeros(np.delete(grad.shape, d1).tolist())
        state["step"] = 0
    decay = np.float32(1.0) - np.float32(state["step"] + 1) ** np.float32(
        -_DECAY_EXPONENT)
    keep, take = float(decay), float(np.float32(1.0) - decay)
    state["step"] += 1
    grad_sqr = grad * grad + _EPS
    if dims is None:
        v = state["v"]
        v.copy_(keep * v + take * grad_sqr)
        return grad * v.pow(-0.5)
    d1, d0 = dims
    v_row, v_col = state["v_row"], state["v_col"]
    v_row.copy_(keep * v_row + take * grad_sqr.mean(dim=d0))
    v_col.copy_(keep * v_col + take * grad_sqr.mean(dim=d1))
    reduced_d1 = d1 - 1 if d1 > d0 else d1
    row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)).pow(-0.5)
    return (grad * row_factor.unsqueeze(d0)
            * v_col.pow(-0.5).unsqueeze(d1))


class GroupAdafactor(_MeansDecay, torch.optim.Optimizer):
    """Per-parameter-group Adafactor, the means on the decayed schedule:
    optax 0.2.6's `adafactor(learning_rate=lr,
    multiply_by_parameter_scale=False)`, a chain of `scale_by_factored_rms`,
    `clip_by_block_rms(1.0)` (u / max(1, rms(u)) per leaf), the learning
    rate and a negation.  (`torch.optim.Adafactor` follows another variant
    of the paper.)"""

    def __init__(self, model: GaussianModel, tc: TrainConfig):
        self._init_decay(tc)
        super().__init__(_param_groups(model, tc), {})

    @torch.no_grad()
    @span("gvrt.optimizer")
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self._decay_means_lr()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = scale_by_factored_rms(p.grad, self.state[p])
                u = u / torch.clamp_min((u * u).mean().sqrt(), 1.0)
                p.add_(u, alpha=-group["lr"])
        return loss


_OPTIMIZERS = {"adam": GroupAdam, "adafactor": GroupAdafactor}


def make_optimizer(tc: TrainConfig, model: GaussianModel):
    """Per-parameter-group Adam or Adafactor over the model's six leaves."""
    if tc.optimizer not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {tc.optimizer!r}")
    return _OPTIMIZERS[tc.optimizer](model, tc)


@span("gvrt.loss")
def _image_loss(rgb, target, tc: TrainConfig) -> torch.Tensor:
    diff = rgb - target
    return (tc.l1_weight * diff.abs().mean()
            + tc.l2_weight * (diff * diff).mean())


def _batch_backward(model: GaussianModel, cams: CameraBatch,
                    targets: torch.Tensor, width, height, cfg, cap, cap_pad,
                    impl, tc: TrainConfig) -> torch.Tensor:
    """Accumulate the gradient of the batch's mean loss into the leaves,
    one camera at a time (forward, then backward of loss_i / B), and
    return the mean loss.  Per camera, so that one camera's graph is alive
    at a time, and so that the leaves see sum_i J^T(g_i) / B: two ranks of
    one camera each, averaged by the sharded step, then give the unsharded
    step's gradients bit for bit (halving is exact; otherwise the sums'
    order differs), where Adam's eps of 1e-15 would turn a last-bit
    difference of a near-zero gradient into a learning-rate-sized move."""
    b = cams.rays.shape[0]
    losses = []
    for i in range(b):
        # no local holds the table or the activated view: the backward
        # needs neither, and the step's peak would carry them
        img = _render_one(*frame_params(model, cfg, impl), cams.w2c[i],
                          cams.proj[i], cams.rays[i], width, height, cfg,
                          cap, cap_pad, impl)
        loss = _image_loss(img[..., 0:3], targets[i], tc)
        with span("gvrt.backward"):
            (loss / b).backward()
        losses.append(loss.detach())
    return torch.stack(losses).mean()


class Trainer:
    """Adam (or Adafactor) fine-tuner, on one card or sharded over a mesh.

    Usage:
        t = Trainer(width, height, cfg, tc, capacity)
        state = t.init(model)             # (model, optimizer)
        state, loss = t.step(state, camera_batch, targets)

    With `mesh`, every rank passes the whole camera batch and targets and
    renders its `local_batch_slice`; the model lives on the mesh's device
    and should start replicated (`parallel.replicate_model`).

    Garden-scale scenes train through the banded pipeline instead: pass
    `n_bands > 1` and call `step(state, camera, target)` with one Camera and
    an (H, W, 3) target.  The trainer holds the per-band topologies and
    rebuilds them every `tc.refresh_every` steps and on a new camera value
    (gradients are exact per step; only culling and depth order go stale).

    `step` updates the model's parameters in place and returns the same
    state with the loss (before the update).
    """

    def __init__(self, width: int, height: int,
                 cfg: RenderConfig = DEFAULT_CONFIG,
                 tc: TrainConfig = TrainConfig(),
                 capacity: tuple = (0, 0), mesh: Optional[Mesh] = None,
                 impl: str = "auto", n_bands: int = 1, device=None):
        if mesh is not None:
            if n_bands > 1:
                raise ValueError("banded training is single-card: n_bands > "
                                 "1 takes no mesh")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device}: the mesh's rank runs on "
                                 f"{mesh.device}")
            device = mesh.device
        self.width, self.height, self.cfg, self.tc = width, height, cfg, tc
        self.cap, self.cap_pad = capacity
        self.mesh = mesh
        self.device = resolve_device(device)
        self.impl = resolve_impl(impl, self.device)
        self.n_bands = n_bands
        #: the banded renderer whose per-band topologies the banded step
        #: holds (n_bands > 1), else None
        self.renderer = None
        if n_bands > 1:
            self.renderer = BandedRenderer(
                width, height, n_bands, cfg,
                capacity=None if tuple(capacity) == (0, 0) else capacity,
                impl=self.impl, remat=tc.banded_remat, span=tc.span_bands,
                balance=tc.balance_bands, device=self.device)
            self._bind_age = self._bind_key = None
            #: the held window's dropped pairs, a device scalar (no host
            #: sync per step); read at the next rebind
            self.last_overflow = None

    def init(self, model: GaussianModel):
        return (model, make_optimizer(self.tc, model))

    @span("gvrt.bind")
    def bind(self, model: GaussianModel, camera):
        """(Re)build the held per-band topologies for `camera` now: what the
        banded `step` does every `refresh_every` steps and on a new camera.
        A rebind syncs with the host anyway, so it reads the held window's
        overflow there: if pairs were dropped, `BandedRenderer.bind`
        re-plans first.  Returns the topologies."""
        topos = self.renderer.bind(
            model, camera, replan=self.last_overflow is not None
            and int(self.last_overflow) > 0)
        # a value key, never id(): a recycled id could reuse another
        # camera's held topologies
        self._bind_age, self._bind_key = 0, camera.content_key()
        return topos

    def _banded_step(self, state, camera, target: torch.Tensor):
        model, optimizer = state
        if (self._bind_age is None or camera.content_key() != self._bind_key
                or self._bind_age >= self.tc.refresh_every):
            self.bind(model, camera)
        self._bind_age += 1
        optimizer.zero_grad(set_to_none=True)
        out = self.renderer.render_bound(model)
        loss = _image_loss(out["rgb"], target, self.tc)
        with span("gvrt.backward"):
            loss.backward()
        optimizer.step()
        self.last_overflow = out["overflow"]
        return (model, optimizer), loss.detach()

    @span("gvrt.step")
    def step(self, state, cams, targets: torch.Tensor):
        if self.n_bands > 1:
            return self._banded_step(state, cams, targets)
        model, optimizer = state
        if self.mesh is not None:  # this rank's cameras
            cams, sl = local_cameras(cams, self.mesh)
            targets = targets[sl].to(self.mesh.device)
        optimizer.zero_grad(set_to_none=True)
        loss = _batch_backward(model, cams, targets, self.width, self.height,
                               self.cfg, self.cap, self.cap_pad, self.impl,
                               self.tc)
        if self.mesh is not None:
            loss = average_gradients(model, self.mesh, loss)
        optimizer.step()
        return (model, optimizer), loss.detach()
