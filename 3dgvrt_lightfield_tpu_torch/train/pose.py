"""Camera-pose refinement through the tile rays' cotangents.

Counterpart of the JAX package's `train/pose.py`.  The pose is a 6-DOF leaf:
per-pixel rays are built in the graph from (translation, axis-angle
rotation) deltas against a base camera, `cfg.ray_gradients=True` makes the
backward kernel (K2, `csrc/tile_backward.cu`) emit the rays' cotangents,
and Adam descends to the pose that explains the target image.

CLI: ``python -m 3dgvrt_lightfield_tpu_torch train --optimize-poses N
[--perturb-poses SIGMA]`` refines every dataset camera against its target
image before the parameter fine-tune starts.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig, resolve_device
from ..io.cameras import Camera
from ..render import binning
from ..render.pallas_forward import forward_dispatch, resolve_impl
from ..render.tiled import _camera_mats
from ..utils.profiling import span


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b over the last two axes as f32 products and sums, so TF32 never
    enters whatever `allow_tf32` says (the JAX package asks for
    Precision.HIGHEST here)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle (3,) -> rotation matrix (3, 3), small-angle safe.

    R = I + A sin(t)/t + A^2 (1 - cos t)/t^2 with A = skew(r); below
    t^2 = 1e-12 both coefficients are their series.  The unsafe branch sees
    a safe angle, or its NaN cotangent would poison the gradient at the
    identity even where the series branch is taken."""
    t2 = (r * r).sum()
    big = t2 > 1e-12
    safe_t2 = torch.where(big, t2, torch.ones_like(t2))
    t = torch.sqrt(safe_t2)
    a = torch.where(big, torch.sin(t) / t, 1.0 - t2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(t)) / safe_t2, 0.5 - t2 / 24.0)
    # stacked from r's elements: torch.tensor([[0, -r[2], ...]]) would cut
    # the graph
    zero = torch.zeros_like(r[0])
    skew = torch.stack([torch.stack([zero, -r[2], r[1]]),
                        torch.stack([r[2], zero, -r[0]]),
                        torch.stack([-r[1], r[0], zero])])
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + a * skew + b * _matmul3(skew, skew)


def _ndc_targets(camera: Camera, device) -> torch.Tensor:
    """(H, W, 3) f32: each pixel centre's NDC point through proj_inverse
    (raygen.rgen:116-121, as `Camera.rays`), built on the host in float64."""
    h, w = camera.height, camera.width
    xs = (np.arange(w, dtype=np.float64) + 0.5) / w * 2.0 - 1.0
    ys = (np.arange(h, dtype=np.float64) + 0.5) / h * 2.0 - 1.0
    dx, dy = np.meshgrid(xs, ys)
    ndc = np.stack([dx, dy, np.ones_like(dx), np.ones_like(dx)], axis=-1)
    return torch.as_tensor(
        (ndc @ camera.proj_inverse.T)[..., :3].astype(np.float32),
        device=device)


def _posed_rays(target3: torch.Tensor, camera: Camera, cfg: RenderConfig,
                delta_t, delta_r, aabb=None) -> torch.Tensor:
    dev = target3.device
    h, w = target3.shape[:2]
    vi = np.asarray(camera.view_inverse, np.float32)
    delta_t = torch.as_tensor(delta_t, dtype=torch.float32, device=dev)
    delta_r = torch.as_tensor(delta_r, dtype=torch.float32, device=dev)
    rot = _matmul3(rodrigues(delta_r),
                   torch.as_tensor(vi[:3, :3].copy(), device=dev))
    d = _matmul3(target3[..., None, :], rot.T)[..., 0, :]
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    o = (torch.as_tensor(vi[:3, 3].copy(), device=dev) + delta_t).expand(
        h, w, 3)
    return binning.tile_ray_rows(o, d, cfg, aabb)


def tile_rays_pose(camera: Camera, cfg: RenderConfig, delta_t, delta_r,
                   aabb=None, device=None) -> torch.Tensor:
    """Differentiable `binning.tile_rays`: (T, 24, R) f32 rays of `camera`
    moved by (delta_t, rodrigues(delta_r)), in the graph of both deltas.

    The per-pixel NDC targets are constants from the host; the graph holds
    the two 3x3 products, the normalisation and the clip and SH-basis rows.
    `device` as `resolve_device` (the card unless the CPU is asked for)."""
    return _posed_rays(_ndc_targets(camera, resolve_device(device)), camera,
                       cfg, delta_t, delta_r, aabb)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def apply_pose_delta(camera: Camera, delta_t, delta_r) -> Camera:
    """Bake a 6-DOF delta into a new Camera: rodrigues in f32 on the CPU,
    the product with the base rotation and the translation in float64."""
    with torch.no_grad():
        rot = rodrigues(torch.as_tensor(_host(delta_r),
                                        dtype=torch.float32)).numpy()
    vi = np.array(camera.view_inverse, np.float64)
    vi[:3, :3] = rot @ vi[:3, :3]
    vi[:3, 3] = vi[:3, 3] + _host(delta_t).astype(np.float64)
    return dataclasses.replace(camera, view_inverse=vi)


class PoseBinding(NamedTuple):
    """One camera's scene bound at its base pose, with its target: what a
    pose step needs besides the deltas (`bind_pose`, `pose_loss`)."""
    camera: Camera
    cfg: RenderConfig            # with ray_gradients set
    binned: binning.BinnedScene  # constants: built under no_grad
    ndc: torch.Tensor            # (H, W, 3) pixel targets, `_ndc_targets`
    target: torch.Tensor         # (T, 3, R) target image in tile layout


@span("gvrt.bind")
def bind_pose(model, camera: Camera, target,
              cfg: RenderConfig = DEFAULT_CONFIG) -> PoseBinding:
    """Plan, bin and gather the scene once at the camera's base pose (pose
    deltas are small and the cull is conservative), on the model's device.
    `cfg.ray_gradients` is set: without it the ray cotangents are silent
    zeros and the pose would stay put."""
    dev = model.device
    cfg = cfg.replace(ray_gradients=True)
    w2c, proj = _camera_mats(camera)
    with torch.no_grad():
        act = model.activate()
        cap, cap_pad = binning.plan_capacity(act, w2c, proj, camera.width,
                                             camera.height, cfg)
        binned = binning.bin_gaussians(act, w2c, proj, camera.width,
                                       camera.height, cfg, cap, cap_pad)
    ts = cfg.tile_size
    img = _host(target).astype(np.float32)
    h, w = img.shape[:2]
    tiled = (img.reshape(h // ts, ts, w // ts, ts, 3)
             .transpose(0, 2, 4, 1, 3).reshape(-1, 3, ts * ts))
    return PoseBinding(camera, cfg, binned, _ndc_targets(camera, dev),
                       torch.as_tensor(np.ascontiguousarray(tiled),
                                       device=dev))


def pose_loss(b: PoseBinding, delta_t, delta_r,
              impl: str = "auto") -> torch.Tensor:
    """Mean squared rgb error of the bound camera moved by (delta_t,
    rodrigues(delta_r)) against its target.  With grad it runs K1 with its
    residual, then K2 with the ray cotangents (impl "cuda", the default on
    the card), or their plain versions ("torch")."""
    rays = _posed_rays(b.ndc, b.camera, b.cfg, delta_t, delta_r)
    acc = forward_dispatch(b.binned, rays, b.cfg,
                           resolve_impl(impl, b.target.device))
    return ((acc[:, 0:3, :] - b.target) ** 2).mean()


def optimize_camera_poses(model, cameras: Sequence[Camera],
                          targets: Sequence, cfg: RenderConfig =
                          DEFAULT_CONFIG, steps: int = 100, lr: float = 3e-3,
                          impl: str = "auto", verbose: bool = True
                          ) -> Tuple[List[Camera], List[dict]]:
    """Refine each camera's pose against its target image, on the model's
    device.

    Per camera: `bind_pose` once, then Adam (optax's `adam(lr)` defaults)
    on (delta_t, delta_r) through `pose_loss`.  Returns (corrected cameras,
    per-camera reports {loss0, loss1, dt_norm, dr_norm}); loss1 is the loss
    of the last step, before its update."""
    dev = model.device
    impl = resolve_impl(impl, dev)
    out_cams, reports = [], []
    for cam, target in zip(cameras, targets):
        bound = bind_pose(model, cam, target, cfg)
        t = torch.zeros(3, device=dev, requires_grad=True)
        r = torch.zeros(3, device=dev, requires_grad=True)
        opt = torch.optim.Adam([t, r], lr=lr, eps=1e-8)
        with torch.no_grad():
            loss0 = float(pose_loss(bound, t, r, impl))
        val = loss0
        for _ in range(steps):
            with span("gvrt.step"):
                opt.zero_grad(set_to_none=True)
                loss = pose_loss(bound, t, r, impl)
                with span("gvrt.backward"):
                    loss.backward()
                with span("gvrt.optimizer"):
                    opt.step()
                val = float(loss.detach())
        dt, dr = _host(t), _host(r)
        out_cams.append(apply_pose_delta(cam, dt, dr))
        rep = {"loss0": loss0, "loss1": val,
               "dt_norm": float(np.linalg.norm(dt)),
               "dr_norm": float(np.linalg.norm(dr))}
        reports.append(rep)
        if verbose:
            print(f"pose-opt {cam.name or len(out_cams) - 1}: "
                  f"loss {loss0:.3e} -> {val:.3e}  |dt| {rep['dt_norm']:.4f} "
                  f"|dr| {rep['dr_norm']:.4f}")
    return out_cams, reports


def perturb_cameras(cameras: Sequence[Camera], sigma_t: float,
                    sigma_r: float = None, seed: int = 0) -> List[Camera]:
    """Jitter every pose (translation sigma_t, rotation sigma_r radians,
    default sigma_t / 3) with the JAX package's draws: the recovery target
    of `train --perturb-poses`."""
    rng = np.random.default_rng(seed)
    sigma_r = sigma_t / 3.0 if sigma_r is None else sigma_r
    return [apply_pose_delta(c, rng.normal(0, sigma_t, 3),
                             rng.normal(0, sigma_r, 3)) for c in cameras]
