"""Brute-force renderer — the port's independent ground truth.

Evaluates every Gaussian against every ray (O(N * rays)), sorts hits by exact
max-response depth and composites front to back with the reference's
termination criteria (raygen.rgen:113-189 + anyhit.rahit:40-71 +
gaussianfunctions.glsl:153-229).  Slow and simple: the tiled renderer's tests
hold it against this.  Differentiable by autograd when grad is enabled and
the model's leaves require grad (the ground truth for gradients, as in the
JAX package); under `torch.no_grad()` it builds no graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig, resolve_device
from ..models.gaussians import ActivatedGaussians, GaussianModel
from ..ops.aabb import intersect_aabb
from ..ops.hit import composite_sorted, ray_gaussian_hit
from ..ops.sh import radiance_from_sh


def render_rays(gaussians: ActivatedGaussians, ray_o: torch.Tensor,
                ray_d: torch.Tensor, cfg: RenderConfig = DEFAULT_CONFIG):
    """Render (R, 3) rays against all Gaussians -> dict of rgb (R, 3),
    depth (R,), transmittance (R,), hit_count (R,)."""
    rot_t = gaussians.rotmats.transpose(-1, -2)  # world->local
    hit = ray_gaussian_hit(
        ray_o[:, None, :], ray_d[:, None, :],
        gaussians.means[None], gaussians.inv_scales[None], rot_t[None],
        gaussians.densities[None],
        kernel_degree=cfg.kernel_degree,
        hit_min_response=cfg.hit_min_response,
        alpha_min=cfg.alpha_min,
        max_alpha=cfg.max_alpha)
    # radiance depends only on the ray direction -> evaluate once per pair
    rgb = radiance_from_sh(gaussians.sh_coeffs[None], ray_d[:, None, :],
                           degree=cfg.sh_degree, clamped=True)
    tmin, tmax = intersect_aabb(cfg.aabb, ray_o, ray_d)
    return composite_sorted(hit.alpha, hit.t, rgb, hit.accept,
                            min_transmittance=cfg.min_transmittance,
                            t_min=tmin, t_max=tmax)


def render_image(model: GaussianModel, camera,
                 cfg: RenderConfig = DEFAULT_CONFIG,
                 chunk: Optional[int] = None, device=None):
    """Render a full camera image with the brute-force renderer ->
    dict with rgb (H, W, 3), depth, transmittance, hit_count (H, W).
    Validation and small scenes only."""
    dev = resolve_device(device)
    ray_o, ray_d = camera.rays()
    h, w = ray_o.shape[:2]
    o = torch.as_tensor(np.ascontiguousarray(ray_o.reshape(-1, 3)), device=dev)
    d = torch.as_tensor(np.ascontiguousarray(ray_d.reshape(-1, 3)), device=dev)
    gauss = model.activate()
    step = chunk or cfg.ray_chunk
    parts = [render_rays(gauss, o[i:i + step], d[i:i + step], cfg)
             for i in range(0, o.shape[0], step)]
    return {k: torch.cat([p[k] for p in parts]).reshape((h, w) + parts[0][k].shape[1:])
            for k in parts[0]}
