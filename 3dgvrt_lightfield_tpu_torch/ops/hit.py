"""Per-(ray, Gaussian) hit math and front-to-back compositing.

The brute-force counterpart of `processHit`
(shaders/glsl/base/gaussianfunctions.glsl:153-229): transform the ray into the
particle's local (unit-sphere) frame, evaluate the generalized-Gaussian kernel
response at the ray's closest approach, derive alpha and the max-response
depth, and composite front-to-back.  Hits are ordered by the exact
max-response depth and every hit is composited (no k=16 window); Gaussians
whose closest approach lies behind the ray origin are rejected explicitly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels import particle_response
from .quaternion import safe_normalize


class HitData(NamedTuple):
    """Per-(ray, gaussian) quantities; all shaped as the broadcast inputs."""
    response: torch.Tensor   # kernel response in [0, 1]
    alpha: torch.Tensor      # min(max_alpha, response * density)
    t: torch.Tensor          # world-space distance of max response along ray
    accept: torch.Tensor     # bool hit-acceptance mask
    s_local: torch.Tensor    # signed ray parameter in the unit local frame


def ray_gaussian_hit(ray_o, ray_d, mean, inv_scale, rot_t, density, *,
                     kernel_degree: int = 4,
                     hit_min_response: float = 0.0113,
                     alpha_min: float = 1.0 / 255.0,
                     max_alpha: float = 0.99) -> HitData:
    """Evaluate rays against Gaussians (batched over broadcast leading dims).

    ray_o, ray_d: (..., 3); mean, inv_scale: (..., 3); rot_t: (..., 3, 3)
    world->local rotation; density: (...,).  Math: gaussianfunctions.glsl:186-206.
    """
    gposc = ray_o - mean
    gro = inv_scale * torch.einsum("...ij,...j->...i", rot_t, gposc)
    grdu = inv_scale * torch.einsum("...ij,...j->...i", rot_t, ray_d)
    grd = safe_normalize(grdu)

    gcrod = torch.linalg.cross(grd, gro, dim=-1)
    gray_dist = torch.sum(gcrod * gcrod, dim=-1)

    response = particle_response(gray_dist, kernel_degree)
    alpha = torch.clamp_max(response * density, max_alpha)

    s_local = torch.sum(grd * (-gro), dim=-1)
    grds = (grd / inv_scale) * s_local[..., None]
    t = torch.sqrt(torch.sum(grds * grds, dim=-1))

    accept = (response > hit_min_response) & (alpha > alpha_min) & (s_local > 0.0)
    return HitData(response=response, alpha=alpha, t=t, accept=accept,
                   s_local=s_local)


def composite_sorted(alpha: torch.Tensor, t: torch.Tensor, rgb: torch.Tensor,
                     accept: torch.Tensor, *,
                     min_transmittance: float = 1e-3,
                     t_min=None, t_max=None):
    """Front-to-back composite of per-ray hit lists (R, H), sorted by `t`
    (gaussianfunctions.glsl:203-219 with the raygen.rgen:142,155 early-out).

    Returns dict with rgb (R, 3), depth (R,), transmittance (R,), hit_count (R,).
    """
    if t_min is not None:
        accept = accept & (t >= t_min[..., None])
    if t_max is not None:
        accept = accept & (t <= t_max[..., None])

    t_sort = torch.where(accept, t, 1e20)
    order = torch.argsort(t_sort, dim=-1, stable=True)
    alpha_s = torch.take_along_dim(torch.where(accept, alpha, 0.0), order, dim=-1)
    t_s = torch.take_along_dim(t, order, dim=-1)
    rgb_s = torch.take_along_dim(rgb, order[..., None], dim=-2)

    one_minus = 1.0 - alpha_s
    # exclusive cumulative product: transmittance *before* each hit
    trans_before = (torch.cumprod(one_minus, dim=-1)
                    / torch.where(one_minus > 0, one_minus, 1.0))
    active = trans_before > min_transmittance
    weight = alpha_s * trans_before * active

    out_rgb = torch.sum(weight[..., None] * rgb_s, dim=-2)
    out_depth = torch.sum(weight * t_s, dim=-1)
    out_trans = torch.prod(torch.where(active, one_minus, 1.0), dim=-1)
    hit_count = torch.sum((weight > 0).to(torch.int32), dim=-1)
    return {"rgb": out_rgb, "depth": out_depth, "transmittance": out_trans,
            "hit_count": hit_count}
