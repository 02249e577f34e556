"""Ray/AABB slab intersection.

Reference: shaders/glsl/base/gaussianfunctions.glsl:8-16 (`intersectAABB`),
with the sign-preserving direction clamp the JAX package uses (the reference
clamps negative components away, SURVEY.md 2.4b).
"""

from __future__ import annotations

import torch


def intersect_aabb(aabb, ray_o: torch.Tensor, ray_d: torch.Tensor):
    """Returns (tmin, tmax) of the ray/AABB overlap, with tmin clamped to >= 0.

    aabb: 6 floats (minx, miny, minz, maxx, maxy, maxz); ray_o, ray_d: (..., 3).
    """
    lo = torch.tensor(aabb[:3], dtype=ray_o.dtype, device=ray_o.device)
    hi = torch.tensor(aabb[3:], dtype=ray_o.dtype, device=ray_o.device)
    safe_d = torch.where(ray_d.abs() < 1e-6,
                         torch.where(ray_d < 0, -1e-6, 1e-6), ray_d)
    inv = 1.0 / safe_d
    t0 = (lo - ray_o) * inv
    t1 = (hi - ray_o) * inv
    tmin = torch.clamp_min(torch.amax(torch.minimum(t0, t1), dim=-1), 0.0)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tmin, tmax


def gaussian_world_aabb(means: torch.Tensor, scales: torch.Tensor,
                        rotmats: torch.Tensor, radius):
    """Conservative world-space AABB of each Gaussian's iso-response
    ellipsoid {mean + R @ (radius * scale * u) : |u| = 1}: half-extent
    radius * sqrt(sum_j (R[i, j] * scale[j])^2) along axis i.

    means, scales (activated): (N, 3); rotmats: (N, 3, 3) local->world;
    radius: (N,) or a scalar, in scale units.  Returns (lo, hi), each (N, 3).
    """
    half = torch.sqrt(torch.sum((rotmats * scales[:, None, :]) ** 2, dim=-1))
    half = half * torch.as_tensor(radius, dtype=half.dtype,
                                  device=half.device).reshape(-1, 1)
    return means - half, means + half
