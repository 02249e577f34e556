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
