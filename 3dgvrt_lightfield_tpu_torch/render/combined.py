"""Combined scene: Gaussian ray march + opaque glTF/mesh geometry, one render.

The PyTorch port of the JAX package's `render/combined.py`, its completion
of the reference's `LOAD_GLTF` FullRT variant (VulkanFullRT.cpp:922-927,
1427-1441; base/Define.h:42):

  1. mesh pass: per-pixel closest triangle hit (hybrid.trace) + GGX local
     shading with mesh-vs-mesh shadow rays (hybrid.pipeline machinery);
  2. Gaussian pass: the tiled march with each ray's tmax clipped to its
     mesh hit distance (binning.tile_rays tmax_clip), so a surface ends the
     march as the reference's payload tmax does; the kernels K1 (and, when
     differentiated, K1's residual, K2 and K3) run on these clipped rays;
  3. composite: out = gaussian_radiance + T_at_surface * mesh_color, the
     mesh as the opaque tail of the front-to-back composite.

`gaussian_shadows=True` lets the Gaussians cast shadows onto the mesh: a
transmittance-attenuated shadow ray from every mesh hit point to every
light through the Gaussian field (the renderer's per-hit response math,
gaussianfunctions.glsl:153-206) scales each light's GGX contribution.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig, resolve_impl
from ..hybrid.mesh import MeshScene
from ..hybrid.pipeline import (HybridConfig, _DeviceScene, _shade_local,
                               _surface_attributes)
from ..models.gaussians import ActivatedGaussians, GaussianModel
from ..ops.kernels import particle_response
from .binning import (bin_topology, binned_scene, gather_from_rows,
                      plan_capacity, tile_rays, untile)
from .pallas_forward import forward_dispatch
from .rows_vjp import frame_params
from .tile_math import ACC_DEPTH, ACC_HITS, ACC_T
from .tiled import _camera_mats


#: acceptance epsilon for shadow-segment endpoints (self/light bias)
_SHADOW_EPS_T = 1e-3
#: (Gaussian, point) pairs per step of the shadow pass: a chunk of 512
#: Gaussians against 65,536 points, ~128 MB per temporary
_SHADOW_PAIRS = 1 << 25


def gaussian_shadow_transmittance(act: ActivatedGaussians,
                                  points: torch.Tensor,
                                  light_pos: torch.Tensor,
                                  cfg: RenderConfig,
                                  chunk: int = 512) -> torch.Tensor:
    """Gaussian-field transmittance along P shadow rays point -> light.

    The renderer's per-hit math (prefolded frame M = diag(1/s) R^T,
    b = M mean; grayDist = |cross(grd, gro)|^2 / |grd|^2; the same
    degree-table response and alpha gates as processHit,
    gaussianfunctions.glsl:153-206) with one difference: no depth sorting.
    Transmittance is the order-independent product prod(1 - alpha_g) over
    the Gaussians whose closest-approach t lies strictly inside the
    segment, summed in log space chunk by chunk in the JAX package's order.
    Points are taken in blocks so that a step holds at most
    `_SHADOW_PAIRS` (Gaussian, point) pairs: each point's sum is its own,
    so blocking the points keeps the order of every sum.
    """
    pts = points.reshape(-1, 3)
    to_l = torch.as_tensor(light_pos, dtype=torch.float32,
                           device=pts.device)[None, :] - pts
    dist = torch.linalg.vector_norm(to_l, dim=-1)            # (P,)
    d = to_l / dist.clamp_min(1e-12)[:, None]                # (P, 3)

    n = act.means.shape[0]
    pad = (-n) % chunk

    def pad0(a):
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]) if pad \
            else a

    inv_s = pad0(act.inv_scales)
    rot9 = pad0(act.rot9)
    means = pad0(act.means)
    dens = pad0(act.densities)                               # pad density 0
    # M rows m[3i+k] = inv_s[:, i] * R[k, i]; b = M @ mean (param_rows math)
    m = [inv_s[:, i] * rot9[:, 3 * k + i]
         for i in range(3) for k in range(3)]                # 9 x (N,)
    b = [inv_s[:, i] * (rot9[:, i] * means[:, 0]
                        + rot9[:, 3 + i] * means[:, 1]
                        + rot9[:, 6 + i] * means[:, 2]) for i in range(3)]
    tab = torch.stack(m + b + [dens], dim=1).reshape(-1, chunk, 13)

    log_t = torch.zeros((pts.shape[0],), device=pts.device)
    step = max(1, _SHADOW_PAIRS // chunk)
    for p0 in range(0, pts.shape[0], step):
        p = slice(p0, p0 + step)
        ox, oy, oz = pts[p, 0], pts[p, 1], pts[p, 2]
        dx, dy, dz = d[p, 0], d[p, 1], d[p, 2]
        dist_p = dist[p]
        acc = log_t[p]
        for blk in tab:                                      # (chunk, 13)
            gro = [blk[:, 3 * i, None] * ox + blk[:, 3 * i + 1, None] * oy
                   + blk[:, 3 * i + 2, None] * oz - blk[:, 9 + i, None]
                   for i in range(3)]                        # 3 x (G, P)
            grd = [blk[:, 3 * i, None] * dx + blk[:, 3 * i + 1, None] * dy
                   + blk[:, 3 * i + 2, None] * dz for i in range(3)]
            n2 = grd[0] ** 2 + grd[1] ** 2 + grd[2] ** 2
            cx = gro[1] * grd[2] - gro[2] * grd[1]
            cy = gro[2] * grd[0] - gro[0] * grd[2]
            cz = gro[0] * grd[1] - gro[1] * grd[0]
            inv_n2 = 1.0 / n2.clamp_min(1e-20)
            gray = (cx * cx + cy * cy + cz * cz) * inv_n2
            t = -(gro[0] * grd[0] + gro[1] * grd[1]
                  + gro[2] * grd[2]) * inv_n2
            resp = particle_response(gray, cfg.kernel_degree)
            alpha = torch.clamp_max(resp * blk[:, 12, None], cfg.max_alpha)
            accept = ((resp > cfg.hit_min_response)
                      & (alpha > cfg.alpha_min)
                      & (t > _SHADOW_EPS_T)
                      & (t < dist_p[None, :] - _SHADOW_EPS_T))
            acc = acc + torch.sum(
                torch.log1p(-torch.where(accept, alpha, 0.0)), dim=0)
        log_t[p] = acc
    return torch.exp(log_t)


def _mesh_pass(dev: _DeviceScene, hcfg: HybridConfig, camera,
               shadow_act: Optional[ActivatedGaussians] = None,
               cfg: Optional[RenderConfig] = None):
    """Closest hit + local shading for every pixel, misses included (their
    color is then zeroed); t = inf where missed.

    `shadow_act`, optional, turns on Gaussian->mesh shadows: each light's
    contribution is scaled by the Gaussian field's transmittance along the
    shadow ray from the hit point."""
    o, d = camera.rays()
    h, w = o.shape[:2]
    rays = torch.as_tensor(np.concatenate([o, d], axis=-1).reshape(-1, 6),
                           device=dev.device)
    hit = dev.closest_hit(rays)
    missed = hit["tri"] < 0
    surf = _surface_attributes(dev, hit, rays)
    cam_pos = torch.as_tensor(
        np.asarray(camera.view_inverse, np.float32)[:3, 3], device=dev.device)
    view = cam_pos - surf["pos"]
    view = view / torch.linalg.vector_norm(
        view, dim=-1, keepdim=True).clamp_min(1e-12)
    light_atten = None
    if shadow_act is not None:
        light_atten = torch.stack([gaussian_shadow_transmittance(
            shadow_act, surf["pos"], dev.lights[li, 0:3], cfg)
            for li in range(dev.lights.shape[0])], dim=1)   # (P, L)
    color = _shade_local(dev, hcfg, surf, view, light_atten=light_atten)
    color = torch.where(missed[:, None], 0.0, color)
    t_mesh = torch.where(missed, torch.inf, hit["t"])
    return color.reshape(h, w, 3), t_mesh.reshape(h, w)


def render_combined(model: GaussianModel, scene: MeshScene, camera,
                    cfg: RenderConfig = DEFAULT_CONFIG,
                    hcfg: HybridConfig = HybridConfig(),
                    impl: str = "auto",
                    capacity: Optional[tuple] = None,
                    gaussian_shadows: bool = False):
    """Render Gaussians and an opaque mesh scene in one frame, on the
    model's device.

    Returns rgb (H, W, 3), gaussian_rgb, mesh_rgb, mesh_t (per-pixel
    surface distance, inf where no mesh), depth, transmittance, hit_count
    and overflow.  Differentiable w.r.t. the model when grad is enabled:
    the mesh pass carries no gradient (the clip distances only gate the
    march's accept tests, and the shadow pass sees the model detached).
    Serving callers wrap it in `torch.no_grad()`, which runs K1 alone.
    """
    device = model.device
    impl = resolve_impl(impl, device)
    grad = torch.is_grad_enabled()   # the gather's backward reads the plan
    width, height = camera.width, camera.height
    dev = _DeviceScene(scene, hcfg, device)
    act, rows64 = frame_params(model, cfg, impl)
    with torch.no_grad():
        mesh_rgb, t_mesh = _mesh_pass(
            dev, hcfg, camera, shadow_act=act if gaussian_shadows else None,
            cfg=cfg)
        w2c, proj = _camera_mats(camera)
        if capacity is None:
            capacity = plan_capacity(act, w2c, proj, width, height, cfg)
        rays = tile_rays(camera, cfg, device, tmax_clip=t_mesh, impl=impl)
        topo = bin_topology(act, w2c, proj, width, height, cfg, *capacity,
                            with_reduce_plan=grad)
    binned = binned_scene(gather_from_rows(rows64, topo, cfg, impl), topo)
    acc = forward_dispatch(binned, rays, cfg, impl)
    img = untile(acc, width, height, cfg.tile_size)

    transmittance = img[..., ACC_T]
    rgb = img[..., 0:3] + transmittance[..., None] * mesh_rgb
    # depth composites the mesh as the opaque tail (an alpha = 1 surface at
    # mesh_t adds T_at_surface * mesh_t, as the radiance composite does);
    # pixels with neither Gaussians nor mesh stay 0
    depth = img[..., ACC_DEPTH] + transmittance * torch.where(
        torch.isfinite(t_mesh), t_mesh, 0.0)
    return {
        "rgb": rgb,
        "gaussian_rgb": img[..., 0:3],
        "mesh_rgb": mesh_rgb,
        "mesh_t": t_mesh,
        "depth": depth,
        "transmittance": transmittance,
        "hit_count": img[..., ACC_HITS],
        "overflow": binned.overflow,
    }
