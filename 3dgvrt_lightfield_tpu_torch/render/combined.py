"""Combined scene: Gaussian ray march + opaque glTF/mesh geometry, one render.

The PyTorch port of the JAX package's `render/combined.py`, its completion
of the reference's `LOAD_GLTF` FullRT variant (VulkanFullRT.cpp:922-927,
1427-1441; base/Define.h:42):

  1. mesh pass: per-pixel closest triangle hit (hybrid.trace) + GGX local
     shading with mesh-vs-mesh shadow rays (hybrid.pipeline machinery);
  2. Gaussian pass: the tiled march with each ray's tmax clipped to its
     mesh hit distance (the tile rays' tmax row), so a surface ends the
     march as the reference's payload tmax does; the kernels K1 (and, when
     differentiated, K1's residual, K2 and K3) run on these clipped rays;
  3. composite: out = gaussian_radiance + T_at_surface * mesh_color, the
     mesh as the opaque tail of the front-to-back composite.

`gaussian_shadows=True` lets the Gaussians cast shadows onto the mesh: a
transmittance-attenuated shadow ray from every mesh hit point to every
light through the Gaussian field (the renderer's per-hit response math,
gaussianfunctions.glsl:153-206) scales each light's GGX contribution.

`CombinedRenderer` serves such frames: it packs and uploads the mesh once
and holds a `TiledRenderer` for the Gaussian pass (its capacity plan,
binning and rays).  A frame builds its tile rays once, unclipped (on the
card in one launch of the camera-ray kernel); the mesh pass traces their
rows 0:6 in pixel order, then each ray's tmax row is clipped to its mesh
hit for the march.  Spans: `gvrt.mesh` (the mesh pass) with, inside it,
`gvrt.mesh.trace` and `gvrt.mesh.shadow` (`hybrid/trace.py`) and
`gvrt.mesh.shade` (the surface attributes and the shading, the shadow
rays included); counter `gvrt.mesh.tris`, the triangles a frame traces.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..hybrid.mesh import MeshScene
from ..hybrid.pipeline import (HybridConfig, _DeviceScene, _shade_local,
                               _surface_attributes)
from ..models.gaussians import ActivatedGaussians, GaussianModel
from ..ops.kernels import particle_response
from ..utils.profiling import count, span
from .binning import plan_capacity, untile
from .rows_vjp import frame_params
from .tiled import TiledRenderer, _camera_mats


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


def _mesh_pass(dev: _DeviceScene, hcfg: HybridConfig, rays: torch.Tensor,
               shadow_act: Optional[ActivatedGaussians] = None,
               cfg: Optional[RenderConfig] = None):
    """Closest hit + local shading for every pixel of the (H, W, 6) [o, d]
    rays, misses included (their color is then zeroed); t = inf where
    missed.  The camera sits at the first ray's origin.

    `shadow_act`, optional, turns on Gaussian->mesh shadows: each light's
    contribution is scaled by the Gaussian field's transmittance along the
    shadow ray from the hit point."""
    h, w = rays.shape[:2]
    rays = rays.reshape(-1, 6)
    count("gvrt.mesh.tris", dev.num_tris)
    hit = dev.closest_hit(rays)
    missed = hit["tri"] < 0
    with span("gvrt.mesh.shade"):
        surf = _surface_attributes(dev, hit, rays)
        view = rays[0, 0:3] - surf["pos"]
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


class CombinedRenderer:
    """Gaussians and an opaque mesh scene in one frame, set up once.

    The mesh (`scene`) is packed, Morton-ordered and uploaded here; the
    Gaussian pass is a held `TiledRenderer`, whose `plan` this `plan` is.
    One instance serves any camera of (width, height) and any model on
    `device` (CUDA unless "cpu" is asked for); `impl` as `TiledRenderer`'s.
    """

    def __init__(self, width: int, height: int, scene: MeshScene,
                 cfg: RenderConfig = DEFAULT_CONFIG,
                 hcfg: HybridConfig = HybridConfig(), impl: str = "auto",
                 device=None, capacity: Optional[tuple] = None):
        self.gaussians = TiledRenderer(width, height, cfg, capacity=capacity,
                                       impl=impl, device=device)
        self.width, self.height, self.cfg, self.hcfg = width, height, cfg, hcfg
        self.device, self.impl = self.gaussians.device, self.gaussians.impl
        self.mesh = _DeviceScene(scene, hcfg, self.device)

    def plan(self, model: GaussianModel, cameras, **kw) -> tuple:
        """The Gaussian pass's capacity over `cameras`
        (`TiledRenderer.plan`)."""
        return self.gaussians.plan(model, cameras, **kw)

    @span("gvrt.frame")
    def render(self, model: GaussianModel, camera,
               gaussian_shadows: bool = False):
        """Render one frame -> the dict of `render_combined`.  Capacity
        overflow re-plans and re-marches once, as `TiledRenderer.render`
        does (one host read of the overflow count a frame).
        Differentiable w.r.t. the model when grad is enabled: the mesh
        pass carries no gradient (the clip distances only gate the march's
        accept tests, and the shadow pass sees the model detached)."""
        g = self.gaussians
        g._check_model(model)
        if g.capacity is None:
            g.plan(model, [camera])
        ts = self.cfg.tile_size
        act, rows64 = frame_params(model, self.cfg, self.impl)
        with torch.no_grad():
            rays = g._rays(camera)                       # (T, 24, R)
            with span("gvrt.mesh"):
                mesh_rgb, t_mesh = _mesh_pass(
                    self.mesh, self.hcfg,
                    untile(rays[:, 0:6], self.width, self.height, ts),
                    shadow_act=act if gaussian_shadows else None,
                    cfg=self.cfg)
            clip = t_mesh.reshape(self.height // ts, ts, self.width // ts,
                                  ts).permute(0, 2, 1, 3).reshape(
                                      rays.shape[0], -1)
            rays[:, 7] = torch.minimum(rays[:, 7], clip)
        out = g._render_once(act, rows64, camera, rays)
        if int(out["overflow"]) > 0:
            g._replan_merged(model, camera)
            out = g._render_once(act, rows64, camera, rays)

        transmittance = out["transmittance"]
        rgb = out["rgb"] + transmittance[..., None] * mesh_rgb
        # depth composites the mesh as the opaque tail (an alpha = 1
        # surface at mesh_t adds T_at_surface * mesh_t, as the radiance
        # composite does); pixels with neither Gaussians nor mesh stay 0
        depth = out["depth"] + transmittance * torch.where(
            torch.isfinite(t_mesh), t_mesh, 0.0)
        return {
            "rgb": rgb,
            "gaussian_rgb": out["rgb"],
            "mesh_rgb": mesh_rgb,
            "mesh_t": t_mesh,
            "depth": depth,
            "transmittance": transmittance,
            "hit_count": out["hit_count"],
            "overflow": out["overflow"],
        }


def render_combined(model: GaussianModel, scene: MeshScene, camera,
                    cfg: RenderConfig = DEFAULT_CONFIG,
                    hcfg: HybridConfig = HybridConfig(),
                    impl: str = "auto",
                    capacity: Optional[tuple] = None,
                    gaussian_shadows: bool = False):
    """Render Gaussians and an opaque mesh scene in one frame, on the
    model's device: a one-frame `CombinedRenderer`, planned by
    `plan_capacity` unless `capacity` is given.

    Returns rgb (H, W, 3), gaussian_rgb, mesh_rgb, mesh_t (per-pixel
    surface distance, inf where no mesh), depth, transmittance, hit_count
    and overflow.  Differentiable w.r.t. the model when grad is enabled.
    Serving callers wrap it in `torch.no_grad()`, which runs K1 alone.
    """
    if capacity is None:
        with torch.no_grad():
            capacity = plan_capacity(model.activate(), *_camera_mats(camera),
                                     camera.width, camera.height, cfg)
    r = CombinedRenderer(camera.width, camera.height, scene, cfg, hcfg,
                         impl, model.device, capacity=capacity)
    return r.render(model, camera, gaussian_shadows=gaussian_shadows)
