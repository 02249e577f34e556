"""The hybrid frame pipeline: G-buffer -> lit image with RT shadows/bounces.

Rebuild of VulkanHybrid's two-pass frame (VulkanHybrid.cpp:1440-1470), as
the JAX package's `hybrid/pipeline.py` does it: pass 0 casts primary rays
for the G-buffer contents, pass 1 shades them with ray-traced shadows and
an iterative reflection/refraction loop (shaders/glsl/VulkanHybrid/
raygen.rgen) of `iterations - 1` bounces with per-pixel active masks.
Everything runs on the card unless the caller asks for the CPU; the
config's switches select code paths on the host, device values never do.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device
from ..utils.profiling import span
from .mesh import MeshScene
from .shade import (AMBIENT, SHADOW_EPS, LightAttenuation, _norm, base_f0,
                    direct_lighting, procedural_sky, reflect, refract,
                    sample_env_cube, sample_env_equirect,
                    sample_texture_bilinear)
from .trace import closest_hit, occluded, pack_triangles


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RayOption push constants + ITERATIONS (define.glsl:18-29)."""
    shadow_rays: bool = True
    reflection: bool = True
    refraction: bool = True
    iterations: int = 6          # bounce loop runs iterations - 1
    attenuation: LightAttenuation = LightAttenuation()
    gamma_correct: bool = True
    tri_chunk: int = 512
    ray_block: int = 16384       # rays the CPU's chunk loop traces at once

    def replace(self, **kw) -> "HybridConfig":
        return dataclasses.replace(self, **kw)


def _unit(x):
    return x / _norm(x, keepdim=True).clamp_min(1e-12)


class _DeviceScene:
    """Packed tensors of one animated scene snapshot on one device."""

    def __init__(self, scene: MeshScene, cfg: HybridConfig, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        dev = self.device

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        self.num_tris = scene.num_tris
        self.tris = pack_triangles(scene.tri_pos, cfg.tri_chunk, device=dev)
        self.tri_normal = t(scene.tri_normal)      # (T, 3, 3)
        self.tri_tangent = t(scene.tri_tangent)    # (T, 3, 4)
        self.tri_uv = t(scene.tri_uv)              # (T, 3, 2)
        self.tri_material = t(scene.tri_material, torch.int64)
        self.materials = t(scene.material_table())  # (M, 16)
        self.lights = t(scene.light_table())         # (L, 8)
        self.textures = [t(x) for x in scene.textures]
        self.env = t(scene.env_map) if scene.env_map is not None else None
        cube = getattr(scene, "env_cube", None)
        self.env_cube = t(cube) if cube is not None else None

    def background(self, dirs):
        # cubemap first: the reference's miss path samples a KTX samplerCube
        # (VulkanHybrid raygen.rgen:67-74); equirect and procedural sky are
        # the fallbacks for scenes without one
        if self.env_cube is not None:
            return sample_env_cube(self.env_cube, dirs)
        if self.env is not None:
            return sample_env_equirect(self.env, dirs)
        return procedural_sky(dirs)

    def closest_hit(self, rays):
        return closest_hit(rays, self.tris,
                           tmin=torch.full((rays.shape[0],), 1e-3,
                                           device=rays.device),
                           batch=self.cfg.ray_block)


def _surface_attributes(dev: _DeviceScene, hit, rays):
    """Interpolate hit-point attributes (closesthit.rchit unpackTriangle)."""
    tri = hit["tri"].clamp_min(0)
    w_u = hit["u"][:, None]
    w_v = hit["v"][:, None]
    w0 = 1.0 - w_u - w_v

    tn = dev.tri_normal[tri]                     # (R, 3, 3)
    n = _unit(w0 * tn[:, 0] + w_u * tn[:, 1] + w_v * tn[:, 2])
    tuv = dev.tri_uv[tri]
    uv = w0 * tuv[:, 0] + w_u * tuv[:, 1] + w_v * tuv[:, 2]

    mat_id = dev.tri_material[tri]
    m = dev.materials[mat_id]                    # (R, 16)
    albedo = m[:, 0:3]
    metallic = m[:, 3]
    roughness = m[:, 4]
    emissive = m[:, 5:8]
    ior = m[:, 8]
    reflectance = m[:, 9]
    refractance = m[:, 10]

    # tangent frame for normal mapping (mrt.frag applies the normal map in
    # the reference's G-buffer pass; glTF tangent w carries handedness)
    tt = dev.tri_tangent[tri]                    # (R, 3, 4)
    tang = w0 * tt[:, 0, :3] + w_u * tt[:, 1, :3] + w_v * tt[:, 2, :3]
    t_norm = _norm(tang, keepdim=True)
    has_tangent = t_norm[:, 0] > 1e-6
    tang = tang / t_norm.clamp_min(1e-12)
    # Gram-Schmidt against the interpolated normal, bitangent via w sign
    tang = _unit(tang - torch.sum(tang * n, dim=-1, keepdim=True) * n)
    bitan = torch.linalg.cross(n, tang, dim=-1) * tt[:, 0, 3:4]

    # texture fetches: one pass per texture of the scene; the material's
    # slots are floats and compared as floats, as the JAX package does
    for k, tex in enumerate(dev.textures):
        texel = sample_texture_bilinear(tex, uv)
        albedo = torch.where(m[:, 11:12] == k, texel[:, :3] ** 2.2,
                             albedo)                # sRGB -> linear
        mr = torch.where(m[:, 12:13] == k, texel[:, :3], 0.0)
        metallic = torch.where(m[:, 12] == k, mr[:, 2] * metallic, metallic)
        roughness = torch.where(m[:, 12] == k, mr[:, 1] * roughness,
                                roughness)
        emissive = torch.where(m[:, 13:14] == k, texel[:, :3], emissive)
        tnm = texel[:, :3] * 2.0 - 1.0           # tangent-space normal map
        n_mapped = _unit(tnm[:, 0:1] * tang + tnm[:, 1:2] * bitan
                         + tnm[:, 2:3] * n)
        use = (m[:, 14] == k) & has_tangent
        n = torch.where(use[:, None], n_mapped, n)

    pos = rays[:, 0:3] + hit["t"][:, None] * rays[:, 3:6]
    return {
        "pos": pos, "normal": n, "albedo": albedo, "metallic": metallic,
        "roughness": roughness, "emissive": emissive, "ior": ior,
        "reflectance": reflectance, "refractance": refractance,
        "object": mat_id,
    }


def _shade_local(dev: _DeviceScene, cfg: HybridConfig, surf, view,
                 light_atten=None):
    """Ambient + emissive + per-light GGX with shadow rays
    (raygen.rgen:97-145 == closesthit.rchit:100-145).

    `light_atten` (P, num_lights), optional: continuous per-pixel
    attenuation multiplying each light's contribution (the combined
    renderer passes the Gaussian field's transmittance along the shadow
    ray, render/combined.py)."""
    albedo = surf["albedo"]
    bounce_surface = torch.zeros_like(surf["reflectance"], dtype=torch.bool)
    if cfg.reflection:
        bounce_surface = bounce_surface | (surf["reflectance"] > 0.0)
    if cfg.refraction:
        bounce_surface = bounce_surface | (surf["refractance"] > 0.0)
    albedo = torch.where(bounce_surface[:, None], 0.0, albedo)

    f0 = base_f0(surf["ior"], albedo, surf["metallic"])
    color = AMBIENT * albedo + surf["emissive"]

    pos = surf["pos"]
    for li in range(dev.lights.shape[0]):
        lrow = dev.lights[li]
        lpos = lrow[0:3]
        lradius = lrow[3]
        lcolor = lrow[4:7]
        to_l = lpos - pos
        dist = _norm(to_l)
        lit = dist <= lradius               # radius cull (raygen.rgen:113)
        if cfg.shadow_rays:
            sdir = to_l / dist.clamp_min(1e-12)[:, None]
            tmax = torch.where(dist >= 0.5, dist - 0.5, dist)
            origin = pos + sdir * SHADOW_EPS
            srays = torch.cat([origin, sdir], dim=1)
            shadowed = occluded(srays, dev.tris, torch.full_like(dist, 0.1),
                                tmax, batch=cfg.ray_block)
            lit = lit & ~shadowed
        contrib = direct_lighting(
            pos, surf["normal"], view, albedo, surf["metallic"],
            surf["roughness"], f0, lpos, lcolor, lradius, lit,
            cfg.attenuation)
        if light_atten is not None:
            contrib = contrib * light_atten[:, li][:, None]
        color = color + contrib
    return color


def _render_rays(dev: _DeviceScene, cfg: HybridConfig, rays, cam_pos):
    r = rays.shape[0]
    hit = dev.closest_hit(rays)
    miss = hit["tri"] < 0
    surf = _surface_attributes(dev, hit, rays)

    view = _unit(cam_pos - surf["pos"])
    color = _shade_local(dev, cfg, surf, view)

    # reflection / refraction loop (raygen.rgen:147-190)
    if cfg.reflection or cfg.refraction:
        zero = torch.zeros((r,), device=rays.device)
        state = {
            "pos": surf["pos"],
            "n": surf["normal"],
            "v": -view,
            "product": torch.ones((r,), device=rays.device),
            "ior_prev": torch.ones((r,), device=rays.device),
            "ior": surf["ior"],
            "reflectance": surf["reflectance"] if cfg.reflection else zero,
            "refractance": surf["refractance"] if cfg.refraction else zero,
            "active": ~miss,
            "color": color,
        }
        for _ in range(cfg.iterations - 1):
            state = _bounce(dev, cfg, state)
        color = state["color"]

    bg = dev.background(rays[:, 3:6])
    color = torch.where(miss[:, None], bg, color)
    if cfg.gamma_correct:
        color = torch.where(miss[:, None], color,
                            color.clamp_min(0.0) ** (1.0 / 2.2))
    return color, hit, surf


def _bounce(dev: _DeviceScene, cfg: HybridConfig, s):
    """One reflection/refraction iteration with per-pixel masks."""
    refr = s["active"] & (s["refractance"] > 0.0)
    refl = s["active"] & ~refr & (s["reflectance"] > 0.0)
    go = refr | refl

    # refraction: flip normal when exiting, swap IORs (raygen.rgen:156-166)
    inside = torch.sum(s["v"] * s["n"], dim=-1) > 0.0
    n_eff = torch.where((refr & inside)[:, None], -s["n"], s["n"])
    ior_from = torch.where(refr & inside, s["ior"], s["ior_prev"])
    ior_to = torch.where(refr & inside, 1.0, s["ior"])
    v_refr = refract(s["v"], n_eff, ior_from / ior_to.clamp_min(1e-6))
    v_refl = reflect(s["v"], s["n"])

    v_new = _unit(torch.where(refr[:, None], v_refr, v_refl))
    pos_new = torch.where(refr[:, None], s["pos"] - n_eff * 0.01,
                          s["pos"] + s["n"] * 0.01)
    product = s["product"] * torch.where(
        refr, s["refractance"], torch.where(refl, s["reflectance"], 1.0))

    rays = torch.cat([pos_new, v_new], dim=1)
    hit = dev.closest_hit(rays)
    miss = hit["tri"] < 0
    surf = _surface_attributes(dev, hit, rays)
    hit_color = _shade_local(dev, cfg, surf, -v_new)
    env_color = dev.background(v_new)
    add = torch.where(miss[:, None], env_color, hit_color)
    color = s["color"] + torch.where(go[:, None], product[:, None] * add, 0.0)

    return {
        "pos": torch.where(go[:, None], surf["pos"], s["pos"]),
        "n": torch.where(go[:, None], surf["normal"], s["n"]),
        "v": torch.where(go[:, None], v_new, s["v"]),
        "product": product,
        "ior_prev": torch.where(refr, ior_from, s["ior_prev"]),
        "ior": torch.where(go, surf["ior"], s["ior"]),
        "reflectance": torch.where(go, surf["reflectance"], 0.0),
        "refractance": torch.where(go, surf["refractance"], 0.0),
        "active": go & ~miss,
        "color": color,
    }


class HybridRenderer:
    """Prepared hybrid pipeline for one scene (animatable per frame).

    `device` defaults to CUDA (and raises without it); pass "cpu" for the
    CPU."""

    def __init__(self, width: int, height: int,
                 cfg: Optional[HybridConfig] = None, device=None):
        self.width = width
        self.height = height
        self.cfg = cfg or HybridConfig()
        self.device = resolve_device(device)

    @torch.no_grad()
    @span("gvrt.frame")
    def render(self, scene: MeshScene, camera, time: float = 0.0):
        """Render one frame -> dict of rgb (H, W, 3), depth (H, W), object
        (H, W) int32 (-1 on a miss) and the G-buffer planes position,
        normal and albedo (H, W, 3)."""
        scene_t = scene.animated(time)
        dev = _DeviceScene(scene_t, self.cfg, self.device)
        o, d = camera.rays()
        rays = torch.as_tensor(np.concatenate([o, d], axis=-1).reshape(-1, 6),
                               device=self.device)
        cam_pos = torch.as_tensor(
            np.asarray(camera.view_inverse[:3, 3], np.float32),
            device=self.device)
        color, hit, surf = _render_rays(dev, self.cfg, rays, cam_pos)
        h, w = self.height, self.width
        miss = hit["tri"] < 0
        return {
            "rgb": torch.clamp(color, 0.0, 1.0).reshape(h, w, 3),
            "depth": torch.where(miss, 0.0, hit["t"]).reshape(h, w),
            "object": torch.where(miss, -1, surf["object"]).to(
                torch.int32).reshape(h, w),
            # G-buffer planes (mrt.frag outputs) for parity/debugging
            "position": surf["pos"].reshape(h, w, 3),
            "normal": surf["normal"].reshape(h, w, 3),
            "albedo": surf["albedo"].reshape(h, w, 3),
        }


def render_hybrid(scene: MeshScene, camera, width: int, height: int,
                  cfg: Optional[HybridConfig] = None, time: float = 0.0,
                  device=None):
    """One-shot convenience wrapper."""
    return HybridRenderer(width, height, cfg, device).render(scene, camera,
                                                             time)
