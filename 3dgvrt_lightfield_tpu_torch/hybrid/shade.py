"""PBR shading math for the hybrid renderer.

PyTorch version of the JAX package's `hybrid/shade.py`, itself a
re-derivation of shaders/glsl/base/pbr.glsl (GGX distribution, Smith
geometry, Schlick Fresnel, the two-piece light attenuation curve) and the
env-map background of raygen.rgen:67-74 / miss.rmiss.  All functions are
batched over leading ray dimensions.

Gathers clamp every index into range after the cast: JAX clamps an
out-of-range gather index silently, while on the card an index out of
range is a device assert (and a NaN coordinate casts to an arbitrary
integer).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

PI = np.pi
#: shadow-ray origin offset (define.glsl SHADOW_RAY_ORIGIN_MOVEMENT_EPSILON)
SHADOW_EPS = 0.1
#: ambient term (raygen.rgen:97 `vec3(0.05) * albedo`)
AMBIENT = 0.05


@dataclasses.dataclass(frozen=True)
class LightAttenuation:
    """Two-piece attenuation curve constants (VulkanRTBase.h:243-247)."""
    alpha: float = 0.6
    beta: float = 0.8
    gamma: float = 0.2


def _norm(x, keepdim=False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def apply_attenuation(color, dist, radius, att: LightAttenuation):
    """pbr.glsl ApplyAttenuation: smooth falloff inside alpha*radius, then a
    quadratic tail pinned so intensity ~gamma at the radius."""
    a, b, g = att.alpha, att.beta, att.gamma
    # near branch
    m_near = dist / (a * radius)
    n_near = 1.0 - 1.0 / b
    f_near = 1.0 / (m_near * n_near * (m_near - 2.0) + 1.0)
    # far branch
    m = a * radius
    n = 1.0 / b
    intensity = torch.amax(color, dim=-1, keepdim=True)
    denom = (1.0 / torch.as_tensor((radius - m) ** 2).clamp_min(1e-12)
             * (intensity / g - n) * (dist[..., None] - m) ** 2 + n)
    f_far = 1.0 / denom
    near = (dist <= a * radius)[..., None]
    f = torch.where(near, f_near[..., None], f_far)
    return torch.clamp(f, 0.001, 1.0) * color


def fresnel_schlick(cos_theta, f0):
    """pbr.glsl FresnelSchlick (explicit 5-factor product form)."""
    x = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return f0 + (1.0 - f0) * x ** 5


def distribution_ggx(n_dot_h, roughness):
    a2 = (roughness * roughness) ** 2
    denom = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom)


def geometry_schlick_ggx(n_dot_x, roughness):
    r = roughness + 1.0
    k = r * r / 8.0
    return n_dot_x / (n_dot_x * (1.0 - k) + k)


def geometry_smith(n_dot_v, n_dot_l, roughness):
    return (geometry_schlick_ggx(n_dot_v, roughness)
            * geometry_schlick_ggx(n_dot_l, roughness))


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def direct_lighting(pos, normal, view, albedo, metallic, roughness, f0,
                    light_pos, light_color, light_radius, lit_mask,
                    att: LightAttenuation):
    """One light's GGX contribution per pixel (raygen.rgen:121-141).

    All inputs (..., 3) or (...,); `lit_mask` folds in shadowing and the
    radius cull.  Returns (..., 3) radiance to add.
    """
    l_vec = light_pos - pos
    dist = _norm(l_vec)
    radiance = apply_attenuation(light_color, dist, light_radius, att)
    l = l_vec / dist.clamp_min(1e-12)[..., None]
    h = view + l
    h = h / _norm(h, keepdim=True).clamp_min(1e-12)

    n_dot_l = _dot(normal, l).clamp_min(0.0)
    n_dot_v = _dot(normal, view).clamp_min(0.0)
    # the reference feeds dot(H, V) into FresnelSchlick (raygen.rgen:129)
    h_dot_v = _dot(h, view).clamp_min(0.0)

    f = fresnel_schlick(h_dot_v[..., None], f0)
    spec = (distribution_ggx(_dot(normal, h), roughness)
            * geometry_smith(n_dot_v, n_dot_l, roughness))[..., None] * f
    spec = spec / (4.0 * n_dot_v * n_dot_l + 1e-4)[..., None]

    kd = (1.0 - f) * (1.0 - metallic[..., None])
    out = (kd * albedo / PI + spec) * radiance * n_dot_l[..., None]
    return torch.where(lit_mask[..., None], out, 0.0)


def base_f0(ior, albedo, metallic):
    """F0 = mix(((ior-1)/(ior+1))^2, albedo, metallic) (raygen.rgen:93-94)."""
    f0s = ((ior - 1.0) / (ior + 1.0)) ** 2
    return (f0s[..., None] * (1.0 - metallic[..., None])
            + albedo * metallic[..., None])


def reflect(v, n):
    return v - 2.0 * _dot(v, n)[..., None] * n


def refract(v, n, eta):
    """GLSL refract(); returns 0 on total internal reflection."""
    cos_i = -_dot(v, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = (eta[..., None] * v
           + (eta * cos_i - torch.sqrt(k.clamp_min(0.0)))[..., None] * n)
    return torch.where((k > 0.0)[..., None], out, 0.0)


def _index(x: torch.Tensor, n: int) -> torch.Tensor:
    """Float coordinate -> int64 index, truncated as a cast, in [0, n)."""
    return x.to(torch.int32).clamp(0, n - 1).long()


def sample_env_equirect(env: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Equirectangular env lookup (the stand-in for samplerCube when a scene
    ships an equirect map; the reference loads KTX cubemaps,
    VulkanRTBase.cpp:3656)."""
    h, w = env.shape[:2]
    d = dirs / _norm(dirs, keepdim=True).clamp_min(1e-12)
    u = (torch.atan2(d[..., 0], -d[..., 2]) / (2.0 * PI) + 0.5) * (w - 1)
    v = (torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0)) / PI) * (h - 1)
    return env[_index(v, h), _index(u, w)]


def sample_env_cube(faces: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Cubemap env lookup with Vulkan `samplerCube` semantics.

    `faces` is (6, S, S, C) in the Vulkan/KTX layer order
    [+X, -X, +Y, -Y, +Z, -Z]; face selection and the per-face (sc, tc)
    coordinates follow the Vulkan spec's cube-map face table
    (base/VulkanRTBase.cpp:3656, VulkanHybrid raygen.rgen:67-74).
    Bilinear filtering, clamp-to-edge within the face.
    """
    s = faces.shape[1]
    d = dirs / _norm(dirs, keepdim=True).clamp_min(1e-12)
    rx, ry, rz = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = rx.abs(), ry.abs(), rz.abs()

    x_major = (ax >= ay) & (ax >= az)
    y_major = (ay > ax) & (ay >= az)

    face = torch.where(
        x_major, torch.where(rx >= 0, 0, 1),
        torch.where(y_major, torch.where(ry >= 0, 2, 3),
                    torch.where(rz >= 0, 4, 5))).long()

    ma = torch.where(x_major, ax, torch.where(y_major, ay, az))
    # Vulkan cube face table: (sc, tc) per face
    sc = torch.where(x_major, torch.where(rx >= 0, -rz, rz),
                     torch.where(y_major, rx, torch.where(rz >= 0, rx, -rx)))
    tc = torch.where(y_major, torch.where(ry >= 0, rz, -rz), -ry)

    inv = 0.5 / ma.clamp_min(1e-12)
    u = (sc * inv + 0.5) * s - 0.5
    v = (tc * inv + 0.5) * s - 0.5
    u0 = _index(torch.floor(u), s)
    v0 = _index(torch.floor(v), s)
    u1 = (u0 + 1).clamp_max(s - 1)
    v1 = (v0 + 1).clamp_max(s - 1)
    fu = torch.clamp(u - u0, 0.0, 1.0)[..., None]
    fv = torch.clamp(v - v0, 0.0, 1.0)[..., None]
    return ((faces[face, v0, u0] * (1 - fu) + faces[face, v0, u1] * fu)
            * (1 - fv)
            + (faces[face, v1, u0] * (1 - fu) + faces[face, v1, u1] * fu)
            * fv)


def procedural_sky(dirs: torch.Tensor) -> torch.Tensor:
    """Fallback background when a scene ships no env map."""
    d = dirs / _norm(dirs, keepdim=True).clamp_min(1e-12)
    t = torch.clamp(0.5 * (d[..., 1] + 1.0), 0.0, 1.0)[..., None]
    white = torch.tensor([1.0, 1.0, 1.0], device=dirs.device)
    blue = torch.tensor([0.5, 0.7, 0.9], device=dirs.device)
    return (1.0 - t) * white + t * blue


def sample_texture_bilinear(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear REPEAT-wrap texture fetch; tex (H, W, C), uv (..., 2).

    `torch.remainder` is Python's (and JAX's) `%`: uv % 1.0 lies in [0, 1]."""
    h, w = tex.shape[:2]
    u = torch.remainder(uv[..., 0], 1.0) * (w - 1)
    v = torch.remainder(uv[..., 1], 1.0) * (h - 1)
    u0 = _index(torch.floor(u), w)
    v0 = _index(torch.floor(v), h)
    u1 = (u0 + 1).clamp_max(w - 1)
    v1 = (v0 + 1).clamp_max(h - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    return ((tex[v0, u0] * (1 - fu) + tex[v0, u1] * fu) * (1 - fv)
            + (tex[v1, u0] * (1 - fu) + tex[v1, u1] * fu) * fv)
