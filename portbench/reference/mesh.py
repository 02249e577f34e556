"""Mesh objects inserted into a Gaussian scene, in plain PyTorch: the mesh
the configuration describes, its closest hits, shadow rays and local GGX
shading, and the frame composited over the Gaussian reference.

The triangles are built here from the configuration's numbers (a floor
quad, an icosphere subdivided from the icosahedron); the rays are the
reference's own (`camera.pixel_rays`).  Every triangle is tested against
every ray (Moller-Trumbore, blocks of rays, no spatial order and no cull)
in the dtype of the inputs.  The rules are the program's, taken from the
reference viewer's shaders:

  * a primary hit lies in [1e-3, 1e30] (miss: t = inf, colour 0); the
    closest hit wins, and of hits at the same t the first in this file's
    triangle order (the program's Morton order may pick another; the
    normals are smooth, so the colour is the same);
  * a shadow ray leaves the hit point towards the light from 0.1 along it
    (define.glsl SHADOW_RAY_ORIGIN_MOVEMENT_EPSILON) and is blocked by a
    hit in [0.1, dist - 0.5] (dist where dist < 0.5); a light lights a
    point within its radius (raygen.rgen:113);
  * shading is ambient 0.05 * albedo + emissive + each light's GGX term
    (pbr.glsl: the GGX distribution, Smith geometry with Schlick-GGX,
    Schlick Fresnel on dot(H, V) as raygen.rgen:129 feeds it, F0 the mix of
    ((ior - 1) / (ior + 1))^2 and the albedo by metalness, the two-piece
    light attenuation of VulkanRTBase.h:243-247);
  * the Gaussians march each ray up to its mesh hit (the ray's tmax
    clipped to t), and the frame is gaussian_rgb + T * mesh_rgb, depth
    gaussian_depth + T * t where the mesh is hit.

Departures from the published equations: the hit test rounds each product
and sum once in the dtype (no fused multiply-adds, which the program
emulates); the normal is interpolated over the triangle and normalised,
as the viewer's closest-hit shader does; materials have no textures, no
reflection and no refraction (the configuration's have none).
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: primary rays' tmin and the miss distance of the hit test
TMIN, FAR = 1e-3, 1e30
#: the shadow ray's origin offset and tmin; the margin kept short of the
#: light
SHADOW_EPS, SHADOW_TMIN, LIGHT_MARGIN = 0.1, 0.1, 0.5
AMBIENT = 0.05
#: the light attenuation curve (alpha, beta, gamma)
ATTENUATION = (0.6, 0.8, 0.2)
#: rays per block of the hit test
RAY_BLOCK = 1 << 15


def icosphere(radius: float, center, subdiv: int):
    """(vertices (V, 3) float32, faces (F, 3) int64, unit normals (V, 3)
    float32): the icosahedron's faces split in four `subdiv` times, new
    vertices at the edges' midpoints pushed onto the unit sphere (float64,
    then float32), scaled by `radius` and moved to `center` in float32."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [np.array(v, np.float64) for v in (
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
        (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
        (-t, 0, -1), (-t, 0, 1))]
    verts = [v / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdiv):
        mid = {}

        def middle(i, j):
            key = (min(i, j), max(i, j))
            if key not in mid:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        split = []
        for i, j, k in faces:
            a, b, c = middle(i, j), middle(j, k), middle(k, i)
            split += [(i, a, c), (j, b, a), (k, c, b), (a, b, c)]
        faces = split
    unit = torch.tensor(np.array(verts), dtype=torch.float32)
    v = unit * float(radius) + torch.tensor(center, dtype=torch.float32)
    return v, torch.tensor(faces, dtype=torch.int64), unit


class Mesh:
    """The configuration's mesh on one device: triangles (T, 3, 3), vertex
    normals (T, 3, 3), a material row per triangle (T, 6: albedo rgb,
    metallic, roughness, ior), the lights (L, 7: position, radius, rgb)."""

    def __init__(self, spec: dict, device):
        def material(m):
            return list(m["base_color"][:3]) + [m["metallic"], m["roughness"],
                                                m.get("ior", 1.45)]

        c = torch.tensor(spec["floor"], dtype=torch.float32)
        floor = torch.stack([c[[0, 1, 2]], c[[0, 2, 3]]])
        fn = torch.linalg.cross(floor[:, 1] - floor[:, 0],
                                floor[:, 2] - floor[:, 0], dim=-1)
        fn = fn / torch.linalg.vector_norm(fn, dim=-1, keepdim=True)
        v, f, n = icosphere(spec["sphere_radius"], spec["sphere_center"],
                            int(spec["sphere_subdiv"]))
        n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
        self.tris = torch.cat([floor, v[f]]).to(device)
        self.normals = torch.cat([fn[:, None].expand(2, 3, 3),
                                  n[f]]).to(device)
        rows = [material(spec["floor_material"])] * 2 + \
            [material(spec["sphere_material"])] * len(f)
        self.materials = torch.tensor(rows, dtype=torch.float32,
                                      device=device)
        self.lights = torch.tensor(
            [list(spec["light_position"]) + [spec["light_radius"]]
             + list(spec["light_color"])], dtype=torch.float32, device=device)
        self.shadows = bool(spec["shadow_rays"])

    def to(self, dtype):
        out = object.__new__(Mesh)
        out.tris, out.normals, out.materials, out.lights = (
            x.to(dtype) for x in (self.tris, self.normals, self.materials,
                                  self.lights))
        out.shadows = self.shadows
        return out


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


def intersect(o, d, tris):
    """Moller-Trumbore of rays (R, 3) against every triangle (T, 3, 3) ->
    t, u, v (R, T) and the hit mask (R, T), two-sided, |det| > 1e-9."""
    v0, e1, e2 = tris[:, 0], tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    p = _cross(d[:, None], e2[None])                 # (R, T, 3)
    det = _dot(e1[None], p)
    ok = det.abs() > 1e-9
    inv = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    s = o[:, None] - v0[None]
    u = _dot(s, p) * inv
    q = _cross(s, e1[None].expand_as(s))
    v = _dot(d[:, None], q) * inv
    t = _dot(e2[None], q) * inv
    return t, u, v, ok & (u >= 0) & (v >= 0) & (u + v <= 1)


def closest_hits(o, d, mesh: Mesh):
    """(t (R,), inf on a miss; triangle (R,) int64, -1 on a miss; u, v)."""
    out = []
    for s in range(0, o.shape[0], RAY_BLOCK):
        t, u, v, hit = intersect(o[s:s + RAY_BLOCK], d[s:s + RAY_BLOCK],
                                 mesh.tris)
        t = torch.where(hit & (t >= TMIN) & (t <= FAR), t,
                        torch.full_like(t, math.inf))
        best, j = t.min(-1)                          # first of equal t's
        tri = torch.where(torch.isfinite(best), j, -1)
        pick = j[:, None]
        out.append((best, tri, u.gather(1, pick)[:, 0],
                    v.gather(1, pick)[:, 0]))
    return tuple(torch.cat(x) for x in zip(*out))


def occluded(o, d, tmax, mesh: Mesh):
    """Whether any triangle lies in [SHADOW_TMIN, tmax] along each ray."""
    out = []
    for s in range(0, o.shape[0], RAY_BLOCK):
        t, _, _, hit = intersect(o[s:s + RAY_BLOCK], d[s:s + RAY_BLOCK],
                                 mesh.tris)
        out.append((hit & (t >= SHADOW_TMIN)
                    & (t <= tmax[s:s + RAY_BLOCK, None])).any(-1))
    return torch.cat(out)


def _attenuation(color, dist, radius):
    """pbr.glsl ApplyAttenuation: a smooth falloff inside alpha * radius,
    then a quadratic tail that reaches about gamma at the radius."""
    a, b, g = ATTENUATION
    m = dist / (a * radius)
    near = 1.0 / (m * (1.0 - 1.0 / b) * (m - 2.0) + 1.0)
    intensity = color.amax(-1, keepdim=True)
    far = 1.0 / ((intensity / g - 1.0 / b) * (dist[..., None] - a * radius)
                 ** 2 / ((radius - a * radius) ** 2) + 1.0 / b)
    f = torch.where((dist <= a * radius)[..., None], near[..., None], far)
    return f.clamp(0.001, 1.0) * color


def _ggx(pos, n, view, albedo, metallic, rough, f0, light, lit):
    """One light's GGX contribution (raygen.rgen:121-141)."""
    to_l = light[0:3] - pos
    dist = torch.linalg.vector_norm(to_l, dim=-1)
    radiance = _attenuation(light[4:7], dist, light[3])
    l_dir = to_l / dist.clamp_min(1e-12)[:, None]
    h = _unit(view + l_dir)
    n_l = _dot(n, l_dir).clamp_min(0.0)
    n_v = _dot(n, view).clamp_min(0.0)
    f = f0 + (1.0 - f0) * (1.0 - _dot(h, view).clamp_min(0.0)).clamp(
        0.0, 1.0)[:, None] ** 5
    a2 = (rough * rough) ** 2
    n_h = _dot(n, h)
    dist_term = a2 / (math.pi * (n_h * n_h * (a2 - 1.0) + 1.0) ** 2)
    k = (rough + 1.0) ** 2 / 8.0
    geom = (n_v / (n_v * (1.0 - k) + k)) * (n_l / (n_l * (1.0 - k) + k))
    spec = (dist_term * geom)[:, None] * f / (4.0 * n_v * n_l + 1e-4)[:, None]
    kd = (1.0 - f) * (1.0 - metallic[:, None])
    out = (kd * albedo / math.pi + spec) * radiance * n_l[:, None]
    return torch.where(lit[:, None], out, torch.zeros_like(out))


def shade(o, d, mesh: Mesh):
    """The mesh pass of rays (R, 3) o, d: (colour (R, 3), t (R,), inf on a
    miss)."""
    t, tri, u, v = closest_hits(o, d, mesh)
    missed = tri < 0
    k = tri.clamp_min(0)
    nrm = mesh.normals[k]
    w0 = 1.0 - u - v
    n = _unit(w0[:, None] * nrm[:, 0] + u[:, None] * nrm[:, 1]
              + v[:, None] * nrm[:, 2])
    mat = mesh.materials[k]
    albedo, metallic, rough, ior = mat[:, 0:3], mat[:, 3], mat[:, 4], mat[:, 5]
    pos = o + torch.where(missed, torch.zeros_like(t), t)[:, None] * d
    view = _unit(o - pos)
    f0 = (((ior - 1.0) / (ior + 1.0)) ** 2 * (1.0 - metallic))[:, None] \
        + albedo * metallic[:, None]
    color = AMBIENT * albedo
    for light in mesh.lights:
        to_l = light[0:3] - pos
        dist = torch.linalg.vector_norm(to_l, dim=-1)
        lit = dist <= light[3]
        if mesh.shadows:
            sdir = to_l / dist.clamp_min(1e-12)[:, None]
            tmax = torch.where(dist >= LIGHT_MARGIN, dist - LIGHT_MARGIN,
                               dist)
            lit = lit & ~occluded(pos + sdir * SHADOW_EPS, sdir, tmax, mesh)
        color = color + _ggx(pos, n, view, albedo, metallic, rough, f0, light,
                             lit)
    color = torch.where(missed[:, None], torch.zeros_like(color), color)
    return color, t


def render(rows, binned, view, st, mesh: Mesh, dev):
    """The combined frame of `view` in rows' dtype, returned as float32:
    {rgb, depth, transmittance, hit_count, mesh_rgb, mesh_t} (H, W[, 3]).
    The mesh pass runs on the reference's own rays; the Gaussian rays'
    tmax is clipped to its t before the composite (`composite.render`)."""
    from . import camera, composite
    dtype, ts, h, w = rows.dtype, st.tile_size, view.height, view.width
    o, d = (torch.as_tensor(np.ascontiguousarray(x), device=dev)
            .reshape(-1, 3).to(dtype) for x in camera.pixel_rays(view, st))
    color, t = shade(o, d, mesh.to(dtype))
    rays = camera.tile_rays(view, st, dev)
    rays[:, 7] = torch.minimum(rays[:, 7], camera.to_tiles(
        t.float().reshape(h, w, 1), ts)[:, 0])
    img = camera.from_tiles(composite.render(rows, binned, rays, st), w, h,
                            ts)
    trans = img[..., 4]
    mesh_rgb, mesh_t = color.reshape(h, w, 3), t.reshape(h, w)
    out = {"rgb": img[..., 0:3] + trans[..., None] * mesh_rgb,
           "depth": img[..., 3] + trans * torch.where(
               torch.isfinite(mesh_t), mesh_t, torch.zeros_like(mesh_t)),
           "transmittance": trans, "hit_count": img[..., 5],
           "mesh_rgb": mesh_rgb, "mesh_t": mesh_t}
    return {k: v.float() for k, v in out.items()}
