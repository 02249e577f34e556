"""Cameras of the reference: the orbit pose, the Vulkan projection, the
per-pixel rays and their tiled layout, worked out from the view alone.

A `View` is what the benchmark hands both sides: a camera-to-world pose,
the vertical field of view and the image size.  The program gets the
same numbers as its own Camera; the reference builds its matrices and
rays here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .math import Settings, clip_box, sh_basis


class View(NamedTuple):
    c2w: np.ndarray   # (4, 4) float64 camera-to-world, row-major
    fovy_deg: float
    width: int
    height: int


def orbit_view(center, radius: float, angle_deg: float, fovy_deg: float,
               width: int, height: int) -> View:
    """A camera on the circle of `radius` about the vertical (y) axis
    through `center`, at elevation 0, looking at `center` with y up.  At
    angle 0 it sits at center + (0, 0, radius) and looks down -z."""
    center = np.asarray(center, np.float64)
    a = math.radians(angle_deg)
    eye = center + radius * np.array([math.sin(a), 0.0, math.cos(a)])
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.array([0.0, 1.0, 0.0]))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = s, u, -f, eye
    return View(c2w, float(fovy_deg), int(width), int(height))


def projection(view: View, st: Settings) -> np.ndarray:
    """The Vulkan perspective (y flipped, depth to [0, 1]), float64."""
    t = math.tan(math.radians(view.fovy_deg) / 2.0)
    p = np.zeros((4, 4), dtype=np.float64)
    p[0, 0] = 1.0 / (view.width / view.height * t)
    p[1, 1] = -1.0 / t
    p[2, 2] = -st.far / (st.far - st.near)
    p[2, 3] = -(st.far * st.near) / (st.far - st.near)
    p[3, 2] = -1.0
    return p


def matrices(view: View, st: Settings):
    """(w2c, proj) float32, each inverted in float64 from the inverse the
    camera keeps (the projection is kept as its inverse)."""
    proj_inv = np.linalg.inv(projection(view, st))
    return (np.linalg.inv(view.c2w).astype(np.float32),
            np.linalg.inv(proj_inv).astype(np.float32))


def pixel_rays(view: View, st: Settings):
    """(H, W, 3) origins and unit directions, float32, pixel (0, 0) top
    left, through pixel centres."""
    h, w = view.height, view.width
    proj_inv = np.linalg.inv(projection(view, st))
    xs = (np.arange(w, dtype=np.float64) + 0.5) / w * 2.0 - 1.0
    ys = (np.arange(h, dtype=np.float64) + 0.5) / h * 2.0 - 1.0
    dx, dy = np.meshgrid(xs, ys)
    ndc = np.stack([dx, dy, np.ones_like(dx), np.ones_like(dx)], axis=-1)
    target = ndc @ proj_inv.T
    dirs = target[..., :3] @ view.c2w[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = np.broadcast_to(view.c2w[:3, 3], dirs.shape)
    return origin.astype(np.float32), dirs.astype(np.float32)


def tile_rays(view: View, st: Settings, device) -> torch.Tensor:
    """(tiles, 24, R) rays in tile order: rows [o, d, tmin, tmax, 16 SH
    basis values], ray r of a tile at (r // ts, r % ts) inside it."""
    o, d = pixel_rays(view, st)
    o = torch.as_tensor(np.ascontiguousarray(o), device=device)
    d = torch.as_tensor(np.ascontiguousarray(d), device=device)
    tmin, tmax = clip_box(st.aabb, o, d)
    basis = sh_basis(d[..., 0], d[..., 1], d[..., 2], st.sh_degree)
    rays = torch.cat([o, d, tmin[..., None], tmax[..., None],
                      torch.stack(basis, dim=-1)], dim=-1)
    ts, h, w = st.tile_size, view.height, view.width
    return (rays.reshape(h // ts, ts, w // ts, ts, 24).permute(0, 2, 4, 1, 3)
            .reshape(-1, 24, ts * ts).contiguous())


def to_tiles(img: torch.Tensor, ts: int) -> torch.Tensor:
    """(H, W, C) image -> (tiles, C, R) in tile_rays' order."""
    h, w, c = img.shape
    return (img.reshape(h // ts, ts, w // ts, ts, c).permute(0, 2, 4, 1, 3)
            .reshape(-1, c, ts * ts))


def from_tiles(acc: torch.Tensor, width: int, height: int,
               ts: int) -> torch.Tensor:
    """(tiles, C, R) -> (H, W, C)."""
    c = acc.shape[1]
    return (acc.reshape(height // ts, width // ts, c, ts, ts)
            .permute(0, 3, 1, 4, 2).reshape(height, width, c))
