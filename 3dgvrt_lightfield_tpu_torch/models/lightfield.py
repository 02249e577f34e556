"""Gaussian light-field precompute.

Counterpart of the JAX package's `models/lightfield.py`, the reference
viewer's namesake feature (GAUSSIAN_LIGHT_FIELD): the Gaussian scene is
rendered from sampling cameras placed on the object's bounding volume into
a 180x180 image array plus a per-ray direction buffer, and dumped as PNGs.

The protocol, as the JAX package reproduces it:
  * the object's AABB from the Gaussian centers only; center = the AABB's
    midpoint, maxR = half its longest extent;
  * 4 cameras at center +- maxR on the X and Y axes, looking at the center
    with up = +Z;
  * one shared 135-degree perspective (aspect 1, near/far of the config)
    through the Vulkan-patched projection;
  * every ray's world direction recorded; images written as
    sampling_cam%04d.png, directions as ray_dirs.npy.

Rendering is a batch of cameras through the tile kernel (K1) at tile 20
(400 rays per tile): `TiledRenderer` on one card, or
`parallel.render_batch_sharded` over a mesh of ranks.  Images are stored
row-major (H, W); the reference shader writes the transpose.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..io.cameras import Camera, look_at_inverse, perspective_vulkan
from .gaussians import GaussianModel


@dataclasses.dataclass(frozen=True)
class LightFieldConfig:
    """The reference viewer's GaussianLightField defaults."""
    num_cameras: int = 4
    width: int = 180
    height: int = 180
    fov_deg: float = 135.0
    #: tile size for the render (180 = 9 * 20; the main default 16 does not
    #: divide 180)
    tile_size: int = 20


def sampling_cameras(model: GaussianModel,
                     lf: LightFieldConfig = LightFieldConfig(),
                     cfg: RenderConfig = DEFAULT_CONFIG) -> List[Camera]:
    """Cameras on the bounding volume of the Gaussian centers."""
    pos = model.means.detach().cpu().numpy()
    lo, hi = pos.min(axis=0), pos.max(axis=0)
    center = (lo + hi) / 2.0
    max_r = float((hi - lo).max() / 2.0)
    up = np.asarray([0.0, 0.0, 1.0])
    positions = [
        center + np.asarray([max_r, 0.0, 0.0]),
        center + np.asarray([0.0, max_r, 0.0]),
        center - np.asarray([max_r, 0.0, 0.0]),
        center - np.asarray([0.0, max_r, 0.0]),
    ][: lf.num_cameras]

    proj = perspective_vulkan(np.radians(lf.fov_deg), lf.width / lf.height,
                              cfg.near, cfg.far)
    proj_inv = np.linalg.inv(proj)
    return [Camera(width=lf.width, height=lf.height,
                   view_inverse=look_at_inverse(eye, center, up),
                   proj_inverse=proj_inv, name=f"sampling_cam{i:04d}")
            for i, eye in enumerate(positions)]


@torch.no_grad()
def compute_light_field(model: GaussianModel,
                        lf: LightFieldConfig = LightFieldConfig(),
                        cfg: RenderConfig = DEFAULT_CONFIG,
                        impl: str = "auto", mesh=None, device=None):
    """Render the light-field sample set.

    Returns a dict with images (C, H, W, 3) float [0, 1], ray_dirs (C, H, W,
    3) and the cameras.  With `mesh` the camera batch is sharded over its
    ranks (every rank gets every image); else it renders on `device` (the
    card unless ``device="cpu"``), where the model must live."""
    from ..render.tiled import TiledRenderer
    cams = sampling_cameras(model, lf, cfg)
    render_cfg = cfg.replace(tile_size=lf.tile_size)
    ray_dirs = np.stack([cam.rays()[1] for cam in cams])

    if mesh is not None:
        from ..parallel.sharding import camera_batch, render_batch_sharded
        from ..render.binning import plan_capacity
        from ..render.tiled import _camera_mats
        act = model.activate()
        cap = 0
        for cam in cams:
            w2c, proj = _camera_mats(cam)
            c, _ = plan_capacity(act, w2c, proj, lf.width, lf.height,
                                 render_cfg)
            cap = max(cap, c)
        nt = (lf.width // lf.tile_size) * (lf.height // lf.tile_size)
        cap_pad = cap + (nt + 1) * render_cfg.chunk_size
        batch = camera_batch(cams, render_cfg, mesh.device, impl=impl)
        imgs = render_batch_sharded(model, batch, mesh, lf.width, lf.height,
                                    render_cfg, cap, cap_pad, impl=impl)
        images = imgs[..., 0:3].cpu().numpy()
    else:
        r = TiledRenderer(lf.width, lf.height, render_cfg, impl=impl,
                          device=device)
        r.plan(model, cams)
        images = np.stack([r.render(model, cam)["rgb"].cpu().numpy()
                           for cam in cams])

    return {"images": images, "ray_dirs": ray_dirs, "cameras": cams}


def save_light_field(out_dir: str, result) -> List[str]:
    """Write sampling_cam%04d.png and ray_dirs.npy."""
    from ..io.image import save_png
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, img in enumerate(result["images"]):
        path = os.path.join(out_dir, f"sampling_cam{i:04d}.png")
        save_png(path, img)
        paths.append(path)
    np.save(os.path.join(out_dir, "ray_dirs.npy"), result["ray_dirs"])
    return paths
