"""Camera batches and the one-camera differentiable render of the trainer.

The single-card pieces of the JAX package's `parallel/sharding.py`:
`CameraBatch`, `camera_batch` and `_render_one`.  The sharded renderers and
the mesh (`make_mesh`, `render_batch_sharded`, `render_image_tile_sharded`,
...) come with multi-device work on `torch.distributed` (ROADMAP.md
section 1 item 11).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import RenderConfig, resolve_device
from ..render.binning import (bin_topology, binned_scene, gather_chunks,
                              tile_rays, untile)
from ..render.pallas_forward import forward_dispatch
from ..render.tiled import _camera_mats


class CameraBatch(NamedTuple):
    """Stacked per-camera render inputs; leading axis = camera."""
    w2c: np.ndarray      # (B, 4, 4) float32
    proj: np.ndarray     # (B, 4, 4) float32
    rays: torch.Tensor   # (B, num_tiles, 24, R): binning.tile_rays layout


def camera_batch(cameras: Sequence, cfg: RenderConfig,
                 device=None) -> CameraBatch:
    """Stack the cameras' matrices and tiled rays (rays on `device`, the
    card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    mats = [_camera_mats(cam) for cam in cameras]
    return CameraBatch(np.stack([m[0] for m in mats]),
                       np.stack([m[1] for m in mats]),
                       torch.stack([tile_rays(cam, cfg, dev)
                                    for cam in cameras]))


def _render_one(act, w2c, proj, rays, width, height, cfg: RenderConfig,
                cap: int, cap_pad: int, impl: str) -> torch.Tensor:
    """Bin, gather and composite one camera -> (H, W, 8) accumulator image,
    differentiable w.r.t. `act` through the gather (the topology is built
    without grad, as in the JAX package)."""
    with torch.no_grad():
        topo = bin_topology(act, w2c, proj, width, height, cfg, cap, cap_pad)
    acc = forward_dispatch(binned_scene(gather_chunks(act, topo, cfg, impl),
                                        topo), rays, cfg, impl)
    return untile(acc, width, height, cfg.tile_size)
