"""High-level tiled renderer: binning + fused kernel + image assembly.

`TiledRenderer.plan` measures pair counts to size the static capacities
(pairs, padded slots, gradient-reduce rows), `render` bins the scene for the
camera, gathers the per-pair parameter rows, runs the tile kernel and
untiles the image.  `bind` holds one camera's topology so `render_bound`
skips the binning pass.

Everything here runs on the card unless the caller passes ``device="cpu"``.
`render` and `render_bound` are differentiable when the caller has grad
enabled (the topology never is: `plan`, `bind` and binning run under
`torch.no_grad()`); serving callers wrap them in `torch.no_grad()`, which
keeps the forward kernel K1 without its training residual.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig, resolve_device
from ..models.gaussians import GaussianModel
from ..utils.profiling import count, span
from .binning import (bin_topology, binned_scene, frame_cull_table,
                      gather_chunks, gather_from_rows,
                      plan_capacity_from_table,
                      plan_reduce_capacity_from_table, tile_rays, untile)
from .pallas_forward import forward_dispatch, resolve_impl
from .rows_vjp import rows64_from_model
from .tile_math import ACC_DEPTH, ACC_HITS, ACC_T


def _camera_mats(camera):
    """(w2c, proj) as float32 NumPy matrices, inverted in float64 first."""
    w2c = np.linalg.inv(camera.view_inverse).astype(np.float32)
    proj = np.linalg.inv(camera.proj_inverse).astype(np.float32)
    return w2c, proj


def _acc_outputs(acc, width, height, cfg, topo):
    img = untile(acc, width, height, cfg.tile_size)
    return {
        "rgb": img[..., 0:3],
        "depth": img[..., ACC_DEPTH],
        "transmittance": img[..., ACC_T],
        "hit_count": img[..., ACC_HITS],
        "num_pairs": topo.num_pairs,
        "overflow": topo.overflow,
    }


class TiledRenderer:
    """Reusable tiled render pipeline with cached capacity plan and rays.

    One instance serves any camera of the same (width, height).  `device`
    defaults to CUDA (and raises without it); `impl` is "auto" (the kernel
    on CUDA, the plain version on the CPU), "cuda" or "torch".
    """

    def __init__(self, width: int, height: int,
                 cfg: RenderConfig = DEFAULT_CONFIG,
                 capacity: Optional[tuple] = None,
                 impl: str = "auto", device=None):
        if width % cfg.tile_size or height % cfg.tile_size:
            raise ValueError(f"{width}x{height} is not a multiple of the "
                             f"tile size {cfg.tile_size}")
        self.width, self.height, self.cfg = width, height, cfg
        self.device = resolve_device(device)
        self.impl = resolve_impl(impl, self.device)
        self.capacity = capacity
        #: static row count of the gradient-reduce layout (0: derived from
        #: the pair capacity; set by plan())
        self.capacity_reduce = 0
        self._ray_cache = {}
        self._bound = None  # (topology, rays) from bind()

    def _check_model(self, model: GaussianModel):
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, renderer on "
                             f"{self.device}")

    @torch.no_grad()
    @span("gvrt.plan")
    def plan(self, model: GaussianModel, cameras: Sequence,
             slack: float = 1.3, bucket_ratio: float = None) -> tuple:
        """Measure pair counts over representative cameras -> static capacity.

        `slack` multiplies the measured counts (headroom for camera drift);
        overflow triggers an eager re-plan either way.  `bucket_ratio`
        overrides the capacity grid (1.0: exact chunk-aligned capacities,
        for a fixed scene and camera).  Also sets `capacity_reduce` from the
        measured survivor pairs."""
        self._check_model(model)
        act = model.activate()
        ratios = {} if bucket_ratio is None else {"bucket_ratio": bucket_ratio}
        cap = cap_pad = cap_r = 0
        for cam in cameras:
            w2c, proj = _camera_mats(cam)
            tab = frame_cull_table(act, w2c, proj, self.width, self.height,
                                   self.cfg)
            c, cp = plan_capacity_from_table(tab, proj, self.width,
                                             self.height, self.cfg,
                                             slack=slack, **ratios)
            cr = plan_reduce_capacity_from_table(
                tab, proj, self.width, self.height, self.cfg,
                model.num_gaussians + 1, slack=max(slack, 1.05), **ratios)
            cap, cap_pad, cap_r = max(cap, c), max(cap_pad, cp), max(cap_r, cr)
        self.capacity = (cap, cap_pad)
        self.capacity_reduce = cap_r
        return self.capacity

    def _replan_merged(self, model, camera):
        """Re-plan for `camera`, max-merged with the held capacities so a
        single-camera re-plan never shrinks a multi-camera plan."""
        count("gvrt.replans")
        cap0, cap_r0 = self.capacity, self.capacity_reduce
        self.plan(model, [camera])
        self.capacity = (max(cap0[0], self.capacity[0]),
                         max(cap0[1], self.capacity[1]))
        self.capacity_reduce = max(cap_r0, self.capacity_reduce)

    @torch.no_grad()
    def _topology(self, act, camera, with_reduce_plan=True):
        w2c, proj = _camera_mats(camera)
        return bin_topology(act, w2c, proj, self.width, self.height,
                            self.cfg, *self.capacity,
                            capacity_reduce=self.capacity_reduce,
                            with_reduce_plan=with_reduce_plan)

    def _rays(self, camera):
        # value-based key: id() of a collected camera can be reused and would
        # silently serve another camera's rays
        key = camera.content_key()
        if key not in self._ray_cache:
            count("gvrt.rays.built")
            if len(self._ray_cache) > 64:
                self._ray_cache.clear()
            self._ray_cache[key] = tile_rays(camera, self.cfg, self.device)
        else:
            count("gvrt.rays.cache_hit")
        return self._ray_cache[key]

    def _render_once(self, act, camera):
        # a frame rendered without grad needs no gradient-reduce plan
        topo = self._topology(act, camera, torch.is_grad_enabled())
        chunks = gather_chunks(act, topo, self.cfg, self.impl)
        acc = forward_dispatch(binned_scene(chunks, topo), self._rays(camera),
                               self.cfg, self.impl)
        return _acc_outputs(acc, self.width, self.height, self.cfg, topo)

    @span("gvrt.frame")
    def render(self, model: GaussianModel, camera):
        """Render one frame -> dict of rgb (H, W, 3), depth, transmittance,
        hit_count (H, W), num_pairs and overflow.  Capacity overflow drops
        pairs (never corrupts): it triggers one re-plan and re-render, at the
        cost of one host read of the overflow count per frame.
        Differentiable w.r.t. the model's parameters when grad is enabled."""
        self._check_model(model)
        if self.capacity is None:
            self.plan(model, [camera])
        act = model.activate()
        out = self._render_once(act, camera)
        if int(out["overflow"]) > 0:
            self._replan_merged(model, camera)
            out = self._render_once(act, camera)
        return out

    @torch.no_grad()
    @span("gvrt.bind")
    def bind(self, model: GaussianModel, camera):
        """Build and hold this (model, camera)'s pair-list topology;
        subsequent `render_bound` calls skip the whole binning pass."""
        self._check_model(model)
        if self.capacity is None:
            self.plan(model, [camera])
        act = model.activate()
        topo = self._topology(act, camera)
        if int(topo.overflow) > 0:
            self._replan_merged(model, camera)
            topo = self._topology(act, camera)
        self._bound = (topo, self._rays(camera))
        return topo

    @span("gvrt.frame")
    def render_bound(self, model: GaussianModel):
        """Render against the topology held by `bind`: one parameter gather
        plus the tile kernel.  Exact for the bound model; culling and depth
        order go stale if its parameters move (re-`bind` then), while
        gradients stay exact for this forward.  The parameter table comes
        from `rows64_from_model`, whose backward is hand-derived."""
        if self._bound is None:
            raise RuntimeError("call bind(model, camera) first")
        self._check_model(model)
        topo, rays = self._bound
        chunks = gather_from_rows(rows64_from_model(model, self.cfg), topo,
                                  self.cfg, self.impl)
        acc = forward_dispatch(binned_scene(chunks, topo), rays, self.cfg,
                               self.impl)
        return _acc_outputs(acc, self.width, self.height, self.cfg, topo)


def render_image_tiled(model: GaussianModel, camera,
                       cfg: RenderConfig = DEFAULT_CONFIG,
                       impl: str = "auto",
                       capacity: Optional[tuple] = None, device=None):
    """One-shot tiled render (convenience wrapper over TiledRenderer)."""
    r = TiledRenderer(camera.width, camera.height, cfg, capacity=capacity,
                      impl=impl, device=device)
    return r.render(model, camera)
