"""Banded (bounded-memory) rendering: sequential tile-row bands on one card.

Counterpart of the JAX package's `render/banded.py`.  A garden-scale scene
(~5M Gaussians at 1080p) has more (tile, Gaussian) pairs than one frame's
chunk array should hold, forward and backward.  So the image's tile rows
are split into `n_bands` bands, round-robin (`stride`), contiguous (`contig`,
span banding) or contiguous at the survivor-pair quantiles (balanced), and
the bands are rendered one after another in a Python loop:

  * per frame, the parameter table (`frame_params`) and the frame cull
    table are built once; each band bins its rows, gathers its pairs' rows
    and runs the tile kernel;
  * with grad on, each band's gather and kernel forward sit inside
    `torch.utils.checkpoint` (the recompute ladder below), so the backward
    re-runs them band by band instead of holding every band's chunk array:
    peak memory is O(N + pairs / n_bands);
  * the bands' gradients of the parameter table are summed by autograd.

Images equal the unbanded render (band binning is full binning restricted
to the band's rows); gradients match up to the order of float summation for
Gaussians that straddle band boundaries.

Recompute ladder (`remat`), per band:
  * "full": the gather and the kernel forward inside the checkpoint; the
    backward re-runs both (K1 with its residual runs twice per band);
  * "gather": the gather outside the checkpoint, so its chunks are held
    for the backward, and the kernel forward inside it;
  * "none": no checkpoint; every band's residuals are held.

Topologies are built without grad and held: `BandedRenderer.bind` holds
them across frames, and the unbound `render_image_banded` holds the
frame's band topologies until its backward (it does not bin again there).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..config import (DEFAULT_CONFIG, RenderConfig, resolve_device,
                      resolve_impl)
from ..models.gaussians import GaussianModel
from ..utils.profiling import count, span
from .binning import (band_rays, band_rays_split, bin_topology_from_table,
                      binned_scene, frame_cull_table, gather_from_rows,
                      plan_capacity_from_table, plan_compact_reduce_from_table,
                      plan_row_split, unband_image, untile)
from .pallas_forward import forward_dispatch
from .rows_vjp import frame_params
from .tile_math import ACC_DEPTH, ACC_HITS, ACC_T
from .tiled import _camera_mats

REMATS = ("full", "gather", "none")


def resolve_bands(height: int, requested: int,
                  cfg: RenderConfig = DEFAULT_CONFIG) -> int:
    """Largest band count <= `requested` that divides the tile-row count
    (1088 px at 16-px tiles has 68 rows, so a requested 8 resolves to 4)."""
    ny = height // cfg.tile_size
    for b in range(min(requested, ny), 0, -1):
        if ny % b == 0:
            return b
    return 1


def resolve_bands_common(heights, requested: int,
                         cfg: RenderConfig = DEFAULT_CONFIG) -> int:
    """Largest band count <= `requested` dividing EVERY camera's tile-row
    count (pose files may carry heights other than the CLI's --height)."""
    g = 0
    for h in heights:
        g = math.gcd(g, h // cfg.tile_size)
    for b in range(min(requested, g), 0, -1):
        if g % b == 0:
            return b
    return 1


def _band_spec(b: int, n_bands: int, height: int, cfg: RenderConfig,
               mode: str):
    """(offset, stride, count) of band b: round-robin or contiguous."""
    if mode == "contig":
        lny = (height // cfg.tile_size) // n_bands
        return (b * lny, 1, lny)
    assert mode == "stride", mode
    return (b, n_bands, 0)


@torch.no_grad()
def _frame_table(model: GaussianModel, camera, cfg: RenderConfig):
    """The band-independent frame cull table of `camera`, and its proj."""
    w2c, proj = _camera_mats(camera)
    return frame_cull_table(model.activate(), w2c, proj, camera.width,
                            camera.height, cfg), proj


def plan_capacity_banded(model: GaussianModel, camera, n_bands: int,
                         cfg: RenderConfig = DEFAULT_CONFIG,
                         slack: float = 1.3, with_reduce: bool = False,
                         mode: str = "stride"):
    """Static (capacity, capacity_padded) = max over the bands' plans, from
    one frame table.  `with_reduce=True` also plans the compact reduce
    layout and returns (capacity, capacity_padded, capacity_live,
    capacity_reduce, capacity_range).  mode="contig" plans contiguous bands
    (span banding): with a y-sorted model each band's live-id window
    capacity_range shrinks to ~N / n_bands."""
    tab, proj = _frame_table(model, camera, cfg)
    cap = cap_pad = cap_live = cap_r = cap_range = 0
    for off in range(n_bands):
        band = _band_spec(off, n_bands, camera.height, cfg, mode)
        c, cp = plan_capacity_from_table(tab, proj, camera.width,
                                         camera.height, cfg, slack=slack,
                                         band=band)
        cap, cap_pad = max(cap, c), max(cap_pad, cp)
        if with_reduce:
            cl, cr, crg = plan_compact_reduce_from_table(
                tab, proj, camera.width, camera.height, cfg,
                slack=max(slack, 1.05), band=band)
            cap_live, cap_r = max(cap_live, cl), max(cap_r, cr)
            cap_range = max(cap_range, crg)
    if with_reduce:
        return cap, cap_pad, cap_live, cap_r, cap_range
    return cap, cap_pad


def plan_capacity_balanced(model: GaussianModel, camera, n_bands: int,
                           cfg: RenderConfig = DEFAULT_CONFIG,
                           slack: float = 1.3):
    """Pair-balanced contiguous plan: (specs, per-band capacity tuples).

    specs = ((row_offset, row_count), ...) at the survivor-pair quantiles;
    caps[b] = (capacity, capacity_padded, capacity_live, capacity_reduce,
    capacity_range) planned for band b alone (no max-merge)."""
    tab, proj = _frame_table(model, camera, cfg)
    specs = plan_row_split(tab, proj, camera.width, camera.height, cfg,
                           n_bands)
    caps = []
    for off, count in specs:
        band = (off, 1, count)
        c, cp = plan_capacity_from_table(tab, proj, camera.width,
                                         camera.height, cfg, slack=slack,
                                         band=band)
        cl, cr, crg = plan_compact_reduce_from_table(
            tab, proj, camera.width, camera.height, cfg,
            slack=max(slack, 1.05), band=band)
        caps.append((c, cp, cl, cr, crg))
    return specs, tuple(caps)


def _band_acc(rows64, topo, rays_b, cfg: RenderConfig, impl: str,
              remat: str) -> torch.Tensor:
    """One band's (T_b, 8, R) accumulators, under the recompute ladder."""
    def composite(chunks):
        return forward_dispatch(binned_scene(chunks, topo), rays_b, cfg, impl)

    def gather(rows):
        return gather_from_rows(rows, topo, cfg, impl)

    if remat == "none" or not (torch.is_grad_enabled()
                               and rows64.requires_grad):
        return composite(gather(rows64))
    if remat == "full":
        return checkpoint(lambda rows: composite(gather(rows)), rows64,
                          use_reentrant=False, preserve_rng_state=False)
    assert remat == "gather", remat
    return checkpoint(composite, gather(rows64), use_reentrant=False,
                      preserve_rng_state=False)


def _render_banded_bound(model: GaussianModel, topos, rays_bands,
                         width: int, height: int, cfg: RenderConfig,
                         impl: str, remat: str = "full",
                         mode: str = "stride"):
    """Render against held per-band topologies -> ((H, W, 8) image,
    overflow).

    Per frame: one `frame_params` table, then per band a parameter gather
    and the tile kernel.  Gradients are exact for this forward; culling and
    depth order are as stale as the topologies."""
    rows64 = frame_params(model, cfg, impl)[1]
    ts = cfg.tile_size
    imgs = []
    for topo, rays_b in zip(topos, rays_bands):
        acc = _band_acc(rows64, topo, rays_b, cfg, impl, remat)
        lh = (rays_b.shape[0] // (width // ts)) * ts
        imgs.append(untile(acc, width, lh, ts))
    if mode == "stride":
        img = unband_image(torch.stack(imgs), width, height, ts, mode)
    else:  # contiguous bands, uniform or balanced: stacked row blocks
        img = torch.cat(imgs, dim=0)
    assert img.shape[0] == height, (img.shape, height)
    overflow = torch.stack([t.overflow for t in topos]).sum()
    return img, overflow


def _outputs(img, overflow):
    return {
        "rgb": img[..., 0:3],
        "depth": img[..., ACC_DEPTH],
        "transmittance": img[..., ACC_T],
        "hit_count": img[..., ACC_HITS],
        "overflow": overflow,
    }


def _check_model(model: GaussianModel, device: torch.device):
    if model.device != device:
        raise ValueError(f"model is on {model.device}, renderer on {device}")


class BandedRenderer:
    """Bounded-memory banded pipeline with bind-once topology reuse.

    `plan` picks static per-band capacities, `bind` builds and holds every
    band's topology (with the compact reduce plan), `render_bound` renders
    frames against them: per frame one parameter table, and per band a
    gather and the tile kernel.  `span=True` bands contiguous tile rows
    (pair it with `GaussianModel.sorted_for_camera`, so each band's live
    ids form a narrow window); `balance=True` (needs span) cuts the rows at
    the survivor-pair quantiles and plans every band at its own capacities.
    """

    def __init__(self, width: int, height: int, n_bands: int,
                 cfg: RenderConfig = DEFAULT_CONFIG,
                 capacity: Optional[tuple] = None, impl: str = "auto",
                 remat: str = "full", span: bool = False,
                 balance: bool = False, device=None):
        if width % cfg.tile_size or height % cfg.tile_size:
            raise ValueError(f"{width}x{height} is not a multiple of the "
                             f"tile size {cfg.tile_size}")
        # balanced bands have variable row counts: no divisibility needed
        if not balance and (height // cfg.tile_size) % n_bands:
            raise ValueError(f"{n_bands} bands do not divide the "
                             f"{height // cfg.tile_size} tile rows")
        if balance and not span:
            raise ValueError("balance requires span (contig) banding")
        if remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
        self.width, self.height, self.n_bands = width, height, n_bands
        self.cfg, self.capacity = cfg, capacity
        self.device = resolve_device(device)
        self.impl = resolve_impl(impl, self.device)
        self.remat = remat
        self.mode = "contig" if span else "stride"
        self.balance = balance
        self.band_specs = None  # ((row_offset, row_count), ...) when balance
        self.band_caps = None   # per-band (cap, cap_pad, cl, cr, crg)
        #: compact reduce budgets, set by plan()
        self.capacity_live = 0
        self.capacity_reduce = 0
        self.capacity_range = 0
        self._bound = None      # (topologies, rays per band)

    @span("gvrt.plan")
    def plan(self, model: GaussianModel, camera, slack: float = 1.3):
        if self.balance:
            specs, caps = plan_capacity_balanced(model, camera, self.n_bands,
                                                 self.cfg, slack=slack)
            if self.band_caps is not None and specs == self.band_specs:
                # same split: max-merge per band, so a drift re-plan never
                # shrinks a band's capacities
                caps = tuple(tuple(max(a, b) for a, b in zip(old, new))
                             for old, new in zip(self.band_caps, caps))
            self.band_specs, self.band_caps = specs, caps
            self.capacity = (max(c[0] for c in caps),
                             max(c[1] for c in caps))
            return self.capacity
        cap, cap_pad, cap_live, cap_r, cap_range = plan_capacity_banded(
            model, camera, self.n_bands, self.cfg, slack=slack,
            with_reduce=True, mode=self.mode)
        self.capacity = (cap, cap_pad)
        self.capacity_live = max(self.capacity_live, cap_live)
        self.capacity_reduce = max(self.capacity_reduce, cap_r)
        self.capacity_range = max(self.capacity_range, cap_range)
        return self.capacity

    @torch.no_grad()
    def _build_topos(self, model: GaussianModel, camera):
        tab, proj = _frame_table(model, camera, self.cfg)
        if self.balance:
            return [bin_topology_from_table(
                tab, proj, self.width, self.height, self.cfg, c, cp,
                row_offset=off, row_stride=1, row_count=count,
                capacity_live=cl, capacity_reduce=cr, capacity_range=crg)
                for (off, count), (c, cp, cl, cr, crg)
                in zip(self.band_specs, self.band_caps)]
        cap, cap_pad = self.capacity
        topos = []
        for b in range(self.n_bands):
            off, stride, count = _band_spec(b, self.n_bands, self.height,
                                            self.cfg, self.mode)
            topos.append(bin_topology_from_table(
                tab, proj, self.width, self.height, self.cfg, cap, cap_pad,
                row_offset=off, row_stride=stride, row_count=count,
                capacity_reduce=self.capacity_reduce,
                capacity_live=self.capacity_live,
                capacity_range=self.capacity_range))
        return topos

    def _replan(self, model: GaussianModel, camera):
        """Plan afresh, max-merged with the held capacities (a re-plan never
        shrinks them)."""
        count("gvrt.replans")
        cap0 = self.capacity
        self.plan(model, camera)
        self.capacity = (max(cap0[0], self.capacity[0]),
                         max(cap0[1], self.capacity[1]))

    @span("gvrt.bind")
    def bind(self, model: GaussianModel, camera, replan: bool = False):
        """Build and hold all bands' topologies for this (model, camera).

        Overflow in any band triggers an eager re-plan (max-merged with the
        held capacities) and rebuild: a truncated pair list would otherwise
        degrade every gradient until the next plan.  This reads the
        overflow count on the host once.  `replan=True` re-plans the same
        way before binding (for a caller whose held topologies dropped
        pairs since the last bind)."""
        _check_model(model, self.device)
        if self.capacity is None or (self.balance and self.band_caps is None):
            self.plan(model, camera)
        elif replan:
            self._replan(model, camera)
        topos = self._build_topos(model, camera)
        if int(torch.stack([t.overflow for t in topos]).sum()) > 0:
            self._replan(model, camera)
            topos = self._build_topos(model, camera)
        if self.balance:
            rays = band_rays_split(camera, self.cfg, self.band_specs,
                                   self.device, impl=self.impl)
        else:
            rays = band_rays(camera, self.cfg, self.n_bands, self.device,
                             mode=self.mode, impl=self.impl)
        self._bound = (topos, rays)
        return topos

    def render_bound(self, model: GaussianModel):
        """Render against the held topologies -> dict of rgb (H, W, 3),
        depth, transmittance, hit_count (H, W) and overflow (a device
        scalar: pairs the held capacities dropped).  Differentiable w.r.t.
        the model's parameters when grad is enabled."""
        if self._bound is None:
            raise RuntimeError("call bind(model, camera) first")
        _check_model(model, self.device)
        topos, rays = self._bound
        img, overflow = _render_banded_bound(
            model, topos, rays, self.width, self.height, self.cfg, self.impl,
            remat=self.remat, mode=self.mode)
        return _outputs(img, overflow)


@span("gvrt.frame")
def render_image_banded(model: GaussianModel, camera, n_bands: int,
                        cfg: RenderConfig = DEFAULT_CONFIG,
                        capacity: Optional[tuple] = None, impl: str = "auto",
                        span: bool = False, device=None):
    """Render one camera in `n_bands` sequential tile-row bands.

    Equals the unbanded `render_image_tiled` (the same binning restricted
    per band); differentiable with grad enabled, with per-band recompute
    ("full").  `capacity` is (cap, cap_pad[, cap_live, cap_r[, cap_range]])
    as `plan_capacity_banded` returns it, planned here when None.  Without
    grad no reduce plan is built or planned.  `span=True` uses contiguous
    row bands and live-id windows (pair with a y-sorted model)."""
    dev = resolve_device(device)
    _check_model(model, dev)
    impl = resolve_impl(impl, dev)
    grad = torch.is_grad_enabled()
    mode = "contig" if span else "stride"
    width, height, ts = camera.width, camera.height, cfg.tile_size
    if (height // ts) % n_bands:
        raise ValueError(f"{n_bands} bands do not divide the {height // ts} "
                         f"tile rows")
    if capacity is None:
        capacity = plan_capacity_banded(model, camera, n_bands, cfg,
                                        with_reduce=grad, mode=mode)
    cap_live = cap_r = cap_range = 0
    if len(capacity) >= 4:  # (cap, cap_pad, cap_live, cap_r[, cap_range])
        cap_live, cap_r = capacity[2], capacity[3]
        cap_range = capacity[4] if len(capacity) > 4 else 0
    tab, proj = _frame_table(model, camera, cfg)
    with torch.no_grad():
        topos = []
        for b in range(n_bands):
            off, stride, count = _band_spec(b, n_bands, height, cfg, mode)
            topos.append(bin_topology_from_table(
                tab, proj, width, height, cfg, capacity[0], capacity[1],
                row_offset=off, row_stride=stride, row_count=count,
                capacity_reduce=cap_r, capacity_live=cap_live,
                capacity_range=cap_range, with_reduce_plan=grad))
    rays = band_rays(camera, cfg, n_bands, dev, mode=mode, impl=impl)
    img, overflow = _render_banded_bound(model, topos, rays, width, height,
                                         cfg, impl, remat="full", mode=mode)
    return _outputs(img, overflow)
