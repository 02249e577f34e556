"""Binning pass: Gaussians -> depth-sorted, chunk-aligned per-tile lists.

The forward half of the JAX package's `render/binning.py`, on tensors:
  1. size each Gaussian's iso-response ellipsoid with the `kernelScale`
     radius math (particlePrimitives.comp:81-105), project its camera-space
     AABB to a screen-tile rect (`frame_cull_table`),
  2. expand every Gaussian into one (tile, gaussian) pair per rect tile and
     kill the over-covered corners with the exact ellipsoid-vs-tile-frustum
     test (`_pair_ellipsoid_cull`),
  3. sort the pairs by one packed (tile, quantized view depth) key, stably,
  4. pad every tile's list to a multiple of the chunk size G, so chunks are
     laid out in tile order and the tile kernel can walk a tile's chunks as
     one contiguous run.

Index math is int64 (torch's index type); the topology's arrays leave as
int32, like the JAX package's.  Per-pair and per-chunk runs (a pair's
Gaussian, a chunk's tile, a sorted pair's slot offset) are filled by a
scatter at each run's start and a running max, `scan.max_scan`: on the card
one launch of `csrc/max_scan.cu`.  Capacities are static per plan: pairs that do
not fit are dropped and counted in `overflow`, and the renderer re-plans.
`plan_capacity` measures a scene+camera once on the host to pick them.

The topology also carries the gradient-reduce plan (`segreduce.py`) that
the gather's backward (`param_grads.chunked_gather`) sums per-pair
cotangents with: the compact plan when the caller planned a live-Gaussian
capacity (the banded path, `render/banded.py`), else the full-id-space
plan wherever its 24-bit slot field holds the frame's padded capacity,
else none (the prefix fallback).
`plan_reduce_capacity_from_table` and `plan_compact_reduce_from_table` size
them from the measured survivors.

Banding restricts binning to a subset of tile rows, round-robin (`stride`)
or contiguous (`contig`); `band_rays`, `plan_row_split`, `band_rays_split`
and `unband_image` cut the rays and reassemble the image to match.

The camera rays (`tile_rays`) are made on the card by one kernel,
`csrc/camera_rays.cu` (`camera_rays_kernel`), straight in the tile layout;
on the CPU by their plain version, `Camera.rays` in NumPy and
`tile_ray_rows` in PyTorch.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..config import SH_MAX_NUM_COEFFS, RenderConfig, resolve_impl
from ..ops.aabb import intersect_aabb
from ..ops.kernels import kernel_scale
from ..ops.sh import sh_basis_components
from ..models.gaussians import ActivatedGaussians
from ..utils.profiling import count, span
from .param_grads import chunked_gather
from .scan import max_scan
from .segreduce import (DEAD_SLOT, GROUP, build_reduce_plan,
                        build_reduce_plan_compact, plan_rows,
                        plan_rows_compact)
from .tile_math import RAY_ROWS

_I32 = torch.int32
_I64 = torch.int64


class BinTopology(NamedTuple):
    """Pair-list topology: which Gaussian lands in which tile chunk slot.

    Pure int32 index structure with no parameter data, so a renderer may
    hold it across frames (TiledRenderer.bind) and re-gather parameters.
    """
    chunk_tile: torch.Tensor  # (num_chunks,) int32 tile id (num_tiles = dummy)
    chunk_first: torch.Tensor # (num_chunks,) int32 1 if first chunk of its tile
    tile_counts: torch.Tensor # (num_tiles,) int32 pairs per tile (un-padded)
    num_pairs: torch.Tensor   # () int32 surviving pairs (post fine-cull)
    overflow: torch.Tensor    # () int32 rect pairs dropped (capacity) +
                              #    padded slots dropped (capacity_padded)
    pair_gauss: torch.Tensor  # (capacity_padded,) int32 gaussian id per slot (N = pad)
    pair_pos: torch.Tensor    # (capacity,) int32 PRE-SORT pair -> padded slot
    gauss_offsets: torch.Tensor  # (N,) int32 pre-sort pair range start
    gauss_counts: torch.Tensor   # (N,) int32 pre-sort pair range length
    red: object               # segreduce.ReducePlan or CompactReducePlan,
                              #    or None (prefix fallback)


class BinnedScene(NamedTuple):
    """Chunked scene data consumed by the tile kernel."""
    chunks: torch.Tensor      # (num_chunks, G, 64) fused params (tile_math)
    chunk_tile: torch.Tensor
    chunk_first: torch.Tensor
    tile_counts: torch.Tensor
    num_pairs: torch.Tensor
    overflow: torch.Tensor
    pair_gauss: torch.Tensor
    pair_pos: torch.Tensor
    gauss_offsets: torch.Tensor
    gauss_counts: torch.Tensor
    red: object


class FrameCullTable(NamedTuple):
    """Band-independent per-Gaussian frame geometry — all (N,) columns."""
    tx0: torch.Tensor    # (N,) int32 GLOBAL tile rect
    ty0: torch.Tensor
    tx1: torch.Tensor
    ty1: torch.Tensor
    valid: torch.Tensor  # (N,) bool
    depth: torch.Tensor  # (N,) f32 view depth (-z cam)
    cs: tuple            # 3 x (N,) f32 camera-space center
    v: tuple             # 9 x (N,) f32 ellipsoid matrix V, row-major


def _tile_index(px, ts: int, n: int) -> torch.Tensor:
    """clip(floor(px / ts), 0, n - 1) as int32; clipped in float first so a
    far off-screen bound never meets an out-of-range int conversion."""
    return torch.clamp(torch.floor(px / ts), 0, n - 1).to(_I32)


@span("gvrt.binning.cull")
def frame_cull_table(act: ActivatedGaussians, w2c, proj, width, height,
                     cfg: RenderConfig) -> FrameCullTable:
    """Per-Gaussian GLOBAL tile rects + cull geometry (see FrameCullTable).

    `w2c` and `proj` are (4, 4) float32 NumPy matrices; their entries enter
    as scalars, in the JAX package's column-arithmetic order.
    """
    ts = cfg.tile_size
    nx, ny = width // ts, height // ts
    w2c = np.asarray(w2c, np.float32)
    proj = np.asarray(proj, np.float32)
    w = [[float(w2c[i, j]) for j in range(4)] for i in range(3)]

    radius = kernel_scale(act.densities, cfg.kernel_min_response,
                          float(cfg.kernel_degree),
                          cfg.adaptive_kernel_clamping)

    # iso-response ellipsoid straight in CAMERA space: with
    # V = W @ R @ diag(radius*s) (W = w2c rotation) the ellipsoid is
    # {cs + V u : |u| <= 1}; its cam AABB half-extent is the row norm of V
    a_sc = radius[:, None] * act.scales                   # (N, 3)
    v_cols = []
    for i in range(3):
        for k in range(3):
            s = (w[i][0] * act.rot9[:, k]
                 + w[i][1] * act.rot9[:, 3 + k]
                 + w[i][2] * act.rot9[:, 6 + k])
            v_cols.append(s * a_sc[:, k])                 # V[i, k]
    cs_cols = tuple(
        w[i][0] * act.means[:, 0] + w[i][1] * act.means[:, 1]
        + w[i][2] * act.means[:, 2] + w[i][3] for i in range(3))
    ec = [torch.sqrt(v_cols[3 * i] * v_cols[3 * i]
                     + v_cols[3 * i + 1] * v_cols[3 * i + 1]
                     + v_cols[3 * i + 2] * v_cols[3 * i + 2]) for i in range(3)]
    # screen bounds: clip = diag(P00, P11) and w = -z, so each ndc extreme is
    # attained at one of the four (coord, z) corner combinations
    z_lo, z_hi = cs_cols[2] - ec[2], cs_cols[2] + ec[2]
    all_behind = z_lo > -cfg.near                         # camera looks -z
    any_behind = z_hi > -cfg.near

    w_lo = torch.clamp_min(-z_hi, cfg.near)
    w_hi = torch.clamp_min(-z_lo, cfg.near)
    inv_wl, inv_wh = 1.0 / w_lo, 1.0 / w_hi

    def ndc_range(ax_lo, ax_hi, p_diag):
        cands = (p_diag * ax_lo * inv_wl, p_diag * ax_lo * inv_wh,
                 p_diag * ax_hi * inv_wl, p_diag * ax_hi * inv_wh)
        return (torch.minimum(torch.minimum(cands[0], cands[1]),
                              torch.minimum(cands[2], cands[3])),
                torch.maximum(torch.maximum(cands[0], cands[1]),
                              torch.maximum(cands[2], cands[3])))

    ndc_x0, ndc_x1 = ndc_range(cs_cols[0] - ec[0], cs_cols[0] + ec[0],
                               float(proj[0, 0]))
    ndc_y0, ndc_y1 = ndc_range(cs_cols[1] - ec[1], cs_cols[1] + ec[1],
                               float(proj[1, 1]))
    px_x0 = (ndc_x0 * 0.5 + 0.5) * width
    px_x1 = (ndc_x1 * 0.5 + 0.5) * width
    px_y0 = (ndc_y0 * 0.5 + 0.5) * height
    px_y1 = (ndc_y1 * 0.5 + 0.5) * height

    # partially-behind gaussians wrap around the image plane: take full screen
    px_x0 = torch.where(any_behind, 0.0, px_x0)
    px_y0 = torch.where(any_behind, 0.0, px_y0)
    px_x1 = torch.where(any_behind, float(width), px_x1)
    px_y1 = torch.where(any_behind, float(height), px_y1)

    off_screen = ((px_x1 < 0) | (px_y1 < 0)
                  | (px_x0 >= width) | (px_y0 >= height))
    # density <= alpha_min can never pass the alpha test (alpha <= density)
    dead = act.densities <= cfg.alpha_min
    valid = ~(all_behind | off_screen | dead)

    return FrameCullTable(_tile_index(px_x0, ts, nx), _tile_index(px_y0, ts, ny),
                          _tile_index(px_x1, ts, nx), _tile_index(px_y1, ts, ny),
                          valid, -cs_cols[2], cs_cols, tuple(v_cols))


def _band_localize(tab: FrameCullTable, ny: int, band):
    """Global tile rects -> LOCAL rows of the band.

    `band` is (offset, stride) for round-robin tile-row banding (the band
    owns global rows offset, offset+stride, ...) or (offset, 1, count) for a
    contiguous band owning rows [offset, offset+count).
    """
    offset, stride = band[0], band[1]
    count = band[2] if len(band) > 2 else 0
    tx0, ty0, tx1, ty1 = tab.tx0, tab.ty0, tab.tx1, tab.ty1
    valid = tab.valid
    if stride != 1:
        assert not count, band
        assert ny % stride == 0, (ny, stride)
        lny = ny // stride
        ly0 = torch.div(ty0 - offset + stride - 1, stride, rounding_mode="floor")
        ly1 = torch.div(ty1 - offset, stride, rounding_mode="floor")
        valid = valid & (ly1 >= ly0) & (ly1 >= 0) & (ly0 <= lny - 1)
        ty0 = torch.clamp(ly0, 0, lny - 1)
        ty1 = torch.clamp(ly1, 0, lny - 1)
        ny = lny
    elif count:
        lny = count
        ly0 = ty0 - offset
        ly1 = ty1 - offset
        valid = valid & (ly1 >= 0) & (ly0 <= lny - 1)
        ty0 = torch.clamp(ly0, 0, lny - 1)
        ty1 = torch.clamp(ly1, 0, lny - 1)
        ny = lny
    return (tx0, ty0, tx1, ty1), valid, ny


def _scatter_max_fill(capacity: int, offsets, values, valid):
    """arr[p] = values[g] for the g whose [offset, offset+count) contains p:
    each run's value scattered at its start, then `max_scan`."""
    arr = torch.zeros(capacity, dtype=_I64, device=offsets.device)
    keep = valid & (offsets < capacity)
    arr.scatter_reduce_(0, offsets[keep].long(), values[keep].long(), "amax")
    return max_scan(arr)


def _pair_ellipsoid_cull(tile_x, tile_y, csx, csy, csz, v9, p00, p11,
                         width, height, ts):
    """Exact ellipsoid-vs-tile-frustum test per (tile, gaussian) pair.

    The tile's frustum is the wedge of four planes through the camera origin
    along the tile's ndc edges; with a diagonal projection and w = -z, the
    plane for ndc_x >= a is n = (P00, 0, a).  The ellipsoid {cs + V u} meets
    the half-space n.x >= 0 iff n.cs >= -|V^T n| (its support function),
    compared squared.  v9 is V.reshape(9) per pair (rows x/y/z).
    """
    fx, fy = 2.0 * ts / width, 2.0 * ts / height
    a0 = fx * tile_x.to(torch.float32) - 1.0
    a1 = a0 + fx
    b0 = fy * tile_y.to(torch.float32) - 1.0
    b1 = b0 + fy
    lx = p00 * csx
    ly = p11 * csy

    def sup2(na, nc, r0, r1):
        # |V^T n|^2 for n with components na on row r0, nc on row r1 (=z)
        s = 0.0
        for k in range(3):
            u = na * v9[..., r0 * 3 + k] + nc * v9[..., r1 * 3 + k]
            s = s + u * u
        return s

    def touches_ge(d, s2):   # ellipsoid touches {n.x >= 0}
        return (d >= 0) | (d * d <= s2)

    def touches_le(d, s2):   # ellipsoid touches {n.x <= 0}
        return (d <= 0) | (d * d <= s2)

    keep = touches_ge(lx + a0 * csz, sup2(p00, a0, 0, 2))
    keep &= touches_le(lx + a1 * csz, sup2(p00, a1, 0, 2))
    keep &= touches_ge(ly + b0 * csz, sup2(p11, b0, 1, 2))
    keep &= touches_le(ly + b1 * csz, sup2(p11, b1, 1, 2))
    return keep


#: binning's stages inside `bin_topology_from_table`
_EXPAND = span("gvrt.binning.expand")
_SORT = span("gvrt.binning.sort")
_LAYOUT = span("gvrt.binning.layout")
_REDUCE_PLAN = span("gvrt.binning.reduce_plan")


@span("gvrt.binning")
def bin_topology(act: ActivatedGaussians, w2c, proj, width: int, height: int,
                 cfg: RenderConfig, capacity: int, capacity_padded: int,
                 row_offset: int = 0, row_stride: int = 1,
                 capacity_reduce: int = 0, capacity_live: int = 0,
                 row_count: int = 0, capacity_range: int = 0,
                 with_reduce_plan: bool = True) -> BinTopology:
    """Build the depth-sorted, chunk-aligned pair-list TOPOLOGY (no params).

    With `row_stride > 1` only every stride-th tile row starting at
    `row_offset` is binned; with `row_count > 0` (and stride 1) the
    contiguous rows [row_offset, row_offset + row_count).
    `capacity_reduce` is the planned row count of the gradient-reduce plan
    (0: sized for every pre-cull pair); `capacity_live > 0` asks for the
    compact plan with that live-Gaussian capacity and the live-id window
    `capacity_range` (0: the whole table).  A forward-only caller passes
    `with_reduce_plan=False` and gets `red = None` without building one."""
    tab = frame_cull_table(act, w2c, proj, width, height, cfg)
    return bin_topology_from_table(tab, proj, width, height, cfg, capacity,
                                   capacity_padded, row_offset, row_stride,
                                   capacity_reduce, capacity_live, row_count,
                                   capacity_range, with_reduce_plan)


@span("gvrt.binning")
def bin_topology_from_table(tab: FrameCullTable, proj, width: int,
                            height: int, cfg: RenderConfig, capacity: int,
                            capacity_padded: int, row_offset: int = 0,
                            row_stride: int = 1, capacity_reduce: int = 0,
                            capacity_live: int = 0,
                            row_count: int = 0, capacity_range: int = 0,
                            with_reduce_plan: bool = True) -> BinTopology:
    """Topology from a precomputed frame table (see FrameCullTable): the
    banded renderer computes the table once per frame and calls this per
    band."""
    g = cfg.chunk_size
    dev = tab.tx0.device
    n = tab.tx0.shape[0]
    nx = width // cfg.tile_size
    (tx0, ty0, tx1, ty1), valid, ny = _band_localize(
        tab, height // cfg.tile_size, (row_offset, row_stride, row_count))
    tx0, ty0, tx1, ty1 = (a.long() for a in (tx0, ty0, tx1, ty1))
    depth = tab.depth
    num_tiles = nx * ny

    rect_w = tx1 - tx0 + 1
    counts = torch.where(valid, rect_w * (ty1 - ty0 + 1), 0)
    offsets = torch.cumsum(counts, 0) - counts
    total = offsets[-1] + counts[-1]
    overflow = torch.clamp_min(total - capacity, 0)

    # depth quantization params (per-gaussian, BEFORE pair expansion); the
    # f32 ops follow the JAX package's order, so both packages cut the same
    # depth levels up to a last-ulp difference.  With no valid gaussian the
    # range is empty and every depth_q is 0 (no pair reads it then).  The
    # levels are the whole frame's even for a band: its tile count and its
    # valid gaussians set them, so a band's per-tile order (ties included)
    # is the unbanded frame's and banded images equal unbanded ones.  The
    # JAX package quantizes per band (the band's tile count and valid
    # set), which reorders near-equal depths at full width.
    frame_tiles = nx * (height // cfg.tile_size)
    tile_bits = max(1, (frame_tiles + 1).bit_length())
    depth_bits = min(31 - tile_bits, 24)
    dmin = torch.where(tab.valid, depth, math.inf).min()
    dmax = torch.where(tab.valid, depth, -math.inf).max()
    dscale = (2.0 ** depth_bits - 2.0) / torch.clamp_min(dmax - dmin, 1e-9)
    depth_q = torch.clamp(
        (torch.clamp_min(depth - dmin, 0.0) * dscale).to(_I64),
        0, 2 ** depth_bits - 1)

    # pair p -> gaussian id via scatter of range starts + running max
    with _EXPAND:
        gid = torch.arange(n, dtype=_I64, device=dev)
        pair_g = _scatter_max_fill(capacity, offsets, gid,
                                   valid & (counts > 0))
        p_idx = torch.arange(capacity, dtype=_I64, device=dev)
        in_range = p_idx < total
        j = p_idx - offsets[pair_g]
        e_rw = rect_w[pair_g]
        tile_x = tx0[pair_g] + j % e_rw
        tile_y = ty0[pair_g] + torch.div(j, e_rw, rounding_mode="floor")
        tile_y_global = tile_y * row_stride + row_offset
        v9 = torch.stack(tab.v, dim=1)[pair_g]
        fine = _pair_ellipsoid_cull(tile_x, tile_y_global, tab.cs[0][pair_g],
                                    tab.cs[1][pair_g], tab.cs[2][pair_g], v9,
                                    float(proj[0, 0]), float(proj[1, 1]),
                                    width, height, cfg.tile_size)
        tile_id = torch.where(in_range & fine, tile_y * nx + tile_x,
                              num_tiles)

    # one packed key: tile in the high bits, quantized depth in the low
    # bits; the stable sort keeps pre-sort pair order among equal keys
    with _SORT:
        key = (tile_id << depth_bits) | torch.where(in_range,
                                                    depth_q[pair_g], 0)
        key_sorted, p_sorted = torch.sort(key, stable=True)
        g_sorted = pair_g[p_sorted]
        tile_sorted = key_sorted >> depth_bits

    with _LAYOUT:
        tiles = torch.arange(num_tiles + 1, dtype=_I64, device=dev)
        tile_edges = torch.searchsorted(tile_sorted, tiles, right=False)
        tile_counts = torch.diff(tile_edges,
                                 append=tile_edges.new_tensor([capacity]))
        starts = tile_edges
        padded_counts = torch.div(tile_counts + g - 1, g,
                                  rounding_mode="floor") * g
        padded_starts = torch.cumsum(padded_counts, 0) - padded_counts
        padded_total = padded_starts[num_tiles]  # excludes dummy tile
        overflow = overflow + torch.clamp_min(padded_total - capacity_padded,
                                              0)

        # chunk -> tile mapping (+ trailing dummy chunks)
        num_chunks = capacity_padded // g
        chunk_arr = torch.zeros(num_chunks, dtype=_I64, device=dev)
        first_chunk = torch.div(padded_starts[:num_tiles], g,
                                rounding_mode="floor")
        has = (tile_counts[:num_tiles] > 0) & (first_chunk < num_chunks)
        chunk_arr.scatter_reduce_(0, first_chunk[has],
                                  tiles[:num_tiles][has], "amax")
        last = torch.clamp_max(torch.div(padded_total, g,
                                         rounding_mode="floor"),
                               num_chunks - 1)
        chunk_arr.scatter_reduce_(0, last.reshape(1), tiles[num_tiles:],
                                  "amax")
        chunk_tile = max_scan(chunk_arr)
        chunk_first = torch.cat([torch.ones(1, dtype=_I64, device=dev),
                                 (chunk_tile[1:] != chunk_tile[:-1]).long()])

        # sorted pair -> padded slot: dest = p + (padded_starts -
        # starts)[tile(p)]; the delta is non-decreasing over sorted pairs,
        # so a scatter at tile edges and a running max (one streaming pass)
        # replace a per-pair gather of the tile's delta
        delta_at = padded_starts - starts
        fill = torch.zeros(capacity, dtype=_I64, device=dev)
        edge = tile_edges[:num_tiles]
        in_cap = edge < capacity
        fill.scatter_reduce_(0, edge[in_cap], delta_at[:num_tiles][in_cap],
                             "amax")
        delta = max_scan(fill)
        keep = tile_sorted < num_tiles
        dest_drop = torch.where(keep, p_idx + delta, capacity_padded)
        placed = dest_drop < capacity_padded
        pair_gauss = torch.full((capacity_padded,), n, dtype=_I64,
                                device=dev)
        pair_gauss[dest_drop[placed]] = g_sorted[placed]
        pair_pos = torch.full((capacity,), capacity_padded, dtype=_I64,
                              device=dev)
        pair_pos[p_sorted] = dest_drop

    # grouped gradient-reduce layout (segreduce.py): pure topology work,
    # amortized over the bind/refresh cadence.  Three regimes: the compact
    # plan over the band's live gaussians when a live capacity is planned
    # (the banded path), else the full-id-space plan while its 24-bit slot
    # field holds every padded slot, else none (the prefix fallback).  The
    # JAX package stops the full plan at 1.5M Gaussians, but the fallback's
    # float32 prefix sums over ~10^7 pairs lose ~2e-3 of a garden-scale
    # gradient's norm to cancellation, so the port keeps the direct sums
    red = None
    if with_reduce_plan and capacity_live > 0:
        assert capacity_live % GROUP == 0, capacity_live
        # without a measured survivor count the pair capacity bounds it
        cap_r = capacity_reduce or plan_rows_compact(capacity)
        with _REDUCE_PLAN:
            red, red_overflow = build_reduce_plan_compact(
                pair_g, pair_pos, offsets, counts, n, capacity,
                capacity_padded, capacity_live, cap_r, capacity_range)
        overflow = overflow + red_overflow
    elif with_reduce_plan and capacity_padded < DEAD_SLOT:
        with _REDUCE_PLAN:
            red, red_overflow = build_reduce_plan(
                pair_g, pair_pos, offsets, counts, n, capacity,
                capacity_padded, capacity_reduce)
        overflow = overflow + red_overflow

    count("gvrt.pairs", tile_edges[num_tiles])
    return BinTopology(
        chunk_tile=chunk_tile.to(_I32),
        chunk_first=chunk_first.to(_I32),
        tile_counts=tile_counts[:num_tiles].to(_I32),
        num_pairs=tile_edges[num_tiles].to(_I32),
        overflow=overflow.to(_I32),
        pair_gauss=pair_gauss.to(_I32),
        pair_pos=pair_pos.to(_I32),
        gauss_offsets=offsets.to(_I32),
        gauss_counts=counts.to(_I32),
        red=red,
    )


@span("gvrt.param_table")
def param_rows(act: ActivatedGaussians, cfg: RenderConfig) -> torch.Tensor:
    """Fused (N+1, 64) per-Gaussian parameter table (dummy row N).

    The world->unit-local frame is prefolded per Gaussian: M = diag(1/s) @ R^T
    and b = M @ mean.  The dummy row N, which padding slots point at, has
    the identity frame and zero density and radiance.
    """
    n = act.means.shape[0]
    dev = act.means.device
    # M[i, k] = inv_s[:, i] * R[k, i], with R[k, i] = rot9[:, 3k+i]
    m_cols = [act.inv_scales[:, i] * act.rot9[:, 3 * k + i]
              for i in range(3) for k in range(3)]
    b_cols = [act.inv_scales[:, i]
              * (act.rot9[:, i] * act.means[:, 0]
                 + act.rot9[:, 3 + i] * act.means[:, 1]
                 + act.rot9[:, 6 + i] * act.means[:, 2])
              for i in range(3)]
    rows = torch.zeros((n + 1, 64), dtype=torch.float32, device=dev)
    rows[:n, 0:9] = torch.stack(m_cols, dim=1)
    rows[n, 0:9] = torch.eye(3, dtype=torch.float32, device=dev).reshape(9)
    rows[:n, 9:12] = torch.stack(b_cols, dim=1)
    rows[:n, 12] = act.densities
    rows[:n, 16:64] = act.sh_flat
    return rows


@span("gvrt.gather")
def gather_from_rows(rows64: torch.Tensor, topo: BinTopology,
                     cfg: RenderConfig, impl: str = "auto") -> torch.Tensor:
    """(N+1, 64) table + topology -> (num_chunks, G, 64) kernel blocks.

    Differentiable (`param_grads.chunked_gather`): its backward sums the
    per-pair cotangents per Gaussian with the topology's reduce plan, by
    the kernel K3 for impl "auto"/"cuda" on the card, by the plain version
    for "torch" or on the CPU."""
    return chunked_gather(cfg.chunk_size, rows64, topo.pair_gauss,
                          topo.pair_pos, topo.gauss_offsets,
                          topo.gauss_counts, topo.red, impl)


def gather_chunks(act: ActivatedGaussians, topo: BinTopology,
                  cfg: RenderConfig, impl: str = "auto") -> torch.Tensor:
    """Gather fused per-pair parameter rows into (num_chunks, G, 64) blocks
    (`param_rows` of `act`, then `gather_from_rows`), as the JAX package
    names it.  The render paths that differentiate build their table with
    `rows_vjp.frame_params` and gather it with `gather_from_rows`."""
    return gather_from_rows(param_rows(act, cfg), topo, cfg, impl)


def binned_scene(chunks: torch.Tensor, topo: BinTopology) -> BinnedScene:
    """Assemble the kernel input from a (possibly held) topology."""
    return BinnedScene(chunks, *topo)


def bin_gaussians(act: ActivatedGaussians, w2c, proj, width: int,
                  height: int, cfg: RenderConfig, capacity: int,
                  capacity_padded: int, row_offset: int = 0,
                  row_stride: int = 1) -> BinnedScene:
    """Build the chunked, depth-sorted per-tile Gaussian lists in one call:
    `bin_topology` (index structure, no gradient) then `gather_chunks`.
    Callers that render many frames of one camera hold the topology and
    gather per frame instead.  The reduce plan is built only when grad is
    enabled (without it the chunks are constants and nothing reads the
    plan)."""
    topo = bin_topology(act, w2c, proj, width, height, cfg, capacity,
                        capacity_padded, row_offset, row_stride,
                        with_reduce_plan=torch.is_grad_enabled())
    return binned_scene(gather_chunks(act, topo, cfg), topo)


def _bucket_capacity(v: int, g: int, ratio: float = 1.25) -> int:
    """Round a capacity UP to the next step of a chunk-aligned geometric grid
    (ratio <= 1: exact chunk alignment).  Snapping re-plans to a few sizes
    keeps the set of distinct capacities small across camera drift."""
    v = max(int(v), g)
    if ratio <= 1.0:
        return -(-v // g) * g
    k = math.ceil(math.log(v / g) / math.log(ratio) - 1e-9)
    return int(math.ceil(g * ratio ** k / g)) * g


def _host_expand_cull(tab: FrameCullTable, proj, width, height,
                      cfg: RenderConfig, band=(0, 1)):
    """The expansion + fine cull of `bin_topology`, counted for planning.

    Runs on the table's device (the card in production): every rect pair
    is expanded and culled exactly as binning does, with no capacity cut.
    Returns (total_rect_pairs, per_tile_survivors, nx, ny, live_counts) for
    the band; per_tile_survivors (per local tile) and live_counts (surviving
    pairs per Gaussian) are NumPy arrays."""
    ts = cfg.tile_size
    nx, ny = width // ts, height // ts
    dev = tab.tx0.device
    n = tab.tx0.shape[0]
    (tx0, ty0, tx1, ty1), valid, ny = _band_localize(tab, ny, band)
    tx0, ty0, tx1, ty1 = (a.long() for a in (tx0, ty0, tx1, ty1))
    offset, stride = band[0], band[1]
    rect_w = tx1 - tx0 + 1
    counts = torch.where(valid, rect_w * (ty1 - ty0 + 1), 0)
    total = int(counts.sum())
    pg = torch.repeat_interleave(torch.arange(n, device=dev), counts,
                                 output_size=total)
    offs = torch.cumsum(counts, 0) - counts
    j = torch.arange(total, device=dev) - offs[pg]
    tile_x = tx0[pg] + j % rect_w[pg]
    tile_y = ty0[pg] + torch.div(j, rect_w[pg], rounding_mode="floor")
    proj = np.asarray(proj, np.float32)
    keep = _pair_ellipsoid_cull(
        tile_x, tile_y * stride + offset, tab.cs[0][pg], tab.cs[1][pg],
        tab.cs[2][pg], torch.stack(tab.v, dim=1)[pg], float(proj[0, 0]),
        float(proj[1, 1]), width, height, cfg.tile_size)
    per_tile = torch.bincount((tile_y * nx + tile_x)[keep], minlength=nx * ny)
    live_counts = torch.bincount(pg[keep], minlength=n)
    return (total, per_tile.cpu().numpy(), nx, ny,
            live_counts.cpu().numpy())


def plan_capacity_from_table(tab: FrameCullTable, proj, width, height,
                             cfg: RenderConfig, slack: float = 1.3,
                             band=(0, 1), bucket_ratio: float = 1.25):
    """Host capacity plan from a frame table — see plan_capacity."""
    g = cfg.chunk_size
    total, per_tile, nx, ny, _ = _host_expand_cull(tab, proj, width, height,
                                                   cfg, band)
    capacity = max(g, int(math.ceil(total * slack / g)) * g)
    # slack per tile for camera motion + a pool of whole chunks for tiles
    # that are empty now but covered later; runtime overflow is reported in
    # the topology (callers re-plan on overflow)
    padded = int((np.ceil(per_tile * slack / g) * g).sum())
    padded += g * (1 + max(64, int(nx) * int(ny) // 16))
    capacity_padded = int(min(padded, capacity + int(nx) * int(ny) * g + g))
    return (_bucket_capacity(capacity, g, bucket_ratio),
            _bucket_capacity(capacity_padded, g, bucket_ratio))


def plan_reduce_capacity_from_table(tab: FrameCullTable, proj, width, height,
                                    cfg: RenderConfig, n_rows: int,
                                    slack: float = 1.05, band=(0, 1),
                                    bucket_ratio: float = 1.1) -> int:
    """Host plan for the live-compacted gradient-reduce layout: the measured
    survivor pairs x slack, bucketed on a 1.1x grid, plus one padded block
    per 256-Gaussian group (`segreduce.plan_rows`).  Rows that do not fit
    at run time count into the topology's overflow (re-plan contract)."""
    _, per_tile, _, _, _ = _host_expand_cull(tab, proj, width, height, cfg,
                                             band)
    survivors = int(per_tile.sum())
    budget = _bucket_capacity(int(math.ceil(survivors * slack)),
                              cfg.chunk_size, ratio=bucket_ratio)
    return plan_rows(budget, n_rows)


def plan_compact_reduce_from_table(tab: FrameCullTable, proj, width, height,
                                   cfg: RenderConfig,
                                   slack: float = 1.05, band=(0, 1)):
    """Host plan for the compact gradient-reduce layout of one band.

    Returns (capacity_live, capacity_reduce, capacity_range): the
    live-Gaussian capacity (bucketed, a multiple of GROUP), the dense row
    count (the surviving pairs x slack, `segreduce.plan_rows_compact`) and
    the live-id window width (first..last live id, x slack).  With a
    y-sorted model and contiguous bands the window is narrow; otherwise it
    degrades to ~N.  Runtime overflow of any budget is folded into the
    topology's overflow (re-plan contract)."""
    _, per_tile, _, _, live_counts = _host_expand_cull(tab, proj, width,
                                                       height, cfg, band)
    n = live_counts.shape[0]
    n_live = int((live_counts > 0).sum())
    survivors = int(per_tile.sum())
    cap_live = _bucket_capacity(int(math.ceil(max(n_live, 1) * slack)),
                                GROUP, ratio=1.1)
    cap_r = plan_rows_compact(int(math.ceil(survivors * slack)))
    live_idx = np.nonzero(live_counts > 0)[0]
    width_ids = (int(live_idx[-1]) - int(live_idx[0]) + 1) if live_idx.size \
        else 1
    cap_range = min(_bucket_capacity(int(math.ceil(width_ids * slack)),
                                     GROUP, ratio=1.1), n)
    return cap_live, cap_r, cap_range


def plan_capacity(act: ActivatedGaussians, w2c, proj, width, height,
                  cfg: RenderConfig, slack: float = 1.3, band=(0, 1)):
    """Measure pair counts once (host) to pick static capacities.

    `capacity` sizes the pre-cull expansion+sort arrays (rect pairs);
    `capacity_padded` sizes the chunked kernel arrays and is planned from the
    post-cull per-tile survivor counts (chunk-rounded, with slack).
    """
    tab = frame_cull_table(act, w2c, proj, width, height, cfg)
    return plan_capacity_from_table(tab, proj, width, height, cfg, slack, band)


@span("gvrt.rays")
def tile_rays(camera, cfg: RenderConfig, device, aabb=None,
              tmax_clip=None, impl: str = "auto") -> torch.Tensor:
    """Per-pixel rays + AABB clip range + SH basis, tiled to (T, 24, R).

    Rows 0:8 are [o, d, tmin, tmax]; rows 8:24 are the 16 SH basis values of
    the ray direction (zero above (sh_degree+1)^2), so the tile kernel never
    re-evaluates the basis polynomials per chunk.  The clip box is `aabb`,
    else cfg.aabb.  `tmax_clip` (H, W), optional, caps each ray's march
    distance (combined Gaussian and mesh scenes: an opaque surface ends the
    march).  `impl` as `resolve_impl` reads it for `device`: "cuda" makes
    the rays in one launch of `camera_rays_kernel`, "torch" with NumPy on
    the host, copied to `device` and tiled by `tile_ray_rows`."""
    device = torch.device(device)
    if resolve_impl(impl, device) == "cuda":
        with span("gvrt.rays.kernel"):
            count("gvrt.rays.kernel")
            return camera_rays_kernel(camera, cfg, device, aabb, tmax_clip)
    with span("gvrt.rays.numpy"):
        o, d = camera.rays()
    with span("gvrt.rays.upload"):
        o = torch.as_tensor(np.ascontiguousarray(o), device=device)
        d = torch.as_tensor(np.ascontiguousarray(d), device=device)
    return tile_ray_rows(o, d, cfg, aabb, tmax_clip)


@span("gvrt.rays.rows")
def tile_ray_rows(o: torch.Tensor, d: torch.Tensor, cfg: RenderConfig,
                  aabb=None, tmax_clip=None) -> torch.Tensor:
    """(H, W, 3) origins and unit directions -> the (T, 24, R) tile rays of
    `tile_rays`, differentiable in both (pose refinement builds them in the
    graph, `train/pose.py`).  `tmax_clip` (H, W) caps tmax per pixel."""
    ts = cfg.tile_size
    h, w = o.shape[:2]
    assert h % ts == 0 and w % ts == 0, (h, w, ts)
    tmin, tmax = intersect_aabb(aabb or cfg.aabb, o, d)
    if tmax_clip is not None:
        tmax = torch.minimum(tmax, torch.as_tensor(
            tmax_clip, dtype=tmax.dtype, device=tmax.device))
    basis = sh_basis_components(d[..., 0], d[..., 1], d[..., 2],
                                cfg.sh_degree)
    basis += [torch.zeros_like(d[..., 0])] * (SH_MAX_NUM_COEFFS - len(basis))
    rays = torch.cat([o, d, tmin[..., None], tmax[..., None],
                      torch.stack(basis, dim=-1)], dim=-1)
    tiled = rays.reshape(h // ts, ts, w // ts, ts, RAY_ROWS)
    return tiled.permute(0, 2, 4, 1, 3).reshape(-1, RAY_ROWS, ts * ts).contiguous()


def camera_rays_kernel(camera, cfg: RenderConfig, device, aabb=None,
                       tmax_clip=None) -> torch.Tensor:
    """`tile_ray_rows(*camera.rays())` on CUDA in one launch of
    `csrc/camera_rays.cu`: the (T, 24, R) f32 rays written straight from
    the camera's matrices, which travel by value, as does the clip box.  It
    launches on the current stream (no synchronisation) and adds one to
    `camera_rays_kernel.launches`.  Rows equal the plain version's bit for
    bit on every ray whose direction does; a direction may differ from
    NumPy's by one f32 ulp on rare rays (the f64 sums' order)."""
    if device.type != "cuda":
        raise ValueError(f"camera_rays_kernel runs on CUDA, not {device}")
    ts, w, h = cfg.tile_size, camera.width, camera.height
    if w % ts or h % ts:
        raise ValueError(f"{w}x{h} is not a multiple of the tile size {ts}")
    clip = None
    if tmax_clip is not None:
        clip = torch.as_tensor(tmax_clip, dtype=torch.float32,
                               device=device).contiguous()
        if clip.shape != (h, w):
            raise ValueError(f"tmax_clip is {tuple(clip.shape)}, the camera "
                             f"{h}x{w}")
    mats = [np.ascontiguousarray(m, np.float64).reshape(16)
            for m in (camera.proj_inverse, camera.view_inverse)]
    box = (ctypes.c_float * 6)(*(aabb or cfg.aabb))
    out = torch.empty(((h // ts) * (w // ts), RAY_ROWS, ts * ts),
                      dtype=torch.float32, device=device)
    lib = _build.load("camera_rays")
    with torch.cuda.device(device):
        err = lib.gvrt_camera_rays(
            mats[0].ctypes.data, mats[1].ctypes.data, box,
            None if clip is None else clip.data_ptr(), out.data_ptr(), w, h,
            ts, cfg.sh_degree, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"camera_rays kernel launch failed: CUDA error "
                           f"{err}")
    camera_rays_kernel.launches += 1
    return out


camera_rays_kernel.launches = 0


def untile(img_tiled: torch.Tensor, width: int, height: int, ts: int):
    """(num_tiles, C, R) -> (H, W, C)."""
    ny, nx = height // ts, width // ts
    c = img_tiled.shape[1]
    return (img_tiled.reshape(ny, nx, c, ts, ts)
            .permute(0, 3, 1, 4, 2).reshape(height, width, c))


@span("gvrt.rays")
def band_rays(camera, cfg: RenderConfig, stride: int, device,
              mode: str = "stride", aabb=None,
              impl: str = "auto") -> torch.Tensor:
    """Tiled rays split into `stride` tile-row bands: (stride, local_tiles,
    RAY_ROWS, R).  mode="stride": band d owns the global tile rows d,
    d + stride, ...; mode="contig": the contiguous rows
    [d * ny / stride, (d + 1) * ny / stride) (span banding).  The clip box
    is `aabb`, else cfg.aabb; `impl` as `tile_rays`."""
    ts = cfg.tile_size
    rays = tile_rays(camera, cfg, device, aabb, impl=impl)  # (ny*nx, 24, R)
    ny, nx = camera.height // ts, camera.width // ts
    assert ny % stride == 0, (ny, stride)
    if mode == "contig":
        return rays.reshape(stride, (ny // stride) * nx, RAY_ROWS, ts * ts)
    assert mode == "stride", mode
    byband = rays.reshape(ny // stride, stride, nx, RAY_ROWS, ts * ts)
    return byband.permute(1, 0, 2, 3, 4).reshape(
        stride, (ny // stride) * nx, RAY_ROWS, ts * ts).contiguous()


def plan_row_split(tab: FrameCullTable, proj, width, height,
                   cfg: RenderConfig, n_bands: int):
    """Pair-balanced contiguous tile-row split: ((offset, count), ...).

    Cuts the tile rows at the n-quantiles of the per-row survivor-pair
    prefix sum: unequal row counts, ~equal pairs, every band keeping at
    least one row."""
    _, per_tile, nx, ny, _ = _host_expand_cull(tab, proj, width, height, cfg)
    assert 1 <= n_bands <= ny, (n_bands, ny)
    cum = np.cumsum(per_tile.reshape(ny, nx).sum(axis=1))
    total = max(int(cum[-1]), 1)
    cuts = [0]
    for k in range(1, n_bands):
        j = int(np.searchsorted(cum, total * k / n_bands))
        # leave enough rows for the remaining bands too
        cuts.append(max(cuts[-1] + 1, min(j, ny - (n_bands - k))))
    cuts.append(ny)
    return tuple((cuts[i], cuts[i + 1] - cuts[i]) for i in range(n_bands))


@span("gvrt.rays")
def band_rays_split(camera, cfg: RenderConfig, specs, device,
                    impl: str = "auto"):
    """Per-band ray arrays of a variable (offset, count) row split: a tuple
    of (count * nx, RAY_ROWS, R) tensors; `impl` as `tile_rays`."""
    rays = tile_rays(camera, cfg, device, impl=impl)  # (ny*nx, 24, R)
    nx = camera.width // cfg.tile_size
    return tuple(rays[off * nx:(off + count) * nx] for off, count in specs)


def unband_image(bands: torch.Tensor, width: int, height: int, ts: int,
                 mode: str = "stride") -> torch.Tensor:
    """(stride, local_H, W, C) band images -> (H, W, C): round-robin tile
    rows interleaved (mode="stride") or row blocks stacked ("contig")."""
    stride, lh, w, c = bands.shape
    if mode == "contig":
        return bands.reshape(height, width, c)
    assert mode == "stride", mode
    lny = lh // ts
    return (bands.reshape(stride, lny, ts, w, c)
            .permute(1, 0, 2, 3, 4).reshape(height, width, c))
