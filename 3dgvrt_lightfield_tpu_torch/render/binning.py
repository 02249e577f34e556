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
int32, like the JAX package's.  Capacities are static per plan: pairs that do
not fit are dropped and counted in `overflow`, and the renderer re-plans.
`plan_capacity` measures a scene+camera once on the host to pick them.

The topology also carries the gradient-reduce plan (`segreduce.py`) that
the gather's backward (`param_grads.chunked_gather`) sums per-pair
cotangents with: the full-id-space plan for scenes up to 1.5M Gaussians,
none (the prefix fallback) above.  `plan_reduce_capacity_from_table` sizes
its rows from the measured survivors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SH_MAX_NUM_COEFFS, RenderConfig
from ..ops.aabb import intersect_aabb
from ..ops.kernels import kernel_scale
from ..ops.sh import sh_basis_components
from ..models.gaussians import ActivatedGaussians
from .param_grads import chunked_gather
from .segreduce import build_reduce_plan, plan_rows
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
    red: object               # segreduce.ReducePlan, or None (prefix fallback)


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


def _scatter_cummax_fill(capacity: int, offsets, values, valid):
    """arr[p] = values[g] for the g whose [offset, offset+count) contains p."""
    arr = torch.zeros(capacity, dtype=_I64, device=offsets.device)
    keep = valid & (offsets < capacity)
    arr.scatter_reduce_(0, offsets[keep].long(), values[keep].long(), "amax")
    return torch.cummax(arr, 0).values


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


#: above this many Gaussians the full-id-space reduce plan's O(N) padding
#: rows outweigh it: the gather's backward takes the prefix fallback
REDUCE_PLAN_MAX_N = 1_500_000


def bin_topology(act: ActivatedGaussians, w2c, proj, width: int, height: int,
                 cfg: RenderConfig, capacity: int, capacity_padded: int,
                 row_offset: int = 0, row_stride: int = 1,
                 capacity_reduce: int = 0, capacity_live: int = 0,
                 row_count: int = 0,
                 with_reduce_plan: bool = True) -> BinTopology:
    """Build the depth-sorted, chunk-aligned pair-list TOPOLOGY (no params).

    With `row_stride > 1` only every stride-th tile row starting at
    `row_offset` is binned; with `row_count > 0` (and stride 1) the
    contiguous rows [row_offset, row_offset + row_count).
    `capacity_reduce` is the planned row count of the gradient-reduce plan
    (0: sized for every pre-cull pair); a forward-only caller passes
    `with_reduce_plan=False` and gets `red = None` without building it."""
    tab = frame_cull_table(act, w2c, proj, width, height, cfg)
    return bin_topology_from_table(tab, proj, width, height, cfg, capacity,
                                   capacity_padded, row_offset, row_stride,
                                   capacity_reduce, capacity_live, row_count,
                                   with_reduce_plan)


def bin_topology_from_table(tab: FrameCullTable, proj, width: int,
                            height: int, cfg: RenderConfig, capacity: int,
                            capacity_padded: int, row_offset: int = 0,
                            row_stride: int = 1, capacity_reduce: int = 0,
                            capacity_live: int = 0,
                            row_count: int = 0,
                            with_reduce_plan: bool = True) -> BinTopology:
    """Topology from a precomputed frame table (see FrameCullTable).

    `capacity_live > 0` asks for the compact reduce plan of the banded path,
    which is not ported yet."""
    if capacity_live > 0:
        raise NotImplementedError(
            "the compact reduce plan (capacity_live > 0, kernel K4) comes "
            "with the banded slice: ROADMAP.md section 1 item 8")
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
    # range is empty and every depth_q is 0 (no pair reads it then).
    tile_bits = max(1, (num_tiles + 1).bit_length())
    depth_bits = min(31 - tile_bits, 24)
    dmin = torch.where(valid, depth, math.inf).min()
    dmax = torch.where(valid, depth, -math.inf).max()
    dscale = (2.0 ** depth_bits - 2.0) / torch.clamp_min(dmax - dmin, 1e-9)
    depth_q = torch.clamp(
        (torch.clamp_min(depth - dmin, 0.0) * dscale).to(_I64),
        0, 2 ** depth_bits - 1)

    # pair p -> gaussian id via scatter of range starts + running max
    gid = torch.arange(n, dtype=_I64, device=dev)
    pair_g = _scatter_cummax_fill(capacity, offsets, gid, valid & (counts > 0))
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
    tile_id = torch.where(in_range & fine, tile_y * nx + tile_x, num_tiles)

    # one packed key: tile in the high bits, quantized depth in the low
    # bits; the stable sort keeps pre-sort pair order among equal keys
    key = (tile_id << depth_bits) | torch.where(in_range, depth_q[pair_g], 0)
    key_sorted, p_sorted = torch.sort(key, stable=True)
    g_sorted = pair_g[p_sorted]
    tile_sorted = key_sorted >> depth_bits

    tiles = torch.arange(num_tiles + 1, dtype=_I64, device=dev)
    tile_edges = torch.searchsorted(tile_sorted, tiles, right=False)
    tile_counts = torch.diff(tile_edges, append=tile_edges.new_tensor([capacity]))
    starts = tile_edges
    padded_counts = torch.div(tile_counts + g - 1, g, rounding_mode="floor") * g
    padded_starts = torch.cumsum(padded_counts, 0) - padded_counts
    padded_total = padded_starts[num_tiles]  # excludes dummy tile
    overflow = overflow + torch.clamp_min(padded_total - capacity_padded, 0)

    # chunk -> tile mapping (+ trailing dummy chunks)
    num_chunks = capacity_padded // g
    chunk_arr = torch.zeros(num_chunks, dtype=_I64, device=dev)
    first_chunk = torch.div(padded_starts[:num_tiles], g, rounding_mode="floor")
    has = (tile_counts[:num_tiles] > 0) & (first_chunk < num_chunks)
    chunk_arr.scatter_reduce_(0, first_chunk[has], tiles[:num_tiles][has],
                              "amax")
    last = torch.clamp_max(torch.div(padded_total, g, rounding_mode="floor"),
                           num_chunks - 1)
    chunk_arr.scatter_reduce_(0, last.reshape(1), tiles[num_tiles:], "amax")
    chunk_tile = torch.cummax(chunk_arr, 0).values
    chunk_first = torch.cat([torch.ones(1, dtype=_I64, device=dev),
                             (chunk_tile[1:] != chunk_tile[:-1]).long()])

    # sorted pair -> padded slot: dest = p + (padded_starts - starts)[tile(p)];
    # the delta is non-decreasing over sorted pairs, so a scatter at tile
    # edges + cummax replaces a per-pair gather
    delta_at = padded_starts - starts
    fill = torch.zeros(capacity, dtype=_I64, device=dev)
    edge = tile_edges[:num_tiles]
    in_cap = edge < capacity
    fill.scatter_reduce_(0, edge[in_cap], delta_at[:num_tiles][in_cap], "amax")
    delta = torch.cummax(fill, 0).values
    keep = tile_sorted < num_tiles
    dest_drop = torch.where(keep, p_idx + delta, capacity_padded)
    placed = dest_drop < capacity_padded
    pair_gauss = torch.full((capacity_padded,), n, dtype=_I64, device=dev)
    pair_gauss[dest_drop[placed]] = g_sorted[placed]
    pair_pos = torch.full((capacity,), capacity_padded, dtype=_I64, device=dev)
    pair_pos[p_sorted] = dest_drop

    # grouped gradient-reduce layout (segreduce.py): pure topology work,
    # amortized over the bind/refresh cadence.  Scenes above
    # REDUCE_PLAN_MAX_N take the prefix fallback (red = None).
    red = None
    if with_reduce_plan and n <= REDUCE_PLAN_MAX_N:
        red, red_overflow = build_reduce_plan(
            pair_g, pair_pos, offsets, counts, n, capacity, capacity_padded,
            capacity_reduce)
        overflow = overflow + red_overflow

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
    """Gather fused per-pair parameter rows into (num_chunks, G, 64) blocks:
    the only path gradients take through binning, so a step may reuse a
    stale topology and still get exactly its forward's gradients."""
    return gather_from_rows(param_rows(act, cfg), topo, cfg, impl)


def binned_scene(chunks: torch.Tensor, topo: BinTopology) -> BinnedScene:
    """Assemble the kernel input from a (possibly held) topology."""
    return BinnedScene(chunks, *topo)


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
    """Host (NumPy) replication of the expansion + fine cull.

    Returns (total_rect_pairs, per_tile_survivors, nx, ny)."""
    ts = cfg.tile_size
    nx, ny = width // ts, height // ts
    tx0, tx1 = tab.tx0.cpu().numpy().astype(np.int64), tab.tx1.cpu().numpy().astype(np.int64)
    ty0, ty1 = tab.ty0.cpu().numpy().astype(np.int64), tab.ty1.cpu().numpy().astype(np.int64)
    valid = tab.valid.cpu().numpy()
    offset, stride = band[0], band[1]
    count = band[2] if len(band) > 2 else 0
    if stride != 1:
        assert ny % stride == 0, (ny, stride)
        lny = ny // stride
        ly0 = -(-(ty0 - offset) // stride)            # ceil
        ly1 = (ty1 - offset) // stride                # floor
        valid = valid & (ly1 >= ly0) & (ly1 >= 0) & (ly0 <= lny - 1)
        ty0 = np.clip(ly0, 0, lny - 1)
        ty1 = np.clip(ly1, 0, lny - 1)
        ny = lny
    elif count:
        lny = count
        ly0 = ty0 - offset
        ly1 = ty1 - offset
        valid = valid & (ly1 >= 0) & (ly0 <= lny - 1)
        ty0 = np.clip(ly0, 0, lny - 1)
        ty1 = np.clip(ly1, 0, lny - 1)
        ny = lny
    counts = np.where(valid, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)
    total = int(counts.sum())
    rect_w = (tx1 - tx0 + 1)
    pg = np.repeat(np.arange(counts.shape[0]), counts)
    offs = np.cumsum(counts) - counts
    j = np.arange(total) - np.repeat(offs, counts)
    tile_x = tx0[pg] + j % rect_w[pg]
    tile_y = ty0[pg] + j // rect_w[pg]
    cs = [c.cpu() for c in tab.cs]
    v9 = torch.stack([c.cpu() for c in tab.v], dim=1)
    pgt = torch.from_numpy(pg)
    proj = np.asarray(proj, np.float32)
    keep = _pair_ellipsoid_cull(
        torch.from_numpy(tile_x), torch.from_numpy(tile_y * stride + offset),
        cs[0][pgt], cs[1][pgt], cs[2][pgt], v9[pgt],
        float(proj[0, 0]), float(proj[1, 1]), width, height,
        cfg.tile_size).numpy()
    tile_id = (tile_y * nx + tile_x)[keep]
    return total, np.bincount(tile_id, minlength=nx * ny), nx, ny


def plan_capacity_from_table(tab: FrameCullTable, proj, width, height,
                             cfg: RenderConfig, slack: float = 1.3,
                             band=(0, 1), bucket_ratio: float = 1.25):
    """Host capacity plan from a frame table — see plan_capacity."""
    g = cfg.chunk_size
    total, per_tile, nx, ny = _host_expand_cull(tab, proj, width, height,
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
    _, per_tile, _, _ = _host_expand_cull(tab, proj, width, height, cfg,
                                          band)
    survivors = int(per_tile.sum())
    budget = _bucket_capacity(int(math.ceil(survivors * slack)),
                              cfg.chunk_size, ratio=bucket_ratio)
    return plan_rows(budget, n_rows)


def plan_capacity(act: ActivatedGaussians, w2c, proj, width, height,
                  cfg: RenderConfig, slack: float = 1.3, band=(0, 1)):
    """Measure pair counts once (host) to pick static capacities.

    `capacity` sizes the pre-cull expansion+sort arrays (rect pairs);
    `capacity_padded` sizes the chunked kernel arrays and is planned from the
    post-cull per-tile survivor counts (chunk-rounded, with slack).
    """
    tab = frame_cull_table(act, w2c, proj, width, height, cfg)
    return plan_capacity_from_table(tab, proj, width, height, cfg, slack, band)


def tile_rays(camera, cfg: RenderConfig, device) -> torch.Tensor:
    """Per-pixel rays + AABB clip range + SH basis, tiled to (T, 24, R).

    Rows 0:8 are [o, d, tmin, tmax]; rows 8:24 are the 16 SH basis values of
    the ray direction (zero above (sh_degree+1)^2), so the tile kernel never
    re-evaluates the basis polynomials per chunk."""
    ts = cfg.tile_size
    o, d = camera.rays()
    h, w = o.shape[:2]
    assert h % ts == 0 and w % ts == 0, (h, w, ts)
    o = torch.as_tensor(np.ascontiguousarray(o), device=device)
    d = torch.as_tensor(np.ascontiguousarray(d), device=device)
    tmin, tmax = intersect_aabb(cfg.aabb, o, d)
    basis = sh_basis_components(d[..., 0], d[..., 1], d[..., 2],
                                cfg.sh_degree)
    basis += [torch.zeros_like(d[..., 0])] * (SH_MAX_NUM_COEFFS - len(basis))
    rays = torch.cat([o, d, tmin[..., None], tmax[..., None],
                      torch.stack(basis, dim=-1)], dim=-1)
    tiled = rays.reshape(h // ts, ts, w // ts, ts, RAY_ROWS)
    return tiled.permute(0, 2, 4, 1, 3).reshape(-1, RAY_ROWS, ts * ts).contiguous()


def untile(img_tiled: torch.Tensor, width: int, height: int, ts: int):
    """(num_tiles, C, R) -> (H, W, C)."""
    ny, nx = height // ts, width // ts
    c = img_tiled.shape[1]
    return (img_tiled.reshape(ny, nx, c, ts, ts)
            .permute(0, 3, 1, 4, 2).reshape(height, width, c))
