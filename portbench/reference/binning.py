"""Which Gaussians reach which tile, and in what order: the reference's
own binning of one frame.

Each Gaussian's iso-response ellipsoid is bounded on screen (a rectangle
of tiles), every (tile, Gaussian) pair of the rectangle is kept if the
ellipsoid meets the tile's frustum, and each tile's pairs are ordered by
the Gaussian's view depth quantized to the frame's levels, ties by
Gaussian id.  The lists are then cut into blocks of G, tile after tile:
`gid` (blocks, G) holds the Gaussian id of each slot (N for padding),
and tile t owns the blocks [start[t], start[t] + count[t]).

Everything is worked out with no capacity and no drop: every pair that
the data has is binned.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .math import Activated, Settings, kernel_radius


class Table(NamedTuple):
    tx0: torch.Tensor
    ty0: torch.Tensor
    tx1: torch.Tensor
    ty1: torch.Tensor
    valid: torch.Tensor
    depth: torch.Tensor
    cs: tuple        # camera-space centre, 3 x (N,)
    v: tuple         # ellipsoid matrix V = W R diag(radius s), 9 x (N,)


class Binned(NamedTuple):
    gid: torch.Tensor          # (blocks, G) int64, N = padding
    tile_counts: torch.Tensor  # (tiles,) int64 pairs per tile
    start: torch.Tensor        # (tiles,) int64 first block of each tile
    count: torch.Tensor        # (tiles,) int64 blocks of each tile
    num_gaussians: int


def _tile_index(px, ts, n):
    return torch.clamp(torch.floor(px / ts), 0, n - 1).long()


def cull_table(act: Activated, w2c, proj, width, height,
               st: Settings) -> Table:
    """Per-Gaussian screen rectangle of tiles and frustum-cull geometry."""
    ts = st.tile_size
    nx, ny = width // ts, height // ts
    w = [[float(w2c[i, j]) for j in range(4)] for i in range(3)]
    a_sc = kernel_radius(act.densities, st)[:, None] * act.scales
    v = []
    for i in range(3):
        for k in range(3):
            s = (w[i][0] * act.rot9[:, k] + w[i][1] * act.rot9[:, 3 + k]
                 + w[i][2] * act.rot9[:, 6 + k])
            v.append(s * a_sc[:, k])
    cs = tuple(w[i][0] * act.means[:, 0] + w[i][1] * act.means[:, 1]
               + w[i][2] * act.means[:, 2] + w[i][3] for i in range(3))
    ec = [torch.sqrt(v[3 * i] * v[3 * i] + v[3 * i + 1] * v[3 * i + 1]
                     + v[3 * i + 2] * v[3 * i + 2]) for i in range(3)]
    z_lo, z_hi = cs[2] - ec[2], cs[2] + ec[2]
    all_behind = z_lo > -st.near
    any_behind = z_hi > -st.near
    inv_wl = 1.0 / torch.clamp_min(-z_hi, st.near)
    inv_wh = 1.0 / torch.clamp_min(-z_lo, st.near)

    def ndc_range(lo, hi, p):
        c = (p * lo * inv_wl, p * lo * inv_wh, p * hi * inv_wl,
             p * hi * inv_wh)
        return (torch.minimum(torch.minimum(c[0], c[1]),
                              torch.minimum(c[2], c[3])),
                torch.maximum(torch.maximum(c[0], c[1]),
                              torch.maximum(c[2], c[3])))

    x0, x1 = ndc_range(cs[0] - ec[0], cs[0] + ec[0], float(proj[0, 0]))
    y0, y1 = ndc_range(cs[1] - ec[1], cs[1] + ec[1], float(proj[1, 1]))
    px0, px1 = (x0 * 0.5 + 0.5) * width, (x1 * 0.5 + 0.5) * width
    py0, py1 = (y0 * 0.5 + 0.5) * height, (y1 * 0.5 + 0.5) * height
    px0 = torch.where(any_behind, 0.0, px0)
    py0 = torch.where(any_behind, 0.0, py0)
    px1 = torch.where(any_behind, float(width), px1)
    py1 = torch.where(any_behind, float(height), py1)
    off = (px1 < 0) | (py1 < 0) | (px0 >= width) | (py0 >= height)
    valid = ~(all_behind | off | (act.densities <= st.alpha_min))
    return Table(_tile_index(px0, ts, nx), _tile_index(py0, ts, ny),
                 _tile_index(px1, ts, nx), _tile_index(py1, ts, ny), valid,
                 -cs[2], cs, tuple(v))


def frustum_keep(tile_x, tile_y, csx, csy, csz, v9, p00, p11, width,
                 height, ts):
    """Does the ellipsoid {cs + V u : |u| <= 1} meet the tile's frustum?
    The frustum's four planes pass through the camera; the ellipsoid meets
    the half-space n.x >= 0 iff n.cs >= -|V^T n|, compared squared."""
    fx, fy = 2.0 * ts / width, 2.0 * ts / height
    a0 = fx * tile_x.to(torch.float32) - 1.0
    a1 = a0 + fx
    b0 = fy * tile_y.to(torch.float32) - 1.0
    b1 = b0 + fy
    lx, ly = p00 * csx, p11 * csy

    def sup2(na, nc, r0, r1):
        s = 0.0
        for k in range(3):
            u = na * v9[..., r0 * 3 + k] + nc * v9[..., r1 * 3 + k]
            s = s + u * u
        return s

    def ge(d, s2):
        return (d >= 0) | (d * d <= s2)

    def le(d, s2):
        return (d <= 0) | (d * d <= s2)

    keep = ge(lx + a0 * csz, sup2(p00, a0, 0, 2))
    keep &= le(lx + a1 * csz, sup2(p00, a1, 0, 2))
    keep &= ge(ly + b0 * csz, sup2(p11, b0, 1, 2))
    keep &= le(ly + b1 * csz, sup2(p11, b1, 1, 2))
    return keep


def depth_levels(tab: Table, num_tiles: int):
    """(quantized depth per Gaussian, depth bits): the frame's valid depth
    range cut into 2^bits - 1 levels, bits = min(31 - tile bits, 24)."""
    tile_bits = max(1, (num_tiles + 1).bit_length())
    bits = min(31 - tile_bits, 24)
    dmin = torch.where(tab.valid, tab.depth, math.inf).min()
    dmax = torch.where(tab.valid, tab.depth, -math.inf).max()
    scale = (2.0 ** bits - 2.0) / torch.clamp_min(dmax - dmin, 1e-9)
    q = torch.clamp((torch.clamp_min(tab.depth - dmin, 0.0) * scale).long(),
                    0, 2 ** bits - 1)
    return q, bits


#: pairs expanded at once (keeps the per-pair temporaries at ~1 GB)
_PAIR_BLOCK = 1 << 23


def bin_frame(act: Activated, w2c, proj, width, height,
              st: Settings) -> Binned:
    """The frame's per-tile, depth-ordered Gaussian lists in blocks of G."""
    ts, g = st.tile_size, st.chunk_size
    nx, ny = width // ts, height // ts
    num_tiles = nx * ny
    dev = act.means.device
    n = act.means.shape[0]
    tab = cull_table(act, w2c, proj, width, height, st)
    depth_q, bits = depth_levels(tab, num_tiles)
    rect_w = tab.tx1 - tab.tx0 + 1
    counts = torch.where(tab.valid, rect_w * (tab.ty1 - tab.ty0 + 1), 0)
    v9 = torch.stack(tab.v, dim=1)
    p00, p11 = float(proj[0, 0]), float(proj[1, 1])
    # expand Gaussian by Gaussian (in id order) a block of them at a time
    ends = torch.cumsum(counts, 0).cpu().numpy()
    keys, gids = [], []
    lo = 0
    while lo < n:
        base = int(ends[lo - 1]) if lo else 0
        hi = int(np.searchsorted(ends, base + _PAIR_BLOCK, side="right"))
        hi = min(max(hi, lo + 1), n)
        total = int(ends[hi - 1]) - base
        if total:
            ids = torch.arange(lo, hi, device=dev)
            pg = torch.repeat_interleave(ids, counts[lo:hi],
                                         output_size=total)
            first = torch.cumsum(counts[lo:hi], 0) - counts[lo:hi]
            j = torch.arange(total, device=dev) - first[pg - lo]
            tx = tab.tx0[pg] + j % rect_w[pg]
            ty = tab.ty0[pg] + torch.div(j, rect_w[pg], rounding_mode="floor")
            keep = frustum_keep(tx, ty, tab.cs[0][pg], tab.cs[1][pg],
                                tab.cs[2][pg], v9[pg], p00, p11, width,
                                height, ts)
            keys.append(((ty * nx + tx) << bits | depth_q[pg])[keep])
            gids.append(pg[keep])
        lo = hi
    key = torch.cat(keys) if keys else torch.zeros(0, dtype=torch.long,
                                                   device=dev)
    gid = torch.cat(gids) if gids else key.clone()
    key, order = torch.sort(key, stable=True)
    gid = gid[order]
    tile = key >> bits
    tile_counts = torch.bincount(tile, minlength=num_tiles)
    nblk = torch.div(tile_counts + g - 1, g, rounding_mode="floor")
    start = torch.cumsum(nblk, 0) - nblk
    first_pair = torch.cumsum(tile_counts, 0) - tile_counts
    slot = start[tile] * g + (torch.arange(len(tile), device=dev)
                              - first_pair[tile])
    blocks = int(nblk.sum())
    out = torch.full((blocks * g,), n, dtype=torch.long, device=dev)
    out[slot] = gid
    return Binned(out.reshape(blocks, g), tile_counts, start, nblk, n)


def y_sort_permutation(act: Activated, w2c, proj, width, height,
                       st: Settings) -> torch.Tensor:
    """The span-banding scene order: Gaussians by twice their rectangle's
    row centre (ty0 + ty1) on the view, culled ones last, ties by id."""
    tab = cull_table(act, w2c, proj, width, height, st)
    key = torch.where(tab.valid, tab.ty0 + tab.ty1, 2 * height)
    return torch.argsort(key, stable=True)
