"""Front-to-back compositing of the binned frame, and the gradient of an
L1 image loss through it by autograd.

Tiles are walked block by block (G Gaussians at a time, `math.chunk_step`)
with the per-ray transmittance carried from block to block.  Tiles go in
order of decreasing block count, so the tiles still walking at block k
are a prefix of the batch.  The forward runs without a graph in batches
of tiles; the gradient runs in batches sized by a budget of blocks, each
batch's loss differentiated on its own into the (N+1, 64) parameter
rows, which then take the sum back to the six leaves in one backward.
"""

from __future__ import annotations

import numpy as np
import torch

from .binning import Binned
from .math import Settings, activate, chunk_step, param_rows

#: background of a tile no block reaches: black, T = 1, no hits
BACKGROUND = (0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)


def _batches(counts: np.ndarray, order: np.ndarray, max_tiles: int,
             max_blocks: int):
    """Consecutive runs of `order` (tiles by decreasing block count) with
    at most max_tiles tiles and max_blocks blocks each."""
    i = 0
    while i < len(order):
        j, blocks = i, 0
        while j < len(order) and j - i < max_tiles and (
                j == i or blocks + counts[order[j]] <= max_blocks):
            blocks += counts[order[j]]
            j += 1
        yield order[i:j]
        i = j


def _walk(rows, binned: Binned, rays, tiles, counts_np, st: Settings,
          t_in=None):
    """Composite the tiles (a batch, by decreasing block count) -> (rgb
    (n, 3, R), depth (n, 1, R), T (n, 1, R), hits (n, 1, R)).  With t_in
    (blocks, R) it records T at the start of every block."""
    n_tiles = len(tiles)
    dev, dt = rays.device, rows.dtype
    r = rays.shape[-1]
    tt = torch.as_tensor(tiles, device=dev)
    ray_b = rays[tt]
    start = binned.start[tt]
    t = torch.ones((n_tiles, 1, r), dtype=dt, device=dev)
    rgb = torch.zeros((n_tiles, 3, r), dtype=dt, device=dev)
    depth = torch.zeros((n_tiles, 1, r), dtype=dt, device=dev)
    hits = torch.zeros((n_tiles, 1, r), dtype=dt, device=dev)
    done = []
    m = n_tiles
    cnt = counts_np[tiles]
    for k in range(int(cnt[0]) if n_tiles else 0):
        m_k = int((cnt > k).sum())
        if m_k < m:
            done.append((rgb[m_k:], depth[m_k:], t[m_k:], hits[m_k:]))
            rgb, depth, t, hits = rgb[:m_k], depth[:m_k], t[:m_k], hits[:m_k]
            m = m_k
        cid = start[:m] + k
        if t_in is not None:
            t_in[cid] = t[:, 0].to(t_in.dtype)
        t, c_rgb, c_dep, c_hit = chunk_step(ray_b[:m], rows[binned.gid[cid]],
                                            t, st)
        rgb, depth, hits = rgb + c_rgb, depth + c_dep, hits + c_hit
    done.append((rgb, depth, t, hits))
    return tuple(torch.cat([d[i] for d in reversed(done)]) for i in range(4))


def _order(binned: Binned):
    counts = binned.count.cpu().numpy()
    order = np.argsort(-counts, kind="stable")
    return counts, order[counts[order] > 0]


@torch.no_grad()
def render(rows: torch.Tensor, binned: Binned, rays: torch.Tensor,
           st: Settings, residual: bool = False, max_tiles: int = 1024):
    """The frame's (tiles, 8, R) accumulators [r g b depth T hits 0 0] in
    rows' dtype, and with `residual` T at the start of every block
    (blocks, R) float32."""
    dev = rays.device
    num_tiles, _, r = rays.shape
    acc = torch.tensor(BACKGROUND, dtype=rows.dtype, device=dev)[:, None] \
        .expand(num_tiles, 8, r).clone()
    t_in = (torch.ones((binned.gid.shape[0], r), dtype=torch.float32,
                       device=dev) if residual else None)
    counts, order = _order(binned)
    rays = rays.to(rows.dtype)
    for tiles in _batches(counts, order, max_tiles, max_tiles * 64):
        rgb, depth, t, hits = _walk(rows, binned, rays, tiles, counts, st,
                                    t_in)
        tt = torch.as_tensor(tiles, device=dev)
        acc[tt, 0:3], acc[tt, 3:4], acc[tt, 4:5], acc[tt, 5:6] = \
            rgb, depth, t, hits
    return (acc, t_in) if residual else acc


def loss_and_grads(leaves, binned: Binned, rays: torch.Tensor,
                   target_tiles: torch.Tensor, st: Settings,
                   dtype=torch.float32, max_blocks: int = 4096):
    """The L1 loss mean |rgb - target| over every pixel and channel, its
    gradient w.r.t. the six leaves, and the mean hit count per ray.
    `target_tiles` is (tiles, 3, R); the composite runs in `dtype` (the
    rows and rays cast to it), the leaves and their gradients keep their
    own dtype."""
    leaves = [x.detach().clone().requires_grad_() for x in leaves]
    rows = param_rows(activate(*leaves))
    rows_d = rows.detach().to(dtype).requires_grad_()
    grad_rows = torch.zeros_like(rows)
    num_tiles, _, r = rays.shape
    denom = float(num_tiles * r * 3)
    rays_d = rays.to(dtype)
    counts, order = _order(binned)
    reached = np.zeros(num_tiles, bool)
    reached[order] = True
    loss = (target_tiles[torch.as_tensor(~reached, device=rays.device)]
            .abs().sum(dtype=torch.float64) / denom)
    hits = torch.zeros((), dtype=torch.float64, device=rays.device)
    for tiles in _batches(counts, order, 1024, max_blocks):
        rgb, _, _, h = _walk(rows_d, binned, rays_d, tiles, counts, st)
        tt = torch.as_tensor(tiles, device=rays.device)
        part = (rgb.to(target_tiles.dtype) - target_tiles[tt]).abs().sum() \
            / denom
        g, = torch.autograd.grad(part, rows_d)
        grad_rows += g.to(rows.dtype)
        loss = loss + part.detach().double()
        hits = hits + h.sum(dtype=torch.float64)
    rows.backward(grad_rows)
    return (float(loss), [x.grad.detach() for x in leaves],
            float(hits) / (num_tiles * r))
