"""The work a frame's data needs of the tile kernels, and its least time
on the card: the yardstick of the roofline shares.

Counted on the reference's side, from its own binning and its own plain
forward with the transmittance at the start of every block, so the count
is the same whatever the program's binning or kernels do.  The
operation counts per pair and per composited pair are the gate chain and
its tails as the kernels split them (FMA = 2 operations); bytes count
each input once and each output once: the parameter rows of the
Gaussians the frame touches, the rays, and the outputs.
"""

from __future__ import annotations

import torch

#: published peaks of one H100 SXM at its full 700 W (NVIDIA data sheet):
#: float32 outside the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: gro = M o - b per Gaussian of a tile whose rays share one origin
OPS_ORIGIN = 18
#: per pair on a live ray: grdu, |grdu|^2, the cross product, cc and the
#: cutoff test
OPS_PREFIX = 36
#: per pair on a live ray inside the response cutoff: the division, gray
#: distance, response, alpha, depth and gates
OPS_TAIL = 20
#: per composited pair, forward: SH radiance, weight, T update and the
#: accumulations
OPS_PER_HIT = 96 + 6 + 2 + 2 + 10
#: per composited pair, backward: SH radiance, the weight's and the
#: transmittance chain's cotangents, response and density, gray distance,
#: depth and cross products, the local-frame and geometry cotangents, the
#: SH column products and the column sums over rays
OPS_PER_HIT_BWD = 99 + 10 + 6 + 14 + 9 + 17 + 42 + 30 + 48 + 61
#: blocks visited per batch at G = 64, R = 256
COUNT_BATCH = 512


def chain_counts(chunks, rays, tile_counts, t_in, hits, d_hi,
                 min_transmittance):
    """What the data needs of the gate chain.

    chunks (C, G, 64) parameter rows of each block, rays (T, 24, R),
    tile_counts (T,) pairs per tile (blocks laid out tile after tile),
    t_in (C, R) transmittance at each block's start, hits the frame's
    composited pairs, d_hi the response cutoff.  A pair is live when its
    slot is real and its ray's T at the block's start is above
    min_transmittance; `inside` are the live pairs within the cutoff
    (cc <= d_hi max(|grdu|^2, 1e-20)), which alone need the tail.
    Returns {origins, pairs, inside, hits, real_pairs}."""
    g, r, dev = chunks.shape[1], rays.shape[2], rays.device
    counts = tile_counts.long()
    nch = torch.div(counts + g - 1, g, rounding_mode="floor")
    start = torch.cumsum(nch, 0) - nch
    tile = torch.repeat_interleave(torch.arange(len(nch), device=dev), nch)
    k = torch.arange(len(tile), device=dev) - start[tile]
    cid = start[tile] + k
    n_real = (counts[tile] - k * g).clamp(0, g)
    shared = (rays[:, 0:3] == rays[:, 0:3, :1]).all(2).all(1)
    n = {"origins": 0, "pairs": 0, "inside": 0}
    batch = max(1, COUNT_BATCH * 64 * 256 // (g * r))
    for b in torch.arange(len(tile), device=dev).split(batch):
        p, ry = chunks[cid[b]], rays[tile[b]]
        live = ((torch.arange(g, device=dev) < n_real[b, None])[..., None]
                & (t_in[cid[b]] > min_transmittance)[:, None, :])
        m = p[..., 0:9].reshape(-1, g, 3, 3)
        gu = torch.einsum("bgij,bjr->bgir", m, ry[:, 3:6])
        gro = torch.einsum("bgij,bjr->bgir", m, ry[:, 0:3]) \
            - p[..., 9:12, None]
        cc = (torch.linalg.cross(gu, gro, dim=2) ** 2).sum(2)
        inside = ~(cc > d_hi * (gu * gu).sum(2).clamp_min(1e-20))
        per_chunk = live.sum((1, 2))
        n["origins"] += int(torch.where(
            shared[tile[b]], n_real[b] * live.any(2).any(1), per_chunk).sum())
        n["pairs"] += int(per_chunk.sum())
        n["inside"] += int((live & inside).sum())
    n["hits"] = float(hits)
    n["real_pairs"] = int(counts.sum()) * r
    return n


def ops(n, per_hit):
    """f32 operations the counted data needs, per_hit per composited
    pair."""
    return (n["origins"] * OPS_ORIGIN + n["pairs"] * OPS_PREFIX
            + n["inside"] * OPS_TAIL + n["hits"] * per_hit)


def bound_ms(nbytes, n_ops):
    """(least ms, what bounds it): bytes over HBM bandwidth against
    operations over the f32 peak, the larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def frame_bounds(n, touched_rows, rays, backward=False):
    """K1's bound (or K2's with `backward`) for one frame: the counted
    operations against the touched parameter rows (read, and for K2 their
    gradients written), the rays read and the accumulators written (K2:
    their cotangents read)."""
    row_bytes = touched_rows * 64 * 4
    nbytes = row_bytes * (2 if backward else 1) + rays.numel() * 4 \
        + rays.shape[0] * 8 * rays.shape[2] * 4
    return bound_ms(nbytes, ops(n, OPS_PER_HIT_BWD if backward
                                else OPS_PER_HIT))
