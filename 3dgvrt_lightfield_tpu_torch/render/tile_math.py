"""Per-chunk tile math: the plain PyTorch version of the tile kernel's body.

For one image tile (R rays) and one depth-ordered chunk of G Gaussians,
evaluate every (gaussian, ray) pair and advance the per-ray compositing
state.  Same math and layouts as the JAX package's `render/tile_math.py`:

  * the world->unit-local frame is prefolded per Gaussian into
    ``M = diag(1/s) @ R^T`` and ``b = M @ mean`` (binning.param_rows), so the
    local origin is ``gro = M @ o - b`` and the direction ``grdu = M @ d``;
  * normalization is deferred: with ``n2 = |grdu|^2``,
    ``grayDist = |cross(grdu, gro)|^2 / n2`` and ``t = -(grdu . gro) / n2``.

The in-chunk exclusive transmittance is a `torch.cumprod` (or, with
``transmittance_prod=False``, a `torch.cumsum` of log1p(-alpha)) over G;
SH radiance is a full-f32 product of (G, 16) coefficients with the tile's
(16, R) basis rows.  Every function takes any leading batch dims, so the
plain tile path runs many tiles' chunks at once.

Data layouts:
  rays  (24, R): rows [ox oy oz dx dy dz tmin tmax | 16 SH basis rows]
  acc   (8, R):  rows [r g b depth T hit_count 0 0]
  chunk (G, 64): cols [0:9 M row-major | 9:12 b | 12 density | 13:16 pad |
                 16:32 sh_r | 32:48 sh_g | 48:64 sh_b]
Padding Gaussians have density == 0 (=> alpha 0, no contribution).
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..ops.kernels import particle_response

ACC_RGB = slice(0, 3)
ACC_DEPTH = 3
ACC_T = 4
ACC_HITS = 5

#: rows per tile ray block: 8 geometry rows + 16 precomputed SH basis rows
RAY_ROWS = 24
RAY_BASIS = slice(8, 24)

# fused chunk column layout (prefolded affine frame)
CH_M = 0         # 9 cols, row-major M = diag(1/s) @ R^T
CH_B = 9         # 3 cols, b = M @ mean
CH_DENSITY = 12  # 1 col
CH_SH = 16       # 3 x 16 cols (r, g, b)

#: the accumulator of a tile no chunk reached: black, T = 1, no hits
BACKGROUND = (0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)


def init_acc(r: int, device=None, batch=()) -> torch.Tensor:
    """Fresh (*batch, 8, R) accumulators: black radiance, unit transmittance."""
    bg = torch.tensor(BACKGROUND, dtype=torch.float32, device=device)
    return bg[:, None].expand(*batch, 8, r).clone()


def chunk_core(rays: torch.Tensor, chunk: torch.Tensor, t_in: torch.Tensor,
               cfg: RenderConfig):
    """Evaluate (..., G, 64) chunks against (..., 24, R) ray blocks.

    The accumulator enters only through the per-ray transmittance `t_in`
    (..., 1, R); radiance, depth and hit count are additive.

    Returns (t_out (..., 1, R), rgb_contrib (..., 3, R),
    depth_contrib (..., 1, R), hits (..., 1, R)).
    """
    o = [rays[..., j:j + 1, :] for j in range(3)]          # (..., 1, R)
    d = [rays[..., 3 + j:4 + j, :] for j in range(3)]
    tmin = rays[..., 6:7, :]
    tmax = rays[..., 7:8, :]

    m = [chunk[..., CH_M + j:CH_M + j + 1] for j in range(9)]   # (..., G, 1)
    b = [chunk[..., CH_B + j:CH_B + j + 1] for j in range(3)]
    density = chunk[..., CH_DENSITY:CH_DENSITY + 1]

    gro, grdu = [], []
    for i in range(3):
        gro.append(m[3 * i] * o[0] + m[3 * i + 1] * o[1]
                   + m[3 * i + 2] * o[2] - b[i])                    # (..., G, R)
        grdu.append(m[3 * i] * d[0] + m[3 * i + 1] * d[1]
                    + m[3 * i + 2] * d[2])

    # the clamp keeps degenerate (padding/dummy) pairs finite
    nrm2 = grdu[0] * grdu[0] + grdu[1] * grdu[1] + grdu[2] * grdu[2]
    inv_n2 = 1.0 / torch.clamp_min(nrm2, 1e-20)

    c0 = grdu[1] * gro[2] - grdu[2] * gro[1]
    c1 = grdu[2] * gro[0] - grdu[0] * gro[2]
    c2 = grdu[0] * gro[1] - grdu[1] * gro[0]
    gray_dist = (c0 * c0 + c1 * c1 + c2 * c2) * inv_n2

    resp = particle_response(gray_dist, cfg.kernel_degree)
    alpha = torch.clamp_max(resp * density, cfg.max_alpha)

    dot_og = grdu[0] * gro[0] + grdu[1] * gro[1] + grdu[2] * gro[2]
    t = -dot_og * inv_n2

    accept = ((resp > cfg.hit_min_response) & (alpha > cfg.alpha_min)
              & (dot_og < 0.0) & (t >= tmin) & (t <= tmax))
    alpha_eff = torch.where(accept, alpha, 0.0)

    # exclusive in-chunk prefix transmittance over the G axis
    if cfg.transmittance_prod:
        u = 1.0 - alpha_eff
        excl = torch.cat([torch.ones_like(u[..., :1, :]),
                          torch.cumprod(u[..., :-1, :], dim=-2)], dim=-2)
        t_before = t_in * excl
    else:
        la = torch.log1p(-alpha_eff)
        cums = torch.cumsum(la, dim=-2)
        t_before = t_in * torch.exp(cums - la)
    active = t_before > cfg.min_transmittance
    w = alpha_eff * t_before * active

    basis16 = rays[..., RAY_BASIS, :]                               # (..., 16, R)
    out_rgb = []
    for c in range(3):
        sh_c = chunk[..., CH_SH + 16 * c:CH_SH + 16 * (c + 1)]     # (..., G, 16)
        rad = torch.clamp_min(torch.matmul(sh_c, basis16) + 0.5, 0.0)
        out_rgb.append(torch.sum(w * rad, dim=-2, keepdim=True))

    depth_contrib = torch.sum(w * t, dim=-2, keepdim=True)
    hits = torch.sum((accept & active).to(t_in.dtype), dim=-2, keepdim=True)
    if cfg.transmittance_prod:
        t_out = t_in * torch.prod(torch.where(active, u, 1.0), dim=-2,
                                  keepdim=True)
    else:
        t_out = t_in * torch.exp(torch.sum(torch.where(active, la, 0.0),
                                           dim=-2, keepdim=True))
    return t_out, torch.cat(out_rgb, dim=-2), depth_contrib, hits


def chunk_update(rays, chunk, acc, cfg: RenderConfig):
    """Composite (..., G, 64) chunks into the (..., 8, R) tile accumulators."""
    t_in = acc[..., ACC_T:ACC_T + 1, :]
    t_out, rgb_c, depth_c, hits = chunk_core(rays, chunk, t_in, cfg)
    return torch.cat(
        [acc[..., 0:3, :] + rgb_c,
         acc[..., 3:4, :] + depth_c,
         t_out,
         acc[..., 5:6, :] + hits,
         acc[..., 6:8, :]], dim=-2)
