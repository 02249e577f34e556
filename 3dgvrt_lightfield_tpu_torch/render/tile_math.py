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
plain tile path runs many tiles' chunks at once.  `chunk_core_bwd` is the
hand-derived VJP of `chunk_core`, the body of the backward kernel K2.

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
from ..ops.kernels import particle_response, particle_response_grad

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


def _exclusive_cumsum_g(x: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum over the Gaussian axis (-2)."""
    return torch.cumsum(x, dim=-2) - x


def chunk_core_bwd(rays: torch.Tensor, chunk: torch.Tensor,
                   t_in: torch.Tensor, bar_tout: torch.Tensor,
                   bar_rgb: torch.Tensor, bar_dep: torch.Tensor,
                   cfg: RenderConfig):
    """Hand-derived VJP of `chunk_core` w.r.t. (chunk, t_in).

    The JAX package's `tile_math.chunk_core_bwd` over any leading batch
    dims: one forward recompute, then the reverse chain with cotangents
    (bar_tout, bar_rgb, bar_dep, 0).  Min/max gates break ties by the
    measure-zero conventions (<=, >=) of the JAX version.

    Returns (bar_chunk (..., G, 64), bar_tin (..., 1, R)); with
    cfg.ray_gradients a third element bar_rays (..., 24, R): cotangents of
    the ray block (o, d, two zero gate rows, 16 SH basis rows).
    """
    o = [rays[..., j:j + 1, :] for j in range(3)]
    d = [rays[..., 3 + j:4 + j, :] for j in range(3)]
    tmin = rays[..., 6:7, :]
    tmax = rays[..., 7:8, :]
    m = [chunk[..., CH_M + j:CH_M + j + 1] for j in range(9)]
    b = [chunk[..., CH_B + j:CH_B + j + 1] for j in range(3)]
    density = chunk[..., CH_DENSITY:CH_DENSITY + 1]

    # ---- forward recompute (identical to chunk_core) ----
    gro, grdu = [], []
    for i in range(3):
        gro.append(m[3 * i] * o[0] + m[3 * i + 1] * o[1]
                   + m[3 * i + 2] * o[2] - b[i])
        grdu.append(m[3 * i] * d[0] + m[3 * i + 1] * d[1]
                    + m[3 * i + 2] * d[2])
    nrm2 = grdu[0] * grdu[0] + grdu[1] * grdu[1] + grdu[2] * grdu[2]
    inv_n2 = 1.0 / torch.clamp_min(nrm2, 1e-20)
    c0 = grdu[1] * gro[2] - grdu[2] * gro[1]
    c1 = grdu[2] * gro[0] - grdu[0] * gro[2]
    c2 = grdu[0] * gro[1] - grdu[1] * gro[0]
    cc = c0 * c0 + c1 * c1 + c2 * c2
    gray_dist = cc * inv_n2
    resp = particle_response(gray_dist, cfg.kernel_degree)
    ra = resp * density
    alpha = torch.clamp_max(ra, cfg.max_alpha)
    dot_og = grdu[0] * gro[0] + grdu[1] * gro[1] + grdu[2] * gro[2]
    t = -dot_og * inv_n2
    accept = ((resp > cfg.hit_min_response) & (alpha > cfg.alpha_min)
              & (dot_og < 0.0) & (t >= tmin) & (t <= tmax))
    alpha_eff = torch.where(accept, alpha, 0.0)
    if cfg.transmittance_prod:
        u = 1.0 - alpha_eff
        prod_excl = torch.cat([torch.ones_like(u[..., :1, :]),
                               torch.cumprod(u[..., :-1, :], dim=-2)], dim=-2)
        t_before = t_in * prod_excl
        active = t_before > cfg.min_transmittance
        m_tot = torch.prod(torch.where(active, u, 1.0), dim=-2, keepdim=True)
    else:
        la = torch.log1p(-alpha_eff)
        ece = torch.exp(_exclusive_cumsum_g(la))
        t_before = t_in * ece
        active = t_before > cfg.min_transmittance
        e_s = torch.exp(torch.sum(torch.where(active, la, 0.0), dim=-2,
                                  keepdim=True))
    w = alpha_eff * t_before * active
    basis16 = rays[..., RAY_BASIS, :]                               # (..., 16, R)

    # ---- reverse ----
    if cfg.transmittance_prod:
        bar_tin = bar_tout * m_tot
        bar_m = bar_tout * t_in
    else:
        bar_tin = bar_tout * e_s
        bar_s = bar_tout * t_in * e_s

    bar_w = bar_dep * t
    bar_sh_cols, bar_pres = [], []
    for c in range(3):
        sh_c = chunk[..., CH_SH + 16 * c:CH_SH + 16 * (c + 1)]     # (..., G, 16)
        rad_pre = torch.matmul(sh_c, basis16) + 0.5
        rad = torch.clamp_min(rad_pre, 0.0)
        bar_c = bar_rgb[..., c:c + 1, :]
        bar_w = bar_w + bar_c * rad
        bar_pre = torch.where(rad_pre > 0.0, bar_c * w, 0.0)
        bar_pres.append(bar_pre)
        bar_sh_cols.append(torch.matmul(bar_pre, basis16.transpose(-1, -2)))

    bar_t = bar_dep * w
    bar_ae = bar_w * t_before * active
    bar_tb = bar_w * alpha_eff * active
    if cfg.transmittance_prod:
        # prod_excl_g = prod_{g'<g} u  =>  bar_u_g = (sum_{g''>g} bar_p
        # prod_excl)_g / u_g, plus active * bar_m * m_tot / u_g for the
        # masked total; u >= 1 - max_alpha > 0
        bar_p = bar_tb * t_in
        bar_tin = bar_tin + torch.sum(bar_tb * prod_excl, dim=-2, keepdim=True)
        pp = bar_p * prod_excl
        suffix_pp = (torch.sum(pp, dim=-2, keepdim=True)
                     - _exclusive_cumsum_g(pp) - pp)
        bar_u = (suffix_pp + torch.where(active, bar_m * m_tot, 0.0)) / u
        bar_ae = bar_ae - bar_u
    else:
        bar_ce = bar_tb * t_in * ece
        bar_tin = bar_tin + torch.sum(bar_tb * ece, dim=-2, keepdim=True)
        total_ce = torch.sum(bar_ce, dim=-2, keepdim=True)
        bar_la = (total_ce - _exclusive_cumsum_g(bar_ce) - bar_ce
                  + torch.where(active, bar_s, 0.0))
        bar_ae = bar_ae - bar_la / (1.0 - alpha_eff)
    bar_alpha = torch.where(accept, bar_ae, 0.0)
    notclamped = ra <= cfg.max_alpha
    bar_resp = torch.where(notclamped, bar_alpha * density, 0.0)
    bar_density = torch.where(notclamped, bar_alpha * resp, 0.0)
    bar_gd = bar_resp * particle_response_grad(gray_dist, resp,
                                               cfg.kernel_degree)
    bar_cc = bar_gd * inv_n2
    bar_un2 = bar_gd * cc - bar_t * dot_og
    bar_dog = -bar_t * inv_n2

    bar_c0 = 2.0 * c0 * bar_cc
    bar_c1 = 2.0 * c1 * bar_cc
    bar_c2 = 2.0 * c2 * bar_cc
    bar_grdu = [
        -bar_c1 * gro[2] + bar_c2 * gro[1] + bar_dog * gro[0],
        bar_c0 * gro[2] - bar_c2 * gro[0] + bar_dog * gro[1],
        -bar_c0 * gro[1] + bar_c1 * gro[0] + bar_dog * gro[2],
    ]
    bar_gro = [
        bar_c1 * grdu[2] - bar_c2 * grdu[1] + bar_dog * grdu[0],
        -bar_c0 * grdu[2] + bar_c2 * grdu[0] + bar_dog * grdu[1],
        bar_c0 * grdu[1] - bar_c1 * grdu[0] + bar_dog * grdu[2],
    ]
    bar_n2 = torch.where(nrm2 >= 1e-20, -inv_n2 * inv_n2 * bar_un2, 0.0)
    for i in range(3):
        bar_grdu[i] = bar_grdu[i] + 2.0 * grdu[i] * bar_n2

    # gro_i = sum_j m_{3i+j} o_j - b_i ; grdu_i = sum_j m_{3i+j} d_j
    bar_geom = []                                                # 16 x (..., G, 1)
    for i in range(3):
        for j in range(3):
            bar_geom.append(torch.sum(bar_gro[i] * o[j] + bar_grdu[i] * d[j],
                                      dim=-1, keepdim=True))
    for i in range(3):
        bar_geom.append(-torch.sum(bar_gro[i], dim=-1, keepdim=True))
    bar_geom.append(torch.sum(bar_density, dim=-1, keepdim=True))
    bar_geom.append(torch.zeros_like(density).expand(
        *density.shape[:-1], 3))
    bar_chunk = torch.cat(bar_geom + bar_sh_cols, dim=-1)          # (..., G, 64)

    if not cfg.ray_gradients:
        return bar_chunk, bar_tin

    # ---- cotangents of the (24, R) ray block ----
    # o enters only gro, d only grdu, the SH basis rows only the radiance
    # products; tmin/tmax are pure gates (zero almost everywhere)
    bar_o_rows, bar_d_rows = [], []
    for j in range(3):
        tmp_o = (m[j] * bar_gro[0] + m[3 + j] * bar_gro[1]
                 + m[6 + j] * bar_gro[2])
        tmp_d = (m[j] * bar_grdu[0] + m[3 + j] * bar_grdu[1]
                 + m[6 + j] * bar_grdu[2])
        bar_o_rows.append(torch.sum(tmp_o, dim=-2, keepdim=True))
        bar_d_rows.append(torch.sum(tmp_d, dim=-2, keepdim=True))
    bar_basis = torch.zeros_like(basis16)
    for c in range(3):
        sh_c = chunk[..., CH_SH + 16 * c:CH_SH + 16 * (c + 1)]
        bar_basis = bar_basis + torch.matmul(sh_c.transpose(-1, -2),
                                             bar_pres[c])
    bar_rays = torch.cat(bar_o_rows + bar_d_rows
                         + [torch.zeros_like(tmin), torch.zeros_like(tmax),
                            bar_basis], dim=-2)                    # (..., 24, R)
    return bar_chunk, bar_tin, bar_rays


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
