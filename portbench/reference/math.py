"""The tiled renderer's per-Gaussian and per-pair math in plain PyTorch.

Frozen copies of the formulas the port states (response kernel, kernel
radius, activations, quaternion rotation, spherical-harmonics basis, the
ray/box clip and the per-chunk composite), written out again so that the
reference imports nothing of the program.  Every function works in the
dtype of its inputs: the reference runs them in float32 with TF32 off, the
control in bfloat16.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)

#: exp(s * gd**k) per kernel degree (the reference viewer's
#: gaussianfunctions.glsl)
RESPONSE_S = {8: -0.000685871056241, 5: -0.0185185185185,
              4: -0.0555555555556, 3: -0.166666666667, 1: -1.5,
              0: -0.329630334487}
RESPONSE_K = {8: 4.0, 5: 2.5, 4: 2.0, 3: 1.5, 1: 0.5}


class Settings(NamedTuple):
    """The renderer constants the reference needs (the port's
    RenderConfig defaults unless a configuration file says otherwise)."""
    kernel_degree: int = 4
    sh_degree: int = 3
    alpha_min: float = 1.0 / 255.0
    max_alpha: float = 0.99
    min_transmittance: float = 1e-3
    hit_min_response: float = 0.0113
    kernel_min_response: float = 0.0113
    aabb: tuple = (-100.0, -100.0, -100.0, 100.0, 100.0, 100.0)
    near: float = 0.005
    far: float = 20.0
    tile_size: int = 16
    chunk_size: int = 64


def particle_response(gd: torch.Tensor, degree: int) -> torch.Tensor:
    if degree == 8:
        d2 = gd * gd
        return torch.exp(RESPONSE_S[8] * d2 * d2)
    if degree == 5:
        return torch.exp(RESPONSE_S[5] * gd * gd * torch.sqrt(gd))
    if degree == 4:
        return torch.exp(RESPONSE_S[4] * gd * gd)
    if degree == 3:
        return torch.exp(RESPONSE_S[3] * gd * torch.sqrt(gd))
    if degree == 1:
        return torch.exp(RESPONSE_S[1] * torch.sqrt(gd))
    if degree == 0:
        return torch.clamp_min(1.0 + RESPONSE_S[0] * torch.sqrt(gd), 0.0)
    return torch.exp(-0.5 * gd)


def gray_cutoff(min_response: float, degree: int) -> float:
    """The gray distance at which the response falls to min_response."""
    if degree == 0:
        return ((1.0 - min_response) / -RESPONSE_S[0]) ** 2
    s, k = ((RESPONSE_S[degree], RESPONSE_K[degree])
            if degree in RESPONSE_K else (-0.5, 1.0))
    return (math.log(min_response) / s) ** (1.0 / k)


def response_cutoff(st: Settings) -> float:
    """D_hi: past it a pair's f32 response stays below hit_min_response
    (the cutoff of a response 2^-18 below the gate, inflated by 2^-13)."""
    h = float(st.hit_min_response)
    if not 0.0 < h < 1.0:
        return math.inf
    return gray_cutoff(h * (1.0 - 2.0 ** -18), st.kernel_degree) * (
        1.0 + 2.0 ** -13)


def kernel_radius(density: torch.Tensor, st: Settings) -> torch.Tensor:
    """Iso-response radius in units of scale (no adaptive clamping)."""
    min_response = torch.clamp_max(
        st.kernel_min_response / torch.ones_like(density), 0.97)
    b = float(st.kernel_degree)
    if b == 0:
        return ((1.0 - min_response) / 3.0) / 0.329630334487
    a = -4.5 / (3.0 ** b)
    return (torch.log(min_response) / a) ** (1.0 / b)


class Activated(NamedTuple):
    means: torch.Tensor       # (N, 3)
    scales: torch.Tensor      # (N, 3)
    inv_scales: torch.Tensor  # (N, 3)
    rot9: torch.Tensor        # (N, 9) row-major local -> world
    densities: torch.Tensor   # (N,)
    sh_flat: torch.Tensor     # (N, 48) channel-major


def activate(means, scales_log, quats, opacity_logit, sh_dc, sh_rest):
    """Raw leaves -> activated quantities (exp scales, sigmoid opacity,
    unit quaternion as a rotation, channel-major SH)."""
    q = quats / torch.sqrt(torch.sum(quats * quats, dim=-1, keepdim=True))
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    xx, yy, zz, xy, xz, yz = x * x, y * y, z * z, x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rot9 = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy)], dim=-1)
    scales = torch.exp(scales_log)
    sh_flat = torch.cat([torch.cat([sh_dc[:, c:c + 1], sh_rest[:, :, c]],
                                   dim=1) for c in range(3)], dim=1)
    return Activated(means, scales, 1.0 / scales, rot9,
                     torch.sigmoid(opacity_logit), sh_flat)


def param_rows(act: Activated) -> torch.Tensor:
    """(N+1, 64) rows: [M = diag(1/s) R^T (9) | b = M mean (3) | density |
    3 zero | sh r, g, b (16 each)], and a dummy row N with the identity
    frame, zero density and radiance."""
    n = act.means.shape[0]
    m_cols = [act.inv_scales[:, i] * act.rot9[:, 3 * k + i]
              for i in range(3) for k in range(3)]
    b_cols = [act.inv_scales[:, i]
              * (act.rot9[:, i] * act.means[:, 0]
                 + act.rot9[:, 3 + i] * act.means[:, 1]
                 + act.rot9[:, 6 + i] * act.means[:, 2]) for i in range(3)]
    zeros = torch.zeros((n, 3), dtype=act.means.dtype,
                        device=act.means.device)
    body = torch.cat([torch.stack(m_cols, 1), torch.stack(b_cols, 1),
                      act.densities[:, None], zeros, act.sh_flat], dim=1)
    dummy = torch.zeros((1, 64), dtype=body.dtype, device=body.device)
    dummy[0, 0] = dummy[0, 4] = dummy[0, 8] = 1.0
    return torch.cat([body, dummy], dim=0)


def sh_basis(x, y, z, degree: int):
    """The 16 SH basis values of unit directions (zero above the degree)."""
    basis = [SH_C0 * torch.ones_like(x)]
    if degree > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz,
                  SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
                  SH_C2[4] * (xx - yy)]
    if degree > 2:
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
    return basis + [torch.zeros_like(x)] * (16 - len(basis))


def clip_box(aabb, o: torch.Tensor, d: torch.Tensor):
    """(tmin, tmax) of the ray/box overlap, tmin clamped at 0, with the
    sign-preserving clamp of near-zero direction components."""
    lo = torch.tensor(aabb[:3], dtype=o.dtype, device=o.device)
    hi = torch.tensor(aabb[3:], dtype=o.dtype, device=o.device)
    safe_d = torch.where(d.abs() < 1e-6, torch.where(d < 0, -1e-6, 1e-6), d)
    inv = 1.0 / safe_d
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    tmin = torch.clamp_min(torch.amax(torch.minimum(t0, t1), dim=-1), 0.0)
    return tmin, torch.amin(torch.maximum(t0, t1), dim=-1)


def chunk_step(rays: torch.Tensor, chunk: torch.Tensor, t_in: torch.Tensor,
               st: Settings):
    """One depth-ordered block of G Gaussians against a tile's R rays.

    rays (..., 24, R) rows [o, d, tmin, tmax, 16 basis]; chunk (..., G, 64)
    parameter rows; t_in (..., 1, R).  Returns (t_out, rgb (..., 3, R),
    depth (..., 1, R), hits (..., 1, R)).  The exclusive transmittance in
    the block is a product over the Gaussians before each one; a pair
    composites only while T before it is above min_transmittance."""
    o = [rays[..., j:j + 1, :] for j in range(3)]
    d = [rays[..., 3 + j:4 + j, :] for j in range(3)]
    tmin, tmax = rays[..., 6:7, :], rays[..., 7:8, :]
    m = [chunk[..., j:j + 1] for j in range(9)]
    b = [chunk[..., 9 + j:10 + j] for j in range(3)]
    density = chunk[..., 12:13]
    gro = [m[3 * i] * o[0] + m[3 * i + 1] * o[1] + m[3 * i + 2] * o[2] - b[i]
           for i in range(3)]
    grdu = [m[3 * i] * d[0] + m[3 * i + 1] * d[1] + m[3 * i + 2] * d[2]
            for i in range(3)]
    nrm2 = grdu[0] * grdu[0] + grdu[1] * grdu[1] + grdu[2] * grdu[2]
    inv_n2 = 1.0 / torch.clamp_min(nrm2, 1e-20)
    c0 = grdu[1] * gro[2] - grdu[2] * gro[1]
    c1 = grdu[2] * gro[0] - grdu[0] * gro[2]
    c2 = grdu[0] * gro[1] - grdu[1] * gro[0]
    resp = particle_response((c0 * c0 + c1 * c1 + c2 * c2) * inv_n2,
                             st.kernel_degree)
    alpha = torch.clamp_max(resp * density, st.max_alpha)
    dot_og = grdu[0] * gro[0] + grdu[1] * gro[1] + grdu[2] * gro[2]
    t = -dot_og * inv_n2
    accept = ((resp > st.hit_min_response) & (alpha > st.alpha_min)
              & (dot_og < 0.0) & (t >= tmin) & (t <= tmax))
    alpha_eff = torch.where(accept, alpha, 0.0)
    u = 1.0 - alpha_eff
    excl = torch.cat([torch.ones_like(u[..., :1, :]),
                      torch.cumprod(u[..., :-1, :], dim=-2)], dim=-2)
    t_before = t_in * excl
    active = t_before > st.min_transmittance
    w = alpha_eff * t_before * active
    basis = rays[..., 8:24, :]
    rgb = [torch.sum(w * torch.clamp_min(
        torch.matmul(chunk[..., 16 + 16 * c:32 + 16 * c], basis) + 0.5, 0.0),
        dim=-2, keepdim=True) for c in range(3)]
    depth = torch.sum(w * t, dim=-2, keepdim=True)
    hits = torch.sum((accept & active).to(t_in.dtype), dim=-2, keepdim=True)
    t_out = t_in * torch.prod(torch.where(active, u, 1.0), dim=-2,
                              keepdim=True)
    return t_out, torch.cat(rgb, dim=-2), depth, hits
