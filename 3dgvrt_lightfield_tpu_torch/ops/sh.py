"""Spherical-harmonics radiance evaluation (degree <= 3).

Reference: shaders/glsl/base/gaussianfunctions.glsl:122-151 (`radianceFromSpH`)
with basis constants from 3dgs.glsl:34-49.  Radiance gets a +0.5 offset and an
optional clamp at 0, exactly like the reference.
"""

from __future__ import annotations

import torch

from ..config import SH_C0, SH_C1, SH_C2, SH_C3


def sh_basis_components(x, y, z, degree: int):
    """List of (degree+1)**2 SH basis values from direction components
    (3dgs.glsl:34-49, gaussianfunctions.glsl:122-151)."""
    basis = [SH_C0 * torch.ones_like(x)]
    if degree > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree > 2:
        basis += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    return basis


def sh_basis(direction: torch.Tensor, degree: int) -> torch.Tensor:
    """(..., 3) unit ray direction -> (..., (degree+1)**2) basis values."""
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    return torch.stack(sh_basis_components(x, y, z, degree), dim=-1)


def radiance_from_sh(coeffs: torch.Tensor, direction: torch.Tensor,
                     degree: int = 3, clamped: bool = True) -> torch.Tensor:
    """RGB radiance from (..., 16, 3) coefficient-major SH coefficients."""
    num = (degree + 1) ** 2
    basis = sh_basis(direction, degree)
    rad = torch.einsum("...k,...kc->...c", basis, coeffs[..., :num, :]) + 0.5
    if clamped:
        rad = torch.clamp_min(rad, 0.0)
    return rad
