"""Quaternion and small vector-math ops (WXYZ convention).

Reference: shaders/glsl/base/utils.glsl:8-57.  `quat_to_rotmat` returns the
standard local->world matrix R such that ``v_world = R @ v_local``;
world->local is ``R.T @ v``.  All functions are batched over leading axes.
"""

from __future__ import annotations

import torch


def safe_normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Normalize, returning v unchanged when ||v|| == 0 (utils.glsl:8-11)."""
    sq = torch.sum(v * v, dim=dim, keepdim=True)
    inv = torch.where(sq > 0.0,
                      torch.reciprocal(torch.sqrt(torch.where(sq > 0.0, sq, 1.0))),
                      1.0)
    return v * inv


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalize WXYZ quaternions, shape (..., 4)."""
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))


def _quat_products(q: torch.Tensor):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (x * x, y * y, z * z, x * y, x * z, y * z, w * x, w * y, w * z)


def quat_to_rot9(q: torch.Tensor) -> torch.Tensor:
    """WXYZ quaternion(s) (..., 4) -> flat row-major rotation (..., 9)."""
    xx, yy, zz, xy, xz, yz, wx, wy, wz = _quat_products(q)
    return torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """WXYZ quaternion(s) -> local->world rotation matrix, shape (..., 3, 3)
    (utils.glsl:36-57, `quaternionWXYZToMatrixTranspose`)."""
    return quat_to_rot9(q).reshape(q.shape[:-1] + (3, 3))
