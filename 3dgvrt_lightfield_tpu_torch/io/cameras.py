"""Cameras: Vulkan-convention perspective, NeRF transforms.json loading, ray gen.

Reference provenance:
  - Projection matrix: the custom `perspective_Vulkan_no_depth_reverse` the
    reference patched into vendored glm (external/glm/glm/gtc/
    matrix_transform.inl:274-290): P[1][1] is Y-flipped and depth maps to
    [0, 1] without reversal.
  - NeRF camera loading: base/LoadCamera.hpp:45-147 (intrinsics from
    camera_angle_x; the c2w->w2c transpose there is immediately undone by the
    shader's viewInverse, so viewInverse == the NeRF c2w matrix).
  - Per-pixel ray generation: shaders/glsl/VulkanFullRT/raygen.rgen:116-121.

Matrices here are row-major (v' = M @ v), unlike glm's column-major storage.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import List

import numpy as np

RAD2DEG = 57.2957795131


def perspective_vulkan(fovy_rad: float, aspect: float, znear: float,
                       zfar: float) -> np.ndarray:
    """Vulkan projection with Y flip and non-reversed [0,1] depth.

    Row-major equivalent of glm/gtc/matrix_transform.inl:274-290.
    """
    t = math.tan(fovy_rad / 2.0)
    p = np.zeros((4, 4), dtype=np.float64)
    p[0, 0] = 1.0 / (aspect * t)
    p[1, 1] = -1.0 / t
    p[2, 2] = -zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    p[3, 2] = -1.0
    return p


@dataclass
class Camera:
    """A render camera: image size + viewInverse (c2w) + projInverse."""
    width: int
    height: int
    view_inverse: np.ndarray  # (4, 4) c2w, row-major
    proj_inverse: np.ndarray  # (4, 4) inverse projection, row-major
    name: str = ""
    fovy_deg: float = 0.0     # vertical FOV in degrees (0 = unknown)

    @classmethod
    def from_fovy(cls, width: int, height: int, fovy_deg: float,
                  c2w: np.ndarray, znear: float = 0.005, zfar: float = 20.0,
                  name: str = "") -> "Camera":
        proj = perspective_vulkan(math.radians(fovy_deg), width / height,
                                  znear, zfar)
        return cls(width=width, height=height,
                   view_inverse=np.asarray(c2w, np.float64),
                   proj_inverse=np.linalg.inv(proj), name=name,
                   fovy_deg=float(fovy_deg))

    def content_key(self) -> bytes:
        """Stable value-based identity (for ray caches etc.)."""
        return (np.asarray(self.view_inverse, np.float64).tobytes()
                + np.asarray(self.proj_inverse, np.float64).tobytes()
                + np.int64([self.width, self.height]).tobytes())

    def rays(self, dtype=np.float32):
        """Per-pixel ray origins/directions, replicating raygen.rgen:116-121.

        Returns (origins (H, W, 3), directions (H, W, 3)); pixel (0, 0) is the
        top-left ray (gl_LaunchID (x=0, y=0)).
        """
        h, w = self.height, self.width
        xs = (np.arange(w, dtype=np.float64) + 0.5) / w * 2.0 - 1.0
        ys = (np.arange(h, dtype=np.float64) + 0.5) / h * 2.0 - 1.0
        dx, dy = np.meshgrid(xs, ys)  # (H, W)
        ndc = np.stack([dx, dy, np.ones_like(dx), np.ones_like(dx)], axis=-1)
        target = ndc @ self.proj_inverse.T          # (H, W, 4)
        dir_w = target[..., :3] @ self.view_inverse[:3, :3].T
        dir_w = dir_w / np.linalg.norm(dir_w, axis=-1, keepdims=True)
        origin = np.broadcast_to(self.view_inverse[:3, 3], dir_w.shape)
        return origin.astype(dtype), dir_w.astype(dtype)


def look_at_inverse(eye: np.ndarray, center: np.ndarray,
                    up: np.ndarray) -> np.ndarray:
    """inverse(glm::lookAt(eye, center, up)) as a row-major c2w matrix.

    Used by the Gaussian light-field sampling cameras
    (VulkanFullRT.cpp:1560-1562).
    """
    eye = np.asarray(eye, np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    c2w = np.eye(4)
    # glm::lookAt view rows are (s, u, -f); its inverse has columns (s, u, -f).
    c2w[:3, 0] = s
    c2w[:3, 1] = u
    c2w[:3, 2] = -f
    c2w[:3, 3] = eye
    return c2w


def load_nerf_cameras(json_path: str, width: int, height: int,
                      znear: float = 0.005, zfar: float = 20.0) -> List[Camera]:
    """Load NeRF `transforms_*.json` dataset cameras (LoadCamera.hpp:124-147).

    fovy follows calcIntrinsics (LoadCamera.hpp:45-55):
    fy = 0.5*W / tan(0.5*camera_angle_x);  fovy = 2*atan(H / (2*fy)).
    """
    with open(json_path, "r") as f:
        j = json.load(f)
    cam_angle_x = float(j["camera_angle_x"])
    fy = 0.5 * width / math.tan(0.5 * cam_angle_x)
    fovy_deg = 2.0 * math.atan(height / (2.0 * fy)) * RAD2DEG
    cams = []
    for i, frame in enumerate(j["frames"]):
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        name = os.path.basename(str(frame.get("file_path", i)))
        cams.append(Camera.from_fovy(width, height, fovy_deg, c2w,
                                     znear, zfar, name=name))
    return cams
