"""Image I/O: float [0,1] radiance <-> 8-bit PNG.

Mirrors the reference's rgba8 imageStore + stbi_write_png output path
(raygen.rgen:184, VulkanFullRT.cpp:2127-2162): radiance is clamped to [0,1]
and quantized to uint8.
"""

from __future__ import annotations

import os

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp float radiance to [0,1] and quantize like VK_FORMAT_R8G8B8A8_UNORM."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return np.round(img * 255.0).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    """Save (H, W, 3) float [0,1] or uint8 image as PNG."""
    if img.dtype != np.uint8:
        img = to_uint8(img)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    from PIL import Image
    Image.fromarray(img).save(path)


def load_png(path: str) -> np.ndarray:
    """Load a PNG as (H, W, C) uint8."""
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"))

