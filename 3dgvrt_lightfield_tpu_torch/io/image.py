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


def load_cubemap(paths) -> np.ndarray:
    """Load a cubemap -> (6, S, S, 3) float32, faces [+X, -X, +Y, -Y, +Z, -Z].

    Accepts either a single `.ktx`/`.ktx2` container (the reference's format:
    base/VulkanTexture.cpp loadCubemap, used at VulkanRTBase.cpp:3656 — read
    by io/ktx.py) or a list of 6 face PNGs in the same Vulkan/KTX layer
    order; faces must share one square size.
    """
    if isinstance(paths, (str, os.PathLike)):
        from .ktx import load_ktx
        cube = load_ktx(os.fspath(paths))
        if cube.ndim != 4 or cube.shape[0] != 6:
            raise ValueError(f"{paths}: not a 6-face cubemap KTX")
        s = cube.shape[1]
        if cube.shape[2] != s:
            raise ValueError("cube faces must be square")
        return np.ascontiguousarray(cube[..., :3], np.float32)
    assert len(paths) == 6, "a cubemap needs exactly 6 faces (+X-X+Y-Y+Z-Z)"
    faces = [np.asarray(load_png(p), np.float32) / 255.0 for p in paths]
    s = faces[0].shape[0]
    for f in faces:
        assert f.shape == (s, s, 3), f"cube faces must be square {s}x{s}x3"
    return np.stack(faces, axis=0)
