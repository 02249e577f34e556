"""Quality metrics: PSNR and SSIM.

Port of the reference's offline evaluation harness
(results/evaluations/eval_quality.py:10-33): PSNR on 8-bit values with
PIXEL_MAX=255, and mean SSIM over RGB channels with a 7x7 uniform window
(scikit-image `structural_similarity` defaults, which eval_quality.py calls).
Implemented in NumPy to avoid a cv2/skimage dependency.
"""

from __future__ import annotations

import numpy as np


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR between two uint8 (or [0,255] float) images (eval_quality.py:10-15)."""
    mse = np.mean((img1.astype(np.float32) - img2.astype(np.float32)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 ** 2 / mse))


def _uniform_filter(img: np.ndarray, win: int) -> np.ndarray:
    """Mean filter with a win x win window via cumsum (valid region only)."""
    pad = win // 2
    x = np.pad(img, ((pad + 1, pad), (pad + 1, pad)), mode="edge").astype(np.float64)
    cs = x.cumsum(0).cumsum(1)
    s = (cs[win:, win:] - cs[:-win, win:] - cs[win:, :-win] + cs[:-win, :-win])
    return s / (win * win)


def ssim(img1: np.ndarray, img2: np.ndarray, win_size: int = 7,
         data_range: float = 255.0) -> float:
    """Mean SSIM matching skimage.structural_similarity defaults.

    Uses a uniform win_size x win_size filter, K1=0.01, K2=0.03, and averages
    over channels (channel_axis=-1), as called in eval_quality.py:17-33.
    """
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    n = win_size * win_size
    cov_norm = n / (n - 1)
    scores = []
    for c in range(img1.shape[-1]):
        x, y = img1[..., c], img2[..., c]
        ux = _uniform_filter(x, win_size)
        uy = _uniform_filter(y, win_size)
        uxx = _uniform_filter(x * x, win_size)
        uyy = _uniform_filter(y * y, win_size)
        uxy = _uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        a1, a2 = 2 * ux * uy + c1, 2 * vxy + c2
        b1, b2 = ux ** 2 + uy ** 2 + c1, vx + vy + c2
        s = (a1 * a2) / (b1 * b2)
        pad = (win_size - 1) // 2
        scores.append(s[pad:s.shape[0] - pad, pad:s.shape[1] - pad].mean())
    return float(np.mean(scores))
