"""Image-quality evaluation: PSNR/SSIM of rendered views vs ground truth.

Counterpart of the JAX package's `utils/evaluate.py` (NumPy only there, so
the port keeps its own copy).  A port of the reference's offline harness
(results/evaluations/eval_quality.py:36-62): walk the ground-truth
directory, compare same-named images in each test directory, print per-view
and average PSNR/SSIM.  The in-app render-eval path (EVAL_QUALITY,
VulkanFullRT.cpp:2127-2162) is `render_eval_set`: render every dataset
camera and write `r_<i>.png`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from .metrics import psnr, ssim


def evaluate_dirs(gt_dir: str, test_dirs: Sequence[str],
                  verbose: bool = True) -> Dict[str, Dict[str, float]]:
    """eval_quality.py:36-62 — per-view and average PSNR/SSIM per method dir."""
    from ..io.image import load_png
    results: Dict[str, Dict[str, float]] = {}
    for td in test_dirs:
        psnr_list, ssim_list = [], []
        if verbose:
            print(f"\n=== {td} ===")
        for fname in sorted(os.listdir(gt_dir)):
            gt_path = os.path.join(gt_dir, fname)
            test_path = os.path.join(td, fname)
            if not os.path.exists(test_path):
                if verbose:
                    print(f"  skip {fname}")
                continue
            gt = load_png(gt_path)
            test = load_png(test_path)
            p = psnr(gt, test)
            s = ssim(gt, test)
            psnr_list.append(p)
            ssim_list.append(s)
            if verbose:
                print(f"{fname}: PSNR={p:.2f}, SSIM={s:.4f}")
        avg_p = sum(psnr_list) / len(psnr_list) if psnr_list else float("nan")
        avg_s = sum(ssim_list) / len(ssim_list) if ssim_list else float("nan")
        if verbose:
            print(f"{td} Average -> PSNR: {avg_p:.2f}, SSIM: {avg_s:.4f}")
        results[td] = {"psnr": avg_p, "ssim": avg_s,
                       "num_views": len(psnr_list)}
    return results


def render_eval_set(model, cameras, out_dir: str, cfg=None, impl: str = "auto",
                    name_fmt: str = "r_{i}.png", renderer=None,
                    device=None) -> List[str]:
    """Render every eval camera to `out_dir` (the EVAL_QUALITY loop), under
    `torch.no_grad()`; `device` as `resolve_device` when no renderer is
    given.

    Output naming matches the reference's `r_<i>.png` convention
    (VulkanFullRT.cpp:2141, results/evaluations/rename.py).
    """
    from ..config import DEFAULT_CONFIG
    from ..io.image import save_png
    from ..render.tiled import TiledRenderer
    cfg = cfg or DEFAULT_CONFIG
    os.makedirs(out_dir, exist_ok=True)
    if renderer is None:
        renderer = TiledRenderer(cameras[0].width, cameras[0].height, cfg,
                                 impl=impl, device=device)
        renderer.plan(model, cameras[: min(len(cameras), 4)])
    paths = []
    for i, cam in enumerate(cameras):
        with torch.no_grad():
            out = renderer.render(model, cam)
        path = os.path.join(out_dir, name_fmt.format(i=i))
        save_png(path, out["rgb"].cpu().numpy())
        paths.append(path)
    return paths


def save_hit_counts(hit_count, path: str) -> None:
    """Per-pixel hit-count dump (ENABLE_HIT_COUNTS,
    VulkanFullRT.cpp:2180-2195 writes results/texts/rayHitCountsOutput.txt);
    `hit_count` an (H, W) array or tensor."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if torch.is_tensor(hit_count):
        hit_count = hit_count.cpu().numpy()
    arr = np.asarray(hit_count)
    with open(path, "w") as f:
        for row in arr:
            f.write(" ".join(str(int(v)) for v in row) + "\n")
