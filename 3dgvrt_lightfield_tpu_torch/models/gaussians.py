"""GaussianModel: the 3D Gaussian scene as an `nn.Module`.

Holds raw (pre-activation) parameters exactly as stored in INRIA PLY files
(base/Vulkan3DGRTModel.cpp:7-125) as six `nn.Parameter` leaves, with the
same names and shapes as the JAX package's pytree leaves, and exposes the
activated view: scale = exp(scale_log), density = sigmoid(opacity_logit)
(particlePrimitives.comp:149-151), a flat rotation and a channel-major SH
table for the binning pass.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..io.ply import SplatSet
from ..ops.kernels import scale_activation, sigmoid
from ..ops.quaternion import normalize_quat, quat_to_rot9
from ..utils.profiling import span

#: the six raw leaves, in the JAX package's field order
LEAVES = ("means", "scales_log", "quats", "opacity_logit", "sh_dc", "sh_rest")


class ActivatedGaussians(NamedTuple):
    """Activated per-Gaussian quantities fed to the renderer."""
    means: torch.Tensor       # (N, 3)
    scales: torch.Tensor      # (N, 3)
    inv_scales: torch.Tensor  # (N, 3)
    rot9: torch.Tensor        # (N, 9) row-major local->world rotation
    densities: torch.Tensor   # (N,)
    sh_flat: torch.Tensor     # (N, 48) channel-major [R:16 | G:16 | B:16]

    @property
    def rotmats(self) -> torch.Tensor:  # (N, 3, 3)
        return self.rot9.reshape(-1, 3, 3)

    @property
    def sh_coeffs(self) -> torch.Tensor:  # (N, 16, 3)
        return self.sh_flat.reshape(-1, 3, 16).transpose(1, 2)


@span("gvrt.param_table")
def activate_leaves(means, scales_log, quats, opacity_logit, sh_dc,
                    sh_rest) -> ActivatedGaussians:
    """The activated view of six raw parameter tensors (LEAVES order)."""
    q = normalize_quat(quats)
    scales = scale_activation(scales_log)
    sh_flat = torch.cat(
        [torch.cat([sh_dc[:, c:c + 1], sh_rest[:, :, c]], dim=1)
         for c in range(3)], dim=1)
    return ActivatedGaussians(
        means=means,
        scales=scales,
        inv_scales=1.0 / scales,
        rot9=quat_to_rot9(q),
        densities=sigmoid(opacity_logit),
        sh_flat=sh_flat,
    )


class GaussianModel(nn.Module):
    """Six raw parameter leaves: means (N, 3), scales_log (N, 3), quats
    (N, 4) WXYZ unnormalized, opacity_logit (N,), sh_dc (N, 3), sh_rest
    (N, 15, 3)."""

    def __init__(self, means, scales_log, quats, opacity_logit, sh_dc,
                 sh_rest):
        super().__init__()
        self.means = nn.Parameter(means)
        self.scales_log = nn.Parameter(scales_log)
        self.quats = nn.Parameter(quats)
        self.opacity_logit = nn.Parameter(opacity_logit)
        self.sh_dc = nn.Parameter(sh_dc)
        self.sh_rest = nn.Parameter(sh_rest)

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    # ---- weight carry ---------------------------------------------------
    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray],
                   device=None) -> "GaussianModel":
        """Model from the six leaves as NumPy arrays (keys as `LEAVES`), e.g.
        `np.asarray` of a JAX model's fields; `device` as `resolve_device`."""
        dev = resolve_device(device)
        return cls(*(torch.tensor(np.asarray(arrays[k], np.float32),
                                  device=dev) for k in LEAVES))

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Inverse of `from_numpy`: the six leaves as float32 NumPy arrays."""
        return {k: getattr(self, k).detach().cpu().numpy() for k in LEAVES}

    @classmethod
    def from_splats(cls, splats: SplatSet, device=None) -> "GaussianModel":
        return cls.from_numpy({
            "means": splats.positions, "scales_log": splats.scale,
            "quats": splats.rotation, "opacity_logit": splats.opacity,
            "sh_dc": splats.f_dc, "sh_rest": splats.f_rest}, device)

    @classmethod
    def from_ply(cls, path: str, device=None) -> "GaussianModel":
        from ..io.ply import load_splats
        return cls.from_splats(load_splats(path), device)

    def to_splats(self) -> SplatSet:
        a = self.to_numpy()
        return SplatSet(positions=a["means"], scale=a["scales_log"],
                        rotation=a["quats"], opacity=a["opacity_logit"],
                        f_dc=a["sh_dc"], f_rest=a["sh_rest"])

    def to_ply(self, path: str) -> None:
        from ..io.ply import save_splats
        save_splats(path, self.to_splats())

    # ---- activated view ---------------------------------------------------
    def leaves(self) -> tuple:
        """The six raw parameters, in `LEAVES` order."""
        return tuple(getattr(self, k) for k in LEAVES)

    def activate(self) -> ActivatedGaussians:
        return activate_leaves(*self.leaves())

    def scene_aabb(self):
        """(min, max) corners over the Gaussian centers
        (VulkanFullRT.cpp:1527-1545)."""
        return torch.amin(self.means, dim=0), torch.amax(self.means, dim=0)

    # ---- filtering ----------------------------------------------------------
    def abnormal_mask(self) -> torch.Tensor:
        """True for particles to KEEP: drop |albedo| > 3 or a cumulative
        specular-norm ratio > 150 (particlePrimitives.comp:120-140, evaluated
        on the per-particle (15, 3) block as the JAX package does)."""
        albedo_strength = torch.linalg.vector_norm(self.sh_dc, dim=-1)
        coeff_norms = torch.linalg.vector_norm(self.sh_rest[:, 1:, :], dim=-1)
        partial = torch.cumsum(coeff_norms, dim=-1)
        ratio = partial[:, -1] / (partial[:, 0] + 1e-5)
        return (albedo_strength <= 3.0) & (ratio <= 150.0)

    @torch.no_grad()
    def filtered(self) -> "GaussianModel":
        """Keep-order compaction of the non-abnormal particles."""
        idx = torch.nonzero(self.abnormal_mask()).squeeze(1)
        return GaussianModel(*(getattr(self, k)[idx].clone() for k in LEAVES))

    # ---- reordering ---------------------------------------------------------
    @torch.no_grad()
    def permute(self, perm) -> "GaussianModel":
        """A new model with every leaf reordered by `perm` (scene prep).
        Gaussian order does not change the image (rendering sorts per tile
        by depth), so a physical reorder is free to do once."""
        idx = torch.as_tensor(perm, device=self.device).long()
        return GaussianModel(*(getattr(self, k)[idx].clone() for k in LEAVES))

    @torch.no_grad()
    def sorted_for_camera(self, camera, cfg=None) -> "GaussianModel":
        """Reorder Gaussians by projected image-row span for `camera`, the
        scene prep of span banding: a contiguous band of tile rows then
        touches a contiguous range of ids.  The key is ty0 + ty1 of the
        binning cull table (twice the row centre); invalid Gaussians sort
        last.  The sort is stable, so ties keep id order and the
        permutation equals the JAX package's."""
        from ..config import DEFAULT_CONFIG
        from ..render.binning import frame_cull_table
        from ..render.tiled import _camera_mats
        cfg = cfg or DEFAULT_CONFIG
        w2c, proj = _camera_mats(camera)
        tab = frame_cull_table(self.activate(), w2c, proj, camera.width,
                               camera.height, cfg)
        key = torch.where(tab.valid, tab.ty0.long() + tab.ty1.long(),
                          2 * camera.height)
        return self.permute(torch.argsort(key, stable=True))


@torch.no_grad()
def random_gaussians(generator: torch.Generator, n: int, extent: float = 1.0,
                     scale_range=(-4.5, -2.5), device=None) -> GaussianModel:
    """Synthetic scene with the JAX `random_gaussians` distributions, drawn
    from `generator` (torch's own stream, so not the JAX scene's numbers).
    The numbers are drawn on the generator's device and the model lives on
    `resolve_device(device)`."""
    dev = resolve_device(device)

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (lo + (hi - lo) * u).to(dev)

    def normal(shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(dev)

    return GaussianModel(
        means=uniform((n, 3), -extent, extent),
        scales_log=uniform((n, 3), scale_range[0], scale_range[1]),
        quats=normal((n, 4)) + torch.tensor([2.0, 0, 0, 0], device=dev),
        opacity_logit=uniform((n,), -2.0, 3.0),
        sh_dc=uniform((n, 3), -1.0, 1.0),
        sh_rest=0.05 * normal((n, 15, 3)),
    )
