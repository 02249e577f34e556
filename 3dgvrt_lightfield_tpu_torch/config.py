"""Single-source configuration of the PyTorch port.

Same constants and `RenderConfig` fields as the JAX package's `config.py`,
so a test can hand one configuration to both packages and compare like with
like.  `resolve_device` is the port's one rule for where an entry point runs:
on the card unless the caller asks for the CPU by name; `resolve_impl` the
one rule for whether a kernel or its plain version runs there.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# Spherical-harmonics basis constants (reference: shaders/glsl/base/3dgs.glsl:34-49).
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)

#: Number of SH coefficients for degree 3 (reference: 3dgs.glsl:19).
SH_MAX_NUM_COEFFS = 16


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All algorithm constants of the renderer (see the JAX `config.py` for
    each field's provenance in the reference viewer)."""

    kernel_degree: int = 4
    sh_degree: int = 3
    alpha_min: float = 1.0 / 255.0
    max_alpha: float = 0.99
    min_transmittance: float = 1e-3
    hit_min_response: float = 0.0113
    kernel_min_response: float = 0.0113
    aabb: Tuple[float, float, float, float, float, float] = (
        -100.0, -100.0, -100.0, 100.0, 100.0, 100.0)
    near: float = 0.005
    far: float = 20.0
    adaptive_kernel_clamping: bool = False

    #: Pixels per side of an image tile; the tile kernel runs one thread
    #: per ray, so a block holds tile_size**2 threads.
    tile_size: int = 16
    #: Gaussians per chunk: the block the tile kernel stages in shared memory.
    chunk_size: int = 64
    #: Ray-chunk size for the brute-force (validation) renderer.
    ray_chunk: int = 4096
    #: Kept for parity with the JAX configuration; the port's prefix sums
    #: are plain scans, so it selects nothing here.
    prefix_matmul: bool = False
    #: Track transmittance as a direct product of (1 - alpha) (True) or as
    #: exp(sum(log1p(-alpha))) per chunk, the reference's log-space form.
    transmittance_prod: bool = True
    #: Emit cotangents of the tile rays in the backward (for pose
    #: refinement); off, gradients w.r.t. the rays are silent zeros.
    ray_gradients: bool = False

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = RenderConfig()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says otherwise.

    Leaving `device` out means the card; without CUDA that raises instead of
    carrying on on the CPU.  Pass ``device="cpu"`` to run on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:  # "cuda" means the current card, by index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


IMPLS = ("cuda", "torch")


def resolve_impl(impl: str, device: torch.device) -> str:
    """"auto" -> "cuda" on a CUDA device, "torch" (the plain version) on the
    CPU.  "cuda" needs a CUDA device; "torch" on CUDA is taken only when
    asked for by name."""
    if impl == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected auto|cuda|torch")
    if impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA device, got {device}")
    return impl
