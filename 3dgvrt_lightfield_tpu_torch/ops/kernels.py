"""Generalized-Gaussian kernel response, activations, and kernel radius.

Reference math:
  - particle_response: shaders/glsl/base/gaussianfunctions.glsl:18-57
  - kernel_scale:      shaders/glsl/VulkanFullRT/particlePrimitives.comp:81-105
  - activations (exp scale / sigmoid opacity): particlePrimitives.comp:149-151

The tile kernels repeat `particle_response` and `particle_response_grad`
branch by branch (csrc/tile_common.cuh); keep them in step.
"""

from __future__ import annotations

import torch

# s-coefficients per kernel degree (gaussianfunctions.glsl:18-57).  For the
# generalized Gaussian of degree b the scaling is a = -4.5 / 3**b
# (particlePrimitives.comp:98-101); degrees 0 and "default" are special-cased.
_RESPONSE_S = {
    8: -0.000685871056241,
    5: -0.0185185185185,
    4: -0.0555555555556,
    3: -0.166666666667,
    1: -1.5,
    0: -0.329630334487,
}


def particle_response(gray_dist: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Kernel response as a function of squared local-frame min distance."""
    if degree == 8:
        d2 = gray_dist * gray_dist
        return torch.exp(_RESPONSE_S[8] * d2 * d2)
    if degree == 5:
        return torch.exp(_RESPONSE_S[5] * gray_dist * gray_dist
                         * torch.sqrt(gray_dist))
    if degree == 4:
        return torch.exp(_RESPONSE_S[4] * gray_dist * gray_dist)
    if degree == 3:
        return torch.exp(_RESPONSE_S[3] * gray_dist * torch.sqrt(gray_dist))
    if degree == 1:
        return torch.exp(_RESPONSE_S[1] * torch.sqrt(gray_dist))
    if degree == 0:
        return torch.clamp_min(1.0 + _RESPONSE_S[0] * torch.sqrt(gray_dist),
                               0.0)
    # default: quadratic (true Gaussian)
    return torch.exp(-0.5 * gray_dist)


def particle_response_grad(gray_dist: torch.Tensor, resp: torch.Tensor,
                           degree: int = 4) -> torch.Tensor:
    """d(particle_response)/d(gray_dist), given the forward response.

    Used by the hand-derived backward (render/tile_math.chunk_core_bwd) so
    the transcendental is not recomputed; matches autodiff of
    `particle_response` for each degree branch.
    """
    s = _RESPONSE_S.get(degree)
    if degree == 8:
        d2 = gray_dist * gray_dist
        return resp * s * 4.0 * d2 * gray_dist
    if degree == 5:
        return resp * s * 2.5 * gray_dist * torch.sqrt(gray_dist)
    if degree == 4:
        return resp * s * 2.0 * gray_dist
    if degree == 3:
        return resp * s * 1.5 * torch.sqrt(gray_dist)
    if degree == 1:
        return resp * s * 0.5 / torch.sqrt(torch.clamp_min(gray_dist, 1e-20))
    if degree == 0:
        root = torch.sqrt(torch.clamp_min(gray_dist, 1e-20))
        return torch.where(1.0 + s * root > 0.0, s * 0.5 / root, 0.0)
    return -0.5 * resp


def kernel_scale(density: torch.Tensor,
                 modulated_min_response: float,
                 kernel_degree: float = 4.0,
                 adaptive_clamping: bool = False) -> torch.Tensor:
    """Iso-response radius r with response(r^2) == min_response, in units of
    (activated) scale (particlePrimitives.comp:81-105)."""
    modulation = density if adaptive_clamping else torch.ones_like(density)
    min_response = torch.clamp_max(modulated_min_response / modulation, 0.97)

    if kernel_degree < 0:  # bump kernel
        k = abs(kernel_degree)
        s = 1.0 / (3.0 ** k)
        return ((1.0 / (torch.log(min_response) - 1.0) + 1.0) / s) ** (1.0 / k)
    if kernel_degree == 0:  # linear kernel
        return ((1.0 - min_response) / 3.0) / 0.329630334487
    b = kernel_degree
    a = -4.5 / (3.0 ** b)
    return (torch.log(min_response) / a) ** (1.0 / b)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Opacity activation (particlePrimitives.comp:107-110)."""
    return torch.sigmoid(x)


def scale_activation(scale_log: torch.Tensor) -> torch.Tensor:
    """Scale activation (particlePrimitives.comp:149)."""
    return torch.exp(scale_log)
