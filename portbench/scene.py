"""A configuration's scene, drawn from the seed on the device.

The distributions of the JAX package's `random_gaussians`, with the
configuration's extent, log-scale and opacity-logit ranges and centre:
means uniform in the cube of half-side `extent` about `centre`, log-scales
and opacity logits uniform, quaternions normal about (2, 0, 0, 0), sh_dc
uniform in [-1, 1], sh_rest normal with sigma 0.05.  A training cell's
model is the same scene with its opacity logits and sh_dc perturbed from
the same stream, so its loss and gradients are not zero.
"""

from __future__ import annotations

import torch

#: the six leaves in the program's order
LEAVES = ("means", "scales_log", "quats", "opacity_logit", "sh_dc",
          "sh_rest")


def draw(config: dict, seed: int, device, perturb: dict = None):
    """(scene leaves, perturbed leaves or None), float32 on `device`,
    from one torch.Generator seeded with `seed`."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    n, e = int(config["gaussians"]), float(config["extent"])

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)

    def normal(shape):
        return torch.randn(shape, generator=g, device=device)

    centre = torch.tensor(config["centre"], dtype=torch.float32,
                          device=device)
    means = uniform((n, 3), -e, e) + centre
    scales_log = uniform((n, 3), *config["scale_log_range"])
    quats = normal((n, 4))
    quats[:, 0] += 2.0
    opacity = uniform((n,), *config["opacity_logit_range"])
    sh_dc = uniform((n, 3), -1.0, 1.0)
    sh_rest = 0.05 * normal((n, 15, 3))
    scene = [means, scales_log, quats, opacity, sh_dc, sh_rest]
    if not perturb:
        return scene, None
    model = [x.clone() for x in scene]
    model[3] += float(perturb["opacity_logit"]) * normal((n,))
    model[4] += float(perturb["sh_dc"]) * normal((n, 3))
    return scene, model
