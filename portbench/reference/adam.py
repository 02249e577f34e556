"""Adam over the six Gaussian leaves with per-leaf learning rates, the
means' on an exponential decay: the fine-tune recipe, written out.

Per leaf: m = m + (1 - b1)(g - m); v = b2 v + (1 - b2) g^2; p -= lr /
(1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps).  The means' lr is
lr0 * final_scale ** (steps taken / total_steps).
"""

from __future__ import annotations

import torch

#: the fine-tune recipe's learning rates per leaf, in leaf order; the
#: means' is multiplied by the scene extent
LEAF_LRS = (1.6e-4, 5e-3, 1e-3, 0.05, 2.5e-3, 2.5e-3 / 20.0)


class Adam:
    def __init__(self, params, scene_extent=1.0, total_steps=1000,
                 final_scale=0.01, betas=(0.9, 0.999), eps=1e-15):
        self.params = params
        self.lrs = [LEAF_LRS[0] * scene_extent, *LEAF_LRS[1:]]
        self.total_steps, self.final_scale = total_steps, final_scale
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        lrs = list(self.lrs)
        lrs[0] = lrs[0] * self.final_scale ** (self.t / self.total_steps)
        self.t += 1
        bc1 = 1.0 - self.b1 ** self.t
        bc2_sqrt = (1.0 - self.b2 ** self.t) ** 0.5
        for p, g, m, v, lr in zip(self.params, grads, self.m, self.v, lrs):
            m.lerp_(g, 1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = (v.sqrt() / bc2_sqrt).add_(self.eps)
            p.addcdiv_(m, denom, value=-lr / bc1)
