"""Hand-derived VJP of the parameter layer: GaussianModel -> rows64.

Counterpart of the JAX package's `render/rows_vjp.py`.
`rows64_from_model(model, cfg)` equals `param_rows(model.activate(), cfg)`;
as a `torch.autograd.Function` its backward is the chain rule written out in
flat (N,) column arithmetic (prefolded frame M = diag(1/s) R^T, b = M mean,
quaternion rotation and normalization, exp/sigmoid activations) instead of
autograd's graph over dozens of small (N, k) intermediates.
"""

from __future__ import annotations

import torch

from ..config import RenderConfig
from ..models.gaussians import GaussianModel, activate_leaves
from ..utils.profiling import span
from .binning import param_rows


class _Rows64(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cfg: RenderConfig, means, scales_log, quats,
                opacity_logit, sh_dc, sh_rest):
        ctx.save_for_backward(means, scales_log, quats, opacity_logit)
        return param_rows(activate_leaves(means, scales_log, quats,
                                          opacity_logit, sh_dc, sh_rest), cfg)

    @staticmethod
    @span("gvrt.param_table.bwd")
    def backward(ctx, g):
        means, scales_log, quats, opacity_logit = ctx.saved_tensors
        n = means.shape[0]
        gt = g[:n].t()                               # (64, N): columns as rows
        col = lambda j: gt[j]                        # noqa: E731

        # --- recompute the (cheap, 1D) forward intermediates ---
        mt, slt, qt = means.t(), scales_log.t(), quats.t()
        u = [torch.exp(-slt[i]) for i in range(3)]   # inv_scales columns
        qw, qx, qy, qz = qt[0], qt[1], qt[2], qt[3]
        qn2 = qw * qw + qx * qx + qy * qy + qz * qz
        # exact 1/sqrt, as normalize_quat's forward divides exactly
        qinv = 1.0 / torch.sqrt(qn2)
        w, x, y, z = qw * qinv, qx * qinv, qy * qinv, qz * qinv
        rot = [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z),
               2.0 * (x * z + w * y),
               2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z),
               2.0 * (y * z - w * x),
               2.0 * (x * z - w * y), 2.0 * (y * z + w * x),
               1.0 - 2.0 * (x * x + y * y)]          # rot9 columns, row-major
        t = [rot[i] * mt[0] + rot[3 + i] * mt[1] + rot[6 + i] * mt[2]
             for i in range(3)]                      # t_i = (R^T mean)_i

        # --- chain rule, all (N,) columns ---
        gm = [[col(i * 3 + k) for k in range(3)] for i in range(3)]
        gb = [col(9 + i) for i in range(3)]
        # d inv_s_i = sum_k gm[i][k] R[k,i] + gb[i] t_i ;  d sl_i = -u_i d u_i
        d_sl = [-u[i] * (sum(gm[i][k] * rot[3 * k + i] for k in range(3))
                         + gb[i] * t[i]) for i in range(3)]
        # d R[k,i] = gm[i][k] u_i + gb[i] u_i m_k
        dR = [None] * 9
        for i in range(3):
            for k in range(3):
                dR[3 * k + i] = gm[i][k] * u[i] + gb[i] * u[i] * mt[k]
        # d m_k = sum_i gb[i] u_i R[k,i]
        d_m = [sum(gb[i] * u[i] * rot[3 * k + i] for i in range(3))
               for k in range(3)]

        # quaternion backward: dR -> d(normalized quat), then normalization
        dR00, dR01, dR02, dR10, dR11, dR12, dR20, dR21, dR22 = dR
        dw = 2.0 * (-dR01 * z + dR02 * y + dR10 * z - dR12 * x
                    - dR20 * y + dR21 * x)
        dx = 2.0 * (dR01 * y + dR02 * z + dR10 * y - 2.0 * dR11 * x
                    - dR12 * w + dR20 * z + dR21 * w - 2.0 * dR22 * x)
        dy = 2.0 * (-2.0 * dR00 * y + dR01 * x + dR02 * w + dR10 * x
                    + dR12 * z - dR20 * w + dR21 * z - 2.0 * dR22 * y)
        dz = 2.0 * (-2.0 * dR00 * z - dR01 * w + dR02 * x + dR10 * w
                    - 2.0 * dR11 * z + dR12 * y + dR20 * x + dR21 * y)
        # qn = q / |q|:  dq = (dqn - qn (qn . dqn)) / |q|
        dot = w * dw + x * dx + y * dy + z * dz
        d_q = [(dw - w * dot) * qinv, (dx - x * dot) * qinv,
               (dy - y * dot) * qinv, (dz - z * dot) * qinv]

        # opacity: density = sigmoid(ol); column 12 is its only consumer
        sig = torch.sigmoid(opacity_logit)
        d_ol = col(12) * sig * (1.0 - sig)

        # SH: rows64 columns 16 + 16 c + j are channel-major [dc_c | rest_c]
        d_shdc = torch.stack([col(16), col(32), col(48)], dim=1)
        rest_cols = [16 + 16 * c + 1 + r for r in range(15) for c in range(3)]
        d_shrest = g[:n, rest_cols].reshape(n, 15, 3)

        return (None, torch.stack(d_m, dim=1), torch.stack(d_sl, dim=1),
                torch.stack(d_q, dim=1), d_ol, d_shdc, d_shrest)


@span("gvrt.param_table")
def rows64_from_model(model: GaussianModel, cfg: RenderConfig) -> torch.Tensor:
    """Fused (N+1, 64) parameter table straight from the raw model.

    Forward is exactly `param_rows(model.activate(), cfg)`; the backward is
    the hand-derived column chain of the module doc, so the six leaves'
    `.grad` fill without autograd's graph of the activation chain.  Used
    by every differentiated render path that holds a topology.  Without a
    gradient to take (grad off, or no leaf needs one) it is the bare
    forward."""
    leaves = model.leaves()
    if not (torch.is_grad_enabled()
            and any(leaf.requires_grad for leaf in leaves)):
        return param_rows(activate_leaves(*leaves), cfg)
    return _Rows64.apply(cfg, *leaves)
