"""The parameter layer of a frame: GaussianModel -> (activated view, rows64).

Counterpart of the JAX package's `render/rows_vjp.py`.  `frame_params`
activates the model once, without grad, for binning and culling, and builds
the (N+1, 64) table from that view; with a gradient to take, the table's
backward is `_Rows64`'s: the chain rule written out by hand (prefolded
frame M = diag(1/s) R^T, b = M mean, quaternion rotation and
normalization, exp/sigmoid activations) in ~60 launches over (N, 3) and
(N, 3, 3) tensors, where autograd's graph of the same chain takes ~280 ops
over small (N, k) intermediates and keeps them from the forward.  Every
render path that differentiates w.r.t. the model builds its table here.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import RenderConfig
from ..models.gaussians import (ActivatedGaussians, GaussianModel,
                                activate_leaves)
from ..utils.profiling import span
from .binning import param_rows


class _Rows64(torch.autograd.Function):
    """`rows`, built from the leaves outside, with the leaves' backward."""

    @staticmethod
    def forward(ctx, rows, means, scales_log, quats, opacity_logit, sh_dc,
                sh_rest):
        ctx.save_for_backward(means, scales_log, quats, opacity_logit)
        return rows

    @staticmethod
    @span("gvrt.param_table.bwd")
    def backward(ctx, g):
        m, scales_log, quats, opacity_logit = ctx.saved_tensors
        n = m.shape[0]
        g = g[:n]
        gM = g[:, 0:9].reshape(n, 3, 3)        # gM[i, k]: d M[i, k]
        gb = g[:, 9:12]

        # --- recompute the frame: u = 1/s, the unit quaternion (w, v), R ---
        u = torch.exp(-scales_log)
        # exact 1/sqrt, as normalize_quat's forward divides exactly
        qinv = 1.0 / torch.sqrt((quats * quats).sum(1, keepdim=True))
        qn = quats * qinv
        w, v = qn[:, 0:1], qn[:, 1:4]
        # R = (1 - 2 v.v) I + 2 v v^T + 2 w [v]x, quat_to_rot9's matrix
        a, b, c = (2.0 * w * v).unbind(1)
        zero = torch.zeros_like(a)
        R = (2.0 * v)[:, :, None] * v[:, None, :] + torch.stack(
            [zero, -c, b, c, zero, -a, -b, a, zero], dim=1).view(n, 3, 3)
        diag = R.diagonal(dim1=1, dim2=2)
        diag += 1.0 - diag.sum(1, keepdim=True)
        Rt = R.transpose(1, 2)                 # Rt[i, k] = R[k, i]

        # --- chain rule: M[i, k] = u_i R[k, i], b_i = u_i (R^T m)_i ---
        t = (Rt * m[:, None, :]).sum(2)
        d_sl = -u * ((gM * Rt).sum(2) + gb * t)   # d u_i, then d sl = -u du
        ug = u * gb
        d_m = (R * ug[:, None, :]).sum(2)   # d m_k = sum_i R[k,i] u_i gb_i
        # dRt[i, k] = d R[k, i] = u_i gM[i, k] + u_i gb_i m_k
        dRt = u[:, :, None] * gM + ug[:, :, None] * m[:, None, :]
        del R, Rt, t, ug

        # quaternion backward, R's formula above:  d w = 2 s.v,
        # d v = 2 (dR + dR^T) v - 4 tr(dR) v + 2 w s, s = vee(dR - dR^T)
        asym = dRt.transpose(1, 2) - dRt
        s = torch.stack([asym[:, 2, 1], asym[:, 0, 2], asym[:, 1, 0]], dim=1)
        tr = dRt.diagonal(dim1=1, dim2=2).sum(1, keepdim=True)
        sym = ((dRt + dRt.transpose(1, 2)) * v[:, None, :]).sum(2)
        dv = 2.0 * (sym + w * s) - 4.0 * tr * v
        dw = 2.0 * (s * v).sum(1, keepdim=True)
        del asym, s, sym, dRt
        # qn = q / |q|:  dq = (dqn - qn (qn . dqn)) / |q|
        dqn = torch.cat([dw, dv], dim=1)
        d_q = (dqn - qn * (qn * dqn).sum(1, keepdim=True)) * qinv

        # opacity: density = sigmoid(ol); column 12 is its only consumer
        sig = torch.sigmoid(opacity_logit)
        d_ol = g[:, 12] * sig * (1.0 - sig)

        # SH: rows64 columns 16 + 16 c + j are channel-major [dc_c | rest_c]
        sh = g[:, 16:64].reshape(n, 3, 16)
        return (None, d_m, d_sl, d_q, d_ol, sh[:, :, 0],
                sh[:, :, 1:].transpose(1, 2))


def frame_params(model: GaussianModel, cfg: RenderConfig
                 ) -> Tuple[ActivatedGaussians, torch.Tensor]:
    """(act, rows64): the model activated once without grad, which binning
    and culling read, and the (N+1, 64) table `param_rows(act, cfg)`.

    The table's bits are `param_rows(model.activate(), cfg)`'s.  With grad
    on and a leaf that needs a gradient, the table carries `_Rows64`'s
    hand-derived backward to the six leaves; otherwise it is a constant."""
    leaves = model.leaves()
    with torch.no_grad():
        act = activate_leaves(*leaves)
        rows = param_rows(act, cfg)
    if torch.is_grad_enabled() and any(p.requires_grad for p in leaves):
        rows = _Rows64.apply(rows, *leaves)
    return act, rows
