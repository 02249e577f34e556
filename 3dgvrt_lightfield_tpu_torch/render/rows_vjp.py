"""The parameter layer of a frame: GaussianModel -> (activated view, rows64).

Counterpart of the JAX package's `render/rows_vjp.py`.  `frame_params`
activates the model once, without grad, for binning and culling, and builds
the (N+1, 64) table from that view; with a gradient to take, the table's
backward is `_Rows64`'s: the chain rule written out by hand (prefolded
frame M = diag(1/s) R^T, b = M mean, quaternion rotation and
normalization, exp/sigmoid activations).  Every render path that
differentiates w.r.t. the model builds its table here.

On the card (impl "auto" or "cuda") both ways are one launch each of
`csrc/param_table.cu`: `param_table_forward` writes the table and the
activated view bit for bit as the plain route computes them, and
`param_table_backward` writes the six leaves' gradients.  The plain route
("torch", or the CPU) is `activate_leaves` plus `param_rows` forward and
`_plain_backward`, ~60 launches over (N, 3) and (N, 3, 3) tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from ..config import RenderConfig, resolve_impl
from ..models.gaussians import (ActivatedGaussians, GaussianModel,
                                activate_leaves)
from ..utils.profiling import count, span
from .binning import param_rows

#: the leaves' shapes past N, in LEAVES order
_TRAILING = ((3,), (3,), (4,), (), (3,), (15, 3))


def _check_leaves(leaves):
    n = leaves[0].shape[0]
    for leaf, tail in zip(leaves, _TRAILING):
        if (leaf.device.type != "cuda" or leaf.dtype != torch.float32
                or tuple(leaf.shape) != (n,) + tail
                or not leaf.is_contiguous() or leaf.data_ptr() % 16):
            raise ValueError(
                f"the parameter-table kernels take contiguous, 16-byte "
                f"aligned float32 leaves on one CUDA device in the shapes "
                f"(N,) + {_TRAILING}; got {leaf.dtype} {tuple(leaf.shape)} "
                f"on {leaf.device} at {leaf.data_ptr():#x}")
        if leaf.device != leaves[0].device:
            raise ValueError(f"leaves on {leaf.device} and "
                             f"{leaves[0].device}")
    return n


def _launch_forward(means, scales_log, quats, opacity_logit, sh_dc, sh_rest):
    n = means.shape[0]

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=means.device)
    out = (empty(n + 1, 64), empty(n, 3), empty(n, 3), empty(n, 9), empty(n))
    with torch.cuda.device(means.device):
        err = _build.load("param_table").gvrt_param_table_forward(
            *(x.data_ptr() for x in (means, scales_log, quats, opacity_logit,
                                     sh_dc, sh_rest) + out),
            n, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"param_table forward kernel launch failed: CUDA "
                           f"error {err}")
    return out


def _launch_backward(g, means, scales_log, quats, opacity_logit, sh_dc,
                     sh_rest):
    leaves = (means, scales_log, quats, opacity_logit, sh_dc, sh_rest)
    grads = tuple(torch.empty_like(leaf) for leaf in leaves)
    with torch.cuda.device(g.device):
        err = _build.load("param_table").gvrt_param_table_backward(
            *(x.data_ptr() for x in (g,) + leaves[:4] + grads),
            means.shape[0], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"param_table backward kernel launch failed: CUDA "
                           f"error {err}")
    return grads


_LEAVES_SCHEMA = ("Tensor means, Tensor scales_log, Tensor quats, "
                  "Tensor opacity_logit, Tensor sh_dc, Tensor sh_rest")
_library = []   # the `torch.library.Library` that holds the two ops


def _ops():
    """`torch.ops.gvrt_port`, where each launch is a dispatcher op with a
    CUDA kernel, defined at first use.  A profiler links device work to the
    innermost op open at its launch; a bare ctypes launch would link to an
    op that opened before the caller's `gvrt.` range (autograd's node), or
    to none, and so fall outside the range's device time."""
    ns = torch.ops.gvrt_port
    if not hasattr(ns, "param_table_forward"):
        lib = torch.library.Library("gvrt_port", "FRAGMENT")
        lib.define(f"param_table_forward({_LEAVES_SCHEMA}) -> "
                   f"(Tensor, Tensor, Tensor, Tensor, Tensor)")
        lib.define(f"param_table_backward(Tensor g, {_LEAVES_SCHEMA}) -> "
                   f"(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
        lib.impl("param_table_forward", _launch_forward, "CUDA")
        lib.impl("param_table_backward", _launch_backward, "CUDA")
        _library.append(lib)
    return ns


@span("gvrt.param_table")
def param_table_forward(means, scales_log, quats, opacity_logit, sh_dc,
                        sh_rest) -> Tuple[ActivatedGaussians, torch.Tensor]:
    """(act, rows64) of six leaves on the card in one launch of
    `csrc/param_table.cu`: every field bit for bit `activate_leaves`', and
    the table `param_rows(act)`'s; `act.means` is the leaf itself and
    `act.sh_flat` the view `rows64[:N, 16:64]`.  Launches on the current
    stream (no synchronisation) through the op
    `gvrt_port::param_table_forward`, adds one to
    `param_table_forward.launches` and counts `gvrt.param_table.kernel`.
    Call it without grad: it records no graph."""
    n = _check_leaves((means, scales_log, quats, opacity_logit, sh_dc,
                       sh_rest))
    rows, scales, inv_scales, rot9, densities = _ops().param_table_forward(
        means, scales_log, quats, opacity_logit, sh_dc, sh_rest)
    param_table_forward.launches += 1
    count("gvrt.param_table.kernel")
    return ActivatedGaussians(means=means, scales=scales,
                              inv_scales=inv_scales, rot9=rot9,
                              densities=densities,
                              sh_flat=rows[:n, 16:64]), rows


param_table_forward.launches = 0


def param_table_backward(g: torch.Tensor, leaves) -> tuple:
    """The six leaves' gradients, contiguous in their shapes, from the
    table's cotangent `g` (N+1, 64) in one launch of `csrc/param_table.cu`
    (copied first unless contiguous and 16-byte aligned); `g`'s row N is
    not read.  Launches on the current stream through the op
    `gvrt_port::param_table_backward`, adds one to
    `param_table_backward.launches` and counts
    `gvrt.param_table.bwd.kernel`."""
    n = _check_leaves(leaves)
    if (g.dtype != torch.float32 or tuple(g.shape) != (n + 1, 64)
            or g.device != leaves[0].device):
        raise ValueError(f"the table's cotangent is {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}, not float32 "
                         f"({n + 1}, 64) on {leaves[0].device}")
    if not g.is_contiguous() or g.data_ptr() % 16:
        g = g.clone(memory_format=torch.contiguous_format)
    grads = _ops().param_table_backward(g, *leaves)
    param_table_backward.launches += 1
    count("gvrt.param_table.bwd.kernel")
    return tuple(grads)


param_table_backward.launches = 0


class _Rows64(torch.autograd.Function):
    """`rows`, built from the leaves outside, with the leaves' backward."""

    @staticmethod
    def forward(ctx, rows, impl, means, scales_log, quats, opacity_logit,
                sh_dc, sh_rest):
        ctx.impl = impl
        ctx.save_for_backward(means, scales_log, quats, opacity_logit, sh_dc,
                              sh_rest)
        return rows

    @staticmethod
    @span("gvrt.param_table.bwd")
    def backward(ctx, g):
        if ctx.impl == "cuda":
            grads = param_table_backward(g, ctx.saved_tensors)
        else:
            grads = _plain_backward(g, *ctx.saved_tensors[:4])
        return (None, None) + grads


def _plain_backward(g, m, scales_log, quats, opacity_logit):
    """`_Rows64`'s backward in PyTorch ops: the six leaves' gradients."""
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
    return (d_m, d_sl, d_q, d_ol, sh[:, :, 0],
            sh[:, :, 1:].transpose(1, 2))


def frame_params(model: GaussianModel, cfg: RenderConfig, impl: str = "auto"
                 ) -> Tuple[ActivatedGaussians, torch.Tensor]:
    """(act, rows64): the model activated once without grad, which binning
    and culling read, and the (N+1, 64) table `param_rows(act, cfg)`.

    The table's bits are `param_rows(model.activate(), cfg)`'s.  With grad
    on and a leaf that needs a gradient, the table carries `_Rows64`'s
    hand-derived backward to the six leaves; otherwise it is a constant.
    `impl` as `resolve_impl` on the model's device: "cuda" builds both ways
    with the kernels of `csrc/param_table.cu`, "torch" with the plain
    route."""
    impl = resolve_impl(impl, model.device)
    leaves = model.leaves()
    with torch.no_grad():
        if impl == "cuda":
            act, rows = param_table_forward(*leaves)
        else:
            act = activate_leaves(*leaves)
            rows = param_rows(act, cfg)
    if torch.is_grad_enabled() and any(p.requires_grad for p in leaves):
        rows = _Rows64.apply(rows, impl, *leaves)
    return act, rows
