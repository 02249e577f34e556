"""Parameter gradients of the binning gather, without scatter-add.

Counterpart of the JAX package's `render/param_grads.py`.  The transpose of
the gather `rows[pair_gauss]` is a scatter-add of millions of 64-float rows
into the per-Gaussian table.  In PRE-SORT pair order every Gaussian's pairs
are contiguous (`offsets`/`counts` from the tile-rectangle expansion), so
gathering the per-slot cotangents back into pre-sort order turns the
scatter into contiguous segment sums.  Two routes:

  * the grouped reduce plan (`segreduce.py`, the default up to 1.5M
    Gaussians): the slot gather and the per-Gaussian sum in one kernel, K3
    on the card (`segreduce.segment_reduce`), a direct sum per Gaussian;
  * the compact plan of the banded path (`segreduce.CompactReducePlan`):
    the same sum over the band's live Gaussians renumbered densely, written
    through the plan's live-id window straight into the table, by K4's
    table mode on the card (`segreduce.segment_reduce_compact_table`);
  * the prefix fallback (no plan in the topology): a blocked inclusive
    cumsum and segment differences, plain PyTorch.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .segreduce import (GROUP, CompactReducePlan, segment_reduce,
                        segment_reduce_compact_table,
                        segment_reduce_compact_table_plain,
                        segment_reduce_plain)


def blocked_cumsum(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Inclusive prefix sum along axis 0 of (P, C) via per-block products
    with a lower-triangular ones matrix plus the running block totals."""
    p, c = x.shape
    pad = (-p) % block
    xb = torch.cat([x, x.new_zeros((pad, c))]).reshape(-1, block, c)
    tri = torch.tril(torch.ones((block, block), dtype=x.dtype,
                                device=x.device))
    incl = torch.matmul(tri, xb)                        # (B, block, C)
    totals = xb.sum(dim=1)
    off = torch.cumsum(totals, dim=0) - totals
    return (incl + off[:, None, :]).reshape(-1, c)[:p]


def _bwd_xla_prefix(n_rows, pair_pos, offsets, counts, bar_flat):
    """Prefix-difference fallback (scenes above the reduce plan's limit)."""
    p_pad, c = bar_flat.shape
    capacity = pair_pos.shape[0]
    pair_pos, offsets, counts = pair_pos.long(), offsets.long(), counts.long()
    live = (pair_pos < p_pad)[:, None]
    bar_pre = torch.where(live, bar_flat[torch.clamp_max(pair_pos, p_pad - 1)],
                          0.0)                          # (capacity, C)
    cum = blocked_cumsum(bar_pre)
    lo = torch.clamp(offsets, 0, capacity)
    hi = torch.clamp(offsets + counts, 0, capacity)
    g_hi = torch.where((hi > 0)[:, None], cum[torch.clamp_min(hi - 1, 0)], 0.0)
    g_lo = torch.where((lo > 0)[:, None], cum[torch.clamp_min(lo - 1, 0)], 0.0)
    grad_rows = g_hi - g_lo                             # (N, C)
    return torch.cat([grad_rows, grad_rows.new_zeros(
        (n_rows - grad_rows.shape[0], c))])             # dummy row(s)


def _bwd_segreduce(n_rows, red, bar_flat, impl: str):
    """Grouped-layout direct segment sum: K3 for "auto"/"cuda" (on CUDA
    tensors; the CPU runs the plain version), the plain version for
    "torch"."""
    n_groups = -(-n_rows // GROUP)
    if impl == "torch":
        out = segment_reduce_plain(bar_flat, red, n_groups)
    else:
        out = segment_reduce(bar_flat, red, n_groups)
    return out[:n_rows]


def _bwd_segreduce_compact(n_rows, red: CompactReducePlan, bar_flat,
                           impl: str):
    """Compact direct segment sum expanded to the (n_rows, C) table: the
    plan's live-id window `src_range` takes the compact sums (ids outside
    the band's live set read zero) to rows [base, base + window).  K4's
    table mode for "auto"/"cuda" (on CUDA tensors; the CPU runs its plain
    version), the plain two-step route for "torch"."""
    if impl == "torch":
        return segment_reduce_compact_table_plain(bar_flat, red, n_rows)
    return segment_reduce_compact_table(bar_flat, red, n_rows)


class _ChunkedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, pair_gauss, pair_pos, offsets, counts,
                chunk_size: int, red, impl: str):
        ctx.save_for_backward(pair_pos, offsets, counts)
        ctx.n_rows, ctx.red, ctx.impl = rows.shape[0], red, impl
        return rows[pair_gauss.long()].view(-1, chunk_size, rows.shape[1])

    @staticmethod
    @span("gvrt.gather.bwd")
    def backward(ctx, bar):
        pair_pos, offsets, counts = ctx.saved_tensors
        bar_flat = bar.reshape(-1, bar.shape[-1]).contiguous()
        if ctx.red is None:
            grad_rows = _bwd_xla_prefix(ctx.n_rows, pair_pos, offsets,
                                        counts, bar_flat)
        elif isinstance(ctx.red, CompactReducePlan):
            grad_rows = _bwd_segreduce_compact(ctx.n_rows, ctx.red, bar_flat,
                                               ctx.impl)
        else:
            grad_rows = _bwd_segreduce(ctx.n_rows, ctx.red, bar_flat,
                                       ctx.impl)
        return grad_rows, None, None, None, None, None, None, None


def chunked_gather(chunk_size: int, rows: torch.Tensor,
                   pair_gauss: torch.Tensor, pair_pos: torch.Tensor,
                   offsets: torch.Tensor, counts: torch.Tensor, red=None,
                   impl: str = "auto") -> torch.Tensor:
    """rows (N+1, C) -> (num_chunks, G, C) per-chunk parameter blocks.

    Forward is exactly `rows[pair_gauss]` reshaped for the kernel; the
    backward is the scatter-free reduction of the module doc.  `pair_gauss`
    maps padded slot -> row id (N = dummy); `pair_pos` maps PRE-SORT pair ->
    padded slot (P_pad = culled/dropped); `offsets`/`counts` give each
    Gaussian's contiguous pre-sort pair range; `red` is the topology's
    `segreduce.ReducePlan` or `CompactReducePlan`, or None for the prefix
    fallback.  Without a
    gradient to take (grad off, or `rows` needs none) it is the bare gather.
    """
    if not (torch.is_grad_enabled() and rows.requires_grad):
        return rows[pair_gauss.long()].view(-1, chunk_size, rows.shape[1])
    return _ChunkedGather.apply(rows, pair_gauss, pair_pos, offsets, counts,
                                chunk_size, red, impl)
