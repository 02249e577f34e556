"""Segmented reduction of per-pair cotangents to per-Gaussian gradients (K3).

Counterpart of the JAX package's `render/segreduce.py` for the full-space
plan.  The transpose of the binning gather (`rows[pair_gauss]`) is a sum,
per Gaussian, of its pairs' (64,) cotangent rows.  `build_reduce_plan` lays
the live pre-sort pairs out so that each GROUP of 256 consecutive Gaussian
ids owns a whole number of 256-row blocks (at least one, so every output
block is written); `segment_reduce` sums them, one output group per CUDA
block (`csrc/segment_reduce.cu`), with the slot gather of the cotangent
rows fused in.  The result is a DIRECT, deterministic f32 sum per Gaussian.

The plan is pure topology: built once per `bin_topology` refresh, never per
backward.  The compact plan of the banded path (`CompactReducePlan`,
`build_reduce_plan_compact`, `plan_rows_compact`, K4) waits for the banded
slice (ROADMAP.md section 1 item 8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build

#: Gaussians per output group == rows per input block
GROUP = 256
GROUP_SHIFT = GROUP.bit_length() - 1
#: reduction rows are padded to GROUP * 8, as in the JAX package's plans
_ROW_QUANT = GROUP * 8

#: dead-row sentinel in ReducePlan.slot (> any real padded slot)
DEAD_SLOT = 0x00FFFFFF

_I32 = torch.int32
_I64 = torch.int64


class ReducePlan(NamedTuple):
    """Static-shape reduction layout carried in BinTopology.

    Rows are pre-sort pairs placed so each group of 256 consecutive
    Gaussians owns a whole number of 256-row blocks (>= 1), in pre-sort
    order: a group's live rows fill its blocks densely from the first, by
    Gaussian id, so a block whose first row is dead holds no live row and
    ends its group (K3 stops there).  Dead rows carry slot == DEAD_SLOT and
    gloc == GROUP and add nothing.
    """
    slot: torch.Tensor     # (cap_r,) int32: padded chunk slot per row
    gloc: torch.Tensor     # (cap_r // 256, 256) int32: Gaussian id - 256*group
    out_idx: torch.Tensor  # (cap_r // 256,) int32: output group per block
    first: torch.Tensor    # (cap_r // 256,) int32: 1 = first block of group


def plan_rows(capacity: int, n_rows: int) -> int:
    """Static reduction row count for `capacity` pre-sort pairs and
    `n_rows` = N+1 parameter-table rows (worst-case group padding)."""
    n_groups = -(-n_rows // GROUP)
    raw = capacity + GROUP * n_groups
    return -(-raw // _ROW_QUANT) * _ROW_QUANT


def build_reduce_plan(pair_g: torch.Tensor, pair_pos: torch.Tensor,
                      offsets: torch.Tensor, counts: torch.Tensor,
                      n: int, capacity: int, capacity_padded: int,
                      cap_r: int = 0):
    """Group-block reduction layout from the pre-sort pair structure.

    `pair_g` (capacity,) pre-sort pair -> Gaussian id, `pair_pos`
    (capacity,) pre-sort pair -> padded slot (capacity_padded = dead),
    `offsets`/`counts` (N,) each Gaussian's contiguous pre-sort range.  The
    layout is live-compacted: pairs killed by the fine cull or dropped for
    capacity take no row.  `cap_r == 0` sizes it for every pre-cull pair;
    a tighter planned `cap_r` counts the live rows that do not fit in the
    returned overflow (the re-plan contract).

    Returns (ReducePlan, red_overflow () int64).
    """
    assert capacity_padded < DEAD_SLOT, capacity_padded
    dev = pair_pos.device
    pair_g, pair_pos = pair_g.long(), pair_pos.long()
    offsets, counts = offsets.long(), counts.long()
    n_rows = n + 1
    n_groups = -(-n_rows // GROUP)
    if cap_r <= 0:
        cap_r = plan_rows(capacity, n_rows)
    nb = cap_r // GROUP
    pad_n = n_groups * GROUP - n

    # live-pair rank in pre-sort order
    live = pair_pos < capacity_padded
    lrank = torch.cumsum(live.long(), 0) - 1

    # per-group live totals via the rank cumsum at group boundaries
    offs_p = torch.cat([offsets, (offsets[-1] + counts[-1]).expand(pad_n)])
    gp_start = offs_p.reshape(n_groups, GROUP)[:, 0]
    live_cum0 = torch.cat([torch.zeros(1, dtype=_I64, device=dev), lrank + 1])
    g_live_start = live_cum0[torch.clamp_max(gp_start, capacity)]
    g_live_end = torch.cat([g_live_start[1:], live_cum0[-1:]])
    gt = g_live_end - g_live_start

    # blocks per group (>= 1 so every output group block is written)
    bk = torch.clamp_min(torch.div(gt + GROUP - 1, GROUP,
                                   rounding_mode="floor"), 1)
    bstart = torch.cumsum(bk, 0) - bk

    # live pair p of group k lands at row GROUP * bstart[k] + (lrank[p] -
    # g_live_start[k])
    delta = GROUP * bstart - g_live_start
    dest = torch.where(live, delta[pair_g >> GROUP_SHIFT] + lrank, cap_r)

    # one packed int table carries the slot and the local Gaussian index
    packed = (((pair_g & (GROUP - 1)) << 24)
              | torch.clamp_max(pair_pos, DEAD_SLOT))
    table = torch.full((cap_r,), DEAD_SLOT, dtype=_I64, device=dev)
    fits = dest < cap_r
    table[dest[fits]] = packed[fits]
    slot = table & DEAD_SLOT
    gloc = (table >> 24) & 0xFF
    # dead rows get the out-of-range local index GROUP: they add nothing
    gloc = torch.where(slot >= capacity_padded, GROUP, gloc).reshape(nb, GROUP)

    in_grid = bstart < nb
    arr = torch.zeros(nb, dtype=_I64, device=dev)
    arr.scatter_reduce_(0, bstart[in_grid],
                        torch.arange(n_groups, device=dev)[in_grid], "amax")
    out_idx = torch.cummax(arr, 0).values
    first = torch.zeros(nb, dtype=_I64, device=dev)
    first[bstart[in_grid]] = 1
    red_overflow = (live & ~fits).sum()
    return ReducePlan(slot=slot.to(_I32), gloc=gloc.to(_I32),
                      out_idx=out_idx.to(_I32),
                      first=first.to(_I32)), red_overflow


def segment_reduce_plain(bar_flat: torch.Tensor, red: ReducePlan,
                         n_groups: int) -> torch.Tensor:
    """Plain version of K3: gather every live row's cotangent and sum it
    into its Gaussian's row with a masked `index_add_` into zeros."""
    p_pad, c = bar_flat.shape
    gloc = red.gloc.long()
    live = (gloc < GROUP).reshape(-1)
    rows = bar_flat[torch.clamp_max(red.slot.long(), p_pad - 1)]
    gid = (red.out_idx.long()[:, None] * GROUP + gloc).reshape(-1)
    out = torch.zeros((n_groups * GROUP, c), dtype=bar_flat.dtype,
                      device=bar_flat.device)
    out.index_add_(0, torch.where(live, gid, 0),
                   torch.where(live[:, None], rows, 0.0))
    return out


def segment_reduce(bar_flat: torch.Tensor, red: ReducePlan,
                   n_groups: int) -> torch.Tensor:
    """(P_pad, 64) per-slot cotangents -> (n_groups * 256, 64) sums.

    Output row g is the f32 sum of the rows of Gaussian g, each row
    gathered as bar_flat[min(slot, P_pad - 1)] inside the kernel (the JAX
    package gathers first and passes the (cap_r, 64) rows).  Rows of groups
    with no block (a plan whose rows overflowed a caller's cap_r) are zero;
    such a plan reports overflow and callers re-plan before using
    gradients.

    On CUDA tensors this launches `csrc/segment_reduce.cu` (K3) on the
    current stream and adds one to `segment_reduce.launches`; on CPU
    tensors it runs the plain version.
    """
    if bar_flat.device.type == "cpu":
        return segment_reduce_plain(bar_flat, red, n_groups)
    if bar_flat.device.type != "cuda":
        raise ValueError(f"segment_reduce runs on CUDA or the CPU, not "
                         f"{bar_flat.device}")
    p_pad, c = bar_flat.shape
    nb = red.gloc.shape[0]
    if c != 64 or bar_flat.dtype != torch.float32 or \
            not bar_flat.is_contiguous():
        raise ValueError(f"bar_flat must be contiguous f32 (P, 64), got "
                         f"{bar_flat.dtype} {tuple(bar_flat.shape)}")
    for name in ReducePlan._fields:
        x = getattr(red, name)
        if x.device != bar_flat.device or x.dtype != _I32 or \
                not x.is_contiguous():
            raise ValueError(f"plan array {name} must be contiguous int32 on "
                             f"{bar_flat.device}")
    if red.gloc.shape != (nb, GROUP) or red.slot.shape != (nb * GROUP,) or \
            red.out_idx.shape != (nb,):
        raise ValueError("inconsistent ReducePlan shapes")
    lib = _build.load("segment_reduce")
    out = torch.empty((n_groups * GROUP, c), dtype=torch.float32,
                      device=bar_flat.device)
    with torch.cuda.device(bar_flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gvrt_segment_reduce(
            bar_flat.data_ptr(), red.slot.data_ptr(), red.gloc.data_ptr(),
            red.out_idx.data_ptr(), out.data_ptr(), p_pad, nb, n_groups, c,
            stream)
    if err != 0:
        raise RuntimeError(f"segment_reduce kernel launch failed: CUDA error "
                           f"{err}")
    segment_reduce.launches += 1
    return out


#: kernel launches since the last reset (plain-version calls do not count)
segment_reduce.launches = 0
