"""Segmented reduction of per-pair cotangents to per-Gaussian gradients (K3, K4).

Counterpart of the JAX package's `render/segreduce.py`.  The transpose of
the binning gather (`rows[pair_gauss]`) is a sum, per Gaussian, of its
pairs' (64,) cotangent rows.  Two layouts, each with its kernel:

  * the full-space plan (`build_reduce_plan`): the live pre-sort pairs laid
    out so that each GROUP of 256 consecutive Gaussian ids owns a whole
    number of 256-row blocks (at least one, so every output block is
    written); `segment_reduce` sums them, one output group per CUDA block
    (K3, `csrc/segment_reduce.cu`);
  * the compact plan of the banded path (`build_reduce_plan_compact`): the
    live Gaussians renumbered 0..n_live-1 in id order and their live pairs
    laid out densely in rank order, with no alignment padding;
    `segment_reduce_compact` sums them per compact id (K4,
    `csrc/segment_reduce_compact.cu`), and `segment_reduce_compact_table`
    (K4's table mode) writes those sums straight into the parameter table
    through the plan's live-id window.

Both kernels fuse the slot gather of the cotangent rows and give a DIRECT,
deterministic f32 sum per Gaussian.  The plans are pure topology: built once
per `bin_topology` refresh, never per backward.
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


class CompactReducePlan(NamedTuple):
    """Alignment-free grouped reduction over live-Gaussian compact ids.

    Live Gaussians are renumbered 0..n_live-1 (order-preserving) and their
    live pairs are laid out densely in rank order, so compact ids are
    nondecreasing over the rows and the pad rows (`_CID_PAD`) sit at the
    end.  Row r's compact id is (k0[r // 256] << 8) + cloc[r // 256, r % 256].
    The fields are the JAX package's; K4 reads slot, cloc and k0, and the
    expansion back to the parameter table reads src_range and base.
    """
    slot: torch.Tensor       # (cap_r,) int32: padded chunk slot per live rank
    cloc: torch.Tensor       # (cap_r // G, G) int32: compact id - G * k0 of
                             #    the row's block (pad rows: huge)
    k0: torch.Tensor         # (cap_r // G,) int32: first output group of block
    first: torch.Tensor      # (cap_r // G,) int32: 1 = k0 changed
    src_range: torch.Tensor  # (cap_range,) int32: Gaussian id (base + r) ->
                             #    compact id (cap_live = dead or outside)
    base: torch.Tensor       # (1,) int32: first Gaussian id of the window
    out_shape: torch.Tensor  # (cap_live // G,) int32 zeros; its shape
                             #    carries cap_live


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


def plan_rows_compact(survivors: int) -> int:
    """Static reduction rows for `survivors` live pairs: the dense rank
    layout, quantized like the other plans, with one extra GROUP because
    `build_reduce_plan_compact` reserves the last block as all-pad."""
    return -(-(max(survivors, 1) + GROUP) // _ROW_QUANT) * _ROW_QUANT


#: out-of-range sentinel for pad rows' compact ids
_CID_PAD = 0x3FFFFFFF


def build_reduce_plan_compact(pair_g: torch.Tensor, pair_pos: torch.Tensor,
                              offsets: torch.Tensor, counts: torch.Tensor,
                              n: int, capacity: int, capacity_padded: int,
                              cap_live: int, cap_r: int, cap_range: int = 0):
    """Alignment-free compact reduction layout (see CompactReducePlan).

    `cap_live` (a multiple of GROUP) is the planned live-Gaussian capacity,
    `cap_r` the planned dense row count (`plan_rows_compact(survivors)`),
    `cap_range` (0, or >= n, for none) the planned live-id window width of
    span banding: the band's live Gaussians then occupy [base, base +
    cap_range) and the expansion back to the table gathers that window
    only.  Live Gaussians beyond cap_live, live rows beyond cap_r and live
    ids outside the window count into the returned overflow (the re-plan
    contract).  Returns (CompactReducePlan, overflow () int64).
    """
    assert capacity_padded < DEAD_SLOT, capacity_padded
    assert cap_live % GROUP == 0 and cap_r % GROUP == 0, (cap_live, cap_r)
    assert n > 0, n
    dev = pair_pos.device
    pair_g, pair_pos = pair_g.long(), pair_pos.long()
    offsets, counts = offsets.long(), counts.long()
    n_groups_c = cap_live // GROUP
    nb = cap_r // GROUP

    # live pair rank (pre-sort order) and per-gaussian live ranges
    live = pair_pos < capacity_padded
    lrank = torch.cumsum(live.long(), 0) - 1
    live_cum0 = torch.cat([torch.zeros(1, dtype=_I64, device=dev), lrank + 1])
    g_pair_start = live_cum0[torch.clamp_max(offsets, capacity)]
    g_pair_end = live_cum0[torch.clamp_max(offsets + counts, capacity)]

    # order-preserving compact renumbering of live gaussians
    lv = g_pair_end > g_pair_start
    cid_raw = torch.cumsum(lv.long(), 0) - 1
    overflow = torch.clamp_min(cid_raw[-1] + 1 - cap_live, 0)
    # gaussian -> compact id; dead or live-overflowed -> cap_live sentinel
    full_src = torch.where(lv & (cid_raw < cap_live), cid_raw, cap_live)

    # live-id window: src_range is the [base, base + cap_range) slice of the
    # full map, with base clamped so the window fits (lax.dynamic_slice)
    if cap_range <= 0 or cap_range >= n:
        cap_range = n
        base = torch.zeros(1, dtype=_I64, device=dev)
    else:
        any_live = lv.any()
        lv8 = lv.to(torch.uint8)
        lo = torch.where(any_live, torch.argmax(lv8), 0)
        hi = torch.where(any_live, n - torch.argmax(torch.flip(lv8, (0,))), 0)
        overflow = overflow + torch.clamp_min(hi - lo - cap_range, 0)
        base = torch.clamp(lo, 0, n - cap_range).reshape(1)
    src_range = full_src[base + torch.arange(cap_range, device=dev)]

    # dense layout: live pair of rank r lands at row r.  The last GROUP rows
    # are reserved all-pad (rows that would land there count into overflow),
    # so a plan without overflow always ends in an all-pad block
    rows_cap = cap_r - GROUP
    cid_pair = full_src[pair_g]
    ok = live & (cid_pair < cap_live)
    dest = torch.where(ok & (lrank < rows_cap), lrank, cap_r)
    fits = dest < cap_r
    slot = torch.full((cap_r,), DEAD_SLOT, dtype=_I64, device=dev)
    slot[dest[fits]] = torch.clamp_max(pair_pos, DEAD_SLOT)[fits]
    cid_tbl = torch.full((cap_r,), _CID_PAD, dtype=_I64, device=dev)
    cid_tbl[dest[fits]] = cid_pair[fits]

    # per-block first output group and local ids.  All-pad blocks claim the
    # spill group last_real_k0 + 1: a real block whose first id is in group
    # K may hold rows of group K + 1, and the TPU kernel's accumulators for
    # K + 1 are zeroed only by a block that starts there.  K4 sums per
    # compact id and does not need it; the fields stay the JAX package's.
    blk = cid_tbl.reshape(nb, GROUP)
    k0_real = blk[:, 0] >> GROUP_SHIFT
    pad_blk = blk[:, 0] >= _CID_PAD
    last_real_k0 = torch.where(pad_blk, -1, k0_real).max()
    spill = torch.clamp(last_real_k0 + 1, 0, n_groups_c - 1)
    k0 = torch.where(pad_blk, spill, torch.clamp_max(k0_real, n_groups_c - 1))
    cloc = blk - (k0[:, None] << GROUP_SHIFT)
    first = torch.cat([torch.ones(1, dtype=_I64, device=dev),
                       (k0[1:] != k0[:-1]).long()])
    red_overflow = (ok & (lrank >= rows_cap)).sum()
    plan = CompactReducePlan(
        slot=slot.to(_I32), cloc=cloc.to(_I32), k0=k0.to(_I32),
        first=first.to(_I32), src_range=src_range.to(_I32),
        base=base.to(_I32),
        out_shape=torch.zeros(n_groups_c, dtype=_I32, device=dev))
    return plan, overflow + red_overflow


def compact_ids(red: CompactReducePlan) -> torch.Tensor:
    """(cap_r,) int64 compact id of every plan row (pad rows: _CID_PAD)."""
    return ((red.k0.long()[:, None] << GROUP_SHIFT)
            + red.cloc.long()).reshape(-1)


def segment_reduce_compact_plain(bar_flat: torch.Tensor,
                                 red: CompactReducePlan,
                                 n_groups: int) -> torch.Tensor:
    """Plain version of K4: gather every plan row's cotangent and sum it
    into its compact id's row with a masked `index_add_` into zeros."""
    p_pad, c = bar_flat.shape
    cid = compact_ids(red)
    live = cid < n_groups * GROUP
    rows = bar_flat[torch.clamp_max(red.slot.long(), p_pad - 1)]
    out = torch.zeros((n_groups * GROUP, c), dtype=bar_flat.dtype,
                      device=bar_flat.device)
    out.index_add_(0, torch.where(live, cid, 0),
                   torch.where(live[:, None], rows, 0.0))
    return out


def expand_compact(out: torch.Tensor, red: CompactReducePlan,
                   n_rows: int) -> torch.Tensor:
    """(cap_live, C) compact sums -> the (n_rows, C) parameter table: the
    plan's live-id window `src_range` gathers the sums (ids outside the
    band's live set read zero) and lands at rows [base, base + window) in
    one indexed copy; every other row is zero."""
    cap_live = out.shape[0]
    src = red.src_range.long()
    sub = torch.where((src < cap_live)[:, None],
                      out[torch.clamp_max(src, cap_live - 1)], 0.0)
    rows = red.base.long() + torch.arange(src.shape[0], device=src.device)
    full = out.new_zeros((n_rows, out.shape[1]))
    return full.index_copy_(0, rows, sub)


def segment_reduce_compact_table_plain(bar_flat: torch.Tensor,
                                       red: CompactReducePlan,
                                       n_rows: int) -> torch.Tensor:
    """Plain version of K4's table mode: K4's plain version, then the
    expansion back to the table (the JAX package's two steps)."""
    n_groups = red.out_shape.shape[0]
    return expand_compact(segment_reduce_compact_plain(bar_flat, red,
                                                       n_groups), red, n_rows)


def _check_compact(name, bar_flat: torch.Tensor, red: CompactReducePlan,
                   fields) -> None:
    """Raise unless the inputs are what K4 takes: contiguous f32 (P, 64)
    cotangents and the plan's `fields` contiguous int32 on their device."""
    if bar_flat.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or the CPU, not "
                         f"{bar_flat.device}")
    if bar_flat.shape[1:] != (64,) or bar_flat.dtype != torch.float32 or \
            not bar_flat.is_contiguous():
        raise ValueError(f"bar_flat must be contiguous f32 (P, 64), got "
                         f"{bar_flat.dtype} {tuple(bar_flat.shape)}")
    for field in fields:
        x = getattr(red, field)
        if x.device != bar_flat.device or x.dtype != _I32 or \
                not x.is_contiguous():
            raise ValueError(f"plan array {field} must be contiguous int32 "
                             f"on {bar_flat.device}")
    nb = red.cloc.shape[0]
    if red.cloc.shape != (nb, GROUP) or red.slot.shape != (nb * GROUP,) or \
            red.k0.shape != (nb,) or red.base.shape != (1,):
        raise ValueError("inconsistent CompactReducePlan shapes")


def segment_reduce_compact(bar_flat: torch.Tensor, red: CompactReducePlan,
                           n_groups: int) -> torch.Tensor:
    """(P_pad, 64) per-slot cotangents -> (n_groups * 256, 64) compact sums.

    Output row `cid` is the f32 sum of bar_flat[min(slot[r], P_pad - 1)]
    over the plan rows r whose compact id is `cid`; ids with no row are
    zero (every output row is written).  On CUDA tensors this launches
    `csrc/segment_reduce_compact.cu` (K4, compact mode) on the current
    stream and adds one to `segment_reduce_compact.launches`; on CPU
    tensors it runs the plain version.
    """
    if bar_flat.device.type == "cpu":
        return segment_reduce_compact_plain(bar_flat, red, n_groups)
    _check_compact("segment_reduce_compact", bar_flat, red,
                   ("slot", "cloc", "k0"))
    p_pad, c = bar_flat.shape
    lib = _build.load("segment_reduce_compact")
    out = torch.empty((n_groups * GROUP, c), dtype=torch.float32,
                      device=bar_flat.device)
    with torch.cuda.device(bar_flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gvrt_segment_reduce_compact(
            bar_flat.data_ptr(), red.slot.data_ptr(), red.cloc.data_ptr(),
            red.k0.data_ptr(), out.data_ptr(), p_pad, red.cloc.shape[0],
            n_groups, c, stream)
    if err != 0:
        raise RuntimeError(f"segment_reduce_compact kernel launch failed: "
                           f"CUDA error {err}")
    segment_reduce_compact.launches += 1
    return out


#: kernel launches since the last reset (plain-version calls do not count)
segment_reduce_compact.launches = 0


def segment_reduce_compact_table(bar_flat: torch.Tensor,
                                 red: CompactReducePlan,
                                 n_rows: int) -> torch.Tensor:
    """(P_pad, 64) per-slot cotangents -> the (n_rows, 64) parameter-table
    gradient of the plan's band, in one launch.

    Row base + i (i < window) is the compact sum of id src_range[i] (as
    `segment_reduce_compact` gives it, bit for bit), or zero where that is
    the sentinel cap_live; rows outside the window are zero.  It equals
    `segment_reduce_compact` followed by `expand_compact`, without the
    (cap_live, 64) sums and the (window, 64) gather in device memory.  On
    CUDA tensors this launches K4's table mode on the current stream and
    adds one to `segment_reduce_compact_table.launches`; on CPU tensors it
    runs the plain version.
    """
    if bar_flat.device.type == "cpu":
        return segment_reduce_compact_table_plain(bar_flat, red, n_rows)
    _check_compact("segment_reduce_compact_table", bar_flat, red,
                   ("slot", "cloc", "k0", "src_range", "base"))
    p_pad, c = bar_flat.shape
    window = red.src_range.shape[0]
    if window > n_rows:
        raise ValueError(f"live-id window {window} exceeds the table's "
                         f"{n_rows} rows")
    lib = _build.load("segment_reduce_compact")
    out = torch.empty((n_rows, c), dtype=torch.float32,
                      device=bar_flat.device)
    with torch.cuda.device(bar_flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gvrt_segment_reduce_compact_table(
            bar_flat.data_ptr(), red.slot.data_ptr(), red.cloc.data_ptr(),
            red.k0.data_ptr(), red.src_range.data_ptr(), red.base.data_ptr(),
            out.data_ptr(), p_pad, red.cloc.shape[0],
            red.out_shape.shape[0] * GROUP, window, n_rows, c, stream)
    if err != 0:
        raise RuntimeError(f"segment_reduce_compact_table kernel launch "
                           f"failed: CUDA error {err}")
    segment_reduce_compact_table.launches += 1
    return out


#: kernel launches since the last reset (plain-version calls do not count)
segment_reduce_compact_table.launches = 0
