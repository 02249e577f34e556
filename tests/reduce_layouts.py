"""Synthetic pre-sort pair layouts for the gradient-reduce tests.

NumPy only (no JAX, no torch), so both the CPU parity tests against the JAX
package (`tests/test_torch_reduce_table.py`) and the card tests
(`tests/test_torch_cuda.py`) build their plans from the same arrays.  A
layout is what `build_reduce_plan` and `build_reduce_plan_compact` take:
pre-sort pair -> Gaussian id (`pair_g`, Gaussians in id order), pre-sort
pair -> padded slot (`pair_pos`, `cap_pad` = dead), and each Gaussian's
pre-sort range (`offsets`, `counts`).
"""

import numpy as np

GROUP = 256

#: case -> layout arguments and the compact plan's sizes (None: planned from
#: the layout; cap_range 0: no window)
CASES = {
    # no window: every live Gaussian of the table
    "no_window": dict(n=600, cap_range=0),
    # a narrow window at the table's start (base 0) and at its end (base =
    # n - window: the window's last row is Gaussian n - 1)
    "window_start": dict(n=600, live=(0, 100), cap_range=128),
    "window_end": dict(n=600, live=(500, 600), cap_range=128),
    # live Gaussians past cap_live: their compact id is the sentinel
    "overflow": dict(n=700, cap_live=GROUP, cap_range=0),
    # every pair dead: no live row, an all-zero table
    "all_pad": dict(n=400, dead=1.0, cap_range=0),
    # one Gaussian with thousands of rows, in a window
    "heavy": dict(n=600, heavy=(310, 3000), live=(200, 500), cap_range=384),
    # many Gaussians with no pair or only dead pairs; cap_live beyond the
    # live ones
    "no_rows": dict(n=900, empty=0.6, dead=0.5, cap_live=4 * GROUP,
                    cap_range=0),
}


def layout(seed, n, live=None, heavy=None, empty=0.2, dead=0.25, **_):
    """(pair_g, pair_pos, offsets, counts, n, capacity, capacity_padded).

    Gaussians outside `live` = (lo, hi) have no pair; a fraction `empty` of
    the others has none either; `heavy` = (id, count) gives one Gaussian
    `count` live pairs; a fraction `dead` of the other pairs is dead.  Live
    pairs take distinct random slots of the padded chunk array.  Where
    `live` is given and pairs survive, its first and last Gaussians keep a
    live pair (so a window sits where the case says)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 6, n)
    counts[rng.random(n) < empty] = 0
    lo, hi = live if live is not None else (0, n)
    counts[:lo] = 0
    counts[hi:] = 0
    if live is not None and dead < 1.0:
        counts[[lo, hi - 1]] = np.maximum(counts[[lo, hi - 1]], 1)
    if heavy is not None:
        counts[heavy[0]] = heavy[1]
    offsets = np.cumsum(counts) - counts
    cap = int(counts.sum())
    pair_g = np.repeat(np.arange(n), counts)
    cap_pad = -(-cap // 64) * 64 + 128
    is_dead = rng.random(cap) < dead
    if live is not None and dead < 1.0:
        is_dead[offsets[[lo, hi - 1]]] = False
    if heavy is not None:
        h0 = offsets[heavy[0]]
        is_dead[h0:h0 + heavy[1]] = False
    pair_pos = np.where(is_dead, cap_pad, rng.permutation(cap_pad)[:cap])
    return (pair_g.astype(np.int64), pair_pos.astype(np.int64),
            offsets.astype(np.int64), counts.astype(np.int64), n, cap,
            cap_pad)


def compact_sizes(lay, case):
    """(cap_live, cap_r, cap_range) of the case's compact plan: cap_live
    the live Gaussians rounded up to a group (or the case's), cap_r the
    rows `plan_rows_compact` gives the survivors."""
    pair_g, pair_pos, offsets, counts, n, cap, cap_pad = lay
    spec = CASES[case]
    live_pair = pair_pos < cap_pad
    n_live = len(np.unique(pair_g[live_pair]))
    cap_live = spec.get("cap_live") or max(-(-n_live // GROUP), 1) * GROUP
    quant = GROUP * 8
    cap_r = -(-(max(int(live_pair.sum()), 1) + GROUP) // quant) * quant
    return cap_live, cap_r, spec["cap_range"]
