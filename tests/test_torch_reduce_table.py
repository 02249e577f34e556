"""PyTorch port, K4's table mode (`segreduce.segment_reduce_compact_table`)
against the JAX package's `param_grads._bwd_segreduce_compact`, on the CPU.

The plans are built by both packages from the same synthetic pre-sort pair
layouts (tests/reduce_layouts.py) and must be equal array for array; JAX's
compact reduce runs its Pallas kernel in interpret mode.  The table must
agree at relative L2 <= 1e-6 (another summation order), with the rows
outside the plan's live-id window exactly zero, in each case: no window, a
narrow window at the table's start and at its end, live Gaussians past
cap_live, an all-pad band, one Gaussian with thousands of rows, Gaussians
with no rows.  On CPU tensors the wrapper runs its plain version and
launches nothing, and `_bwd_segreduce_compact` gives the same table for
"auto" and "torch".
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvrt_tpu.render import param_grads as jpg
from gvrt_tpu.render import segreduce as jsr
from gvrt_tpu_torch.render import param_grads as tpg
from gvrt_tpu_torch.render import segreduce as tsr

from reduce_layouts import CASES, compact_sizes, layout


def _plans(case):
    lay = layout(11, **CASES[case])
    sizes = compact_sizes(lay, case)
    jred, jovf = jsr.build_reduce_plan_compact(
        *(jnp.asarray(a, jnp.int32) for a in lay[:4]), *lay[4:], *sizes)
    tred, tovf = tsr.build_reduce_plan_compact(
        *(torch.from_numpy(a) for a in lay[:4]), *lay[4:], *sizes)
    for f in tsr.CompactReducePlan._fields:
        np.testing.assert_array_equal(getattr(tred, f).numpy(),
                                      np.asarray(getattr(jred, f)),
                                      err_msg=f)
    assert int(tovf) == int(jovf)
    bar_flat = np.random.default_rng(5).normal(
        size=(lay[6], 64)).astype(np.float32)
    return lay, jred, tred, int(tovf), bar_flat


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_mode_plain_matches_jax(case):
    lay, jred, tred, overflow, bar_flat = _plans(case)
    n = lay[4]
    n_rows = n + 1
    want = np.asarray(jpg._bwd_segreduce_compact(n_rows, jred,
                                                 jnp.asarray(bar_flat)))
    before = tsr.segment_reduce_compact_table.launches
    got = tsr.segment_reduce_compact_table(torch.from_numpy(bar_flat), tred,
                                           n_rows)
    assert tsr.segment_reduce_compact_table.launches == before  # CPU: plain
    assert torch.equal(got, tsr.segment_reduce_compact_table_plain(
        torch.from_numpy(bar_flat), tred, n_rows))
    assert got.shape == want.shape == (n_rows, 64)
    got = got.numpy()
    assert np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)
    base, window = int(tred.base[0]), tred.src_range.shape[0]
    outside = np.ones(n_rows, bool)
    outside[base:base + window] = False
    assert not got[outside].any()
    # what each case is for
    live = tred.src_range.numpy() < tred.out_shape.shape[0] * tsr.GROUP
    if case == "all_pad":
        assert not live.any() and not got.any()
    else:
        assert live.any() and np.abs(got[base:base + window][live]).sum(
            1).min() > 0
    assert (overflow > 0) == (case == "overflow")
    if case == "window_start":
        assert base == 0 and window < n
    if case == "window_end":
        assert base + window == n and base > 0
    if case == "heavy":
        cid = tsr.compact_ids(tred)
        cap_live = tred.out_shape.shape[0] * tsr.GROUP
        assert int(torch.bincount(cid[cid < cap_live]).max()) >= 3000


def test_bwd_segreduce_compact_auto_is_the_plain_route_on_cpu():
    counters = (tsr.segment_reduce_compact, tsr.segment_reduce_compact_table)
    for case in sorted(CASES):
        lay, _, tred, _, bar_flat = _plans(case)
        n_rows = lay[4] + 1
        before = [f.launches for f in counters]
        bar = torch.from_numpy(bar_flat)
        got = tpg._bwd_segreduce_compact(n_rows, tred, bar, "auto")
        want = tpg._bwd_segreduce_compact(n_rows, tred, bar, "torch")
        assert [f.launches for f in counters] == before, case
        assert torch.equal(got, want), case
        # the route is the compact sums expanded through the window
        n_groups = tred.out_shape.shape[0]
        assert torch.equal(want, tsr.expand_compact(
            tsr.segment_reduce_compact_plain(bar, tred, n_groups), tred,
            n_rows)), case
