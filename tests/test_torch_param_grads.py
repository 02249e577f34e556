"""PyTorch port, the gradient reduce (render/segreduce.py,
render/param_grads.py) against the JAX package.

`build_reduce_plan` gets the same pre-sort pair structure in both packages
and must give the same four arrays and overflow exactly.  The plain version
of K3 is held against JAX's `segment_reduce` run through its Pallas kernel
in interpret mode; the backward of `chunked_gather`, both routes, against
JAX's `_gather_bwd`.  Sums run in other orders in the two packages, so they
agree to rtol 1e-5 (atol 1e-5 of the largest value).  K3 itself is checked
on the card (tests/test_torch_cuda.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvrt_tpu.render import binning as jb
from gvrt_tpu.render import param_grads as jpg
from gvrt_tpu.render import segreduce as jsr
from gvrt_tpu.render.tiled import _camera_mats
from gvrt_tpu_torch.render import param_grads as tpg
from gvrt_tpu_torch.render import segreduce as tsr

from port_scenes import CFG_T8, camera, jax_scene


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _layout(n=700, res=64):
    """A real topology's pre-sort pair structure (JAX binning) as NumPy:
    pair_g, pair_pos, offsets, counts, capacity, capacity_padded, and the
    topology itself."""
    model = jax_scene(n, seed=31)
    cam = camera(res)
    w2c, proj = _camera_mats(cam)
    act = model.activate()
    cap, cap_pad = jb.plan_capacity(act, w2c, proj, res, res, CFG_T8)
    topo = jb.bin_topology(act, w2c, proj, res, res, CFG_T8, cap, cap_pad)
    assert int(topo.overflow) == 0
    offsets = np.asarray(topo.gauss_offsets).astype(np.int64)
    counts = np.asarray(topo.gauss_counts).astype(np.int64)
    pair_g = np.zeros(cap, np.int64)
    has = (counts > 0) & (offsets < cap)
    np.maximum.at(pair_g, offsets[has], np.nonzero(has)[0])
    pair_g = np.maximum.accumulate(pair_g)
    return (pair_g, np.asarray(topo.pair_pos).astype(np.int64), offsets,
            counts, cap, cap_pad, topo)


@pytest.mark.parametrize("tight", [False, True], ids=["planned", "overflow"])
def test_build_reduce_plan_equals_jax(tight):
    pair_g, pair_pos, offsets, counts, cap, cap_pad, _ = _layout()
    n = offsets.shape[0]
    live = int((pair_pos < cap_pad).sum())
    # a caller-tightened row budget that cannot hold every live row
    cap_r = tsr.GROUP * max(1, live // (2 * tsr.GROUP)) if tight else 0
    jred, jovf = jsr.build_reduce_plan(
        jnp.asarray(pair_g, jnp.int32), jnp.asarray(pair_pos, jnp.int32),
        jnp.asarray(offsets, jnp.int32), jnp.asarray(counts, jnp.int32), n,
        cap, cap_pad, cap_r)
    tred, tovf = tsr.build_reduce_plan(
        *(torch.from_numpy(x) for x in (pair_g, pair_pos, offsets, counts)),
        n, cap, cap_pad, cap_r)
    for f in tsr.ReducePlan._fields:
        x, y = np.asarray(getattr(jred, f)), getattr(tred, f).numpy()
        assert y.dtype == np.int32 and y.shape == x.shape, f
        np.testing.assert_array_equal(y, x, err_msg=f)
    assert int(tovf) == int(jovf)
    assert (int(tovf) > 0) == tight


def test_segment_reduce_plain_matches_interpreted_pallas():
    _, _, _, _, _, cap_pad, topo = _layout()
    n = topo.gauss_offsets.shape[0]
    n_groups = -(-(n + 1) // tsr.GROUP)
    red = topo.red
    bar_flat = np.random.default_rng(0).normal(size=(cap_pad, 64))
    bar_flat = bar_flat.astype(np.float32)
    bar_pre = jnp.asarray(bar_flat)[jnp.minimum(red.slot, cap_pad - 1)]
    want = jsr.segment_reduce(bar_pre, red, n_groups, interpret=True)
    tred = tsr.ReducePlan(*(torch.from_numpy(np.array(x)) for x in red))
    before = tsr.segment_reduce.launches
    got = tsr.segment_reduce(torch.from_numpy(bar_flat), tred, n_groups)
    assert tsr.segment_reduce.launches == before  # CPU: the plain version
    assert got.shape == want.shape
    _close(got.numpy(), want)
    torch.testing.assert_close(
        got, tsr.segment_reduce_plain(torch.from_numpy(bar_flat), tred,
                                      n_groups), rtol=0, atol=0)


@pytest.mark.parametrize("route", ["segreduce", "prefix"])
def test_chunked_gather_backward_matches_jax(route):
    _, _, _, _, _, cap_pad, topo = _layout()
    n = topo.gauss_offsets.shape[0]
    g = CFG_T8.chunk_size
    red = topo.red if route == "segreduce" else None
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(n + 1, 64)).astype(np.float32)
    bar = rng.normal(size=(cap_pad // g, g, 64)).astype(np.float32)
    res = (n + 1, topo.pair_gauss, topo.pair_pos, topo.gauss_offsets,
           topo.gauss_counts, red)
    want = jpg._gather_bwd(g, res, jnp.asarray(bar))[0]
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    trows = torch.from_numpy(rows).requires_grad_()
    tred = None if red is None else tsr.ReducePlan(*(t(x) for x in red))
    out = tpg.chunked_gather(g, trows, t(topo.pair_gauss), t(topo.pair_pos),
                             t(topo.gauss_offsets), t(topo.gauss_counts),
                             tred, "torch")
    np.testing.assert_array_equal(
        out.detach().numpy(),
        rows[np.asarray(topo.pair_gauss)].reshape(-1, g, 64))
    out.backward(torch.from_numpy(bar))
    _close(trows.grad.numpy(), want)
    assert np.abs(np.asarray(want)).max() > 0


def test_blocked_cumsum_matches_jax():
    x = np.random.default_rng(2).normal(size=(1000, 7)).astype(np.float32)
    want = jpg.blocked_cumsum(jnp.asarray(x), block=64)
    got = tpg.blocked_cumsum(torch.from_numpy(x), block=64)
    _close(got.numpy(), want)
    _close(got.numpy(), np.cumsum(x.astype(np.float64), axis=0))
