"""Binning's pair expansion (`render/binning.py::expand_pairs`) on the CPU.

On CPU tensors `expand_pairs` is its plain version, `_expand_pairs_plain`;
the kernels (`csrc/bin_expand.cu`) are held to it on the card by
`tests/test_torch_cuda.py`.  These tests hold that the plain version's
int32 key sorts as the int64 key it replaced, on frames built with many
equal keys, that the wrapper refuses what the kernels do not take, and
that the kernel is built with the others.  They import neither JAX nor
the JAX package:

    python -m pytest tests/test_torch_bin_expand.py -q --noconftest \
        -p no:cacheprovider
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gvrt_tpu_torch as gt  # noqa: E402
from gvrt_tpu_torch import _build  # noqa: E402
from gvrt_tpu_torch.render import binning  # noqa: E402
from gvrt_tpu_torch.render.tiled import _camera_mats  # noqa: E402

RES = 64
CFG = gt.DEFAULT_CONFIG.replace(tile_size=8, chunk_size=64)
BANDS = {"unbanded": (0, 1, 0), "stride": (1, 2, 0), "contig": (1, 1, 3)}


def _tied_scene(n=240, seed=5):
    """n Gaussians in 12 stacks of 20 at identical centres and scales (each
    stack's pairs share their tiles and quantized depths), two stacks
    straddling the near plane (full-screen rects)."""
    g = torch.Generator().manual_seed(seed)
    model = gt.random_gaussians(g, n, extent=0.8, device="cpu")
    with torch.no_grad():
        for leaf in (model.means, model.scales_log):
            leaf.copy_(leaf[::20].repeat_interleave(20, dim=0))
        model.means[:, 2] -= 2.5
        model.means[:40, 2] = -0.02
        model.scales_log[:40] = -1.0
    return model


def _expansion(model, band):
    """The topology of one band of the 64x64 frame on the CPU, and the
    arguments and results of its `expand_pairs` call."""
    cam = gt.Camera.from_fovy(RES, RES, 60.0, np.eye(4))
    w2c, proj = _camera_mats(cam)
    off, stride, rows = band
    with torch.no_grad():
        act = model.activate()
        cap = binning.plan_capacity(act, w2c, proj, RES, RES, CFG,
                                    band=(off, stride))
        seen = []

        def spy(*args):
            seen.append((args, binning._expand_pairs_plain(*args)))
            return seen[-1][1]
        orig = binning.expand_pairs
        binning.expand_pairs = spy
        try:
            topo = binning.bin_topology(act, w2c, proj, RES, RES, CFG, *cap,
                                        row_offset=off, row_stride=stride,
                                        row_count=rows)
        finally:
            binning.expand_pairs = orig
    assert len(seen) == 1
    return topo, seen[0]


def _int64_key(capacity, offsets, counts, total, rect, depth_q, cs, v, nx,
               num_tiles, row_offset, row_stride, depth_bits, cull):
    """The sort key as binning built it in int64 before the int32 key:
    pair ids, tiles, the exact cull and the key, op by op."""
    n = offsets.shape[0]
    tx0, ty0, tx1 = (a.long() for a in rect)
    p_idx = torch.arange(capacity)
    arr = torch.zeros(capacity, dtype=torch.int64)
    keep = (counts > 0) & (offsets < capacity)
    arr.scatter_reduce_(0, offsets[keep], torch.arange(n)[keep], "amax")
    pair_g = torch.cummax(arr, 0).values
    in_range = p_idx < total
    j = p_idx - offsets[pair_g]
    e_rw = (tx1 - tx0 + 1)[pair_g]
    tile_x = tx0[pair_g] + j % e_rw
    tile_y = ty0[pair_g] + torch.div(j, e_rw, rounding_mode="floor")
    fine = binning._pair_ellipsoid_cull(
        tile_x, tile_y * row_stride + row_offset, cs[0][pair_g],
        cs[1][pair_g], cs[2][pair_g], torch.stack(v, dim=1)[pair_g], *cull)
    tile_id = torch.where(in_range & fine, tile_y * nx + tile_x, num_tiles)
    key = (tile_id << depth_bits) | torch.where(in_range, depth_q[pair_g], 0)
    return pair_g, key


@pytest.mark.parametrize("band", sorted(BANDS))
def test_int32_key_sorts_as_the_int64_key(band):
    """The plain version's int32 key holds the int64 key's values, and the
    stable sort gives the same order, on a frame where most in-range keys
    tie (stacked Gaussians) and every slot past the total ties."""
    topo, (args, (pair_g, key)) = _expansion(_tied_scene(), BANDS[band])
    want_g, want_key = _int64_key(*args)
    assert pair_g.dtype == torch.int64 and torch.equal(pair_g, want_g)
    assert key.dtype == torch.int32 and key.shape == want_key.shape
    assert int(want_key.max()) < 2**31 and int(want_key.min()) >= 0
    assert torch.equal(key.long(), want_key)
    in_range = key[:int(args[3])]
    assert in_range.numel() > 2 * torch.unique(in_range).numel()
    got = torch.sort(key, stable=True)
    want = torch.sort(want_key, stable=True)
    assert torch.equal(got.indices, want.indices)
    assert int(topo.num_pairs) > 0 and int(topo.overflow) == 0


def _args():
    """Valid `expand_pairs` arguments of a small frame."""
    return list(_expansion(_tied_scene(), BANDS["unbanded"])[1][0])


def _bad(case):
    a = _args()
    rect, cs, v = list(a[4]), list(a[6]), list(a[7])
    if case == "offsets_int32":
        a[1] = a[1].to(torch.int32)
    elif case == "counts_two_dims":
        a[2] = a[2].reshape(1, -1)
    elif case == "rect_int64":
        rect[1] = rect[1].long()
    elif case == "cs_float64":
        cs[2] = cs[2].double()
    elif case == "v_strided":
        v[4] = torch.stack([v[4], v[4]], dim=1)[:, 0]
    elif case == "v_short":
        v[0] = v[0][1:]
    elif case == "eight_v_columns":
        v = v[:8]
    elif case == "total_int32":
        a[3] = a[3].to(torch.int32)
    elif case == "depth_q_on_meta":
        a[5] = torch.empty_like(a[5], device="meta")
    else:
        assert case == "all_on_meta", case
        a[1], a[2], a[3], a[5] = (torch.empty_like(t, device="meta")
                                  for t in (a[1], a[2], a[3], a[5]))
        rect, cs, v = ([torch.empty_like(t, device="meta") for t in c]
                       for c in (rect, cs, v))
    a[4], a[6], a[7] = tuple(rect), tuple(cs), tuple(v)
    return a


@pytest.mark.parametrize("case", [
    "offsets_int32", "counts_two_dims", "rect_int64", "cs_float64",
    "v_strided", "v_short", "eight_v_columns", "total_int32",
    "depth_q_on_meta", "all_on_meta"])
def test_expand_pairs_rejects_what_the_kernel_does_not_take(case):
    before = binning.expand_pairs.launches
    with pytest.raises(ValueError, match="expand_pairs"):
        binning.expand_pairs(*_bad(case))
    assert binning.expand_pairs.launches == before


def test_expand_pairs_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's results and
    counts no launch."""
    args = _args()
    before = binning.expand_pairs.launches
    got = binning.expand_pairs(*args)
    want = binning._expand_pairs_plain(*args)
    assert binning.expand_pairs.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_bin_expand_is_built_with_the_other_kernels():
    """The kernel's source is built by `_build` with its two C entry points,
    under IEEE math: no fast math, no FMA contraction flag that would
    override the source's round-to-nearest intrinsics."""
    assert set(_build.SIGNATURES["bin_expand"]) == {
        "gvrt_bin_run_starts", "gvrt_bin_pair_keys"}
    src = os.path.join(_build.CSRC_DIR, "bin_expand.cu")
    with open(src) as f:
        text = f.read()
    for fn in _build.SIGNATURES["bin_expand"]:
        assert f'extern "C" int {fn}(' in text, fn
    assert not any("fast_math" in f or "fmad" in f for f in _build.NVCC_FLAGS)
    assert "__fmul_rn" in text and "__fadd_rn" in text
