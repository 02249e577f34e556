"""The mesh-trace kernel's parts that the CPU reaches (`hybrid/trace.py`).

The kernel itself (`csrc/mesh_trace.cu`) runs on the card only, where
`tests/test_torch_cuda.py` holds it to the chunk loop.  Here, without JAX:

* the warp skip's group boxes (`_group_boxes`): every triangle of a group
  inside its box, pad-only groups empty, and every hit the intersection
  test reports (t in [tmin, tmax]) inside the box's slab interval as the
  kernel computes it (`may_touch`, mirrored in float32 below), on seeded
  soups, edge cases and the combined cell's props under primary and
  shadow rays;
* the wrapper's input checks, which raise before anything is built;
* the source's two C entry points and their argument counts against
  `_build.SIGNATURES`, and IEEE math;
* the CPU route: no group boxes in the pack, no kernel counted.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import gvrt_tpu_torch as gt  # noqa: E402
from gvrt_tpu_torch import _build  # noqa: E402
from gvrt_tpu_torch.hybrid import trace  # noqa: E402
from gvrt_tpu_torch.utils import profiling  # noqa: E402

F = np.float32


def _soup(seed=5, n=700, n_rays=2000):
    rng = np.random.default_rng(seed)
    tri = (rng.uniform(-4, 4, (n, 1, 3))
           + 0.4 * rng.standard_normal((n, 3, 3))).astype(F)
    o = rng.uniform(-6, 6, (n_rays, 3))
    d = rng.standard_normal((n_rays, 3))
    axis = n_rays // 10                  # rays along the axes
    d[:axis] = np.eye(3)[rng.integers(0, 3, axis)]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d], 1).astype(F)
    return tri, rays, np.full(n_rays, 0.1, F)


def _edges():
    """A quad of two triangles sharing a diagonal, the same quad again
    (duplicates), a triangle in the plane of every ray's direction, and
    rays through the shared edge, the shared vertex and parallel to it."""
    quad = np.asarray([[[0, 0, -2], [1, 0, -2], [1, 1, -2]],
                       [[0, 0, -2], [1, 1, -2], [0, 1, -2]]], F)
    side = np.asarray([[[-1, -1, -3], [-1, 1, -3], [-1, 1, -1]]], F)
    tri = np.concatenate([quad, quad, side])
    o = np.asarray([[0.5, 0.5, 0], [0.25, 0.25, 0], [0, 0, 0], [1, 1, 0],
                    [0.3, 0.7, 0], [-1, 0, 0], [0.5, 0.5, -2]], F)
    d = np.asarray([[0, 0, -1]] * 5 + [[0, 0, -1], [1, 0, 0]], F)
    return tri, np.concatenate([o, d], 1), np.zeros(len(o), F)


def _props(res=48):
    """The combined cell's props (`portbench/entries/combined.py`: the CLI's
    quad_icosphere in the garden box) under an orbit camera's primary
    rays, and the shadow rays to its light from every hit."""
    c, e = np.asarray([0.0, 0.0, -4.0]), 2.0
    scene = gt.hybrid.mesh.PROCEDURAL["quad_icosphere"](c - e, c + e, up=1,
                                                        subdiv=2)
    eye = c + 4.0 * np.asarray([np.sin(0.3), 0.25, np.cos(0.3)])
    c2w = gt.io.cameras.look_at_inverse(eye, c, np.asarray([0.0, 1.0, 0.0]))
    cam = gt.Camera.from_fovy(res, res, 60.0, c2w)
    o, d = cam.rays()
    prim = np.concatenate([o, d], -1).reshape(-1, 6).astype(F)
    pack = trace.pack_triangles(scene.tri_pos, 512, device="cpu")
    hit = trace.closest_hit(torch.from_numpy(prim), pack,
                            tmin=torch.full((len(prim),), 1e-3))
    t = hit["t"].numpy()[:, None]
    pos = prim[:, :3] + t * prim[:, 3:]
    to_l = np.asarray(scene.light_table()[0, :3], F) - pos
    dist = np.linalg.norm(to_l.astype(np.float64), axis=1, keepdims=True)
    sdir = (to_l / np.maximum(dist, 1e-12)).astype(F)
    shadow = np.concatenate([pos + sdir * 0.1, sdir], 1).astype(F)
    rays = np.concatenate([prim, shadow])
    tmin = np.concatenate([np.full(len(prim), 1e-3, F),
                           np.full(len(shadow), 0.1, F)])
    return scene.tri_pos.astype(F), rays, tmin


def _may_touch(rays, box, lo_t, hi_t):
    """The kernel's `may_touch` in float32, (R,) rays against one box."""
    o, d = rays[:, :3], rays[:, 3:]
    d = np.where(np.abs(d) < F(1e-12), np.where(d < 0, F(-1e-12),
                                                F(1e-12)), d).astype(F)
    inv = (F(1) / d).astype(F)
    with np.errstate(over="ignore", invalid="ignore"):
        a = ((box[None, :3] - o) * inv).astype(F)
        b = ((box[None, 3:] - o) * inv).astype(F)
    near = np.maximum(np.minimum(a, b).max(1), F(-trace.INF))
    far = np.minimum(np.maximum(a, b).min(1), F(trace.INF))
    slack = F(trace._WIDEN)
    hi_t = (hi_t + slack * np.abs(hi_t)).astype(F)
    lo_t = (lo_t - slack * np.abs(lo_t)).astype(F)
    return ~((near > far) | (near > hi_t) | (far < lo_t))


def _pack_and_boxes(tri, chunk):
    pack = trace.pack_triangles(tri, chunk, device="cpu")
    order = pack.tri_id.reshape(-1)[:len(tri)].numpy()
    return pack, trace._group_boxes(tri[order], pack.tri_id.numel())


SCENES = {"soup_256": (_soup, 256), "soup_512": (_soup, 512),
          "soup_40": (lambda: _soup(seed=7, n=90), 40),
          "edges": (_edges, 8), "props": (_props, 512)}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_group_boxes_hold_every_hit(name):
    """Every (ray, lane) pair that the intersection test accepts with t in
    [tmin, INF] lies in its group's slab interval up to t, as the kernel
    computes it: so a warp never skips a group that holds a hit of one of
    its rays within that ray's [tmin, min(tmax, best_t)]."""
    make, chunk = SCENES[name]
    tri, rays, tmin = make()
    pack, boxes = _pack_and_boxes(tri, chunk)
    o, d = trace._split(torch.from_numpy(rays))
    n_hits = 0
    for c in range(pack.v0.shape[0]):
        t, _, _, hit = trace._intersect_chunk(o, d,
                                              *trace._chunk_planes(pack, c))
        ok = (hit & (pack.tri_id[c] >= 0)
              & (t >= torch.from_numpy(tmin)[:, None])
              & (t <= trace.INF)).numpy()
        t = t.numpy()
        for lane in np.flatnonzero(ok.any(0)):
            k = c * chunk + lane
            rows = np.flatnonzero(ok[:, lane])
            touch = _may_touch(rays[rows], boxes[k // trace.GROUP],
                               tmin[rows], t[rows, lane])
            assert touch.all(), (k, rows[~touch])
            n_hits += len(rows)
    assert n_hits > 0


@pytest.mark.parametrize("chunk", (8, 40, 512))
def test_group_boxes_cover_their_triangles(chunk):
    tri, _, _ = _soup(seed=3, n=100)
    pack, boxes = _pack_and_boxes(tri, chunk)
    lanes = pack.tri_id.numel()
    assert boxes.shape == (-(-lanes // trace.GROUP), 6)
    assert boxes.dtype == np.float32
    packed = tri[pack.tri_id.reshape(-1)[:len(tri)].numpy()]
    for g in range(len(boxes)):
        p = packed[g * trace.GROUP:(g + 1) * trace.GROUP].reshape(-1, 3)
        if len(p) == 0:      # pad lanes alone: the empty box
            assert (boxes[g, :3] == F(trace.INF)).all()
            assert (boxes[g, 3:] == F(-trace.INF)).all()
            continue
        assert (boxes[g, :3] < p.min(0)).all() and \
            (boxes[g, 3:] > p.max(0)).all(), g


def test_cpu_pack_has_no_group_boxes():
    tri, _, _ = _soup(n=50)
    assert trace.pack_triangles(tri, 64, device="cpu").groups is None


def test_cpu_route_counts_no_kernel():
    """On the CPU a query runs the chunk loop: its shape counters, no
    `gvrt.mesh.trace.kernel`."""
    tri, rays, tmin = _soup(n=60, n_rays=100)
    pack = trace.pack_triangles(tri, 64, device="cpu")
    r = torch.from_numpy(rays)
    profiling.reset()
    with torch.profiler.profile():
        trace.closest_hit(r, pack, tmin=torch.from_numpy(tmin), block=32)
        trace.occluded(r, pack, torch.from_numpy(tmin),
                       torch.full((100,), 5.0), block=32)
    counts = profiling.recorded()["counts"]
    profiling.reset()
    assert counts["gvrt.mesh.rays"] == 200
    assert counts["gvrt.mesh.chunk_tests"] == 2 * 4 * 1
    assert "gvrt.mesh.trace.kernel" not in counts


def _bad(case):
    """(rays, pack, tmin, tmax, groups) with one thing the kernel does not
    take."""
    tri, rays, tmin = _soup(n=40, n_rays=10)
    pack = trace.pack_triangles(tri, 64, device="cpu")
    groups = torch.from_numpy(trace._group_boxes(tri, 64))
    r, tn = torch.from_numpy(rays), torch.from_numpy(tmin)
    tx = torch.full((10,), 5.0)
    if case == "rays_float64":
        r = r.double()
    elif case == "rays_five_columns":
        r = r[:, :5]
    elif case == "tmin_short":
        tn = tn[:9]
    elif case == "tmax_int":
        tx = tx.int()
    elif case == "v0_float64":
        pack = pack._replace(v0=pack.v0.double())
    elif case == "tri_id_int32":
        pack = pack._replace(tri_id=pack.tri_id.int())
    elif case == "e2_strided":
        pack = pack._replace(e2=pack.e2.transpose(0, 2).contiguous()
                             .transpose(0, 2))
    elif case == "groups_short":
        groups = groups[:1]
    elif case == "groups_on_meta":
        groups = groups.to("meta")
    return r, pack, tn, tx, groups


@pytest.mark.parametrize("case", [
    "rays_float64", "rays_five_columns", "tmin_short", "tmax_int",
    "v0_float64", "tri_id_int32", "e2_strided", "groups_short",
    "groups_on_meta"])
def test_launch_rejects_what_the_kernel_does_not_take(case, monkeypatch):
    def no_build(name):
        raise AssertionError("built before the inputs were checked")
    monkeypatch.setattr(_build, "load", no_build)
    r, pack, tn, tx, groups = _bad(case)
    before = (trace.closest_hit.launches, trace.occluded.launches)
    profiling.reset()
    with torch.profiler.profile():
        for any_hit in (False, True):
            with pytest.raises(ValueError):
                trace._launch(any_hit, r, *pack[:4], groups, tn, tx)
    counts = profiling.recorded()["counts"]
    profiling.reset()
    # a refused launch is not counted
    assert (trace.closest_hit.launches, trace.occluded.launches) == before
    assert "gvrt.mesh.trace.kernel" not in counts


def test_mesh_trace_is_built_with_the_other_kernels():
    """Two C entry points whose argument counts match their ctypes
    signatures; IEEE math (no fast math, no contraction flag that would
    override the source's round-to-nearest intrinsics)."""
    assert set(_build.SIGNATURES["mesh_trace"]) == {
        "gvrt_mesh_closest_hit", "gvrt_mesh_occluded"}
    with open(os.path.join(_build.CSRC_DIR, "mesh_trace.cu")) as f:
        text = f.read()
    for fn, (argtypes, _) in _build.SIGNATURES["mesh_trace"].items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", text)
        assert m, fn
        assert len(m.group(1).split(",")) == len(argtypes), fn
    assert not any("fast_math" in f or "fmad" in f for f in _build.NVCC_FLAGS)
    for op in ("fmaf", "__fmul_rn", "__fadd_rn", "__fsub_rn", "__fdiv_rn"):
        assert op in text, op
