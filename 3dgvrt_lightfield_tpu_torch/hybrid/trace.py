"""Batched ray-triangle intersection (the hybrid renderer's traversal layer).

Replaces the reference's Vulkan TLAS traversal + closest-hit dispatch
(VulkanHybrid.cpp AS build, closesthit.rchit `unpackTriangle`) with
Möller-Trumbore over triangle chunks and a masked argmin, as the JAX
package does.  Layout: rays are rows (R, 6), triangles are packed on the
last dimension (C, 3, G), so every arithmetic op is an (R, G) broadcast.

BVH-lite cull: `pack_triangles` Morton-orders triangles by centroid so
each chunk is spatially compact and stores a per-chunk AABB.  Rays are
grouped into cull blocks of `block` rays (image regions are coherent); a
block skips a chunk when its slab test says no ray of the block can touch
it, including rays whose current best hit (closest_hit) or shadow-segment
end (occluded) is nearer.  The cull is conservative, so the result is the
brute-force scan's.  Here the skip is a mask on the device (`torch.where`
on the carry) rather than a branch: a branch would read a device value on
the host once per (block, chunk).  Rays are computed `batch` at a time
(whole cull blocks), which bounds the (rays, chunk) temporaries.

That chunk loop is the route of rays on the CPU.  Rays on the card take
`csrc/mesh_trace.cu` instead, one launch a query (a thread a ray over the
pack staged in shared memory, a warp skipping each 32-lane group whose box
none of its rays can touch; the boxes are `pack_triangles`' `groups`, made
on the card only).  Its hits equal the chunk loop's: the same arithmetic
in the same order, with `fmaf` where `_fma` rounds in float64.

Spans: `gvrt.mesh.trace` around `closest_hit`, `gvrt.mesh.shadow` around
`occluded`; each query adds its rays to `gvrt.mesh.rays` and its (cull
block, chunk) pairs to `gvrt.mesh.chunk_tests`, both known from shapes, on
either route; each kernel launch counts `gvrt.mesh.trace.kernel`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..config import resolve_device
from ..utils.profiling import count, span

#: back-face/parallel tolerance (Möller-Trumbore determinant cutoff)
EPS_DET = 1e-9
#: primary/secondary ray tmin (define.glsl RAY_TMIN is 0.1 for secondary
#: rays; primaries from the G-buffer cast use a tighter 1e-3)
RAY_TMIN = 0.1
#: miss distance: finite, as the JAX package's (render/combined.py turns it
#: into inf)
INF = 1e30
#: default rays per culling block: one 64x64 image tile
RAY_BLOCK = 4096
#: default rays computed at once (whole cull blocks): the (rays, chunk)
#: temporaries of a 512-triangle chunk stay at tens of MB each
RAY_BATCH = 16384
#: lanes of the packed order that one skip decision of the kernel covers
GROUP = 32
#: the group boxes' outward widening, relative to their coordinates' size
_WIDEN = 2.0 ** -16


class TrianglePack(NamedTuple):
    """Packed triangles on one device, chunked for the chunk loop."""
    v0: torch.Tensor      # (C, 3, G) chunk, xyz, lane
    e1: torch.Tensor      # (C, 3, G) v1 - v0
    e2: torch.Tensor      # (C, 3, G) v2 - v0
    tri_id: torch.Tensor  # (C, G) int64 original triangle id (or -1 pad)
    lo: torch.Tensor      # (C, 3) chunk AABB min (+INF for all-pad chunks)
    hi: torch.Tensor      # (C, 3) chunk AABB max (-INF for all-pad chunks)
    #: (ceil(C * G / GROUP), 6) widened boxes (lo xyz, hi xyz) of each
    #: GROUP lanes of the packed order, for the kernel; on the card only
    groups: Optional[torch.Tensor] = None


def _morton3(x: np.ndarray) -> np.ndarray:
    """(N, 3) int in [0, 1024) -> interleaved 30-bit Morton codes."""
    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    return (spread(x[:, 0]) | (spread(x[:, 1]) << np.uint64(1))
            | (spread(x[:, 2]) << np.uint64(2)))


def pack_triangles(tri_pos: np.ndarray, chunk: int = 512,
                   reorder: bool = True, device=None) -> TrianglePack:
    """(T, 3, 3) vertex triples -> lane-major chunks padded to `chunk`, on
    `device` (the card unless "cpu" is asked for).

    With `reorder` (default), triangles are sorted (in NumPy, as the JAX
    package sorts them) by the Morton code of their centroid, so chunks are
    spatially compact and the per-chunk AABBs are tight.  `tri_id` carries
    the original triangle index, so attribute gathers are unaffected.  On
    the card the pack also holds the kernel's `groups` (`_group_boxes`).
    """
    dev = resolve_device(device)
    t = np.asarray(tri_pos, np.float32)
    n = len(t)
    order = np.arange(n)
    if reorder and n > 1:
        cent = t.mean(axis=1)
        lo, hi = cent.min(0), cent.max(0)
        q = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023.0)
        order = np.argsort(_morton3(np.clip(q, 0, 1023).astype(np.int64)),
                           kind="stable")
        t = t[order]
    c = max(1, -(-n // chunk))
    pad = c * chunk - n
    v0 = t[:, 0, :]
    e1 = t[:, 1, :] - t[:, 0, :]
    e2 = t[:, 2, :] - t[:, 0, :]

    def chunked(x):
        x = np.concatenate([x, np.zeros((pad, 3), np.float32)])
        return torch.as_tensor(np.ascontiguousarray(
            x.reshape(c, chunk, 3).transpose(0, 2, 1)), device=dev)

    ids = np.concatenate([order.astype(np.int64),
                          np.full((pad,), -1, np.int64)])

    # per-chunk AABB over real triangles (pad slots excluded via +-INF)
    vmin = np.minimum(np.minimum(t[:, 0], t[:, 1]), t[:, 2])
    vmax = np.maximum(np.maximum(t[:, 0], t[:, 1]), t[:, 2])
    vmin = np.concatenate([vmin, np.full((pad, 3), INF, np.float32)])
    vmax = np.concatenate([vmax, np.full((pad, 3), -INF, np.float32)])
    lo = vmin.reshape(c, chunk, 3).min(axis=1)
    hi = vmax.reshape(c, chunk, 3).max(axis=1)

    return TrianglePack(chunked(v0), chunked(e1), chunked(e2),
                        torch.as_tensor(ids.reshape(c, chunk), device=dev),
                        torch.as_tensor(lo, device=dev),
                        torch.as_tensor(hi, device=dev),
                        torch.as_tensor(_group_boxes(t, c * chunk),
                                        device=dev)
                        if dev.type == "cuda" else None)


def _group_boxes(t: np.ndarray, lanes: int) -> np.ndarray:
    """(ceil(lanes / GROUP), 6) boxes of the packed (T, 3, 3) triangles
    `t`, GROUP lanes a box, each widened outward by `_WIDEN` of its largest
    coordinate and extent and then by one f32 ulp, so that the kernel's
    slab test holds every hit the intersection test can report in it.  A
    group of pad lanes alone gets the empty box lo = INF > hi = -INF."""
    n_groups = -(-lanes // GROUP)
    box = np.empty((n_groups, 6), np.float32)
    box[:, :3], box[:, 3:] = INF, -INF
    for g in range(-(-len(t) // GROUP)):
        pts = t[g * GROUP:(g + 1) * GROUP].reshape(-1, 3).astype(np.float64)
        lo, hi = pts.min(0), pts.max(0)
        w = _WIDEN * (np.abs(pts).max() + (hi - lo).max())
        box[g, :3] = np.nextafter((lo - w).astype(np.float32),
                                  np.float32(-INF))
        box[g, 3:] = np.nextafter((hi + w).astype(np.float32),
                                  np.float32(INF))
    return box


def _fma(a, b, c):
    """a * b + c rounded once to f32, as a fused multiply-add rounds it
    (the f32 product is exact in f64; rounding the f64 sum to f32 differs
    from one rounding only at an f32 midpoint)."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _intersect_chunk(o, d, v0, e1, e2):
    """Möller-Trumbore for (..., 1) ray columns x (G,) triangles -> t, u, v,
    hit mask, each (..., G).

    The products and sums are contracted into fused multiply-adds where
    XLA contracts the JAX package's expressions on the CPU (a*b - c*d ->
    fma(a, b, -(c*d)); a*b + c*d + e*f -> fma(e, f, fma(a, b, c*d))), so a
    ray through a triangle edge resolves as it does there."""
    # pvec = d x e2 ; det = e1 . pvec
    p0 = _fma(d[1], e2[2], -(d[2] * e2[1]))
    p1 = _fma(d[2], e2[0], -(d[0] * e2[2]))
    p2 = _fma(d[0], e2[1], -(d[1] * e2[0]))
    det = _fma(e1[2], p2, _fma(e1[0], p0, e1[1] * p1))
    ok_det = det.abs() > EPS_DET
    inv_det = torch.where(ok_det, 1.0 / det, 0.0)

    t0 = o[0] - v0[0]
    t1 = o[1] - v0[1]
    t2 = o[2] - v0[2]
    u = _fma(t2, p2, _fma(t0, p0, t1 * p1)) * inv_det

    # qvec = tvec x e1
    q0 = _fma(t1, e1[2], -(t2 * e1[1]))
    q1 = _fma(t2, e1[0], -(t0 * e1[2]))
    q2 = _fma(t0, e1[1], -(t1 * e1[0]))
    v = _fma(d[2], q2, _fma(d[0], q0, d[1] * q1)) * inv_det
    t = _fma(e2[2], q2, _fma(e2[0], q0, e2[1] * q1)) * inv_det

    hit = ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def _split(rays):
    """(..., 6) rays -> ([ox, oy, oz], [dx, dy, dz]), each (..., 1)."""
    o = [rays[..., j:j + 1] for j in range(3)]
    d = [rays[..., 3 + j:4 + j] for j in range(3)]
    return o, d


def _slab(o, d, lo, hi):
    """Ray-vs-AABB slab test of (..., 1) ray columns and (3,) box corners.

    Returns (near, far) per ray; overlap iff near <= far (and the interval
    meets the caller's [tmin, bound]).  Zero direction components are
    clamped to +-1e-12, which keeps the test conservative (huge finite t's
    instead of NaNs from 0 * inf).
    """
    near = torch.full_like(o[0][..., 0], -INF)
    far = torch.full_like(o[0][..., 0], INF)
    for j in range(3):
        dj = d[j][..., 0]
        inv = 1.0 / torch.where(dj.abs() < 1e-12,
                                torch.where(dj < 0, -1e-12, 1e-12), dj)
        a = (lo[j] - o[j][..., 0]) * inv
        b = (hi[j] - o[j][..., 0]) * inv
        near = torch.maximum(near, torch.minimum(a, b))
        far = torch.minimum(far, torch.maximum(a, b))
    return near, far


def _chunk_planes(tris: TrianglePack, c: int):
    """Chunk c's vertex and edge rows as lists of (G,) tensors."""
    return ([tris.v0[c, j] for j in range(3)],
            [tris.e1[c, j] for j in range(3)],
            [tris.e2[c, j] for j in range(3)])


def _pad_blocks(rays, aux, block):
    """Split (R, ...) tensors into (B, block, ...), padding with dead rays.

    The last aux entry returned is an explicit per-ray validity mask (1 for
    real rays, 0 for padding): callers disable padded rays through it
    (tmax = -INF), never through a tmax sentinel."""
    r = rays.shape[0]
    b = max(1, -(-r // block))
    pad = b * block - r
    rays = torch.nn.functional.pad(rays, (0, 0, 0, pad))
    aux = [torch.nn.functional.pad(a, (0, pad)) for a in aux]
    aux.append(torch.nn.functional.pad(
        torch.ones((r,), dtype=rays.dtype, device=rays.device), (0, pad)))
    return (rays.reshape(b, block, 6), [a.reshape(b, block) for a in aux], r)


def _block_groups(n_blocks: int, block: int, batch: int):
    """Slices of whole cull blocks, about `batch` rays each."""
    per = max(1, batch // block)
    return [slice(i, min(i + per, n_blocks)) for i in range(0, n_blocks, per)]


def _closest_hit_blocks(rays, tris, tmin, tmax):
    """Nearest hit of (B, block) rays: the cull per block and chunk."""
    o, d = _split(rays)
    shape = rays.shape[:-1]
    best_t = torch.full(shape, INF, device=rays.device)
    best_tri = torch.full(shape, -1, dtype=torch.int64, device=rays.device)
    best_u = torch.zeros(shape, device=rays.device)
    best_v = torch.zeros(shape, device=rays.device)
    for c in range(tris.v0.shape[0]):
        near, far = _slab(o, d, tris.lo[c], tris.hi[c])
        live = ((near <= torch.minimum(far, torch.minimum(tmax, best_t)))
                & (far >= tmin))
        live = live.any(dim=-1, keepdim=True)      # per cull block
        v0, e1, e2 = _chunk_planes(tris, c)
        t, u, v, hit = _intersect_chunk(o, d, v0, e1, e2)
        ids = tris.tri_id[c]
        ok = (hit & (ids >= 0) & (t >= tmin[..., None])
              & (t <= tmax[..., None]) & (t < best_t[..., None]))
        tbig = torch.where(ok, t, INF)
        j = torch.argmin(tbig, dim=-1, keepdim=True)   # first minimum
        t_j = torch.gather(tbig, -1, j)[..., 0]
        better = (t_j < best_t) & live
        best_tri = torch.where(better, ids[j[..., 0]], best_tri)
        best_u = torch.where(better, torch.gather(u, -1, j)[..., 0], best_u)
        best_v = torch.where(better, torch.gather(v, -1, j)[..., 0], best_v)
        best_t = torch.where(better, t_j, best_t)
    return best_t, best_tri, best_u, best_v


def _count_query(n_rays: int, n_blocks: int, tris: TrianglePack):
    """The counters of one trace query, known from shapes alone: the rays
    traced and the (cull block, chunk) pairs computed."""
    count("gvrt.mesh.rays", n_rays)
    count("gvrt.mesh.chunk_tests", n_blocks * tris.v0.shape[0])


# ---- the kernel route: rays on the card ------------------------------------

def _check_pack(rays: torch.Tensor, v0, e1, e2, tri_id, groups):
    c, _, g = v0.shape
    for name, x in (("v0", v0), ("e1", e1), ("e2", e2), ("tri_id", tri_id),
                    ("groups", groups)):
        if x is None:
            continue
        want = ({"tri_id": (c, g), "groups": (-(-c * g // GROUP), 6)}
                .get(name, (c, 3, g)))
        dtype = torch.int64 if name == "tri_id" else torch.float32
        if (x.device != rays.device or x.dtype != dtype
                or tuple(x.shape) != want or not x.is_contiguous()):
            raise ValueError(f"the mesh-trace kernel takes a contiguous "
                             f"{dtype} {name} {want} on {rays.device}; got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _ray_bounds(rays: torch.Tensor, bound: Optional[torch.Tensor], name):
    """`bound` as the kernel takes it: None, or (R,) float32 contiguous on
    the rays' device."""
    if bound is None:
        return None
    if (bound.device != rays.device or bound.dtype != torch.float32
            or tuple(bound.shape) != (rays.shape[0],)):
        raise ValueError(f"{name} is {bound.dtype} {tuple(bound.shape)} on "
                         f"{bound.device}, not float32 ({rays.shape[0]},) on "
                         f"{rays.device}")
    return bound.contiguous()


def _launch(any_hit: bool, rays: torch.Tensor, v0, e1, e2, tri_id,
            groups: Optional[torch.Tensor], tmin: Optional[torch.Tensor],
            tmax: Optional[torch.Tensor],
            stats: Optional[torch.Tensor] = None):
    """One launch of `csrc/mesh_trace.cu` on the current stream (no
    synchronisation) over the pack's planes v0, e1, e2 and tri_id: the
    closest hits (t, tri, u, v) of (R, 6) rays, or with `any_hit` their
    occluded flags.  `tmin`/`tmax` None read as RAY_TMIN/INF; `groups`
    None turns the warp skip off (the result is the same); `stats`, two
    zeroed int64 on the card or None, gets the (warp, group) visits and
    the skipped ones.  A launch that returns adds one to
    `occluded.launches` or `closest_hit.launches` and counts
    `gvrt.mesh.trace.kernel`."""
    if rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[1] != 6:
        raise ValueError(f"rays are {rays.dtype} {tuple(rays.shape)}, not "
                         f"float32 (R, 6)")
    if rays.stride(1) != 1 or rays.stride(0) < 6:
        rays = rays.contiguous()
    _check_pack(rays, v0, e1, e2, tri_id, groups)
    tmin, tmax = (_ray_bounds(rays, b, n) for b, n in ((tmin, "tmin"),
                                                       (tmax, "tmax")))
    r, dev = rays.shape[0], rays.device
    c, _, g = v0.shape

    def ptr(x):
        return None if x is None else x.data_ptr()
    inputs = (rays.data_ptr(), rays.stride(0), r, ptr(tmin), ptr(tmax),
              RAY_TMIN, INF, v0.data_ptr(), e1.data_ptr(), e2.data_ptr(),
              tri_id.data_ptr(), c, g, ptr(groups))
    lib = _build.load("mesh_trace")
    if any_hit:
        out = (torch.empty(r, dtype=torch.bool, device=dev),)
        fn = lib.gvrt_mesh_occluded
    else:
        out = (torch.empty(r, device=dev),
               torch.empty(r, dtype=torch.int64, device=dev),
               torch.empty(r, device=dev), torch.empty(r, device=dev))
        fn = lib.gvrt_mesh_closest_hit
    with torch.cuda.device(dev):
        err = fn(*inputs, *(x.data_ptr() for x in out), ptr(stats),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mesh_trace kernel launch failed: CUDA error "
                           f"{err}")
    (occluded if any_hit else closest_hit).launches += 1
    count("gvrt.mesh.trace.kernel")
    return out[0] if any_hit else out


_PACK_SCHEMA = ("Tensor rays, Tensor v0, Tensor e1, Tensor e2, "
                "Tensor tri_id, Tensor? groups")
_library = []   # the `torch.library.Library` that holds the two ops


def _ops():
    """`torch.ops.gvrt_port` with the trace's two ops, defined at first use:
    each launch runs inside a dispatcher op with a CUDA kernel, so the
    profiler links the kernel's device time to the op and through it into
    `gvrt.mesh.trace` or `gvrt.mesh.shadow` (a bare ctypes launch links to
    no range)."""
    ns = torch.ops.gvrt_port
    if not hasattr(ns, "mesh_closest_hit"):
        lib = torch.library.Library("gvrt_port", "FRAGMENT")
        lib.define(f"mesh_closest_hit({_PACK_SCHEMA}, Tensor? tmin, "
                   f"Tensor? tmax) -> (Tensor, Tensor, Tensor, Tensor)")
        lib.define(f"mesh_occluded({_PACK_SCHEMA}, Tensor tmin, "
                   f"Tensor tmax) -> Tensor")
        lib.impl("mesh_closest_hit", lambda *a: _launch(False, *a), "CUDA")
        lib.impl("mesh_occluded", lambda *a: _launch(True, *a), "CUDA")
        _library.append(lib)
    return ns


def _count_kernel_query(rays: torch.Tensor, tris: TrianglePack,
                        block: int):
    """The kernel route's shape counters: the chunk loop's (its cull
    blocks of min(block, R) rays); `_launch` counts the launch."""
    r = rays.shape[0]
    _count_query(r, -(-r // min(block, r)) if r else 0, tris)


@span("gvrt.mesh.trace")
def closest_hit(rays: torch.Tensor, tris: TrianglePack,
                tmin: Optional[torch.Tensor] = None,
                tmax: Optional[torch.Tensor] = None,
                block: int = RAY_BLOCK, batch: int = RAY_BATCH):
    """Nearest intersection per ray.

    rays (R, 6) [o, d]; returns a dict of (R,) tensors: t (INF on miss),
    tri (int64, -1 on miss), u, v barycentrics.  On the CPU rays are culled
    in blocks of `block` (contiguous rays come from one image region) and
    computed `batch` rays at a time.  Rays on the card take one launch of
    `csrc/mesh_trace.cu` (the op `gvrt_port::mesh_closest_hit`, no
    synchronisation; adds one to `closest_hit.launches`), which accepts
    `block` and `batch` and ignores them.
    """
    if rays.device.type == "cuda":
        _count_kernel_query(rays, tris, block)
        t, tri, u, v = _ops().mesh_closest_hit(
            rays, tris.v0, tris.e1, tris.e2, tris.tri_id, tris.groups, tmin,
            tmax)
        return {"t": t, "tri": tri, "u": u, "v": v}
    return _closest_hit_plain(rays, tris, tmin, tmax, block, batch)


closest_hit.launches = 0


def _closest_hit_plain(rays, tris, tmin=None, tmax=None, block=RAY_BLOCK,
                       batch=RAY_BATCH):
    """`closest_hit`'s chunk loop, the route of rays on the CPU (on any
    device when called directly)."""
    r = rays.shape[0]
    tmin = torch.full((r,), RAY_TMIN, device=rays.device) if tmin is None \
        else tmin
    tmax = torch.full((r,), INF, device=rays.device) if tmax is None \
        else tmax
    rb, (tminb, tmaxb, validb), r0 = _pad_blocks(rays, [tmin, tmax],
                                                 min(block, r))
    _count_query(r0, rb.shape[0], tris)
    # padded rays (valid == 0) get an empty [tmin, -INF) interval
    tmaxb = torch.where(validb > 0, tmaxb, -INF)
    outs = [_closest_hit_blocks(rb[s], tris, tminb[s], tmaxb[s])
            for s in _block_groups(rb.shape[0], rb.shape[1], batch)]
    t, tri, u, v = (torch.cat(x).reshape(-1)[:r0] for x in zip(*outs))
    return {"t": t, "tri": tri, "u": u, "v": v}


def _occluded_blocks(rays, tris, tmin, tmax):
    """Any hit of (B, block) rays in (tmin, tmax): the cull per block."""
    o, d = _split(rays)
    occ = torch.zeros(rays.shape[:-1], dtype=torch.bool, device=rays.device)
    for c in range(tris.v0.shape[0]):
        near, far = _slab(o, d, tris.lo[c], tris.hi[c])
        # a fully shadowed block stops testing
        live = ((near <= torch.minimum(far, tmax)) & (far >= tmin) & ~occ)
        live = live.any(dim=-1, keepdim=True)
        v0, e1, e2 = _chunk_planes(tris, c)
        t, _, _, hit = _intersect_chunk(o, d, v0, e1, e2)
        any_hit = (hit & (tris.tri_id[c] >= 0) & (t >= tmin[..., None])
                   & (t <= tmax[..., None])).any(dim=-1)
        occ = occ | (any_hit & live)
    return occ


@span("gvrt.mesh.shadow")
def occluded(rays: torch.Tensor, tris: TrianglePack, tmin: torch.Tensor,
             tmax: torch.Tensor, block: int = RAY_BLOCK,
             batch: int = RAY_BATCH) -> torch.Tensor:
    """Any-hit test in (tmin, tmax): the shadow-ray trace (raygen.rgen
    traceRayEXT with TerminateOnFirstHit).  (R,) bool.  Rays on the card
    take one launch of `csrc/mesh_trace.cu` (the op
    `gvrt_port::mesh_occluded`; adds one to `occluded.launches`), which
    ignores `block` and `batch`."""
    if rays.device.type == "cuda":
        _count_kernel_query(rays, tris, block)
        return _ops().mesh_occluded(rays, tris.v0, tris.e1, tris.e2,
                                    tris.tri_id, tris.groups, tmin, tmax)
    return _occluded_plain(rays, tris, tmin, tmax, block, batch)


occluded.launches = 0


def _occluded_plain(rays, tris, tmin, tmax, block=RAY_BLOCK,
                    batch=RAY_BATCH):
    """`occluded`'s chunk loop, the route of rays on the CPU (on any device
    when called directly)."""
    rb, (tminb, tmaxb, validb), r0 = _pad_blocks(rays, [tmin, tmax],
                                                 min(block, rays.shape[0]))
    _count_query(r0, rb.shape[0], tris)
    tmaxb = torch.where(validb > 0, tmaxb, -INF)
    occ = [_occluded_blocks(rb[s], tris, tminb[s], tmaxb[s])
           for s in _block_groups(rb.shape[0], rb.shape[1], batch)]
    return torch.cat(occ).reshape(-1)[:r0]
