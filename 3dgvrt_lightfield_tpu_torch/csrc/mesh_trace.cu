// The mesh trace for Hopper (sm_90a): each ray's closest triangle hit, or
// whether anything lies on its shadow segment, in one launch a query.
//
// Replaces no TPU kernel: the JAX package traces its meshes with plain jnp
// (`3dgvrt_lightfield_tpu/hybrid/trace.py`, `closest_hit`, `occluded`).
// The port's plain version is the chunk loop of `hybrid/trace.py`
// (`_closest_hit_blocks`, `_occluded_blocks`), about a hundred launches a
// batch of 16,384 rays with the products rounded in float64; the wrappers
// `hybrid/trace.py::closest_hit` and `occluded` launch these kernels for
// rays on the card.
//
// What it computes, a thread a ray, over the pack's L = C * G lanes in
// packed order (chunk by chunk, lane by lane; `TrianglePack`'s (C, 3, G)
// planes, pad lanes past the last triangle):
//   closest hit: the nearest lane whose Moller-Trumbore test hits, whose
//     id is >= 0 and whose t lies in [tmin, tmax]; a lane replaces the
//     best only when t < best_t, so the first minimum in packed order wins,
//     as the chunk loop's argmin and its `t_j < best_t` do.  Writes t (1e30
//     on a miss), the lane's int64 triangle id (-1), u and v (0).
//   occluded: whether any such lane exists; the ray stops at the first.
// The arithmetic is `_intersect_chunk`'s in its order: fmaf wherever it
// calls `_fma`, __fmul_rn / __fadd_rn / __fsub_rn for every other product
// and sum (never contracted), IEEE division for 1 / det.  `_fma` rounds
// twice (the f64 sum, then to f32), fmaf once: the two differ only where
// the f64 sum falls on an f32 midpoint.
//
// Bound on this card: operations (about 69 f32 operations a ray-triangle
// pair against 32 B read and at most 20 B written a ray).  Design:
//   * a block of 256 rays stages the pack through shared memory 512 lanes
//     at a time (48 B a lane: v0, e1, e2 and an id flag, three 16-byte
//     loads), so triangles are read from memory once a block; every lane
//     of a warp reads the same triangle, a broadcast;
//   * before testing a group of 32 lanes, a warp skips it when no ray of
//     the warp can touch the group's box within [tmin, min(tmax, best_t)]
//     (closest hit) or [tmin, tmax] (occluded, whose shadowed rays drop
//     out), decided by a warp vote.  The boxes (`groups`, one a 32 lanes
//     of the flat order) are built once at pack time and widened there;
//     the test adds a slack of 2^-16 of |t| on both ends and never skips
//     for a ray with a non-finite component.  A null `groups` turns the
//     skip off; the result is the same either way.  A group of pad lanes
//     alone (lo > hi) is always skipped.
//   * `stats`, optional: the (warp, group) visits of warps with a live ray
//     and how many of them were skipped, added once a warp.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // rays a block
constexpr int kWindow = 512;           // lanes staged at a time
constexpr int kGroup = 32;             // lanes a skip decision covers
constexpr int kGroups = kWindow / kGroup;
constexpr float kInf = 1e30f;          // `hybrid/trace.py::INF`
constexpr float kEpsDet = 1e-9f;       // `EPS_DET`
constexpr float kSlack = 1.0f / 65536.0f;
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
  float o[3], d[3], inv[3], tmin, tmax;
  bool alive, finite;
};

// _intersect_chunk for one ray and one staged lane (a: v0.xyz e1.x,
// b: e1.yz e2.xy, c: e2.z flag); u, v and t are read only when hit
__device__ __forceinline__ bool intersect(const Ray& r, const float4 a,
                                          const float4 b, const float4 c,
                                          float& t, float& u, float& v) {
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float d0 = r.d[0], d1 = r.d[1], d2 = r.d[2];
  // pvec = d x e2 ; det = e1 . pvec
  const float p0 = fmaf(d1, e2z, -__fmul_rn(d2, e2y));
  const float p1 = fmaf(d2, e2x, -__fmul_rn(d0, e2z));
  const float p2 = fmaf(d0, e2y, -__fmul_rn(d1, e2x));
  const float det = fmaf(e1z, p2, fmaf(e1x, p0, __fmul_rn(e1y, p1)));
  const bool ok_det = fabsf(det) > kEpsDet;
  const float inv_det = ok_det ? __fdiv_rn(1.0f, det) : 0.0f;
  const float t0 = __fsub_rn(r.o[0], a.x);
  const float t1 = __fsub_rn(r.o[1], a.y);
  const float t2 = __fsub_rn(r.o[2], a.z);
  u = __fmul_rn(fmaf(t2, p2, fmaf(t0, p0, __fmul_rn(t1, p1))), inv_det);
  // qvec = tvec x e1
  const float q0 = fmaf(t1, e1z, -__fmul_rn(t2, e1y));
  const float q1 = fmaf(t2, e1x, -__fmul_rn(t0, e1z));
  const float q2 = fmaf(t0, e1y, -__fmul_rn(t1, e1x));
  v = __fmul_rn(fmaf(d2, q2, fmaf(d0, q0, __fmul_rn(d1, q1))), inv_det);
  t = __fmul_rn(fmaf(e2z, q2, fmaf(e2x, q0, __fmul_rn(e2y, q1))), inv_det);
  return ok_det && u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f &&
         __float_as_int(c.y) != 0;
}

// whether the ray may touch the (widened) box lo[3], hi[3] within
// [lo_t, hi_t], with a slack of 2^-16 |t| on both ends; true for a ray
// with a non-finite component, false for an empty box (lo > hi)
__device__ __forceinline__ bool may_touch(const Ray& r, const float* box,
                                          float lo_t, float hi_t) {
  if (box[0] > box[3]) return false;
  if (!r.finite) return true;
  float near = -kInf, far = kInf;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float a = (box[j] - r.o[j]) * r.inv[j];
    const float b = (box[3 + j] - r.o[j]) * r.inv[j];
    near = fmaxf(near, fminf(a, b));
    far = fminf(far, fmaxf(a, b));
  }
  hi_t += kSlack * fabsf(hi_t);
  lo_t -= kSlack * fabsf(lo_t);
  return !(near > far || near > hi_t || far < lo_t);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
mesh_trace_kernel(const float* __restrict__ rays, long long ray_stride,
                  long long n_rays, const float* __restrict__ tmin,
                  const float* __restrict__ tmax, float tmin0, float tmax0,
                  const float* __restrict__ v0, const float* __restrict__ e1,
                  const float* __restrict__ e2,
                  const long long* __restrict__ tri_id, int lanes_per_chunk,
                  int n_lanes, const float* __restrict__ groups,
                  float* __restrict__ t_out, long long* __restrict__ tri_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  unsigned char* __restrict__ occ_out,
                  unsigned long long* __restrict__ stats) {
  __shared__ float4 s_lane[kWindow][3];
  __shared__ float s_box[kGroups][6];

  const long long ray = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  Ray r;
  r.alive = ray < n_rays;
  r.finite = true;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r.o[j] = r.alive ? rays[ray * ray_stride + j] : 0.0f;
    r.d[j] = r.alive ? rays[ray * ray_stride + 3 + j] : 1.0f;
    r.finite = r.finite && isfinite(r.o[j]) && isfinite(r.d[j]);
    // `_slab`'s clamp of zero components to +-1e-12
    const float dj = fabsf(r.d[j]) < 1e-12f
                         ? (r.d[j] < 0.0f ? -1e-12f : 1e-12f) : r.d[j];
    r.inv[j] = 1.0f / dj;
  }
  r.tmin = !r.alive ? 0.0f : (tmin ? tmin[ray] : tmin0);
  r.tmax = !r.alive ? -kInf : (tmax ? tmax[ray] : tmax0);

  float best_t = kInf, best_u = 0.0f, best_v = 0.0f;
  int best_k = -1;
  bool done = false;   // occluded: a hit found
  const bool warp_live = __any_sync(kFull, r.alive);
  unsigned long long visits = 0, skips = 0;

  for (int base = 0; base < n_lanes; base += kWindow) {
    // every block walks on while one of its rays still looks
    if (!__syncthreads_or(r.alive && !done)) break;
    for (int i = threadIdx.x; i < kWindow; i += kThreads) {
      const int k = base + i;
      float x[9];
      int flag = 0;
      if (k < n_lanes) {
        const int c = k / lanes_per_chunk;
        const long long at = static_cast<long long>(c) * 3 *
                             lanes_per_chunk + (k - c * lanes_per_chunk);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          x[j] = __ldg(v0 + at + j * lanes_per_chunk);
          x[3 + j] = __ldg(e1 + at + j * lanes_per_chunk);
          x[6 + j] = __ldg(e2 + at + j * lanes_per_chunk);
        }
        flag = __ldg(tri_id + k) >= 0;
      } else {
#pragma unroll
        for (int j = 0; j < 9; ++j) x[j] = 0.0f;
      }
      s_lane[i][0] = make_float4(x[0], x[1], x[2], x[3]);
      s_lane[i][1] = make_float4(x[4], x[5], x[6], x[7]);
      s_lane[i][2] = make_float4(x[8], __int_as_float(flag), 0.0f, 0.0f);
    }
    if (groups != nullptr && threadIdx.x < kGroups * 6) {
      const int g = base / kGroup + threadIdx.x / 6;
      s_box[threadIdx.x / 6][threadIdx.x % 6] =
          g * kGroup < n_lanes ? __ldg(groups + g * 6 + threadIdx.x % 6)
                               : (threadIdx.x % 6 < 3 ? kInf : -kInf);
    }
    __syncthreads();

    const int end = min(kWindow, n_lanes - base);
    for (int g0 = 0; g0 < end; g0 += kGroup) {
      bool want = r.alive && !done;
      if (groups != nullptr && want)
        want = may_touch(r, s_box[g0 / kGroup], r.tmin,
                         kAnyHit ? r.tmax : fminf(r.tmax, best_t));
      const bool any = __any_sync(kFull, want);
      if (stats != nullptr && warp_live) {
        ++visits;
        skips += !any;
      }
      if (!any) continue;
      const int g1 = min(g0 + kGroup, end);
      for (int i = g0; i < g1; ++i) {
        float t, u, v;
        const bool hit = intersect(r, s_lane[i][0], s_lane[i][1],
                                   s_lane[i][2], t, u, v);
        if (hit && t >= r.tmin && t <= r.tmax) {
          if (kAnyHit) {
            done = true;
          } else if (t < best_t) {
            best_t = t;
            best_u = u;
            best_v = v;
            best_k = base + i;
          }
        }
      }
    }
  }

  if (stats != nullptr && warp_live && (threadIdx.x & 31) == 0) {
    atomicAdd(stats, visits);
    atomicAdd(stats + 1, skips);
  }
  if (!r.alive) return;
  if (kAnyHit) {
    occ_out[ray] = done;
  } else {
    t_out[ray] = best_t;
    tri_out[ray] = best_k >= 0 ? __ldg(tri_id + best_k) : -1;
    u_out[ray] = best_u;
    v_out[ray] = best_v;
  }
}

int check_and_launch(bool any_hit, const float* rays, long long ray_stride,
                     long long n_rays, const float* tmin, const float* tmax,
                     float tmin0, float tmax0, const float* v0,
                     const float* e1, const float* e2,
                     const long long* tri_id, int chunks, int lanes,
                     const float* groups, float* t, long long* tri, float* u,
                     float* v, unsigned char* occ, unsigned long long* stats,
                     void* stream) {
  const long long n_lanes = static_cast<long long>(chunks) * lanes;
  if (n_rays < 0 || ray_stride < 6 || chunks < 1 || lanes < 1 ||
      n_lanes > (1LL << 30) || (n_rays + kThreads - 1) / kThreads > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((n_rays + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (any_hit)
    mesh_trace_kernel<true><<<blocks, kThreads, 0, s>>>(
        rays, ray_stride, n_rays, tmin, tmax, tmin0, tmax0, v0, e1, e2,
        tri_id, lanes, static_cast<int>(n_lanes), groups, t, tri, u, v, occ,
        stats);
  else
    mesh_trace_kernel<false><<<blocks, kThreads, 0, s>>>(
        rays, ray_stride, n_rays, tmin, tmax, tmin0, tmax0, v0, e1, e2,
        tri_id, lanes, static_cast<int>(n_lanes), groups, t, tri, u, v, occ,
        stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rays: n_rays rows of [o, d] (f32), row i at rays + i * ray_stride; tmin,
// tmax: n_rays f32 each, or null for the scalars tmin0, tmax0; v0, e1, e2:
// the pack's (chunks, 3, lanes) f32 planes; tri_id: (chunks, lanes) int64;
// groups: (ceil(chunks * lanes / 32), 6) f32 boxes (lo xyz, hi xyz) or
// null (no skip); t, u, v: n_rays f32, tri: n_rays int64, written in full;
// stats: two zeroed uint64 or null.  All on the card.  Launches on
// `stream` without synchronising; returns the CUDA error.
extern "C" int gvrt_mesh_closest_hit(
    const float* rays, long long ray_stride, long long n_rays,
    const float* tmin, const float* tmax, float tmin0, float tmax0,
    const float* v0, const float* e1, const float* e2,
    const long long* tri_id, int chunks, int lanes, const float* groups,
    float* t, long long* tri, float* u, float* v, unsigned long long* stats,
    void* stream) {
  return check_and_launch(false, rays, ray_stride, n_rays, tmin, tmax, tmin0,
                          tmax0, v0, e1, e2, tri_id, chunks, lanes, groups,
                          t, tri, u, v, nullptr, stats, stream);
}

// As gvrt_mesh_closest_hit, with occ: n_rays bytes (torch.bool), each 1
// where a triangle lies at t in [tmin, tmax], else 0, written in full.
extern "C" int gvrt_mesh_occluded(
    const float* rays, long long ray_stride, long long n_rays,
    const float* tmin, const float* tmax, float tmin0, float tmax0,
    const float* v0, const float* e1, const float* e2,
    const long long* tri_id, int chunks, int lanes, const float* groups,
    unsigned char* occ, unsigned long long* stats, void* stream) {
  return check_and_launch(true, rays, ray_stride, n_rays, tmin, tmax, tmin0,
                          tmax0, v0, e1, e2, tri_id, chunks, lanes, groups,
                          nullptr, nullptr, nullptr, nullptr, occ, stats,
                          stream);
}
