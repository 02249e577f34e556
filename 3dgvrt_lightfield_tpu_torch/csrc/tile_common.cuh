// Per-pair math shared by the forward tile kernel (tile_forward.cu, K1) and
// the backward tile kernel (tile_backward.cu, K2).
//
// Both kernels evaluate the same (gaussian, ray) gate chain: the prefolded
// local frame (gro = M o - b, grdu = M d), the gray distance
// |grdu x gro|^2 / |grdu|^2, the kernel response, alpha, the depth
// t = -dot(grdu, gro) / |grdu|^2 and the accept gates.  K2 recomputes the
// forward from the saved per-chunk transmittance, so a gate that fell one
// way in K1 must fall the same way in K2, or K2 differentiates another
// function.  Keeping the chain in one header, rounded op by op
// (`mul`/`add`/`sub`: no FMA contraction, in the plain PyTorch version's
// order), makes that hold by construction.
//
// Mirrors render/tile_math.py::chunk_core and ops/kernels.py
// (particle_response, particle_response_grad).

#pragma once

#include <cuda_runtime.h>

namespace gvrt {

constexpr int kRayRows = 24;
constexpr int kAccRows = 8;
constexpr int kCols = 64;
constexpr int kColB = 9;
constexpr int kColDensity = 12;
constexpr int kColSh = 16;
constexpr int kAccT = 4;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// particle_response (ops/kernels.py); DEG = -1 is the quadratic default.
template <int DEG>
__device__ __forceinline__ float particle_response(float gd) {
  if (DEG == 8) {
    const float d2 = gd * gd;
    return expf(-0.000685871056241f * d2 * d2);
  }
  if (DEG == 5) return expf(-0.0185185185185f * gd * gd * sqrtf(gd));
  if (DEG == 4) return expf(-0.0555555555556f * gd * gd);
  if (DEG == 3) return expf(-0.166666666667f * gd * sqrtf(gd));
  if (DEG == 1) return expf(-1.5f * sqrtf(gd));
  if (DEG == 0) return fmaxf(add(1.0f, mul(-0.329630334487f, sqrtf(gd))), 0.0f);
  return expf(-0.5f * gd);
}

// d particle_response / d gray_dist given the response (ops/kernels.py
// particle_response_grad); a gradient value, not a gate, so FMAs are fine.
template <int DEG>
__device__ __forceinline__ float particle_response_grad(float gd, float resp) {
  if (DEG == 8) return resp * -0.000685871056241f * 4.0f * (gd * gd) * gd;
  if (DEG == 5) return resp * -0.0185185185185f * 2.5f * gd * sqrtf(gd);
  if (DEG == 4) return resp * -0.0555555555556f * 2.0f * gd;
  if (DEG == 3) return resp * -0.166666666667f * 1.5f * sqrtf(gd);
  if (DEG == 1) return resp * -1.5f * 0.5f / sqrtf(fmaxf(gd, 1e-20f));
  if (DEG == 0) {
    const float root = sqrtf(fmaxf(gd, 1e-20f));
    return add(1.0f, mul(-0.329630334487f, root)) > 0.0f
               ? -0.329630334487f * 0.5f / root
               : 0.0f;
  }
  return -0.5f * resp;
}

struct Gates {
  float max_alpha, alpha_min, hit_min_response, min_t;
};

// One ray's 8 geometry rows and 16 SH basis rows, kept in registers.
struct Ray {
  float o0, o1, o2, d0, d1, d2, tmin, tmax;
  float basis[16];
};

// rays (num_tiles, 24, R): ray r of the tile block starting at `blk`
__device__ __forceinline__ void load_ray(const float* blk, int R, int r,
                                         Ray& ray) {
  const float* p = blk + r;
  ray.o0 = p[0];
  ray.o1 = p[R];
  ray.o2 = p[2 * R];
  ray.d0 = p[3 * R];
  ray.d1 = p[4 * R];
  ray.d2 = p[5 * R];
  ray.tmin = p[6 * R];
  ray.tmax = p[7 * R];
#pragma unroll
  for (int j = 0; j < 16; ++j) ray.basis[j] = p[(8 + j) * R];
}

// The forward gate chain of one (gaussian, ray) pair; `p` is the
// gaussian's 64-column row.  K1 reads accept/alpha/t, K2 every field.
struct Pair {
  float gro0, gro1, gro2, gu0, gu1, gu2;
  float nrm2, inv_n2, c0, c1, c2, cc, gray, resp, ra, alpha, dot_og, t;
  bool accept;
};

template <int DEG>
__device__ __forceinline__ Pair eval_pair(const float* p, const Ray& ray,
                                          const Gates& q) {
  Pair e;
  e.gro0 = sub(dot3(p[0], p[1], p[2], ray.o0, ray.o1, ray.o2), p[kColB + 0]);
  e.gro1 = sub(dot3(p[3], p[4], p[5], ray.o0, ray.o1, ray.o2), p[kColB + 1]);
  e.gro2 = sub(dot3(p[6], p[7], p[8], ray.o0, ray.o1, ray.o2), p[kColB + 2]);
  e.gu0 = dot3(p[0], p[1], p[2], ray.d0, ray.d1, ray.d2);
  e.gu1 = dot3(p[3], p[4], p[5], ray.d0, ray.d1, ray.d2);
  e.gu2 = dot3(p[6], p[7], p[8], ray.d0, ray.d1, ray.d2);
  e.nrm2 = dot3(e.gu0, e.gu1, e.gu2, e.gu0, e.gu1, e.gu2);
  e.inv_n2 = 1.0f / fmaxf(e.nrm2, 1e-20f);
  e.c0 = sub(mul(e.gu1, e.gro2), mul(e.gu2, e.gro1));
  e.c1 = sub(mul(e.gu2, e.gro0), mul(e.gu0, e.gro2));
  e.c2 = sub(mul(e.gu0, e.gro1), mul(e.gu1, e.gro0));
  e.cc = dot3(e.c0, e.c1, e.c2, e.c0, e.c1, e.c2);
  e.gray = mul(e.cc, e.inv_n2);
  e.resp = particle_response<DEG>(e.gray);
  e.ra = e.resp * p[kColDensity];
  e.alpha = fminf(q.max_alpha, e.ra);
  e.dot_og = dot3(e.gu0, e.gu1, e.gu2, e.gro0, e.gro1, e.gro2);
  e.t = -e.dot_og * e.inv_n2;
  e.accept = e.resp > q.hit_min_response && e.alpha > q.alpha_min &&
             e.dot_og < 0.0f && e.t >= ray.tmin && e.t <= ray.tmax;
  return e;
}

// SH radiance before the clamp, rad_c = C_c . basis + 0.5, per channel
__device__ __forceinline__ void sh_radiance(const float* p, const Ray& ray,
                                            float& rr, float& rg, float& rb) {
  const float* sh = p + kColSh;
  rr = 0.5f;
  rg = 0.5f;
  rb = 0.5f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    rr += sh[j] * ray.basis[j];
    rg += sh[16 + j] * ray.basis[j];
    rb += sh[32 + j] * ray.basis[j];
  }
}

// Stage one chunk's G x 64 block into shared memory with 16-byte loads.
__device__ __forceinline__ void stage_chunk(float4* dst, const float* chunks,
                                            int chunk, int G) {
  const float4* src =
      reinterpret_cast<const float4*>(chunks + static_cast<size_t>(chunk) * G * kCols);
  const int n4 = G * (kCols / 4);
  for (int i = threadIdx.x; i < n4; i += blockDim.x) dst[i] = src[i];
}

// Chunks [start[T-1] + count[T-1], C) belong to no tile's run (the dead
// trailing chunks of the capacity); runs are contiguous from chunk 0.
__device__ __forceinline__ int first_dead_chunk(const int* tile_start,
                                                const int* tile_nchunks,
                                                int num_tiles, int C) {
  if (num_tiles == 0) return 0;
  const int end = tile_start[num_tiles - 1] + tile_nchunks[num_tiles - 1];
  return end < C ? end : C;
}

}  // namespace gvrt
