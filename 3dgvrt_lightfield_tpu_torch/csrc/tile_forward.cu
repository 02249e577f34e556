// Fused per-tile forward composite for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `render/pallas_vjp.py::_fwd_kernel`
// (launched by `_forward_call`), whose per-chunk body is
// `render/tile_math.py::chunk_update`.  The plain PyTorch version of the same
// function is `render/pallas_forward.py::forward_tiles_reference`; the Python
// wrapper `tile_forward` in that module checks the inputs and launches this.
//
// What it computes: for every image tile t (R = tile_size^2 rays) it walks
// the tile's depth-sorted chunks of G Gaussians front to back and composites
// each (gaussian, ray) pair: prefolded local frame (gro = M o - b,
// grdu = M d), gray distance |grdu x gro|^2 / |grdu|^2, kernel response,
// alpha = min(max_alpha, resp * density), four accept gates (response,
// alpha_min, dot(grdu, gro) < 0, tmin <= t <= tmax), depth
// t = -dot(grdu, gro) / |grdu|^2, front-to-back transmittance T, weight
// alpha * T * (T > min_T) and SH radiance max(C . basis + 0.5, 0).
// Output per tile is the (8, R) block [r g b depth T hits 0 0].
//
// Design:
//   * One block per tile, one thread per ray (blockDim = R <= 1024).  Chunks
//     are laid out in tile order, so the wrapper hands each block the start
//     and count of its tile's contiguous chunk run: trailing dead chunks are
//     never visited, and no scalar-prefetch map or neighbour compare (TPU
//     devices) is needed.
//   * Each chunk's G x 64 f32 block (16 KB at G = 64, 32 KB at G = 128) is
//     staged in shared memory with coalesced 16-byte loads; every thread then
//     reads the same row per pair, a shared-memory broadcast.
//   * The ray's 24 rows (origin, direction, tmin, tmax, 16 SH basis values)
//     and its accumulator stay in registers for the whole tile.
//   * The per-ray running product is the sequential form of the TPU's
//     exclusive shift-tree cumprod; with transmittance_prod = false the
//     log-space form (exp of the running log1p sum, folded once per chunk)
//     is used instead.
//   * Before each chunk the block takes __syncthreads_or(T > min_T) and stops
//     when no ray of the tile is alive: the `alive` predicate of the Pallas
//     kernel.  Per-ray gating already zeroes later contributions, so the
//     skip changes time only.  A ray whose own T fell to min_T skips its
//     remaining pairs for the same reason.
//   * Every tile's block is written, tiles without chunks included (they get
//     the background [0 0 0 0 1 0 0 0]): the wrapper allocates with
//     torch.empty.
//
// Bound on this card: about 200 f32 operations (48 of them the SH products)
// and one exp per evaluated pair, against 470 MB of chunk reads for the whole
// bench plan (cap_pad ~ 1.84M slots, ~4.7e8 pair evaluations at R = 256), so
// the kernel is compute bound: ~1e11 f32 operations is ~1.4 ms at the H100's
// 67 TFLOP/s, the bytes ~0.14 ms at 3.35 TB/s.  The design meets that bound
// by keeping all per-pair operands in registers or broadcast shared memory
// and by doing no work for dead trailing chunks, saturated tiles or rays.
// Overlapping the chunk load with compute (cp.async / TMA double buffering)
// and tensor-core SH products (wgmma) are for later work.
//
// Numerics: IEEE division and expf/log1pf (no --use_fast_math), the gate
// chain without FMA contraction (see `mul`/`add` below); the
// 1 / max(n2, 1e-20) clamp keeps padding pairs (identity frame, density 0)
// finite.

#include <cuda_runtime.h>

namespace {

constexpr int kRayRows = 24;
constexpr int kAccRows = 8;
constexpr int kCols = 64;
constexpr int kColB = 9;
constexpr int kColDensity = 12;
constexpr int kColSh = 16;

// The gate chain (frame, gray distance, response, alpha, depth) is rounded
// op by op in the plain version's order, with no FMA contraction, so that a
// borderline gate (resp > hit_min_response, alpha > alpha_min, tmin <= t)
// falls the same way in the kernel and in its plain version.
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

struct Gates {
  float max_alpha, alpha_min, hit_min_response, min_t;
};

template <int DEG, bool PROD>
__global__ void __launch_bounds__(1024)
tile_forward_kernel(const float* __restrict__ chunks,
                    const float* __restrict__ rays,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_nchunks,
                    float* __restrict__ acc, int R, int G, Gates q) {
  extern __shared__ float4 smem4[];
  const float* sm = reinterpret_cast<const float*>(smem4);
  const int tile = blockIdx.x;
  const int r = threadIdx.x;

  const float* ray = rays + static_cast<size_t>(tile) * kRayRows * R + r;
  const float o0 = ray[0], o1 = ray[R], o2 = ray[2 * R];
  const float d0 = ray[3 * R], d1 = ray[4 * R], d2 = ray[5 * R];
  const float tmin = ray[6 * R], tmax = ray[7 * R];
  float basis[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) basis[j] = ray[(8 + j) * R];

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, dep = 0.0f, hits = 0.0f;
  const int first = tile_start[tile];
  const int nc = tile_nchunks[tile];
  const int n4 = G * (kCols / 4);

  for (int k = 0; k < nc; ++k) {
    // tile early-out; also the barrier before the block reuses the buffer
    if (!__syncthreads_or(T > q.min_t)) break;
    const float4* src = reinterpret_cast<const float4*>(
        chunks + static_cast<size_t>(first + k) * G * kCols);
    for (int i = r; i < n4; i += R) smem4[i] = src[i];
    __syncthreads();

    const float t_in = T;     // log-space form: T at the chunk start
    float cs = 0.0f;          // running log1p sum over accepted pairs
    float cs_act = 0.0f;      // the same over accepted, active pairs
    bool ray_alive = T > q.min_t;
    for (int g = 0; g < G && ray_alive; ++g) {
      const float* p = sm + g * kCols;
      const float gro0 = sub(dot3(p[0], p[1], p[2], o0, o1, o2), p[kColB + 0]);
      const float gro1 = sub(dot3(p[3], p[4], p[5], o0, o1, o2), p[kColB + 1]);
      const float gro2 = sub(dot3(p[6], p[7], p[8], o0, o1, o2), p[kColB + 2]);
      const float gu0 = dot3(p[0], p[1], p[2], d0, d1, d2);
      const float gu1 = dot3(p[3], p[4], p[5], d0, d1, d2);
      const float gu2 = dot3(p[6], p[7], p[8], d0, d1, d2);

      const float inv_n2 = 1.0f / fmaxf(dot3(gu0, gu1, gu2, gu0, gu1, gu2),
                                        1e-20f);
      const float c0 = sub(mul(gu1, gro2), mul(gu2, gro1));
      const float c1 = sub(mul(gu2, gro0), mul(gu0, gro2));
      const float c2 = sub(mul(gu0, gro1), mul(gu1, gro0));
      const float gray = mul(dot3(c0, c1, c2, c0, c1, c2), inv_n2);

      const float resp = particle_response<DEG>(gray);
      const float alpha = fminf(q.max_alpha, resp * p[kColDensity]);
      const float dot_og = dot3(gu0, gu1, gu2, gro0, gro1, gro2);
      const float t = -dot_og * inv_n2;
      const bool accept = resp > q.hit_min_response && alpha > q.alpha_min &&
                          dot_og < 0.0f && t >= tmin && t <= tmax;
      if (!accept) continue;  // alpha_eff = 0: T and the sums are unchanged

      float t_before;
      if (PROD) {
        t_before = T;
      } else {
        const float la = log1pf(-alpha);
        t_before = t_in * expf(cs);
        cs += la;
        if (t_before > q.min_t) cs_act += la;
      }
      if (!(t_before > q.min_t)) {
        ray_alive = false;  // T only falls: no later pair of this ray counts
        continue;
      }
      const float w = alpha * t_before;
      if (PROD) {
        T = t_before * (1.0f - alpha);
        ray_alive = T > q.min_t;
      }

      const float* sh = p + kColSh;
      float rr = 0.5f, rg = 0.5f, rb = 0.5f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        rr += sh[j] * basis[j];
        rg += sh[16 + j] * basis[j];
        rb += sh[32 + j] * basis[j];
      }
      cr += w * fmaxf(rr, 0.0f);
      cg += w * fmaxf(rg, 0.0f);
      cb += w * fmaxf(rb, 0.0f);
      dep += w * t;
      hits += 1.0f;
    }
    if (!PROD) T = t_in * expf(cs_act);
  }

  float* out = acc + static_cast<size_t>(tile) * kAccRows * R + r;
  out[0] = cr;
  out[R] = cg;
  out[2 * R] = cb;
  out[3 * R] = dep;
  out[4 * R] = T;
  out[5 * R] = hits;
  out[6 * R] = 0.0f;
  out[7 * R] = 0.0f;
}

template <int DEG>
void launch(bool prod, int num_tiles, int R, int G, size_t smem,
            cudaStream_t stream, const float* chunks, const float* rays,
            const int* tile_start, const int* tile_nchunks, float* acc,
            Gates q) {
  if (prod) {
    tile_forward_kernel<DEG, true><<<num_tiles, R, smem, stream>>>(
        chunks, rays, tile_start, tile_nchunks, acc, R, G, q);
  } else {
    tile_forward_kernel<DEG, false><<<num_tiles, R, smem, stream>>>(
        chunks, rays, tile_start, tile_nchunks, acc, R, G, q);
  }
}

}  // namespace

// chunks (C, G, 64) f32, rays (num_tiles, 24, R) f32, tile_start and
// tile_nchunks (num_tiles,) i32, acc (num_tiles, 8, R) f32; all contiguous
// device memory.  Returns cudaGetLastError() after the launch.
extern "C" int gvrt_tile_forward(const float* chunks, const float* rays,
                                 const int* tile_start,
                                 const int* tile_nchunks, float* acc,
                                 int num_tiles, int R, int G,
                                 int kernel_degree, float max_alpha,
                                 float alpha_min, float hit_min_response,
                                 float min_transmittance,
                                 int transmittance_prod, void* stream) {
  if (num_tiles <= 0) return 0;
  const Gates q{max_alpha, alpha_min, hit_min_response, min_transmittance};
  const size_t smem = static_cast<size_t>(G) * kCols * sizeof(float);
  const bool prod = transmittance_prod != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel_degree) {
    case 8:
      launch<8>(prod, num_tiles, R, G, smem, s, chunks, rays, tile_start,
                tile_nchunks, acc, q);
      break;
    case 5:
      launch<5>(prod, num_tiles, R, G, smem, s, chunks, rays, tile_start,
                tile_nchunks, acc, q);
      break;
    case 4:
      launch<4>(prod, num_tiles, R, G, smem, s, chunks, rays, tile_start,
                tile_nchunks, acc, q);
      break;
    case 3:
      launch<3>(prod, num_tiles, R, G, smem, s, chunks, rays, tile_start,
                tile_nchunks, acc, q);
      break;
    case 1:
      launch<1>(prod, num_tiles, R, G, smem, s, chunks, rays, tile_start,
                tile_nchunks, acc, q);
      break;
    case 0:
      launch<0>(prod, num_tiles, R, G, smem, s, chunks, rays, tile_start,
                tile_nchunks, acc, q);
      break;
    default:
      launch<-1>(prod, num_tiles, R, G, smem, s, chunks, rays, tile_start,
                 tile_nchunks, acc, q);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
