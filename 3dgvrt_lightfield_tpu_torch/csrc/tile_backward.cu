// Fused per-tile backward of the tile composite for Hopper (sm_90a): K2.
//
// Replaces the JAX package's Pallas kernel `render/pallas_vjp.py::_bwd_kernel`
// (launched by `_render_bwd`), whose per-chunk body is
// `render/tile_math.py::chunk_core_bwd`.  The plain PyTorch version of the
// same function is `render/pallas_vjp.py::_backward_plain`; the Python
// wrapper `tile_backward` in that module checks the inputs and launches this.
//
// What it computes: given the chunks, the rays, the forward's T_in residual
// (the transmittance at the start of every chunk, written by K1's residual
// variant) and the cotangent bar_acc of the (num_tiles, 8, R) accumulators,
// it walks every tile's chunk run from its last chunk to its first, carrying
// bar_T (the cotangent of the transmittance) from chunk to chunk, and emits
//   * bar_chunks (C, G, 64): per chunk row g the 64 parameter-column
//     cotangents summed over the tile's R rays (9 M, 3 b, density, 3 zeros,
//     48 SH), the chain rule of `chunk_core` back through alpha, the kernel
//     response, the gray distance, the depth and the local frame;
//   * with ray_gradients, bar_rays (num_tiles, 24, R): each ray's own
//     cotangents (o, d, two zero gate rows, 16 SH basis rows) summed over
//     its tile's chunks; tiles without chunks get zeros.
// Chunks whose tile was saturated at their start (max T_in <= min_T) get
// zero blocks and leave bar_T as it is (the forward skipped them), and the
// dead trailing chunks no run owns get zero blocks from kTailBlocks extra
// blocks, so bar_chunks is defined memory everywhere (the gradient reduce
// K3 gathers any row of it).
//
// Design:
//   * One block per tile, one thread per ray (blockDim = R rounded up to a
//     warp; the extra lanes carry no ray).  bar_T, the ray's rows and the
//     ray-cotangent sums stay in registers.
//   * Per chunk, two passes over its G gaussians, with the chunk staged in
//     shared memory as in K1.  Pass 1 recomputes the forward transmittance
//     front to back from T_in and stores each accepted pair's exclusive
//     state (the running product P of (1 - alpha), or the running log1p sum
//     in the log-space form) in shared memory: G x R x 4 bytes, 64 KB at
//     the defaults.  The suffix sums of the transmittance chain need those
//     values in reverse order; dividing them back out of T_out would not
//     reproduce the forward's `active` gates.  Pass 2 walks the gaussians
//     in reverse, carrying the suffix sum in a register.
//   * The gate chain is `eval_pair` of tile_common.cuh, shared with K1 and
//     rounded op by op, and t_before = T_in * P is formed as K1 forms it, so
//     every accept and active gate falls in K2 as it fell in K1.
//   * The per-gaussian column sums over rays are deterministic: a warp
//     shuffle butterfly per column (skipped for a warp none of whose rays
//     composited the gaussian), then the warps' partials, staged in shared
//     memory for a batch of kBatch gaussians, summed in warp order.  No
//     float atomics: two runs give the same bits.
//
// Bound on this card: the work is data dependent.  For every pair the
// forward recompute (~72 f32 operations, once per pass), and for every
// composited pair ~360 more (SH radiance, the backward chain, 61 column
// products and their sums); the bytes are the chunk rows of the visited
// runs plus T_in, rays and outputs.  At the bench frame that is compute
// bound.  This first version is simple: the shuffle reductions, the second
// forward recompute and the unoverlapped chunk staging are where a faster
// one would start (tensor-core column sums, cp.async staging).
//
// Numerics: IEEE division, expf/log1pf (no --use_fast_math); the gate chain
// without FMA contraction; the backward chain itself with FMAs.

#include "tile_common.cuh"

namespace {

using namespace gvrt;

//: blocks after the tile blocks that zero the dead trailing chunks
constexpr int kTailBlocks = 32;
//: gaussians per reduction batch (warp partials staged in shared memory)
constexpr int kBatch = 8;
constexpr int kMaxThreads = 512;
//: nonzero geometry columns: 9 M, 3 b, density
constexpr int kGeomCols = 13;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // the same bits in every lane (addition commutes)
}

__device__ __forceinline__ void zero_rows(float* dst, int n) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = z;
}

template <int DEG, bool PROD, bool RAYG>
__global__ void __launch_bounds__(kMaxThreads)
tile_backward_kernel(const float* __restrict__ chunks,
                     const float* __restrict__ rays,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_nchunks,
                     const float* __restrict__ t_in,
                     const float* __restrict__ bar_acc,
                     float* __restrict__ bar_chunks,
                     float* __restrict__ bar_rays, int num_tiles,
                     int num_chunks, int R, int G, Gates q) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);   // staged chunk, G x 64
  float* xs = sm + G * kCols;                    // exclusive state, G x R
  float* part = xs + G * R;                      // nwarps x kBatch x 64
  __shared__ int s_nlive;

  const int chunk_elems = G * kCols;
  if (static_cast<int>(blockIdx.x) >= num_tiles) {
    const int dead0 = first_dead_chunk(tile_start, tile_nchunks, num_tiles,
                                       num_chunks);
    for (int c = dead0 + static_cast<int>(blockIdx.x) - num_tiles; c < num_chunks;
         c += kTailBlocks)
      zero_rows(bar_chunks + static_cast<size_t>(c) * chunk_elems,
                chunk_elems);
    return;
  }

  const int tile = static_cast<int>(blockIdx.x);
  const int r = threadIdx.x;
  const bool valid = r < R;
  const int lane = r & 31;
  const int warp = r >> 5;
  const int nwarps = blockDim.x >> 5;

  Ray ray = {};
  float bar_T = 0.0f, bar_r = 0.0f, bar_g = 0.0f, bar_b = 0.0f,
        bar_dep = 0.0f;
  if (valid) {
    load_ray(rays + static_cast<size_t>(tile) * kRayRows * R, R, r, ray);
    const float* ba = bar_acc + static_cast<size_t>(tile) * kAccRows * R + r;
    bar_r = ba[0];
    bar_g = ba[R];
    bar_b = ba[2 * R];
    bar_dep = ba[3 * R];
    bar_T = ba[kAccT * R];
  }
  float bo[3] = {0.0f, 0.0f, 0.0f}, bd[3] = {0.0f, 0.0f, 0.0f};
  float bbasis[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) bbasis[j] = 0.0f;

  const int first = tile_start[tile];
  const int nc = tile_nchunks[tile];
  for (int k = nc - 1; k >= 0; --k) {
    const int chunk = first + k;
    float* out = bar_chunks + static_cast<size_t>(chunk) * chunk_elems;
    const float tin = valid ? t_in[static_cast<size_t>(chunk) * R + r] : 0.0f;
    // the forward's `alive` predicate; also the barrier before the block
    // reuses its shared buffers
    if (!__syncthreads_or(valid && tin > q.min_t)) {
      zero_rows(out, chunk_elems);
      continue;
    }
    stage_chunk(smem4, chunks, chunk, G);
    if (r == 0) s_nlive = 0;
    __syncthreads();

    // ---- pass 1: forward transmittance, front to back (as K1) ----
    float P = 1.0f, cs = 0.0f, cs_act = 0.0f;
    int n_live = 0;  // one past the last composited pair of this ray
    bool alive = valid && tin > q.min_t;
    for (int g = 0; g < G && alive; ++g) {
      const Pair e = eval_pair<DEG>(sm + g * kCols, ray, q);
      if (!e.accept) continue;
      float state, t_before;
      if (PROD) {
        state = P;
        t_before = tin * P;
      } else {
        const float la = log1pf(-e.alpha);
        state = cs;
        t_before = tin * expf(cs);
        cs += la;
        if (t_before > q.min_t) cs_act += la;
      }
      if (!(t_before > q.min_t)) {
        alive = false;
        continue;
      }
      xs[g * R + r] = state;
      if (PROD) P = P * (1.0f - e.alpha);
      n_live = g + 1;
    }
    const float m_tot = PROD ? P : expf(cs_act);  // T_out / T_in
    if (n_live) atomicMax(&s_nlive, n_live);       // integer max: exact
    __syncthreads();
    const int nlive_blk = s_nlive;
    // rows no ray composited
    for (int i = nlive_blk * kCols + r; i < chunk_elems; i += blockDim.x)
      out[i] = 0.0f;

    // ---- pass 2: reverse over the composited prefix ----
    float bar_tin = bar_T * m_tot;
    const float bar_m = bar_T * tin;          // PROD: d/d m_tot
    const float bar_s = bar_T * tin * m_tot;  // log-space: d/d sum(la)
    float S = 0.0f;  // suffix sum over later pairs of this ray
    for (int gb_end = nlive_blk; gb_end > 0; gb_end -= kBatch) {
      const int gb0 = gb_end > kBatch ? gb_end - kBatch : 0;
      for (int g = gb_end - 1; g >= gb0; --g) {
        const float* p = sm + g * kCols;
        float geo[kGeomCols];
#pragma unroll
        for (int j = 0; j < kGeomCols; ++j) geo[j] = 0.0f;
        float bp0 = 0.0f, bp1 = 0.0f, bp2 = 0.0f;
        bool contrib = false;
        if (g < n_live) {
          const Pair e = eval_pair<DEG>(p, ray, q);
          if (e.accept) {  // accepted below n_live: active in pass 1
            contrib = true;
            const float state = xs[g * R + r];
            const float ece = PROD ? state : expf(state);
            const float t_before = tin * ece;
            const float alpha = e.alpha;
            const float w = alpha * t_before;
            float rr, rg, rb;
            sh_radiance(p, ray, rr, rg, rb);
            const float bar_w = bar_dep * e.t + bar_r * fmaxf(rr, 0.0f) +
                                bar_g * fmaxf(rg, 0.0f) +
                                bar_b * fmaxf(rb, 0.0f);
            bp0 = rr > 0.0f ? bar_r * w : 0.0f;
            bp1 = rg > 0.0f ? bar_g * w : 0.0f;
            bp2 = rb > 0.0f ? bar_b * w : 0.0f;
            const float bar_t = bar_dep * w;
            float bar_ae = bar_w * t_before;
            const float bar_tb = bar_w * alpha;
            bar_tin += bar_tb * ece;
            if (PROD) {
              // prod_excl_g = prod_{g'<g} u: bar_u_g = (sum_{g''>g} bar_tb
              // t_before + bar_m m_tot) / u_g, with u >= 1 - max_alpha
              const float pp = bar_tb * tin * ece;
              bar_ae -= (S + bar_m * m_tot) / (1.0f - alpha);
              S += pp;
            } else {
              const float bar_ce = bar_tb * tin * ece;
              bar_ae -= (S + bar_s) / (1.0f - alpha);
              S += bar_ce;
            }
            const bool notclamped = e.ra <= q.max_alpha;
            const float bar_resp = notclamped ? bar_ae * p[kColDensity] : 0.0f;
            geo[12] = notclamped ? bar_ae * e.resp : 0.0f;
            const float bar_gd =
                bar_resp * particle_response_grad<DEG>(e.gray, e.resp);
            const float bar_cc = bar_gd * e.inv_n2;
            const float bar_un2 = bar_gd * e.cc - bar_t * e.dot_og;
            const float bar_dog = -bar_t * e.inv_n2;
            const float bc0 = 2.0f * e.c0 * bar_cc;
            const float bc1 = 2.0f * e.c1 * bar_cc;
            const float bc2 = 2.0f * e.c2 * bar_cc;
            const float bar_n2 =
                e.nrm2 >= 1e-20f ? -e.inv_n2 * e.inv_n2 * bar_un2 : 0.0f;
            const float bgu0 = -bc1 * e.gro2 + bc2 * e.gro1 + bar_dog * e.gro0 +
                               2.0f * e.gu0 * bar_n2;
            const float bgu1 = bc0 * e.gro2 - bc2 * e.gro0 + bar_dog * e.gro1 +
                               2.0f * e.gu1 * bar_n2;
            const float bgu2 = -bc0 * e.gro1 + bc1 * e.gro0 + bar_dog * e.gro2 +
                               2.0f * e.gu2 * bar_n2;
            const float bgo0 = bc1 * e.gu2 - bc2 * e.gu1 + bar_dog * e.gu0;
            const float bgo1 = -bc0 * e.gu2 + bc2 * e.gu0 + bar_dog * e.gu1;
            const float bgo2 = bc0 * e.gu1 - bc1 * e.gu0 + bar_dog * e.gu2;
            const float bgo[3] = {bgo0, bgo1, bgo2};
            const float bgu[3] = {bgu0, bgu1, bgu2};
            const float o[3] = {ray.o0, ray.o1, ray.o2};
            const float d[3] = {ray.d0, ray.d1, ray.d2};
#pragma unroll
            for (int i = 0; i < 3; ++i) {
#pragma unroll
              for (int j = 0; j < 3; ++j)
                geo[3 * i + j] = bgo[i] * o[j] + bgu[i] * d[j];
              geo[9 + i] = -bgo[i];
            }
            if (RAYG) {
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                bo[j] += p[j] * bgo0 + p[3 + j] * bgo1 + p[6 + j] * bgo2;
                bd[j] += p[j] * bgu0 + p[3 + j] * bgu1 + p[6 + j] * bgu2;
              }
              const float* sh = p + kColSh;
#pragma unroll
              for (int j = 0; j < 16; ++j)
                bbasis[j] += sh[j] * bp0 + sh[16 + j] * bp1 + sh[32 + j] * bp2;
            }
          }
        }
        // sum the 64 columns over the warp's rays
        float* pw = part + (warp * kBatch + (g - gb0)) * kCols;
        if (__ballot_sync(0xffffffffu, contrib) == 0) {
          pw[lane] = 0.0f;
          pw[lane + 32] = 0.0f;
        } else {
#pragma unroll
          for (int j = 0; j < kGeomCols; ++j) {
            const float v = warp_sum(geo[j]);
            if (lane == 0) pw[j] = v;
          }
          if (lane < 3) pw[kGeomCols + lane] = 0.0f;
          const float bps[3] = {bp0, bp1, bp2};
#pragma unroll
          for (int c = 0; c < 3; ++c) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const float v = warp_sum(bps[c] * ray.basis[j]);
              if (lane == 0) pw[kColSh + 16 * c + j] = v;
            }
          }
        }
      }
      __syncthreads();
      // the warps' partials, summed in warp order
      const int n = (gb_end - gb0) * kCols;
      for (int i = r; i < n; i += blockDim.x) {
        float s = 0.0f;
        for (int w = 0; w < nwarps; ++w) s += part[w * kBatch * kCols + i];
        out[gb0 * kCols + i] = s;
      }
      __syncthreads();
    }
    bar_T = bar_tin;
  }

  if (RAYG && valid) {
    float* br = bar_rays + static_cast<size_t>(tile) * kRayRows * R + r;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      br[j * R] = bo[j];
      br[(3 + j) * R] = bd[j];
    }
    br[6 * R] = 0.0f;
    br[7 * R] = 0.0f;
#pragma unroll
    for (int j = 0; j < 16; ++j) br[(8 + j) * R] = bbasis[j];
  }
}

template <int DEG, bool PROD, bool RAYG>
int launch3(dim3 grid, int threads, size_t smem, cudaStream_t stream,
            const float* chunks, const float* rays, const int* tile_start,
            const int* tile_nchunks, const float* t_in, const float* bar_acc,
            float* bar_chunks, float* bar_rays, int num_tiles,
            int num_chunks, int R, int G, Gates q) {
  auto kernel = tile_backward_kernel<DEG, PROD, RAYG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(chunks, rays, tile_start,
                                          tile_nchunks, t_in, bar_acc,
                                          bar_chunks, bar_rays, num_tiles,
                                          num_chunks, R, G, q);
  return static_cast<int>(cudaGetLastError());
}

template <int DEG>
int launch(bool prod, bool rayg, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, const float* chunks, const float* rays,
           const int* tile_start, const int* tile_nchunks, const float* t_in,
           const float* bar_acc, float* bar_chunks, float* bar_rays,
           int num_tiles, int num_chunks, int R, int G, Gates q) {
#define GVRT_ARGS                                                            \
  grid, threads, smem, stream, chunks, rays, tile_start, tile_nchunks, t_in, \
      bar_acc, bar_chunks, bar_rays, num_tiles, num_chunks, R, G, q
  if (prod) {
    return rayg ? launch3<DEG, true, true>(GVRT_ARGS)
                : launch3<DEG, true, false>(GVRT_ARGS);
  }
  return rayg ? launch3<DEG, false, true>(GVRT_ARGS)
              : launch3<DEG, false, false>(GVRT_ARGS);
#undef GVRT_ARGS
}

}  // namespace

// Shared memory K2 needs per block: the staged chunk, the per-pair state
// and the warp partials.  The wrapper checks it against the card's limit.
extern "C" int gvrt_tile_backward_smem(int R, int G) {
  const int threads = (R + 31) / 32 * 32;
  return static_cast<int>(sizeof(float)) *
         (G * kCols + G * R + (threads / 32) * kBatch * kCols);
}

// chunks (C, G, 64) f32, rays (num_tiles, 24, R) f32, tile_start and
// tile_nchunks (num_tiles,) i32, t_in (C, R) f32 from K1's residual
// variant, bar_acc (num_tiles, 8, R) f32 -> bar_chunks (C, G, 64) f32 and,
// when bar_rays is not null (ray_gradients), bar_rays (num_tiles, 24, R)
// f32.  All contiguous device memory; R <= 512.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int gvrt_tile_backward(const float* chunks, const float* rays,
                                  const int* tile_start,
                                  const int* tile_nchunks, const float* t_in,
                                  const float* bar_acc, float* bar_chunks,
                                  float* bar_rays, int num_tiles,
                                  int num_chunks, int R, int G,
                                  int kernel_degree, float max_alpha,
                                  float alpha_min, float hit_min_response,
                                  float min_transmittance,
                                  int transmittance_prod, void* stream) {
  if (num_tiles <= 0 && num_chunks <= 0) return 0;
  const Gates q{max_alpha, alpha_min, hit_min_response, min_transmittance};
  const int threads = (R + 31) / 32 * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(gvrt_tile_backward_smem(R, G));
  const bool prod = transmittance_prod != 0;
  const bool rayg = bar_rays != nullptr;
  const dim3 grid(num_tiles + kTailBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GVRT_LAUNCH(D)                                                       \
  launch<D>(prod, rayg, grid, threads, smem, s, chunks, rays, tile_start,    \
            tile_nchunks, t_in, bar_acc, bar_chunks, bar_rays, num_tiles,    \
            num_chunks, R, G, q)
  switch (kernel_degree) {
    case 8: return GVRT_LAUNCH(8);
    case 5: return GVRT_LAUNCH(5);
    case 4: return GVRT_LAUNCH(4);
    case 3: return GVRT_LAUNCH(3);
    case 1: return GVRT_LAUNCH(1);
    case 0: return GVRT_LAUNCH(0);
    default: return GVRT_LAUNCH(-1);
  }
#undef GVRT_LAUNCH
}
