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
//   * Within a chunk, t_before = t_in * P with P the per-ray running
//     product of (1 - alpha): the sequential form of the TPU's exclusive
//     shift-tree cumprod, and the product the plain version's cumprod and
//     K2's recompute form.  With transmittance_prod = false the log-space
//     form (exp of the running log1p sum, folded once per chunk) is used.
//   * Before each chunk the block takes __syncthreads_or(T > min_T) and stops
//     when no ray of the tile is alive: the `alive` predicate of the Pallas
//     kernel.  Per-ray gating already zeroes later contributions, so the
//     skip changes time only.  A ray whose own T fell to min_T skips its
//     remaining pairs for the same reason.
//   * Every tile's block is written, tiles without chunks included (they get
//     the background [0 0 0 0 1 0 0 0]): the wrapper allocates with
//     torch.empty.
//   * Training's residual variant (t_in != null, the `tin_ref` output of the
//     Pallas kernel) also writes T_in (C, R), the transmittance at the start
//     of every chunk: for each chunk of a tile's run, the ones after the
//     early-out included (they get the saturated T), and, from kTailBlocks
//     extra blocks, 1 for the dead trailing chunks no run owns.  Every entry
//     is defined, so the backward kernel K2 may read any of them.
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
// chain without FMA contraction (`eval_pair` in tile_common.cuh, shared with
// K2); the
// 1 / max(n2, 1e-20) clamp keeps padding pairs (identity frame, density 0)
// finite.

#include "tile_common.cuh"

namespace {

using namespace gvrt;

//: blocks after the tile blocks that write T_in = 1 for the dead trailing
//: chunks (the residual variant only)
constexpr int kTailBlocks = 32;

template <int DEG, bool PROD>
__global__ void __launch_bounds__(1024)
tile_forward_kernel(const float* __restrict__ chunks,
                    const float* __restrict__ rays,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_nchunks,
                    float* __restrict__ acc, float* __restrict__ t_in_out,
                    int num_tiles, int num_chunks, int R, int G, Gates q) {
  extern __shared__ float4 smem4[];
  const float* sm = reinterpret_cast<const float*>(smem4);
  const int r = threadIdx.x;
  if (static_cast<int>(blockIdx.x) >= num_tiles) {
    // residual variant: dead trailing chunks are in no run; they get the
    // transmittance of a tile no chunk reached, so T_in is defined memory
    const int dead0 = first_dead_chunk(tile_start, tile_nchunks, num_tiles,
                                       num_chunks);
    for (int c = dead0 + static_cast<int>(blockIdx.x) - num_tiles; c < num_chunks;
         c += kTailBlocks)
      t_in_out[static_cast<size_t>(c) * R + r] = 1.0f;
    return;
  }
  const int tile = static_cast<int>(blockIdx.x);

  Ray ray;
  load_ray(rays + static_cast<size_t>(tile) * kRayRows * R, R, r, ray);

  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, dep = 0.0f, hits = 0.0f;
  const int first = tile_start[tile];
  const int nc = tile_nchunks[tile];

  int k = 0;
  for (; k < nc; ++k) {
    // tile early-out; also the barrier before the block reuses the buffer
    if (!__syncthreads_or(T > q.min_t)) break;
    if (t_in_out) t_in_out[static_cast<size_t>(first + k) * R + r] = T;
    stage_chunk(smem4, chunks, first + k, G);
    __syncthreads();

    // t_before = t_in * P with P the running exclusive product of
    // (1 - alpha) (PROD) or exp of the running log1p sum (log-space), as
    // in the plain version: both kernels and the plain version form the
    // same product, so the active gate falls alike
    const float t_in = T;
    float P = 1.0f;           // PROD: prod of (1 - alpha) over accepted pairs
    float cs = 0.0f;          // log-space: running log1p sum
    float cs_act = 0.0f;      // the same over accepted, active pairs
    bool ray_alive = T > q.min_t;
    for (int g = 0; g < G && ray_alive; ++g) {
      const float* p = sm + g * kCols;
      const Pair e = eval_pair<DEG>(p, ray, q);
      if (!e.accept) continue;  // alpha_eff = 0: T and the sums are unchanged

      float t_before;
      if (PROD) {
        t_before = t_in * P;
      } else {
        const float la = log1pf(-e.alpha);
        t_before = t_in * expf(cs);
        cs += la;
        if (t_before > q.min_t) cs_act += la;
      }
      if (!(t_before > q.min_t)) {
        ray_alive = false;  // T only falls: no later pair of this ray counts
        continue;
      }
      const float w = e.alpha * t_before;
      if (PROD) P = P * (1.0f - e.alpha);

      float rr, rg, rb;
      sh_radiance(p, ray, rr, rg, rb);
      cr += w * fmaxf(rr, 0.0f);
      cg += w * fmaxf(rg, 0.0f);
      cb += w * fmaxf(rb, 0.0f);
      dep += w * e.t;
      hits += 1.0f;
    }
    T = PROD ? t_in * P : t_in * expf(cs_act);
  }
  if (t_in_out) {
    // chunks after the early-out keep the saturated T: K2 reads
    // max(T_in) <= min_T there and writes zero blocks
    for (; k < nc; ++k) t_in_out[static_cast<size_t>(first + k) * R + r] = T;
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
void launch(bool prod, dim3 grid, int R, size_t smem, cudaStream_t stream,
            const float* chunks, const float* rays, const int* tile_start,
            const int* tile_nchunks, float* acc, float* t_in, int num_tiles,
            int num_chunks, int G, Gates q) {
  if (prod) {
    tile_forward_kernel<DEG, true><<<grid, R, smem, stream>>>(
        chunks, rays, tile_start, tile_nchunks, acc, t_in, num_tiles,
        num_chunks, R, G, q);
  } else {
    tile_forward_kernel<DEG, false><<<grid, R, smem, stream>>>(
        chunks, rays, tile_start, tile_nchunks, acc, t_in, num_tiles,
        num_chunks, R, G, q);
  }
}

}  // namespace

// chunks (C, G, 64) f32, rays (num_tiles, 24, R) f32, tile_start and
// tile_nchunks (num_tiles,) i32, acc (num_tiles, 8, R) f32; t_in is null
// (serving) or (C, R) f32, the transmittance at the start of every chunk
// (training's residual).  All contiguous device memory.  Returns
// cudaGetLastError() after the launch.
extern "C" int gvrt_tile_forward(const float* chunks, const float* rays,
                                 const int* tile_start,
                                 const int* tile_nchunks, float* acc,
                                 float* t_in, int num_tiles, int num_chunks,
                                 int R, int G, int kernel_degree,
                                 float max_alpha, float alpha_min,
                                 float hit_min_response,
                                 float min_transmittance,
                                 int transmittance_prod, void* stream) {
  if (num_tiles <= 0) return 0;
  const Gates q{max_alpha, alpha_min, hit_min_response, min_transmittance};
  const size_t smem = static_cast<size_t>(G) * kCols * sizeof(float);
  const bool prod = transmittance_prod != 0;
  const dim3 grid(num_tiles + (t_in ? kTailBlocks : 0));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GVRT_LAUNCH(D)                                                     \
  launch<D>(prod, grid, R, smem, s, chunks, rays, tile_start, tile_nchunks, \
            acc, t_in, num_tiles, num_chunks, G, q)
  switch (kernel_degree) {
    case 8: GVRT_LAUNCH(8); break;
    case 5: GVRT_LAUNCH(5); break;
    case 4: GVRT_LAUNCH(4); break;
    case 3: GVRT_LAUNCH(3); break;
    case 1: GVRT_LAUNCH(1); break;
    case 0: GVRT_LAUNCH(0); break;
    default: GVRT_LAUNCH(-1); break;
  }
#undef GVRT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
