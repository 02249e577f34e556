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
//   * One block per tile, one thread per ray (blockDim = R rounded up to
//     whole warps; lanes past R hold no ray).  A tile of more than 1024
//     rays (tile_size >= 33) is split into equal slabs of at most 1024
//     rays, one block each (blockIdx.y), all walking the tile's chunk run:
//     compositing is per ray, so a ray's output does not depend on the
//     split.  Per slab: the early-out below, the shared-origin test
//     (against the tile's ray 0) and the slab's own columns of T_in.
//     Chunks are laid out in tile order, so the wrapper hands each block
//     the start and count of its tile's contiguous chunk run and the
//     tile's pair count: trailing dead chunks are never visited, the last
//     chunk stops before its padding, and no scalar-prefetch map or
//     neighbour compare (TPU devices) is needed.  Slabs and pieces (below)
//     are the SPLIT instances, a host-side choice: a tile of up to 1024
//     rays with chunks of up to 512 gaussians runs the instances without
//     them, the code of one slab and one piece.
//   * Each chunk's G x 64 f32 block (16 KB at G = 64, 32 KB at G = 128) is
//     staged in shared memory with coalesced 16-byte loads; every thread then
//     reads the same row per pair, a shared-memory broadcast.  Above 48 KB
//     (G > 180) the block opts in to the card's dynamic shared memory; a
//     chunk of more than kMaxPiece = 512 gaussians is staged in pieces of
//     512 rows, with P and the log1p sums running on across the pieces from
//     the chunk's start, so every gate falls as in the plain version.
//   * The ray's 24 rows (origin, direction, tmin, tmax, 16 SH basis values)
//     and its accumulator stay in registers for the whole tile.
//   * Shared origin: when every ray of the tile starts at ray 0's origin bit
//     for bit (a pinhole frame; one __syncthreads_and at tile start), gro =
//     M o - b is one value per gaussian, computed with the chain's own ops
//     while the chunk is staged and read from shared memory by every ray.
//     Other tiles compute it per ray.
//   * Warp-wide early reject: almost every pair fails the response gate (a
//     gaussian binned to a tile covers a few of its rays).  Each ray runs
//     the chain's prefix up to cc = |grdu x gro|^2 and flags whether its ray
//     is alive and cc <= D_hi * max(|grdu|^2, 1e-20), D_hi the response
//     cutoff from the wrapper (float64, with a margin for the f32 roundings
//     and expf).  When no lane of the warp is flagged (one vote.any), the
//     warp skips the division, the response, the gates and the composite:
//     none of its rays would accept the gaussian, so no output bit changes.
//     Otherwise every live ray runs the tail exactly as before.  Dead rays
//     stay in the loop and vote too; a warp whose rays all died leaves it.
//   * Within a chunk, t_before = t_in * P with P the per-ray running
//     product of (1 - alpha): the sequential form of the TPU's exclusive
//     shift-tree cumprod, and the product the plain version's cumprod and
//     K2's recompute form.  With transmittance_prod = false the log-space
//     form (exp of the running log1p sum, folded once per chunk) is used.
//   * Before each chunk the block takes __syncthreads_or(T > min_T) and stops
//     when no ray of the slab is alive: the `alive` predicate of the Pallas
//     kernel.  Per-ray gating already zeroes later contributions, so the
//     skip changes time only.
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
// Bound on this card: chip_smoke.py bounds the kernel by the f32
// operations this data needs (chain_counts): gro once per gaussian of a
// shared-origin tile, 36 per real pair on a live ray (the prefix and the
// cutoff test), the 20 of the tail only for pairs inside D_hi, and 116 per
// composited pair, over the H100's 67 TFLOP/s; the chunk rows read once
// at 3.35 TB/s come close (0.43 of the 0.51 ms at garden band 0, 0.14 of
// 0.22 ms at 300k).  The pair loop is bound by instruction
// issue: before the early reject a rejected pair issued ~116 instructions
// (the IEEE division, expf, the gates); a (gaussian, warp) that every ray
// rejects now issues ~59 (SASS of the default instance).  On an NVIDIA
// H100 80GB HBM3 at 700 W (scripts/torch_k1_ab.py, chip_smoke.py) the warp
// skipped ~79% of (gaussian, warp) pairs at garden band 0 and ~60% on the
// 300k-Gaussian frame; the kernel ran at ~7x its bound at both (3.6 ms
// against 0.51 ms, 1.56 ms against 0.22 ms), and the shared origin saved
// 5-8%.  Staging the chunks (1.43 GB at garden band 0) costs ~1 ms.
// Overlapping the chunk load with compute (cp.async / TMA double
// buffering) and tensor-core SH products are for later work.
//
// Numerics: IEEE division and expf/log1pf (no --use_fast_math), the gate
// chain without FMA contraction (`pair_origin`, `pair_prefix` and
// `pair_tail` in tile_common.cuh, which make up K2's `eval_pair`); the
// 1 / max(n2, 1e-20) clamp keeps padding pairs (identity frame, density 0)
// finite.

#include "tile_common.cuh"

namespace {

using namespace gvrt;

//: blocks after the tile blocks that write T_in = 1 for the dead trailing
//: chunks (the residual variant only)
constexpr int kTailBlocks = 32;
constexpr unsigned kFullWarp = 0xffffffffu;
//: rays per block: a tile of more rays is split into slabs of at most this
constexpr int kMaxSlab = 1024;
//: chunk rows staged at a time: a larger chunk is staged in pieces
//: (512 x 272 B = 139,264 B of the 232,448 a block may have)
constexpr int kMaxPiece = 512;
//: dynamic shared memory a block gets without opting in
constexpr size_t kDefaultSmem = 48 * 1024;

// gro = M o - b of rows [g0, g0 + n) of the chunk for the tile's one ray
// origin: pair_origin's ops on the values stage_rows copies, read from
// device memory beside it, so the barrier after the staging covers both
__device__ __forceinline__ void stage_origins(float4* dst, const float* chunks,
                                              int chunk, int G, int g0, int n,
                                              const Ray& ray) {
  const float* src = chunks + (static_cast<size_t>(chunk) * G + g0) * kCols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float4 v;
    pair_origin(src + i * kCols, ray.o0, ray.o1, ray.o2, v.x, v.y, v.z);
    v.w = 0.0f;
    dst[i] = v;
  }
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// One block per tile.  SPLIT: one block per (tile, slab), the slab's rays
// [blockIdx.y * S, min(R, (blockIdx.y + 1) * S)), and the chunk staged GP
// rows at a time; without SPLIT (S = R, GP = G: up to 1024 rays and 512
// gaussians per chunk) the code of one slab and one piece.
template <int DEG, bool PROD, bool SPLIT>
__global__ void __launch_bounds__(kMaxSlab)
tile_forward_kernel(const float* __restrict__ chunks,
                    const float* __restrict__ rays,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_nchunks,
                    const int* __restrict__ tile_counts,
                    float* __restrict__ acc, float* __restrict__ t_in_out,
                    int num_tiles, int num_chunks, int R, int G, int S,
                    int GP, Gates q, float d_hi) {
  extern __shared__ float4 smem4[];
  const float* sm = reinterpret_cast<const float*>(smem4);
  // (GP,) gro of the shared origin
  float4* s_gro = smem4 + (SPLIT ? GP : G) * (kCols / 4);
  // blockDim is the slab rounded up to whole warps: lanes past the slab
  // hold no ray, stay dead and write nothing, so every vote takes the full
  // warp
  const int slab0 = SPLIT ? static_cast<int>(blockIdx.y) * S : 0;
  const int r = slab0 + static_cast<int>(threadIdx.x);
  const bool real = SPLIT ? static_cast<int>(threadIdx.x) < min(S, R - slab0)
                          : r < R;
  if (static_cast<int>(blockIdx.x) >= num_tiles) {
    // residual variant: dead trailing chunks are in no run; they get the
    // transmittance of a tile no chunk reached, so T_in is defined memory
    if (!real) return;
    const int dead0 = first_dead_chunk(tile_start, tile_nchunks, num_tiles,
                                       num_chunks);
    for (int c = dead0 + static_cast<int>(blockIdx.x) - num_tiles; c < num_chunks;
         c += kTailBlocks)
      t_in_out[static_cast<size_t>(c) * R + r] = 1.0f;
    return;
  }
  const int tile = static_cast<int>(blockIdx.x);

  const float* blk = rays + static_cast<size_t>(tile) * kRayRows * R;
  Ray ray;
  load_ray(blk, R, real ? r : slab0, ray);
  // a pinhole frame: every ray of the slab starts at the tile's ray 0's
  // origin
  const bool shared_origin = __syncthreads_and(
      same_bits(ray.o0, blk[0]) && same_bits(ray.o1, blk[R]) &&
      same_bits(ray.o2, blk[2 * R]));

  float T = real ? 1.0f : 0.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, dep = 0.0f, hits = 0.0f;
  const int first = tile_start[tile];
  const int nc = tile_nchunks[tile];
  const int count = tile_counts[tile];

  int k = 0;
  for (; k < nc; ++k) {
    // slab early-out; also the barrier before the block reuses the buffer
    if (!__syncthreads_or(T > q.min_t)) break;
    if (t_in_out && real) t_in_out[static_cast<size_t>(first + k) * R + r] = T;
    if (!SPLIT) {  // the whole chunk at once
      stage_chunk(smem4, chunks, first + k, G);
      if (shared_origin) stage_origins(s_gro, chunks, first + k, G, 0, G, ray);
      __syncthreads();
    }

    // t_before = t_in * P with P the running exclusive product of
    // (1 - alpha) (PROD) or exp of the running log1p sum (log-space), as
    // in the plain version: both kernels and the plain version form the
    // same product, so the active gate falls alike.  P and the sums run
    // over the whole chunk, across its staged pieces.
    const float t_in = T;
    float P = 1.0f;           // PROD: prod of (1 - alpha) over accepted pairs
    float cs = 0.0f;          // log-space: running log1p sum
    float cs_act = 0.0f;      // the same over accepted, active pairs
    bool ray_alive = T > q.min_t;
    // the last chunk of a run stops at the tile's count: padding slots
    // (density 0) are never accepted
    const int n_live = min(G, count - k * G);
    for (int g0 = 0; g0 < n_live; g0 += GP) {
      if (SPLIT) {
        if (g0 > 0) __syncthreads();  // every warp is done with the last piece
        const int n_staged = min(GP, G - g0);
        stage_rows(smem4, chunks, first + k, G, g0, n_staged);
        if (shared_origin)
          stage_origins(s_gro, chunks, first + k, G, g0, n_staged, ray);
        __syncthreads();
        // a warp whose rays all died in an earlier piece waits for the next
        if (g0 > 0 && !__any_sync(kFullWarp, ray_alive)) continue;
      }
      const int n_piece = SPLIT ? min(GP, n_live - g0) : n_live;
      for (int g = 0; g < n_piece; ++g) {
        const float* p = sm + g * kCols;
        Pair e;
        if (shared_origin) {
          const float4 o = s_gro[g];
          e.gro0 = o.x;
          e.gro1 = o.y;
          e.gro2 = o.z;
        } else {
          pair_origin(p, ray.o0, ray.o1, ray.o2, e.gro0, e.gro1, e.gro2);
        }
        pair_prefix(p, ray, e);
        // Early reject: cc > D_hi |grdu|^2 puts the gray distance past the
        // response cutoff (the wrapper's margin covers the roundings), so
        // the pair fails the response gate.  When no lane of the warp is
        // alive and below the cutoff, the warp skips the tail; a NaN falls
        // to the full chain.  Dead lanes stay in the loop and vote too.
        const bool maybe = ray_alive && !(e.cc > d_hi * fmaxf(e.nrm2, 1e-20f));
        if (!__any_sync(kFullWarp, maybe)) continue;
        if (ray_alive) {
          pair_tail<DEG>(p, ray, q, e);
          if (e.accept) {  // else alpha_eff = 0: T and the sums are unchanged
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
              ray_alive = false;  // T only falls: no later pair counts
            } else {
              const float w = e.alpha * t_before;
              if (PROD) P = P * (1.0f - e.alpha);

              float rr, rg, rb;
              sh_radiance(p, ray.basis, rr, rg, rb);
              cr += w * fmaxf(rr, 0.0f);
              cg += w * fmaxf(rg, 0.0f);
              cb += w * fmaxf(rb, 0.0f);
              dep += w * e.t;
              hits += 1.0f;
            }
          }
        }
        if (!__any_sync(kFullWarp, ray_alive)) break;  // the whole warp is done
      }
      if (!SPLIT) break;  // the chunk was one piece
    }
    T = PROD ? t_in * P : t_in * expf(cs_act);
  }
  if (!real) return;
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

template <int DEG, bool PROD, bool SPLIT>
int launch3(dim3 grid, int threads, size_t smem, cudaStream_t stream,
            const float* chunks, const float* rays, const int* tile_start,
            const int* tile_nchunks, const int* tile_counts, float* acc,
            float* t_in, int num_tiles, int num_chunks, int R, int G, int S,
            int GP, Gates q, float d_hi) {
  auto kernel = tile_forward_kernel<DEG, PROD, SPLIT>;
  if (smem > kDefaultSmem) {  // large chunks: opt in to the card's limit
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(chunks, rays, tile_start,
                                          tile_nchunks, tile_counts, acc,
                                          t_in, num_tiles, num_chunks, R, G,
                                          S, GP, q, d_hi);
  return static_cast<int>(cudaGetLastError());
}

template <int DEG>
int launch(bool prod, bool split, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, const float* chunks, const float* rays,
           const int* tile_start, const int* tile_nchunks,
           const int* tile_counts, float* acc, float* t_in, int num_tiles,
           int num_chunks, int R, int G, int S, int GP, Gates q, float d_hi) {
#define GVRT_ARGS                                                          \
  grid, threads, smem, stream, chunks, rays, tile_start, tile_nchunks,    \
      tile_counts, acc, t_in, num_tiles, num_chunks, R, G, S, GP, q, d_hi
  if (split)
    return prod ? launch3<DEG, true, true>(GVRT_ARGS)
                : launch3<DEG, false, true>(GVRT_ARGS);
  return prod ? launch3<DEG, true, false>(GVRT_ARGS)
              : launch3<DEG, false, false>(GVRT_ARGS);
#undef GVRT_ARGS
}

}  // namespace

// chunks (C, G, 64) f32, rays (num_tiles, 24, R) f32, tile_start,
// tile_nchunks and tile_counts (num_tiles,) i32 (each tile's chunk run and
// its un-padded pair count), acc (num_tiles, 8, R) f32; t_in is null
// (serving) or (C, R) f32, the transmittance at the start of every chunk
// (training's residual).  All contiguous device memory; any R >= 1 and
// G >= 1.  response_cutoff is D_hi, the gray distance past which no pair
// passes the response gate (+inf: no early reject).  Returns
// cudaGetLastError() after the launch.
extern "C" int gvrt_tile_forward(const float* chunks, const float* rays,
                                 const int* tile_start,
                                 const int* tile_nchunks,
                                 const int* tile_counts, float* acc,
                                 float* t_in, int num_tiles, int num_chunks,
                                 int R, int G, int kernel_degree,
                                 float max_alpha, float alpha_min,
                                 float hit_min_response,
                                 float min_transmittance,
                                 float response_cutoff,
                                 int transmittance_prod, void* stream) {
  if (num_tiles <= 0) return 0;
  const Gates q{max_alpha, alpha_min, hit_min_response, min_transmittance};
  // slabs of equal size, at most kMaxSlab rays (one slab up to 1024 rays)
  const int nslab = (R + kMaxSlab - 1) / kMaxSlab;
  const int S = (R + nslab - 1) / nslab;
  const int GP = G < kMaxPiece ? G : kMaxPiece;
  const int threads = (S + 31) & ~31;  // whole warps
  // a piece of the chunk and the gro of its gaussians (shared-origin tiles)
  const size_t smem = static_cast<size_t>(GP) * (kCols + 4) * sizeof(float);
  const bool prod = transmittance_prod != 0;
  const bool split = nslab > 1 || GP < G;
  const dim3 grid(num_tiles + (t_in ? kTailBlocks : 0), nslab);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GVRT_LAUNCH(D)                                                      \
  launch<D>(prod, split, grid, threads, smem, s, chunks, rays, tile_start,  \
            tile_nchunks, tile_counts, acc, t_in, num_tiles, num_chunks, R, \
            G, S, GP, q, response_cutoff)
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
