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
//     warp; the extra lanes carry no ray).  bar_T, the ray's 8 geometry
//     rows and the ray-cotangent sums stay in registers; its 16 SH basis
//     values are read from the tile's basis rows in shared memory (below),
//     by the radiance as by the column product.
//   * Large tiles and chunks (the SPLIT instances; a host-side choice, so
//     the defaults R = 256 and 400 at G = 64 run the one-pass instances
//     below unchanged): where R > 512 or the one-pass shared memory below
//     would pass the card's 232,448 B, the block walks the tile's rays in
//     slabs of at most kSlabRays = 512 (equal slabs, one after the other,
//     each with its own bar_T, basis rows and ray cotangents, over the
//     whole chunk run).  The first slab writes bar_chunks and each later
//     one adds its column sums to it, in slab order: no float atomics,
//     reruns bit-identical.  Separate slab blocks writing partial
//     bar_chunks would need (slabs - 1) more copies of bar_chunks and a
//     reduce; the slab loop needs neither.  A chunk is walked in
//     sub-chunks of kSubRows = 64 rows (a chunk of at most 64 rows is
//     walked as in the one-pass instances): pass 1 runs over the whole
//     chunk first, one sub-chunk staged at a time, and keeps each ray's state
//     (P, or the log1p sum) at the start of every stride-th sub-chunk in
//     kBndRows = 8 checkpoint rows; then, walking the sub-chunks in
//     reverse, each is re-run from its checkpoint (storing the exclusive
//     states of its 64 rows only) before its pass 2.  P runs from the
//     chunk's start, so every accept and active gate falls as in K1, and
//     per ray the sums run in the one-pass order.  Shared memory is then
//     at most 230,400 B whatever R and G are.
//   * Registers: __launch_bounds__(kMaxThreads = 512) caps every instance
//     at 65,536 / 512 = 128.  A higher cap buys nothing at R = 256: two
//     blocks share an SM (shared memory below), 2 x 256 threads x 128 is
//     the register file, and one block per SM cost 3 ms (PERF.md).
//     So the live set is kept under 128: the basis in shared memory (16
//     registers); with ray gradients (RAYG) the product's geometry
//     features read at their use (8), and a compiler barrier before the
//     ray-cotangent sums, so that the gaussian's SH rows and frame are
//     loaded again there and not kept across the backward chain from
//     eval_pair and sh_radiance (57 values: ptxas spilled 408-444 B per
//     RAYG instance without it, 24-48 B with it; PERF.md).
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
//   * The per-gaussian column sums over rays are a product on the tensor
//     cores, as the TPU kernel contracts its SH columns on the MXU: each
//     column is a per-pair coefficient times a per-ray feature, summed over
//     rays, col[(a, f)] = sum_r A[a, r] F[r, f] with A = bar_pre (3),
//     bar_gro (3), bar_grdu (3), bar_ae * resp and F = 16 SH basis values,
//     o, d, 1.  The basis rows are staged in shared memory from `rays`
//     once per tile; per gaussian each lane writes its 10 coefficients
//     (zero where its ray did not composite it) into its warp's staging
//     rows, 8 lanes at a time, which turns "one lane per ray" into mma
//     fragments with __syncwarp only, and the warp contracts its 32 rays in
//     four k-steps of `mma.sync.m16n8k8.f32.tf32.tf32.f32`: basis x bar_pre,
//     and [o d 1] x [bar_gro bar_ae bar_grdu] (column_sums).  One TF32 pass
//     keeps ~3 digits, so every operand is split into TF32 hi + lo and the
//     product is a_lo b_hi + a_hi b_lo + a_hi b_hi (3xTF32, ~f32 accuracy),
//     accumulated in f32.  A warp none of whose rays composited the
//     gaussian skips the product.  The warps' partials, staged in shared
//     memory for a batch of kBatch gaussians, are summed in warp order.  The
//     mma order is fixed and there are no float atomics: two runs give the
//     same bits.
//   * Ray cotangents (RAYG): each lane sums its own ray's, in f32 FMAs in
//     registers over the tile's pairs in the reverse walk's order: o and d
//     (the frame rows times the local-frame cotangents bar_gro, bar_grdu)
//     and the 16 basis rows (the SH rows times bar_pre).  A 3xTF32
//     mma.sync form of the basis sums, from the staged bar_pre rows, ran
//     0.16 ms slower at the bench frame (PERF.md) and is not used.
//   * Shared memory, 115,200 B (112.5 KB) at R = 256, G = 64, the same with
//     and without ray gradients (two blocks per SM): chunk 16 KB, exclusive
//     state 64 KB, basis rows 16 KB, coefficient staging 2.5 KB, warp
//     partials 14 KB; a SPLIT block of 512 rays at G > 64 takes 230,400 B
//     (one block per SM).  Every block barrier costs (H100,
//     PERF.md: 3 gaussians per barrier pair 8.3 ms, 7 gaussians 7.9 ms, one
//     block per SM 11.4 ms), so the coefficients are staged 8 rays per round
//     (kStageRays) to leave room for kBatch = 7.  Staged rows are
//     XOR-swizzled so the fragment loads hit distinct banks.
//
// Bound on this card: the work is data dependent.  For every pair the
// forward recompute (~72 f32 operations, once per pass), and for every
// composited pair ~360 more (SH radiance, the backward chain, 61 column
// products and their sums, counted as f32 operations whatever unit runs
// them); the bytes are the chunk rows of the visited runs plus T_in, rays
// and outputs.  At the bench frame that is compute bound.  Measured on an
// H100 (PERF.md): the shuffle butterflies this product replaced were 25% of
// K2; the second forward recompute, the barriers and the unoverlapped chunk
// staging are what remains (pass-1 accept masks, cp.async/TMA staging).
//
// Numerics: IEEE division, expf/log1pf (no --use_fast_math); the gate chain
// without FMA contraction; the backward chain itself with FMAs; the column
// sums in 3xTF32 (per-column relative L2 ~1e-7 against the f32 plain
// version on the H100); the ray cotangents in f32 FMAs (per-row relative
// L2 <= 4.6e-7).

#include <cstdint>

#include "tile_common.cuh"

namespace {

using namespace gvrt;

//: blocks after the tile blocks that zero the dead trailing chunks
constexpr int kTailBlocks = 32;
//: gaussians per reduction batch (warp partials staged in shared memory)
constexpr int kBatch = 7;
//: rays of a warp whose coefficients are staged at a time (32 / kStageRays
//: rounds per gaussian): smaller staging leaves room for a larger kBatch
constexpr int kStageRays = 8;
constexpr int kMaxThreads = 512;
//: the largest dynamic shared memory a block may ask for on an H100
constexpr size_t kMaxSmem = 232448;
//: the SPLIT instances' plan: rays per slab, chunk rows per sub-chunk
//: (the exclusive states kept at once), checkpoint rows at most
constexpr int kSlabRays = kMaxThreads;
constexpr int kSubRows = 64;
constexpr int kBndRows = 8;
//: per-pair coefficients staged for the column product, in this order:
//: bar_pre (3), bar_gro (3), bar_ae * resp (1), bar_grdu (3)
constexpr int kCoefs = 10;
constexpr int kCoefBgo = 3, kCoefBae = 6, kCoefBgu = 7;
//: ray features staged per tile for the product: the 16 SH basis values
constexpr int kFeat = 16;

// XOR swizzles of staged rows (32 ray slots for the basis rows, kStageRays
// for the coefficient rows): the fragment loads of 8 consecutive rows (one
// per lane group) fall in distinct banks.
__device__ __forceinline__ int swz(int row) { return (row & 7) << 2; }
__device__ __forceinline__ int stage_swz(int row) {
  return ((row / (32 / kStageRays)) & (kStageRays / 4 - 1)) << 2;
}

// Basis value j of ray r from the tile's staged basis rows (row stride
// nthr, swizzled as the product reads them): sh_radiance's basis in K2
struct StagedBasis {
  const float* fs;
  int nthr, r;
  __device__ __forceinline__ float operator[](int j) const {
    return fs[j * nthr + (r ^ swz(j))];
  }
};

// Geometry feature m of the product ([o0 o1 o2 d0 d1 d2 1 0]) of the
// warp's ray k: `gf` is row min(m, 5) of the tile's rays at the warp's
// first ray, `nq` the number of the warp's rays that exist
__device__ __forceinline__ float geo_feature(const float* gf, int m, int k,
                                             int nq) {
  return k >= nq ? 0.0f : m < 6 ? gf[k] : m == 6 ? 1.0f : 0.0f;
}

// cvt.rna.tf32.f32 in integer arithmetic (add half of the 13 dropped bits,
// truncate: round to nearest, ties away from zero), so the compiler folds
// the split of a constant
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with both parts TF32 (lo holds the next 11 bits of x)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32 (a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms
// first)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], float a0, float a1,
                                           float a2, float a3, float b0,
                                           float b1) {
  uint32_t ah[4], al[4], bh[2], bl[2];
  split_tf32(a0, ah[0], al[0]);
  split_tf32(a1, ah[1], al[1]);
  split_tf32(a2, ah[2], al[2]);
  split_tf32(a3, ah[3], al[3]);
  split_tf32(b0, bh[0], bl[0]);
  split_tf32(b1, bh[1], bl[1]);
  mma_tf32(d, al[0], al[1], al[2], al[3], bh[0], bh[1]);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bl[0], bl[1]);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bh[0], bh[1]);
}

// The 61 nonzero parameter columns of one gaussian summed over the warp's
// 32 rays, on the tensor cores, written to the warp's partial `pw` (64
// floats; columns 13..15 zero).  `cf` is this lane's kCoefs coefficients
// (zero where its ray did not composite the gaussian), `st` the warp's
// kCoefs x kStageRays staging rows (filled by kStageRays lanes per round,
// at least 64 floats), `fw` the warp's first ray slot of the staged
// basis rows (row stride nthr), `ga` this lane's geometry-feature
// fragments or, with RAYG, `gf` and `nq` of geo_feature to read them at
// their use (8 registers fewer over the tile walk).  With gid = lane / 4
// and tig = lane % 4 (the mma fragment coordinates), per k-step s of 8
// rays:
//   C_sh  (16 x 8) += Basis (16 x 8 rays) x [bp0 bp1 bp2 0 ...] (8 rays x 8)
//   C_geo (16 x 8) += [o0 o1 o2 d0 d1 d2 1 0; 0] x
//                     [bgo0 bgo1 bgo2 bae bgu0 bgu1 bgu2 0]
// so SH column 16 + 16c + j is C_sh[j][c], M[3i + j] is
// C_geo[j][i] + C_geo[3 + j][4 + i], b[i] is -C_geo[6][i] and the density
// column C_geo[6][3].
template <bool RAYG>
__device__ __forceinline__ void column_sums(const float (&cf)[kCoefs],
                                            float* st, const float* fw,
                                            int nthr,
                                            const float (&ga)[4][2],
                                            const float* gf, int nq,
                                            float* pw, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  float csh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float cgeo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int rg = gid + kCoefBgo;  // staged row of B_geo's column gid
  const float* lo_row = fw + gid * nthr;
  const float* hi_row = fw + (gid + 8) * nthr;
#pragma unroll
  for (int u = 0; u < 32 / kStageRays; ++u) {
    if (lane / kStageRays == u) {
      const int k = lane % kStageRays;
#pragma unroll
      for (int i = 0; i < kCoefs; ++i)
        st[i * kStageRays + (k ^ stage_swz(i))] = cf[i];
    }
    __syncwarp();
#pragma unroll
    for (int sl = 0; sl < kStageRays / 8; ++sl) {
      const int s = u * (kStageRays / 8) + sl;  // k-step of the warp's rays
      const int k0 = 8 * s + tig, k1 = k0 + 4;
      const int f0 = k0 ^ swz(gid), f1 = k1 ^ swz(gid);
      const int l0 = 8 * sl + tig, l1 = l0 + 4;  // slots in this round
      const float bsh0 =
          gid < 3 ? st[gid * kStageRays + (l0 ^ stage_swz(gid))] : 0.0f;
      const float bsh1 =
          gid < 3 ? st[gid * kStageRays + (l1 ^ stage_swz(gid))] : 0.0f;
      const float bgeo0 =
          gid < 7 ? st[rg * kStageRays + (l0 ^ stage_swz(rg))] : 0.0f;
      const float bgeo1 =
          gid < 7 ? st[rg * kStageRays + (l1 ^ stage_swz(rg))] : 0.0f;
      mma_3xtf32(csh, lo_row[f0], hi_row[f0], lo_row[f1], hi_row[f1], bsh0,
                 bsh1);
      const float ga0 = RAYG ? geo_feature(gf, gid, k0, nq) : ga[s][0];
      const float ga1 = RAYG ? geo_feature(gf, gid, k1, nq) : ga[s][1];
      mma_3xtf32(cgeo, ga0, 0.0f, ga1, 0.0f, bgeo0, bgeo1);
    }
    __syncwarp();  // every lane has read this round's B fragments
  }
  // SH columns straight from the accumulator fragment
  const int c = 2 * tig;
  if (c < 3) {
    pw[kColSh + 16 * c + gid] = csh[0];
    pw[kColSh + 16 * c + gid + 8] = csh[2];
    if (c + 1 < 3) {
      pw[kColSh + 16 * (c + 1) + gid] = csh[1];
      pw[kColSh + 16 * (c + 1) + gid + 8] = csh[3];
    }
  }
  // C_geo rows 0..7 through the staging rows, then the 13 columns
  st[gid * 8 + c] = cgeo[0];
  st[gid * 8 + c + 1] = cgeo[1];
  __syncwarp();
  if (lane < 16) {
    float v = 0.0f;
    if (lane < 9) {
      const int i = lane / 3, j = lane % 3;
      v = st[j * 8 + i] + st[(3 + j) * 8 + 4 + i];
    } else if (lane < 12) {
      v = -st[6 * 8 + lane - 9];
    } else if (lane == 12) {
      v = st[6 * 8 + 3];
    }
    pw[lane] = v;
  }
  __syncwarp();  // `st` is reused by the next gaussian
}

__device__ __forceinline__ void zero_rows(float* dst, int n) {
  float4* d4 = reinterpret_cast<float4*>(dst);
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = z;
}

// Pass 1's forward over rows [g_from, g_to) of a chunk whose rows from
// g_stage on are staged at `sm`: the transmittance chain from T_in as K1
// forms it, carried in P (PROD) or the log1p sums cs and cs_act.  With
// STORE each composited pair's exclusive state goes to xs[(g - x0) *
// xstride]; n_live becomes one past the last composited pair.
template <int DEG, bool PROD, bool STORE>
__device__ __forceinline__ void forward_rows(const float* sm, int g_stage,
                                             int g_from, int g_to,
                                             const RayGeom& ray,
                                             const Gates& q, float tin,
                                             float& P, float& cs,
                                             float& cs_act, bool& alive,
                                             int& n_live, float* xs,
                                             int xstride, int x0) {
  for (int g = g_from; g < g_to && alive; ++g) {
    const Pair e = eval_pair<DEG>(sm + (g - g_stage) * kCols, ray, q);
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
    if (STORE) xs[(g - x0) * xstride] = state;
    if (PROD) P = P * (1.0f - e.alpha);
    n_live = g + 1;
  }
}

// The split plan of a large tile or chunk (SPLIT instances): rays per slab,
// chunk rows per sub-chunk, checkpoint rows and the sub-chunks between two
// checkpoints.
struct Split {
  int slab, rows, nbnd, stride;
};

template <int DEG, bool PROD, bool RAYG, bool SPLIT>
__global__ void __launch_bounds__(kMaxThreads)
tile_backward_kernel(const float* __restrict__ chunks,
                     const float* __restrict__ rays,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_nchunks,
                     const float* __restrict__ t_in,
                     const float* __restrict__ bar_acc,
                     float* __restrict__ bar_chunks,
                     float* __restrict__ bar_rays, int num_tiles,
                     int num_chunks, int R, int G, Gates q, Split sp) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);   // staged rows, GS x 64
  const int nthr = blockDim.x;
  const int GS = SPLIT ? sp.rows : G;            // chunk rows staged at once
  const int xstride = SPLIT ? nthr : R;
  float* xs = sm + GS * kCols;                   // exclusive state, GS x xstride
  float* fs = xs + GS * xstride;                 // basis rows, kFeat x nthr
  float* stage = fs + kFeat * nthr;       // nwarps x kCoefs x kStageRays
  float* part = stage + (nthr >> 5) * kCoefs * kStageRays;  // x kBatch x 64
  float* bnd = part + (nthr >> 5) * kBatch * kCols;  // SPLIT: nbnd x nthr
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
  const int lane = r & 31;
  const int warp = r >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* blk = rays + static_cast<size_t>(tile) * kRayRows * R;
  const int first = tile_start[tile];
  const int nc = tile_nchunks[tile];

  // SPLIT walks the tile's rays slab by slab, each over the whole chunk
  // run; the first slab writes bar_chunks, the later ones add to it in
  // slab order
  const int nslab = SPLIT ? (R + sp.slab - 1) / sp.slab : 1;
  for (int slab = 0; slab < nslab; ++slab) {
    const int lo = SPLIT ? slab * sp.slab : 0;  // the slab's first ray
    const int nr = SPLIT ? min(sp.slab, R - lo) : R;
    const int ri = lo + r;                      // this lane's ray
    const bool valid = r < nr;
    const bool first_slab = !SPLIT || slab == 0;
    if (SPLIT && slab > 0) __syncthreads();  // every warp is done with fs

    RayGeom ray = {};
    float bar_T = 0.0f, bar_r = 0.0f, bar_g = 0.0f, bar_b = 0.0f,
          bar_dep = 0.0f;
    if (valid) {
      load_ray_geometry(blk, R, ri, ray);
      const float* ba = bar_acc + static_cast<size_t>(tile) * kAccRows * R + ri;
      bar_r = ba[0];
      bar_g = ba[R];
      bar_b = ba[2 * R];
      bar_dep = ba[3 * R];
      bar_T = ba[kAccT * R];
    }
    // the product's ray features: the basis rows staged once per slab from
    // `rays` (read after the first chunk's barrier; also the radiance's
    // basis), and the geometry features [o0 o1 o2 d0 d1 d2 1 0] (row
    // lane / 4) of this lane's fragment rays, in registers without RAYG
#pragma unroll
    for (int j = 0; j < kFeat; ++j)
      fs[j * nthr + (r ^ swz(j))] = valid ? blk[(8 + j) * R + ri] : 0.0f;
    const StagedBasis basis{fs, nthr, r};
    const float* gf = blk + min(lane >> 2, 5) * R + lo + warp * 32;
    const int nq = nr - warp * 32;
    float ga[4][2];
    if (!RAYG) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ga[s][h] = geo_feature(gf, lane >> 2, 8 * s + (lane & 3) + 4 * h, nq);
      }
    }
    float bo[3] = {0.0f, 0.0f, 0.0f}, bd[3] = {0.0f, 0.0f, 0.0f};
    float bbasis[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) bbasis[j] = 0.0f;

    for (int k = nc - 1; k >= 0; --k) {
      const int chunk = first + k;
      float* out = bar_chunks + static_cast<size_t>(chunk) * chunk_elems;
      const float tin = valid ? t_in[static_cast<size_t>(chunk) * R + ri] : 0.0f;
      // the forward's `alive` predicate; also the barrier before the block
      // reuses its shared buffers
      if (!__syncthreads_or(valid && tin > q.min_t)) {
        if (first_slab) zero_rows(out, chunk_elems);
        continue;
      }

      // ---- pass 1: forward transmittance, front to back (as K1) ----
      float P = 1.0f, cs = 0.0f, cs_act = 0.0f;
      int n_live = 0;  // one past the last composited pair of this ray
      bool alive = valid && tin > q.min_t;
      if (!SPLIT) {
        stage_chunk(smem4, chunks, chunk, G);
        if (r == 0) s_nlive = 0;
        __syncthreads();
        forward_rows<DEG, PROD, true>(sm, 0, 0, G, ray, q, tin, P, cs, cs_act,
                                      alive, n_live, xs + r, xstride, 0);
      } else if (G <= GS) {  // slabs of a chunk that is one sub-chunk
        stage_chunk(smem4, chunks, chunk, G);
        if (r == 0) s_nlive = 0;
        __syncthreads();
        forward_rows<DEG, PROD, true>(sm, 0, 0, G, ray, q, tin, P, cs, cs_act,
                                      alive, n_live, xs + r, xstride, 0);
      } else {
        // sub-chunk by sub-chunk without the exclusive states; the state
        // at the start of every sp.stride-th sub-chunk is kept in bnd
        if (r == 0) s_nlive = 0;
        for (int j = 0, g0 = 0; g0 < G; ++j, g0 += GS) {
          if (j > 0) {
            if (j % sp.stride == 0)
              bnd[(j / sp.stride - 1) * nthr + r] = PROD ? P : cs;
            __syncthreads();  // every warp is done with the staged rows
          }
          stage_rows(smem4, chunks, chunk, G, g0, min(GS, G - g0));
          __syncthreads();
          forward_rows<DEG, PROD, false>(sm, g0, g0, min(G, g0 + GS), ray, q,
                                         tin, P, cs, cs_act, alive, n_live,
                                         nullptr, 0, 0);
        }
      }
      const float m_tot = PROD ? P : expf(cs_act);  // T_out / T_in
      if (n_live) atomicMax(&s_nlive, n_live);       // integer max: exact
      __syncthreads();
      const int nlive_blk = s_nlive;
      // rows no ray composited
      if (first_slab) {
        for (int i = nlive_blk * kCols + r; i < chunk_elems; i += blockDim.x)
          out[i] = 0.0f;
      }

      // ---- pass 2: reverse over the composited prefix ----
      float bar_tin = bar_T * m_tot;
      const float bar_m = bar_T * tin;          // PROD: d/d m_tot
      const float bar_s = bar_T * tin * m_tot;  // log-space: d/d sum(la)
      float S = 0.0f;  // suffix sum over later pairs of this ray
      // SPLIT: the sub-chunks in reverse, each re-running pass 1 first
      const int nsub = SPLIT ? (nlive_blk + GS - 1) / GS : 1;
      for (int j = nsub - 1; j >= 0; --j) {
        const int g0 = SPLIT ? j * GS : 0;
        const int g1 = SPLIT ? min(g0 + GS, nlive_blk) : nlive_blk;
        if (SPLIT && G > GS) {
          // from the checkpoint at or before sub-chunk j, for the rays that
          // composite a pair of it or later (alive through its start): P
          // runs from the chunk's start, so the gates fall as in K1
          const int cp = j / sp.stride * sp.stride;
          float Pj = 1.0f, csj = 0.0f, csj_act = 0.0f;
          if (cp > 0) {
            const float b = bnd[(cp / sp.stride - 1) * nthr + r];
            Pj = b;
            csj = b;
          }
          bool alive_j = n_live > g0;
          int unused = 0;
          for (int i = cp; i < j; ++i) {
            __syncthreads();
            stage_rows(smem4, chunks, chunk, G, i * GS, GS);
            __syncthreads();
            forward_rows<DEG, PROD, false>(sm, i * GS, i * GS, i * GS + GS,
                                           ray, q, tin, Pj, csj, csj_act,
                                           alive_j, unused, nullptr, 0, 0);
          }
          __syncthreads();
          stage_rows(smem4, chunks, chunk, G, g0, min(GS, G - g0));
          __syncthreads();
          forward_rows<DEG, PROD, true>(sm, g0, g0, min(g0 + GS, n_live), ray,
                                        q, tin, Pj, csj, csj_act, alive_j,
                                        unused, xs + r, xstride, g0);
        }
        for (int gb_end = g1; gb_end > g0; gb_end -= kBatch) {
          const int gb0 = gb_end - kBatch > g0 ? gb_end - kBatch : g0;
          for (int g = gb_end - 1; g >= gb0; --g) {
            const float* p = sm + (g - g0) * kCols;
            float cf[kCoefs];  // zero unless this ray composited g
#pragma unroll
            for (int j = 0; j < kCoefs; ++j) cf[j] = 0.0f;
            bool contrib = false;
            if (g < n_live) {
              const Pair e = eval_pair<DEG>(p, ray, q);
              if (e.accept) {  // accepted below n_live: active in pass 1
                contrib = true;
                const float state = xs[(g - g0) * xstride + r];
                const float ece = PROD ? state : expf(state);
                const float t_before = tin * ece;
                const float alpha = e.alpha;
                const float w = alpha * t_before;
                float rr, rg, rb;
                sh_radiance(p, basis, rr, rg, rb);
                const float bar_w = bar_dep * e.t + bar_r * fmaxf(rr, 0.0f) +
                                    bar_g * fmaxf(rg, 0.0f) +
                                    bar_b * fmaxf(rb, 0.0f);
                const float bp0 = rr > 0.0f ? bar_r * w : 0.0f;
                const float bp1 = rg > 0.0f ? bar_g * w : 0.0f;
                const float bp2 = rb > 0.0f ? bar_b * w : 0.0f;
                const float bar_t = bar_dep * w;
                float bar_ae = bar_w * t_before;
                const float bar_tb = bar_w * alpha;
                bar_tin += bar_tb * ece;
                if (PROD) {
                  // prod_excl_g = prod_{g'<g} u: bar_u_g = (sum_{g''>g}
                  // bar_tb t_before + bar_m m_tot) / u_g, with u >= 1 -
                  // max_alpha
                  const float pp = bar_tb * tin * ece;
                  bar_ae -= (S + bar_m * m_tot) / (1.0f - alpha);
                  S += pp;
                } else {
                  const float bar_ce = bar_tb * tin * ece;
                  bar_ae -= (S + bar_s) / (1.0f - alpha);
                  S += bar_ce;
                }
                const bool notclamped = e.ra <= q.max_alpha;
                const float bar_resp =
                    notclamped ? bar_ae * p[kColDensity] : 0.0f;
                cf[kCoefBae] = notclamped ? bar_ae * e.resp : 0.0f;
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
                const float bgu0 = -bc1 * e.gro2 + bc2 * e.gro1 +
                                   bar_dog * e.gro0 + 2.0f * e.gu0 * bar_n2;
                const float bgu1 = bc0 * e.gro2 - bc2 * e.gro0 +
                                   bar_dog * e.gro1 + 2.0f * e.gu1 * bar_n2;
                const float bgu2 = -bc0 * e.gro1 + bc1 * e.gro0 +
                                   bar_dog * e.gro2 + 2.0f * e.gu2 * bar_n2;
                const float bgo0 = bc1 * e.gu2 - bc2 * e.gu1 + bar_dog * e.gu0;
                const float bgo1 = -bc0 * e.gu2 + bc2 * e.gu0 + bar_dog * e.gu1;
                const float bgo2 = bc0 * e.gu1 - bc1 * e.gu0 + bar_dog * e.gu2;
                cf[0] = bp0;
                cf[1] = bp1;
                cf[2] = bp2;
                cf[kCoefBgo] = bgo0;
                cf[kCoefBgo + 1] = bgo1;
                cf[kCoefBgo + 2] = bgo2;
                cf[kCoefBgu] = bgu0;
                cf[kCoefBgu + 1] = bgu1;
                cf[kCoefBgu + 2] = bgu2;
                if (RAYG) {
                  // a compiler barrier: the gaussian's rows are read again
                  // here (vectorized), not kept in registers across the
                  // chain from eval_pair and sh_radiance (48 + 9 values)
                  asm volatile("" ::: "memory");
#pragma unroll
                  for (int j = 0; j < 3; ++j) {
                    bo[j] += p[j] * bgo0 + p[3 + j] * bgo1 + p[6 + j] * bgo2;
                    bd[j] += p[j] * bgu0 + p[3 + j] * bgu1 + p[6 + j] * bgu2;
                  }
                  const float* sh = p + kColSh;
#pragma unroll
                  for (int j = 0; j < 16; ++j)
                    bbasis[j] +=
                        sh[j] * bp0 + sh[16 + j] * bp1 + sh[32 + j] * bp2;
                }
              }
            }
            // sum the 64 columns over the warp's rays
            float* pw = part + (warp * kBatch + (g - gb0)) * kCols;
            if (__ballot_sync(0xffffffffu, contrib) == 0) {
              pw[lane] = 0.0f;
              pw[lane + 32] = 0.0f;
            } else {
              column_sums<RAYG>(cf, stage + warp * kCoefs * kStageRays,
                                fs + warp * 32, nthr, ga, gf, nq, pw, lane);
            }
          }
          __syncthreads();
          // the warps' partials, summed in warp order (and the slabs' in
          // slab order)
          const int n = (gb_end - gb0) * kCols;
          for (int i = r; i < n; i += blockDim.x) {
            float s = 0.0f;
            for (int w = 0; w < nwarps; ++w) s += part[w * kBatch * kCols + i];
            if (first_slab) {
              out[gb0 * kCols + i] = s;
            } else {
              out[gb0 * kCols + i] += s;
            }
          }
          __syncthreads();
        }
      }
      bar_T = bar_tin;
    }

    if (RAYG && valid) {
      float* br = bar_rays + static_cast<size_t>(tile) * kRayRows * R + ri;
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
}

template <int DEG, bool PROD, bool RAYG, bool SPLIT>
int launch4(dim3 grid, int threads, size_t smem, cudaStream_t stream,
            const float* chunks, const float* rays, const int* tile_start,
            const int* tile_nchunks, const float* t_in, const float* bar_acc,
            float* bar_chunks, float* bar_rays, int num_tiles,
            int num_chunks, int R, int G, Gates q, Split sp) {
  auto kernel = tile_backward_kernel<DEG, PROD, RAYG, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(chunks, rays, tile_start,
                                          tile_nchunks, t_in, bar_acc,
                                          bar_chunks, bar_rays, num_tiles,
                                          num_chunks, R, G, q, sp);
  return static_cast<int>(cudaGetLastError());
}

template <int DEG>
int launch(bool prod, bool rayg, bool split, dim3 grid, int threads,
           size_t smem, cudaStream_t stream, const float* chunks,
           const float* rays, const int* tile_start, const int* tile_nchunks,
           const float* t_in, const float* bar_acc, float* bar_chunks,
           float* bar_rays, int num_tiles, int num_chunks, int R, int G,
           Gates q, Split sp) {
#define GVRT_ARGS                                                            \
  grid, threads, smem, stream, chunks, rays, tile_start, tile_nchunks, t_in, \
      bar_acc, bar_chunks, bar_rays, num_tiles, num_chunks, R, G, q, sp
#define GVRT_RAYG(P, S)                                      \
  (rayg ? launch4<DEG, P, true, S>(GVRT_ARGS)                \
        : launch4<DEG, P, false, S>(GVRT_ARGS))
  if (split) return prod ? GVRT_RAYG(true, true) : GVRT_RAYG(false, true);
  return prod ? GVRT_RAYG(true, false) : GVRT_RAYG(false, false);
#undef GVRT_RAYG
#undef GVRT_ARGS
}

// Floats of shared memory per block: `rows` staged chunk rows and their
// exclusive states (xcols per row), the basis rows, the coefficient
// staging, the warp partials and `nbnd` checkpoint rows.
constexpr size_t smem_floats(int rows, int xcols, int threads, int nbnd) {
  return static_cast<size_t>(rows) * kCols +
         static_cast<size_t>(rows) * xcols +
         static_cast<size_t>(kFeat) * threads +
         static_cast<size_t>(threads / 32) * (kCoefs * kStageRays + kBatch * kCols) +
         static_cast<size_t>(nbnd) * threads;
}

// The split plan's largest block fits whatever R and G are.
static_assert(smem_floats(kSubRows, kSlabRays, kSlabRays, kBndRows) *
                      sizeof(float) <= kMaxSmem,
              "the split plan must fit any tile and chunk size");

struct Plan {
  bool split;
  int threads;
  Split sp;
  size_t smem;
};

// A tile of up to kMaxThreads rays whose whole chunk and exclusive states
// fit runs the one-pass instances (the defaults: R = 256, G = 64 and R =
// 400, G = 64); any other shape the SPLIT instances: slabs of at most
// kSlabRays rays, sub-chunks of kSubRows rows, at most kBndRows checkpoint
// rows (every stride-th sub-chunk's start).
Plan plan(int R, int G) {
  const int threads = (R + 31) / 32 * 32;
  const size_t whole = smem_floats(G, R, threads, 0) * sizeof(float);
  if (threads <= kMaxThreads && whole <= kMaxSmem)
    return {false, threads, {R, G, 0, 1}, whole};
  const int nslab = (R + kSlabRays - 1) / kSlabRays;
  const int slab = (R + nslab - 1) / nslab;
  const int rows = G < kSubRows ? G : kSubRows;
  const int nsub = (G + rows - 1) / rows;
  const int stride = nsub > 1 ? (nsub - 1 + kBndRows - 1) / kBndRows : 1;
  const int nbnd = (nsub - 1) / stride;
  const int t = (slab + 31) / 32 * 32;
  return {true, t, {slab, rows, nbnd, stride},
          smem_floats(rows, t, t, nbnd) * sizeof(float)};
}

}  // namespace

// Shared memory K2 needs per block (115,200 B at R = 256, G = 64: two
// blocks fit on an SM; at most 230,400 B for any shape).  The wrapper
// checks it against the card's limit.
extern "C" int gvrt_tile_backward_smem(int R, int G) {
  return static_cast<int>(plan(R, G).smem);
}

// chunks (C, G, 64) f32, rays (num_tiles, 24, R) f32, tile_start and
// tile_nchunks (num_tiles,) i32, t_in (C, R) f32 from K1's residual
// variant, bar_acc (num_tiles, 8, R) f32 -> bar_chunks (C, G, 64) f32 and,
// when bar_rays is not null (ray_gradients), bar_rays (num_tiles, 24, R)
// f32.  All contiguous device memory; any R >= 1 and G >= 1.  Returns the
// CUDA error of the launch (0 on success).
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
  const Plan pl = plan(R, G);
  const bool prod = transmittance_prod != 0;
  const bool rayg = bar_rays != nullptr;
  const dim3 grid(num_tiles + kTailBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GVRT_LAUNCH(D)                                                         \
  launch<D>(prod, rayg, pl.split, grid, pl.threads, pl.smem, s, chunks, rays, \
            tile_start, tile_nchunks, t_in, bar_acc, bar_chunks, bar_rays,     \
            num_tiles, num_chunks, R, G, q, pl.sp)
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
