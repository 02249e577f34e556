// Binning's pair expansion for Hopper (sm_90a): run starts, then every
// pair slot's tile, exact ellipsoid-vs-tile cull and packed sort key.
//
// Replaces no TPU kernel: the JAX package expands its pairs with XLA ops
// (`3dgvrt_lightfield_tpu/render/binning.py`, `bin_topology_from_table`:
// `_scatter_cummax_fill`, the per-pair gathers, `_pair_ellipsoid_cull`, the
// key).  The port's plain version is the same torch code
// (`render/binning.py::_expand_pairs_plain`), about a hundred ops over every
// pair slot, most of them int64, with a (C, 9) gather of the ellipsoid
// matrix; the wrapper `render/binning.py::expand_pairs` checks the inputs
// and launches these two kernels around the max-scan (`csrc/max_scan.cu`).
//
// What it computes, for a table of n Gaussians whose pair ranges are
// [offsets[g], offsets[g] + counts[g]) and a capacity of C slots:
//   1. run_starts_kernel, a thread a Gaussian: pair_g[offsets[g]] = g for
//      each g with counts[g] > 0 and offsets[g] < C, into zeros.  The
//      starts are distinct, so plain stores do.  The max-scan then fills
//      every slot with its run's Gaussian.
//   2. pair_keys_kernel, a thread a slot p: for p < total, j = p -
//      offsets[g] of g = pair_g[p] gives the slot's band-local tile
//      (tx0 + j % w, ty0 + j / w), its global row, the four plane tests of
//      the tile's frustum against the ellipsoid, and
//      key = (tile_id << depth_bits) | depth_q[g], tile_id the local tile
//      if the ellipsoid touches it, else num_tiles; past total
//      key = num_tiles << depth_bits.  tile_id <= num_tiles < 2^tile_bits
//      and depth_bits = min(31 - tile_bits, 24), so the key fits in 31
//      bits and is written as int32.
// The float cull rounds op by op as the plain version's torch ops do:
// __fmul_rn, __fadd_rn and __fsub_rn are never contracted into an FMA, and
// the scalars (the projection's diagonal and the tile's ndc width and
// height) arrive as the f32 values torch takes for a Python float against
// an f32 tensor.  Integer math is exact, so the keys equal the plain
// version's bit for bit, and so does the topology sorted from them.
//
// Bound on this card: bytes.  The pair kernel reads pair_g (8 B) and
// writes the key (4 B) a slot, and reads about 76 B a live Gaussian
// (offsets, the rect's three columns, depth_q, three centre and nine
// matrix columns); the run starts read 16 B a Gaussian and write 8 B a
// live one.  Design: neighbouring slots mostly share a Gaussian, and the
// Gaussians of a warp's slots are neighbours too, so the per-Gaussian
// reads of a warp fall on a few cache lines of each column (read-only
// loads); the slot reads and key stores are coalesced, and a slot past
// total reads nothing but the total.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 12;  // cs x, y, z, then V row-major

struct CullColumns {
  const float* col[kCols];
};

__global__ void __launch_bounds__(kThreads)
run_starts_kernel(const long long* __restrict__ offsets,
                  const long long* __restrict__ counts, long long n,
                  long long capacity, long long* __restrict__ pair_g) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (g >= n) return;
  const long long start = __ldg(offsets + g);
  if (__ldg(counts + g) > 0 && start < capacity) pair_g[start] = g;
}

// |V^T n|^2 for the plane normal n with component na on V's row r0 and nc
// on row 2 (z), summed in the plain version's order: 0 + u0^2 + u1^2 + u2^2
__device__ __forceinline__ float support2(const float (&v)[9], int r0,
                                          float na, float nc) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float u = __fadd_rn(__fmul_rn(na, v[r0 * 3 + k]),
                              __fmul_rn(nc, v[6 + k]));
    s = __fadd_rn(s, __fmul_rn(u, u));
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
pair_keys_kernel(const long long* __restrict__ pair_g,
                 const long long* __restrict__ total,
                 const long long* __restrict__ offsets,
                 const int* __restrict__ tx0, const int* __restrict__ ty0,
                 const int* __restrict__ tx1,
                 const long long* __restrict__ depth_q, CullColumns cols,
                 int* __restrict__ key, long long capacity, int nx,
                 int num_tiles, int row_offset, int row_stride,
                 int depth_bits, float p00, float p11, float fx, float fy) {
  const long long p = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (p >= capacity) return;
  if (p >= __ldg(total)) {
    key[p] = num_tiles << depth_bits;
    return;
  }
  const long long g = pair_g[p];
  const int j = static_cast<int>(p - __ldg(offsets + g));
  const int x0 = __ldg(tx0 + g);
  const int w = __ldg(tx1 + g) - x0 + 1;
  const int jy = j / w;
  const int tile_x = x0 + (j - jy * w);
  const int tile_y = __ldg(ty0 + g) + jy;
  const int row = tile_y * row_stride + row_offset;

  const float csx = __ldg(cols.col[0] + g);
  const float csy = __ldg(cols.col[1] + g);
  const float csz = __ldg(cols.col[2] + g);
  float v[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) v[i] = __ldg(cols.col[3 + i] + g);

  // the tile's ndc edges and the four planes through the camera origin
  const float a0 = __fsub_rn(__fmul_rn(fx, static_cast<float>(tile_x)), 1.0f);
  const float a1 = __fadd_rn(a0, fx);
  const float b0 = __fsub_rn(__fmul_rn(fy, static_cast<float>(row)), 1.0f);
  const float b1 = __fadd_rn(b0, fy);
  const float lx = __fmul_rn(p00, csx);
  const float ly = __fmul_rn(p11, csy);
  const float d0 = __fadd_rn(lx, __fmul_rn(a0, csz));
  const float d1 = __fadd_rn(lx, __fmul_rn(a1, csz));
  const float d2 = __fadd_rn(ly, __fmul_rn(b0, csz));
  const float d3 = __fadd_rn(ly, __fmul_rn(b1, csz));
  // touches {n.x >= 0}: d >= 0 or d^2 <= |V^T n|^2; {n.x <= 0}: d <= 0 or
  const bool fine =
      (d0 >= 0.0f || __fmul_rn(d0, d0) <= support2(v, 0, p00, a0)) &&
      (d1 <= 0.0f || __fmul_rn(d1, d1) <= support2(v, 0, p00, a1)) &&
      (d2 >= 0.0f || __fmul_rn(d2, d2) <= support2(v, 1, p11, b0)) &&
      (d3 <= 0.0f || __fmul_rn(d3, d3) <= support2(v, 1, p11, b1));

  const int tile_id = fine ? tile_y * nx + tile_x : num_tiles;
  key[p] = (tile_id << depth_bits) | static_cast<int>(__ldg(depth_q + g));
}

unsigned blocks_of(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// offsets, counts: n int64 on the card; pair_g: capacity int64 on the card,
// zeroed by the caller.  Stores each live run's Gaussian id at its start
// and launches on `stream` without synchronising; returns the CUDA error.
extern "C" int gvrt_bin_run_starts(const long long* offsets,
                                   const long long* counts, long long n,
                                   long long capacity, long long* pair_g,
                                   void* stream) {
  if (n < 0 || capacity < 0 || (n + kThreads - 1) / kThreads > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  run_starts_kernel<<<blocks_of(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      offsets, counts, n, capacity, pair_g);
  return static_cast<int>(cudaGetLastError());
}

// pair_g: capacity int64 (the filled runs); total: one int64, the rect
// pairs of the band before the capacity cut; offsets, depth_q: int64 a
// Gaussian; tx0, ty0, tx1: int32 band-local tile rects a Gaussian;
// columns: a host array of 12 f32 column pointers (the camera-space centre
// x, y, z, then V row-major); key: capacity int32, written in full.  All
// on the card.  Launches on `stream` without synchronising; returns the
// CUDA error.
extern "C" int gvrt_bin_pair_keys(const long long* pair_g,
                                  const long long* total,
                                  const long long* offsets, const int* tx0,
                                  const int* ty0, const int* tx1,
                                  const long long* depth_q,
                                  const float* const* columns, int* key,
                                  long long capacity, int nx, int num_tiles,
                                  int row_offset, int row_stride,
                                  int depth_bits, float p00, float p11,
                                  float fx, float fy, void* stream) {
  if (capacity < 0 || (capacity + kThreads - 1) / kThreads > INT_MAX ||
      depth_bits < 0 || depth_bits > 30 ||
      (static_cast<long long>(num_tiles) << depth_bits) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (capacity == 0) return 0;
  CullColumns cols;
  for (int i = 0; i < kCols; ++i) cols.col[i] = columns[i];
  pair_keys_kernel<<<blocks_of(capacity), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      pair_g, total, offsets, tx0, ty0, tx1, depth_q, cols, key, capacity,
      nx, num_tiles, row_offset, row_stride, depth_bits, p00, p11, fx, fy);
  return static_cast<int>(cudaGetLastError());
}
