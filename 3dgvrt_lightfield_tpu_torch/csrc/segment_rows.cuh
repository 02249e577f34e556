// Warp-owned segment sums of 256-byte cotangent rows: the routine shared by
// the gradient reduces K3 (`segment_reduce.cu`) and K4
// (`segment_reduce_compact.cu`) for Hopper (sm_90a).
//
// Both reduces compute one function over two plans: output row o is the f32
// sum of bar_flat[min(slot[r], P - 1)] over the plan rows r whose key is
// o's key, where the keys of the plan rows do not decrease.  Here a warp
// owns a run of 32 output rows, lane l describing row l of the run: its
// index in `out` (or -1: no row) and its key (or kNone: a zero row).  The
// keys of a run's keyed lanes increase with the lane, so the rows that feed
// the run are one contiguous stretch of the plan.
//
//   * The warp finds the stretch's first row by a 32-ary search over the
//     non-decreasing keys (every lane probes one point a round: ~5 rounds
//     for millions of rows) and walks the rows in order, stopping at the
//     first row whose key is past the run's last key.
//   * Each lane reads the key and the clamped slot of one of the next 32
//     rows; they reach the other lanes by __shfl_sync.  Lane l holds columns
//     2l, 2l+1 of the row being summed (a float2), so one row is one
//     coalesced 256-byte warp load, and the loads of kUnroll rows are issued
//     before their adds.
//   * The sum stays in registers: no shared memory, so occupancy is set by
//     registers alone.  When the key changes, the finished row is written
//     (256 bytes, coalesced) to the lane whose key it is.
//   * Exact output: every output cell has one owner, which adds its rows in
//     row order starting from 0.0f, as the one-block-per-group kernels these
//     replaced did; the same bits on every run, no float atomics.
//   * Defined memory: every row of the run that no sum reached (no key, or a
//     key without rows) is written as zeros.

#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace gvrt_rows {

constexpr int kCols = 64;
constexpr int kWarp = 32;
constexpr int kUnroll = 8;
constexpr int kRowsPerRun = kWarp;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
// the key of no output row, above every real key
constexpr int kNone = INT_MAX;

// row `row` of a (rows, 64) f32 table
template <class T>
__device__ __forceinline__ T* bar_row(T* table, int row) {
  return table + static_cast<size_t>(row) * kCols;
}

// Smallest r in [0, n) with key(r) >= target (n if none), over keys that do
// not decrease.  Warp-uniform; every lane probes one point per round.
template <class Key>
__device__ __forceinline__ int warp_lower_bound(const Key& key, int n,
                                                int target, int lane) {
  int lo = 0, hi = n;  // key(r) < target for r < lo; key(hi) >= target
  while (lo < hi) {
    const int step = (hi - lo + kWarp - 1) / kWarp;
    const int p = min(lo + (lane + 1) * step, hi) - 1;  // in [lo, hi - 1]
    // the probes below target are a prefix of the lanes
    const int below = __popc(__ballot_sync(kFull, key(p) < target));
    const int p_lo = __shfl_sync(kFull, p, below > 0 ? below - 1 : 0);
    const int p_hi = __shfl_sync(kFull, p, below < kWarp ? below : 0);
    if (below > 0) lo = p_lo + 1;
    if (below < kWarp) hi = p_hi;
  }
  return lo;
}

// The warp's run: see the file comment.  `key(r)` is plan row r's key
// (r < n_rows); `my_row`/`my_key` describe this lane's output row.
template <class Key>
__device__ __forceinline__ void warp_segment_rows(
    const float* __restrict__ bar_flat, const int* __restrict__ slot,
    int p_pad, int n_rows, const Key& key, int my_key, int my_row,
    float* __restrict__ out, int lane) {
  const unsigned keyed = __ballot_sync(kFull, my_key != kNone);
  unsigned written = 0;
  if (keyed) {
    const int k_lo = __shfl_sync(kFull, my_key, __ffs(keyed) - 1);
    const int k_end = __shfl_sync(kFull, my_key, 31 - __clz(keyed)) + 1;
    int cur = kNone;  // the key being summed
    float2 acc = make_float2(0.0f, 0.0f);
    // the finished sum of `cur` goes to the lane whose key it is (a key of
    // the stretch that no lane holds is dropped: none arises in the plans)
    auto flush = [&]() {
      if (cur == kNone) return;
      const unsigned hit = __ballot_sync(kFull, my_key == cur);
      if (hit) {
        const int row = __shfl_sync(kFull, my_row, __ffs(hit) - 1);
        reinterpret_cast<float2*>(bar_row(out, row))[lane] = acc;
        written |= hit;
      }
    };
    bool done = false;
    for (int r0 = warp_lower_bound(key, n_rows, k_lo, lane);
         !done && r0 < n_rows; r0 += kWarp) {
      const int r = r0 + lane;
      const int rk = r < n_rows ? key(r) : kNone;
      const int rs = r < n_rows ? min(slot[r], p_pad - 1) : 0;
      for (int j = 0; j < kWarp && !done; j += kUnroll) {
        int kk[kUnroll];
        float2 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          kk[u] = __shfl_sync(kFull, rk, j + u);
          const int s = __shfl_sync(kFull, rs, j + u);
          v[u] = make_float2(0.0f, 0.0f);
          if (kk[u] < k_end)
            v[u] = reinterpret_cast<const float2*>(
                bar_row(bar_flat, s))[lane];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (done) continue;
          if (kk[u] >= k_end) {  // past the run: the walk ends
            done = true;
            continue;
          }
          if (kk[u] != cur) {
            flush();
            cur = kk[u];
            acc = make_float2(0.0f, 0.0f);
          }
          acc.x += v[u].x;
          acc.y += v[u].y;
        }
      }
    }
    flush();
  }
  // every row of the run that no sum reached is zero
  unsigned todo = __ballot_sync(kFull, my_row >= 0) & ~written;
  while (todo) {
    const int row = __shfl_sync(kFull, my_row, __ffs(todo) - 1);
    reinterpret_cast<float2*>(bar_row(out, row))[lane] =
        make_float2(0.0f, 0.0f);
    todo &= todo - 1;
  }
}

}  // namespace gvrt_rows
