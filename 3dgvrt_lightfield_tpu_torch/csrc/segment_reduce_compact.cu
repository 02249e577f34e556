// Compact per-Gaussian gradient reduce of the banded path for Hopper
// (sm_90a): K4, in two modes.
//
// Replaces the JAX package's Pallas kernel
// `render/segreduce.py::_kernel_compact` (launched by
// `segment_reduce_compact` for `param_grads._bwd_segreduce_compact`).  The
// plain PyTorch versions of the same functions are
// `render/segreduce.py::segment_reduce_compact_plain` and
// `segment_reduce_compact_table_plain`; the Python wrappers
// `segment_reduce_compact` and `segment_reduce_compact_table` in that module
// check the inputs and launch these.
//
// What it computes: over a CompactReducePlan (`build_reduce_plan_compact`),
// whose rows are the band's live pairs in rank order, row r carries the
// compact id cid(r) = (k0[r / 256] << 8) + cloc[r] of its Gaussian and the
// padded slot slot[r] of its cotangent.  Compact ids do not decrease over
// the rows (pad rows, id 0x3FFFFFFF, sit at the end).  The sum of compact id
// c is the f32 sum of bar_flat[min(slot[r], P - 1)] over the rows r with
// cid(r) == c (the gather of `param_grads._bwd_segreduce_compact`, fused
// in).
//   * Compact mode: output row c (of n_groups * 256) is the sum of c; ids
//     with no row are zero.  This is the JAX kernel's function.
//   * Table mode: the (n_rows, 64) parameter-table gradient, the JAX
//     package's `param_grads._bwd_segreduce_compact` in one launch (compact
//     sums, then their expansion through the plan's live-id window).  Table
//     row base + i, for i < W, holds the sum of compact id src_range[i], or
//     zeros where that is the sentinel cap_live (a dead or overflowed
//     Gaussian); rows outside [base, base + W) are zero.  The renumbering
//     keeps order, so the live compact ids of consecutive table rows are
//     consecutive.
//
// Design: the warp-owned segment sums of `segment_rows.cuh`, keyed on the
// compact id.  A warp owns 32 consecutive output rows: in compact mode the
// ids 32 q .. 32 q + 31, in table mode the table rows 32 q .. 32 q + 31 and
// through src_range their compact ids.  The TPU kernel carried two
// accumulators per input block because a Pallas output block is revisited
// only by consecutive grid steps; the plan's spill group exists to zero the
// second one.  Here nothing carries over between warps, and the spill group
// is not needed.  Table mode writes the table directly: the compact sums and
// the (W, 64) window never reach device memory.
//
// Bound on this card: bytes.  Each live row is 256 bytes gathered once, its
// slot and local id read once, the output written once (compact mode: the
// (cap_live, 64) sums; table mode: the (n_rows, 64) table and the window's
// src_range read); no arithmetic beyond one add per gathered float.

#include "segment_rows.cuh"

using namespace gvrt_rows;

namespace {

constexpr int kGroup = 256;
constexpr int kShift = 8;

struct CompactKey {
  const int* __restrict__ cloc;
  const int* __restrict__ k0;
  __device__ __forceinline__ int operator()(int r) const {
    return (k0[r >> kShift] << kShift) + cloc[r];
  }
};

__global__ void __launch_bounds__(kThreads)
segment_reduce_compact_kernel(const float* __restrict__ bar_flat,
                              const int* __restrict__ slot,
                              const int* __restrict__ cloc,
                              const int* __restrict__ k0,
                              float* __restrict__ out, int p_pad,
                              int n_rows, int n_runs) {
  const int lane = threadIdx.x % kWarp;
  const int run = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (run >= n_runs) return;  // the whole warp
  const int id = run * kRowsPerRun + lane;
  warp_segment_rows(bar_flat, slot, p_pad, n_rows, CompactKey{cloc, k0}, id,
                    id, out, lane);
}

__global__ void __launch_bounds__(kThreads)
segment_reduce_compact_table_kernel(const float* __restrict__ bar_flat,
                                    const int* __restrict__ slot,
                                    const int* __restrict__ cloc,
                                    const int* __restrict__ k0,
                                    const int* __restrict__ src_range,
                                    const int* __restrict__ base,
                                    float* __restrict__ out, int p_pad,
                                    int n_rows, int cap_live, int window,
                                    int table_rows) {
  const int lane = threadIdx.x % kWarp;
  const int run = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  const int j = run * kRowsPerRun + lane;  // this lane's table row
  if (run * kRowsPerRun >= table_rows) return;  // the whole warp
  int key = kNone;
  const int i = j - base[0];
  if (j < table_rows && i >= 0 && i < window) {
    const int c = src_range[i];
    if (c < cap_live) key = c;
  }
  warp_segment_rows(bar_flat, slot, p_pad, n_rows, CompactKey{cloc, k0}, key,
                    j < table_rows ? j : -1, out, lane);
}

}  // namespace

// bar_flat (p_pad, 64) f32, slot (nb * 256,) i32, cloc (nb, 256) i32,
// k0 (nb,) i32 -> out (n_groups * 256, 64) f32.  All contiguous device
// memory.  Returns the CUDA error of the launch.
extern "C" int gvrt_segment_reduce_compact(const float* bar_flat,
                                           const int* slot, const int* cloc,
                                           const int* k0, float* out,
                                           int p_pad, int nb, int n_groups,
                                           int cols, void* stream) {
  if (cols != kCols || p_pad <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups <= 0) return 0;
  const int n_runs = n_groups * (kGroup / kRowsPerRun);
  const int blocks = (n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_reduce_compact_kernel<<<blocks, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      bar_flat, slot, cloc, k0, out, p_pad, nb * kGroup, n_runs);
  return static_cast<int>(cudaGetLastError());
}

// The same plan, src_range (window,) i32 and base (1,) i32 -> out
// (table_rows, 64) f32, the parameter-table gradient.  cap_live = n_groups
// * 256 is the sentinel of src_range.  All contiguous device memory.
// Returns the CUDA error of the launch.
extern "C" int gvrt_segment_reduce_compact_table(
    const float* bar_flat, const int* slot, const int* cloc, const int* k0,
    const int* src_range, const int* base, float* out, int p_pad, int nb,
    int cap_live, int window, int table_rows, int cols, void* stream) {
  if (cols != kCols || p_pad <= 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (table_rows <= 0) return 0;
  const int n_runs = (table_rows + kRowsPerRun - 1) / kRowsPerRun;
  const int blocks = (n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_reduce_compact_table_kernel<<<blocks, kThreads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
      bar_flat, slot, cloc, k0, src_range, base, out, p_pad, nb * kGroup,
      cap_live, window, table_rows);
  return static_cast<int>(cudaGetLastError());
}
