// Compact per-Gaussian gradient reduce of the banded path for Hopper
// (sm_90a): K4.
//
// Replaces the JAX package's Pallas kernel
// `render/segreduce.py::_kernel_compact` (launched by
// `segment_reduce_compact` for `param_grads._bwd_segreduce_compact`).  The
// plain PyTorch version of the same function is
// `render/segreduce.py::segment_reduce_compact_plain`; the Python wrapper
// `segment_reduce_compact` in that module checks the inputs and launches
// this.
//
// What it computes: over a CompactReducePlan (`build_reduce_plan_compact`),
// whose rows are the band's live pairs in rank order, row r carries the
// compact id cid(r) = (k0[r / 256] << 8) + cloc[r] of its Gaussian and the
// padded slot slot[r] of its cotangent.  Output row `cid` is the f32 sum of
// bar_flat[min(slot[r], P - 1)] over the rows r with that compact id (the
// gather of `param_grads._bwd_segreduce_compact`, fused in).  Ids with no
// row get zeros: every one of the n_groups * 256 output rows is written.
//
// Design:
//   * The TPU kernel carried two accumulators per 256-row input block,
//     because a Pallas output block is revisited only by consecutive grid
//     steps and a dense block spans two output groups; the plan's spill
//     group exists to zero the second one.  Here one block owns one output
//     group of 256 compact ids.  Compact ids are nondecreasing over the
//     rows (pad rows, id 0x3FFFFFFF, sit at the end), so the block finds the
//     group's first row by a binary search and walks its rows in order,
//     256 at a time, staging their slots and local ids in shared memory.
//   * The group's (256, 64) sums live in shared memory (64 KB); thread t
//     owns column t % 64 of the quarter t / 64 of the group's ids, so every
//     cell has one owner and adds its rows in row order: no float atomics,
//     the same bits on every run.  A row's 64 columns are read by the two
//     warps of its owning quarter, 256 contiguous bytes; loads of kUnroll
//     rows are issued before their sums, so the gather latency overlaps.
//
// Bound on this card: bytes.  Each live row is 256 bytes gathered once,
// the (cap_live, 64) table written once, and each row's slot and local id
// read once; no arithmetic beyond one add per gathered float.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 256;
constexpr int kShift = 8;
constexpr int kCols = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ int row_cid(const int* __restrict__ k0,
                                       const int* __restrict__ cloc, int r) {
  return (k0[r >> kShift] << kShift) + cloc[r];
}

__global__ void __launch_bounds__(kThreads)
segment_reduce_compact_kernel(const float* __restrict__ bar_flat,
                              const int* __restrict__ slot,
                              const int* __restrict__ cloc,
                              const int* __restrict__ k0,
                              float* __restrict__ out, int p_pad,
                              int n_rows) {
  extern __shared__ float acc[];  // kGroup x kCols
  __shared__ int s_slot[kGroup];
  __shared__ int s_loc[kGroup];
  const int t = threadIdx.x;
  const int col = t & (kCols - 1);
  const int quarter = t >> 6;
  const int id0 = blockIdx.x << kShift;  // first compact id of the group

  for (int i = t; i < kGroup * kCols; i += kThreads) acc[i] = 0.0f;

  // first row of the group: lower bound of id0 over the nondecreasing ids
  int lo = 0, hi = n_rows;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (row_cid(k0, cloc, mid) < id0) lo = mid + 1; else hi = mid;
  }
  for (int r0 = lo; r0 < n_rows; r0 += kGroup) {
    // every thread reads the same id: the exit is uniform over the block
    if (row_cid(k0, cloc, r0) >= id0 + kGroup) break;
    __syncthreads();  // the previous batch's staged rows are consumed
    const int r = r0 + t;
    int loc = kGroup, s = 0;  // kGroup: a row of no id of this group
    if (r < n_rows) {
      const unsigned d = static_cast<unsigned>(row_cid(k0, cloc, r) - id0);
      if (d < static_cast<unsigned>(kGroup)) {
        loc = static_cast<int>(d);
        s = min(slot[r], p_pad - 1);
      }
    }
    s_slot[t] = s;
    s_loc[t] = loc;
    __syncthreads();
    for (int i0 = 0; i0 < kGroup; i0 += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int gl = s_loc[i0 + j];
        v[j] = 0.0f;
        if ((gl >> 6) == quarter)  // a row of my quarter (none: 256)
          v[j] = bar_flat[static_cast<size_t>(s_slot[i0 + j]) * kCols + col];
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int gl = s_loc[i0 + j];
        if ((gl >> 6) == quarter) acc[gl * kCols + col] += v[j];
      }
    }
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(blockIdx.x) * kGroup * kCols;
  for (int i = t; i < kGroup * kCols; i += kThreads) dst[i] = acc[i];
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
  if (cols != kCols || p_pad <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups <= 0) return 0;
  const size_t smem = sizeof(float) * kGroup * kCols;
  cudaError_t err = cudaFuncSetAttribute(
      segment_reduce_compact_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_reduce_compact_kernel<<<n_groups, kThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      bar_flat, slot, cloc, k0, out, p_pad, nb * kGroup);
  return static_cast<int>(cudaGetLastError());
}
