// Segmented per-Gaussian gradient reduce for Hopper (sm_90a): K3.
//
// Replaces the JAX package's Pallas kernel `render/segreduce.py::_kernel`
// (launched by `segment_reduce` for `param_grads._bwd_segreduce`).  The plain
// PyTorch version of the same function is
// `render/segreduce.py::segment_reduce_plain`; the Python wrapper
// `segment_reduce` in that module checks the inputs and launches this.
//
// What it computes: over a ReducePlan (`build_reduce_plan`), where each
// group k of 256 consecutive Gaussian ids owns the consecutive input blocks
// b with out_idx[b] == k (256 rows each), output row 256 k + i is the f32
// sum of the rows of block rows with gloc == i, each row gathered as
// bar_flat[min(slot, P - 1)] (the gather of `param_grads._bwd_segreduce`,
// fused in).  Rows with gloc == 256 are dead and add nothing.
//
// Design:
//   * One block per output group, 256 threads.  The group's (256, 64) sums
//     live in shared memory (64 KB); thread t owns column t % 64 of the
//     quarter t / 64 of the group's Gaussians, so every cell has one owner
//     and adds its rows in row order: no float atomics, the same bits on
//     every run.  The TPU's 0/1 selection matmul existed to reach the MXU;
//     here the sum is a plain segmented sum.
//   * The block finds its first input block by a binary search of the
//     non-decreasing out_idx and walks the group's blocks in order, staging
//     each block's slot and gloc in shared memory.  `build_reduce_plan`
//     packs a group's live rows densely from its first block, so the walk
//     stops at the first block whose first row is dead: the unused tail of
//     the planned rows (out_idx of the last group, often a third of them)
//     is never read (walking it made one block serial over it).  A row's
//     64 columns are read by the two warps of its owning quarter, 256
//     contiguous bytes; the other quarters' warps skip it.  Loads of kUnroll rows are issued
//     before their sums, so the gather latency overlaps.
//   * Every output row is written: a group with no block (a plan whose rows
//     overflowed a caller's capacity, which reports overflow) gets zeros.
//
// Bound on this card: bytes.  Each live row is 256 bytes gathered once, the
// (N+1, 64) table written once, and the plan's ints read once; no
// arithmetic beyond one add per gathered float.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 256;
constexpr int kCols = 64;
constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ bar_flat,
                      const int* __restrict__ slot,
                      const int* __restrict__ gloc,
                      const int* __restrict__ out_idx,
                      float* __restrict__ out, int p_pad, int nb) {
  extern __shared__ float acc[];  // kGroup x kCols
  __shared__ int s_slot[kGroup];
  __shared__ int s_gloc[kGroup];
  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int col = t & (kCols - 1);
  const int quarter = t >> 6;

  for (int i = t; i < kGroup * kCols; i += kThreads) acc[i] = 0.0f;

  // first input block of group k: lower bound of k in out_idx
  int lo = 0, hi = nb;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (out_idx[mid] < k) lo = mid + 1; else hi = mid;
  }
  for (int b = lo; b < nb && out_idx[b] == k; ++b) {
    // live rows come first in a group's blocks: a dead first row ends them
    if (gloc[static_cast<size_t>(b) * kGroup] >= kGroup) break;
    __syncthreads();  // the previous block's staged indices are consumed
    s_slot[t] = slot[static_cast<size_t>(b) * kGroup + t];
    s_gloc[t] = gloc[static_cast<size_t>(b) * kGroup + t];
    __syncthreads();
    for (int i0 = 0; i0 < kGroup; i0 += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int gl = s_gloc[i0 + j];
        v[j] = 0.0f;
        if ((gl >> 6) == quarter) {  // live row of my quarter (dead: 256)
          const int s = min(s_slot[i0 + j], p_pad - 1);
          v[j] = bar_flat[static_cast<size_t>(s) * kCols + col];
        }
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int gl = s_gloc[i0 + j];
        if ((gl >> 6) == quarter) acc[gl * kCols + col] += v[j];
      }
    }
  }
  __syncthreads();
  float* dst = out + static_cast<size_t>(k) * kGroup * kCols;
  for (int i = t; i < kGroup * kCols; i += kThreads) dst[i] = acc[i];
}

}  // namespace

// bar_flat (p_pad, 64) f32, slot (nb * 256,) i32, gloc (nb, 256) i32,
// out_idx (nb,) i32 non-decreasing -> out (n_groups * 256, 64) f32.  All
// contiguous device memory.  Returns the CUDA error of the launch.
extern "C" int gvrt_segment_reduce(const float* bar_flat, const int* slot,
                                   const int* gloc, const int* out_idx,
                                   float* out, int p_pad, int nb,
                                   int n_groups, int cols, void* stream) {
  if (cols != kCols) return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups <= 0) return 0;
  const size_t smem = sizeof(float) * kGroup * kCols;
  cudaError_t err = cudaFuncSetAttribute(
      segment_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_reduce_kernel<<<n_groups, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      bar_flat, slot, gloc, out_idx, out, p_pad, nb);
  return static_cast<int>(cudaGetLastError());
}
