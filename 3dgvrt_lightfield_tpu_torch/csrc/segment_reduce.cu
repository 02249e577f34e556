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
// Design: the warp-owned segment sums of `segment_rows.cuh`.  A warp owns
// 32 consecutive Gaussians of one group.  `build_reduce_plan` packs a
// group's live rows densely from its first block, in Gaussian order, and
// its dead rows after them, so the key 257 out_idx[b] + gloc does not
// decrease over the plan: a live row of Gaussian 256 k + i has key 257 k +
// i, a dead row of group k has 257 k + 256, below every key of group k + 1
// and above every live key of group k.  The warp's walk stops at the first
// dead row of its group, so the plan's unused tail (often a third of its
// rows) is never read.  A group with no block (a plan whose rows overflowed
// a caller's capacity, which reports overflow) gets zeros.
//
// Bound on this card: bytes.  Each live row is 256 bytes gathered once, the
// (N+1, 64) table written once, and the plan's ints read once; no
// arithmetic beyond one add per gathered float.

#include "segment_rows.cuh"

using namespace gvrt_rows;

namespace {

constexpr int kGroup = 256;
constexpr int kShift = 8;
// keys per group: 256 Gaussians and the dead rows' key
constexpr int kGroupKeys = kGroup + 1;
constexpr int kRunsPerGroup = kGroup / kRowsPerRun;

struct FullKey {
  const int* __restrict__ gloc;
  const int* __restrict__ out_idx;
  __device__ __forceinline__ int operator()(int r) const {
    return out_idx[r >> kShift] * kGroupKeys + gloc[r];
  }
};

__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const float* __restrict__ bar_flat,
                      const int* __restrict__ slot,
                      const int* __restrict__ gloc,
                      const int* __restrict__ out_idx,
                      float* __restrict__ out, int p_pad, int n_rows,
                      int n_runs) {
  const int lane = threadIdx.x % kWarp;
  const int run = blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (run >= n_runs) return;  // the whole warp
  const int k = run / kRunsPerGroup;
  const int i = (run % kRunsPerGroup) * kRowsPerRun + lane;
  warp_segment_rows(bar_flat, slot, p_pad, n_rows, FullKey{gloc, out_idx},
                    k * kGroupKeys + i, k * kGroup + i, out, lane);
}

}  // namespace

// bar_flat (p_pad, 64) f32, slot (nb * 256,) i32, gloc (nb, 256) i32,
// out_idx (nb,) i32 non-decreasing -> out (n_groups * 256, 64) f32.  All
// contiguous device memory.  Returns the CUDA error of the launch.
extern "C" int gvrt_segment_reduce(const float* bar_flat, const int* slot,
                                   const int* gloc, const int* out_idx,
                                   float* out, int p_pad, int nb,
                                   int n_groups, int cols, void* stream) {
  if (cols != kCols || p_pad <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups <= 0) return 0;
  const int n_runs = n_groups * kRunsPerGroup;
  const int blocks = (n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  segment_reduce_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      bar_flat, slot, gloc, out_idx, out, p_pad, nb * kGroup, n_runs);
  return static_cast<int>(cudaGetLastError());
}
