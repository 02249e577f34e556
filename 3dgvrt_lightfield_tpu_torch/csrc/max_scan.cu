// Inclusive max-scan of a 1-D int64 array for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package fills its binning runs with
// `jax.lax.cummax`, an XLA op (`3dgvrt_lightfield_tpu/render/binning.py`,
// `_scatter_cummax_fill`).  The port's binning does the same four times a
// topology (pair -> Gaussian id, chunk -> tile, sorted pair -> padded-slot
// delta, reduce block -> output group); PyTorch's cummax runs a 1-D array as
// one row on one thread block and writes an index array nobody reads.  The
// plain version of this kernel's function is cummax's values; the Python
// wrapper `render/scan.py::max_scan` checks the input and launches this.
//
// What it computes: out[i] = max(in[0], ..., in[i]) for 0 <= i < n.  Max
// over int64 is exact and associative, so the result equals the sequential
// scan bit for bit in any order of evaluation.
//
// Bound on this card: bytes.  Each element is read once and written once,
// 16 bytes an element; one compare an element beside it.
//
// Design: one pass with decoupled look-back (Merrill and Garland, "Single-
// pass Parallel Prefix Scan with Decoupled Look-back", 2016).  A block takes
// a tile of kTile elements.  Its tile id comes from an atomic ticket, not
// from blockIdx, so a block only ever waits on blocks that have started.  It
// loads the tile with coalesced 16-byte loads into shared memory (swizzled:
// no bank conflicts either way), each thread scans its kItems consecutive
// elements in registers, warps combine with shuffles, and the block's local
// scan goes back to shared memory.  Warp 0 publishes the tile's maximum
// (status kAggregate), then looks back over its predecessors 32 at a time:
// each lane waits for a predecessor's status, the window stops at the
// nearest one that has published its inclusive prefix (kInclusive), and the
// lanes' values combine into the tile's carry-in.  Warp 0 then publishes the
// tile's inclusive prefix, and the block stores max(carry, local) with
// coalesced 16-byte stores.  Status words are written with release and read
// with acquire semantics; the values they guard are read through L2.
//
// Scratch (the wrapper's, int64 words): [ticket, status[tiles],
// aggregate[tiles], inclusive[tiles]].  The entry point clears the ticket
// and the status words on the stream before the launch; the values need no
// clearing, since a status guards each.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;                // elements a thread
constexpr int kVecs = kItems / 2;         // 16-byte vectors a thread
constexpr int kTile = kThreads * kItems;  // elements a block
constexpr int kWarps = kThreads / 32;
constexpr long long kLowest = LLONG_MIN;  // max's identity
constexpr long long kAggregate = 1;
constexpr long long kInclusive = 2;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ long long mx(long long a, long long b) {
  return a > b ? a : b;
}

// Shared-memory slot of the tile's 16-byte vector v: thread t's vectors t *
// kVecs + j sit at t * kVecs + (j ^ (t & 7)).  Eight neighbouring threads
// reading their j-th vector, and eight neighbouring vectors written in load
// order, then fall on eight distinct 16-byte bank groups.
__device__ __forceinline__ int slot(int v) { return v ^ ((v >> 3) & 7); }

__device__ __forceinline__ long long load_acquire(const long long* p) {
  long long v;
  asm volatile("ld.global.acquire.gpu.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(long long* p, long long v) {
  asm volatile("st.global.release.gpu.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__global__ void __launch_bounds__(kThreads)
max_scan_kernel(const long long* __restrict__ in, long long* __restrict__ out,
                long long n, long long* __restrict__ scratch, int tiles,
                bool aligned) {
  __shared__ __align__(16) long long buf[kTile];
  __shared__ long long warp_max[kWarps];
  __shared__ long long carry_in;
  __shared__ int tile_id;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  long long* status = scratch + 1;
  long long* aggregate = status + tiles;
  long long* inclusive = aggregate + tiles;

  if (tid == 0)
    tile_id = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned long long*>(scratch), 1ull));
  __syncthreads();
  const int tile = tile_id;
  const long long base = static_cast<long long>(tile) * kTile;
  const bool whole = aligned && n - base >= kTile;
  const int count = static_cast<int>(n - base < kTile ? n - base : kTile);
  longlong2* vbuf = reinterpret_cast<longlong2*>(buf);

  // the tile into shared memory, coalesced; past n the identity
  if (whole) {
    const longlong2* src = reinterpret_cast<const longlong2*>(in + base);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int v = k * kThreads + tid;
      vbuf[slot(v)] = src[v];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int e = k * kThreads + tid;
      buf[(slot(e >> 1) << 1) | (e & 1)] = e < count ? in[base + e] : kLowest;
    }
  }
  __syncthreads();

  // each thread's kItems consecutive elements, scanned in registers
  long long x[kItems];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const longlong2 p = vbuf[tid * kVecs + (j ^ (tid & 7))];
    x[2 * j] = p.x;
    x[2 * j + 1] = p.y;
  }
#pragma unroll
  for (int i = 1; i < kItems; ++i) x[i] = mx(x[i], x[i - 1]);

  // the threads' totals scanned across the warp, then across the block
  long long run = x[kItems - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long up = __shfl_up_sync(kAll, run, d);
    if (lane >= d) run = mx(run, up);
  }
  long long before = __shfl_up_sync(kAll, run, 1);
  if (lane == 0) before = kLowest;
  if (lane == 31) warp_max[warp] = run;
  __syncthreads();
  long long total = kLowest;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) before = mx(before, total);
    total = mx(total, warp_max[w]);
  }

  // the tile-local inclusive scan back into this thread's own slots
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    longlong2 p;
    p.x = mx(before, x[2 * j]);
    p.y = mx(before, x[2 * j + 1]);
    vbuf[tid * kVecs + (j ^ (tid & 7))] = p;
  }

  // the carry-in from the tiles before: decoupled look-back by warp 0
  if (warp == 0) {
    long long prefix = kLowest;
    if (tile == 0) {
      if (lane == 0) {
        inclusive[0] = total;
        store_release(status, kInclusive);
      }
    } else {
      if (lane == 0) {
        aggregate[tile] = total;
        store_release(status + tile, kAggregate);
      }
      for (int last = tile - 1;; last -= 32) {
        const int p = last - lane;  // lane 0 nearest
        long long s;
        do {
          s = p >= 0 ? load_acquire(status + p) : kInclusive;
        } while (__any_sync(kAll, s == 0));
        const unsigned inc = __ballot_sync(kAll, s == kInclusive);
        // the window ends at the nearest inclusive prefix, lanes past it
        // add nothing
        const int stop = inc ? __ffs(inc) - 1 : 31;
        long long v = kLowest;
        if (lane <= stop && p >= 0)
          v = __ldcg(s == kInclusive ? inclusive + p : aggregate + p);
#pragma unroll
        for (int d = 16; d; d >>= 1) v = mx(v, __shfl_xor_sync(kAll, v, d));
        prefix = mx(prefix, v);
        if (inc) break;
      }
      if (lane == 0) {
        inclusive[tile] = mx(prefix, total);
        store_release(status + tile, kInclusive);
      }
    }
    if (lane == 0) carry_in = prefix;
  }
  __syncthreads();
  const long long carry = carry_in;

  // max(carry, local scan) out, coalesced
  if (whole) {
    longlong2* dst = reinterpret_cast<longlong2*>(out + base);
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int v = k * kThreads + tid;
      longlong2 p = vbuf[slot(v)];
      p.x = mx(carry, p.x);
      p.y = mx(carry, p.y);
      dst[v] = p;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int e = k * kThreads + tid;
      if (e < count)
        out[base + e] = mx(carry, buf[(slot(e >> 1) << 1) | (e & 1)]);
    }
  }
}

long long tiles_of(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// int64 words of scratch that gvrt_max_scan needs for n elements.
extern "C" long long gvrt_max_scan_scratch_words(long long n) {
  return 1 + 3 * tiles_of(n);
}

// in, out: n >= 1 int64 on the card, not overlapping; scratch:
// gvrt_max_scan_scratch_words(n) int64 words on the card.  Clears the
// scratch's ticket and status words and launches on `stream`, without
// synchronising; returns the CUDA error of either.  16-byte aligned in and
// out take 16-byte loads and stores.
extern "C" int gvrt_max_scan(const long long* in, long long* out,
                             long long n, long long* scratch, void* stream) {
  const long long tiles = tiles_of(n);
  if (n < 1 || tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, static_cast<size_t>(1 + tiles) * sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(in) |
                         reinterpret_cast<std::uintptr_t>(out)) & 15) == 0;
  max_scan_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      in, out, n, scratch, static_cast<int>(tiles), aligned);
  return static_cast<int>(cudaGetLastError());
}
