// The parameter table of a frame, both ways, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds the table with XLA ops
// (`render/binning.py::param_rows` over `GaussianModel.activate`) and its
// backward by autodiff (`render/rows_vjp.py`).  The port did the same in
// eager PyTorch: some forty ops forward (cats of strided SH columns, stacks
// of 9 and 3 columns, a zero fill of the whole table) and some sixty launches
// over (N, 3, 3) temporaries backward.  The plain versions of these kernels'
// functions are `models/gaussians.py::activate_leaves` plus
// `render/binning.py::param_rows`, and `render/rows_vjp.py::_Rows64`'s plain
// backward; the Python wrappers `param_table_forward` and
// `param_table_backward` in `render/rows_vjp.py` check the inputs and launch
// these.
//
// What they compute, for N Gaussians with leaves means (N, 3), scales_log
// (N, 3), quats (N, 4) WXYZ, opacity_logit (N,), sh_dc (N, 3), sh_rest
// (N, 15, 3), all f32 and contiguous:
//  * forward: the (N+1, 64) table, row i = [M (9, row-major), b (3),
//    density, 0, 0, 0, SH (48, channel-major: [dc_c | rest_c] for c = 0..2)]
//    with M = diag(1 / s) R^T, b = M mean, s = exp(scales_log), R the
//    rotation of the normalized quaternion, density = sigmoid(opacity_logit);
//    row N the identity frame and zeros.  Besides, the activated view that
//    binning reads: scales (N, 3), inv_scales (N, 3), rot9 (N, 9),
//    densities (N,).
//  * backward: given the table's cotangent g (N+1, 64), the six leaves'
//    gradients in the leaves' shapes; g's row N is ignored.
//
// Bound on this card: bytes.  Forward: 59 floats read and 80 written a
// Gaussian (556 B); backward: 75 read and 59 written (536 B).  The
// arithmetic is ~100 f32 operations a Gaussian each way, noise beside that.
//
// Design: one thread per Gaussian, a block owns kG consecutive Gaussians,
// so every input and output slab of the block is one contiguous run of
// memory.  The block loads its slabs into shared memory with 16-byte loads
// (all issued before the first store to shared memory), each thread computes
// from shared memory, and the block writes every output slab back with
// 16-byte stores; the channel-major SH columns are transposed through shared
// memory on the way.  The table is written whole, row N by the block that
// owns it, so nothing is zero-filled first.  The forward rounds op by op in
// the plain version's order (`tile_common.cuh`'s mul/add/sub: no FMA
// contraction; IEEE division and square root; expf as PyTorch's exp calls
// it), so every output equals the plain version's bit for bit on the card.
// The backward follows `_Rows64`'s chain rule in the same way.

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

using gvrt::add;
using gvrt::mul;
using gvrt::sub;

constexpr int kG = 128;  // Gaussians a block, one a thread
constexpr int kThreads = kG;
constexpr int kCols = gvrt::kCols;  // 64 floats a table row
constexpr int kGeo = 16;            // table columns 0:16 (M, b, density, 0)
constexpr int kRest = 45;           // sh_rest floats a Gaussian
constexpr int kGStride = kCols + 4;  // a cotangent row in shared memory

// A slab of nb Gaussians of W floats, every pointer 16-byte aligned.  A
// whole block's slab moves global -> shared in kVec 16-byte vectors, loaded
// into registers by `load` and written to shared memory by `put`, so that a
// caller issues every slab's loads before the first store; the last, partial
// block's slab moves float by float in `copy`.
template <int W>
struct Slab {
  static constexpr int kVec = kG * W / 4;
  static constexpr int kPer = (kVec + kThreads - 1) / kThreads;

  __device__ __forceinline__ static void load(float4 (&v)[kPer],
                                              const float* __restrict__ src) {
    const float4* s = reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (kVec % kThreads == 0 || i < kVec) v[k] = s[i];
    }
  }

  __device__ __forceinline__ static void put(float* __restrict__ dst,
                                             const float4 (&v)[kPer]) {
    float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (kVec % kThreads == 0 || i < kVec) d[i] = v[k];
    }
  }

  __device__ __forceinline__ static void copy(float* __restrict__ dst,
                                              const float* __restrict__ src,
                                              int nb) {
    for (int i = threadIdx.x; i < nb * W; i += kThreads) dst[i] = src[i];
  }

  // shared -> global, dst 16-byte aligned: 16-byte stores, and float by
  // float the tail of a last, partial block
  __device__ __forceinline__ static void store(float* __restrict__ dst,
                                               const float* __restrict__ src,
                                               int nb) {
    const int count = nb * W, nv = count >> 2;
    float4* d = reinterpret_cast<float4*>(dst);
    const float4* s = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < nv; i += kThreads) d[i] = s[i];
    for (int i = (nv << 2) + threadIdx.x; i < count; i += kThreads)
      dst[i] = src[i];
  }
};

// dst[e] = value(e) for 0 <= e < count, dst 16-byte aligned: 16-byte
// stores, and float by float the tail
template <typename F>
__device__ __forceinline__ void store_each(float* __restrict__ dst, int count,
                                           F value) {
  const int nv = count >> 2;
  float4* d = reinterpret_cast<float4*>(dst);
  for (int c = threadIdx.x; c < nv; c += kThreads)
    d[c] = make_float4(value(4 * c), value(4 * c + 1), value(4 * c + 2),
                       value(4 * c + 3));
  for (int e = (nv << 2) + threadIdx.x; e < count; e += kThreads)
    dst[e] = value(e);
}

// torch.sum(q * q, -1) of a (N, 4) tensor on the card: a block row of four
// lanes, one element each, combined by shuffles at offsets 2 then 1
__device__ __forceinline__ float quat_norm2(float4 q) {
  return add(add(mul(q.x, q.x), mul(q.z, q.z)),
             add(mul(q.y, q.y), mul(q.w, q.w)));
}

// torch.sum over a last dimension of 3: lanes 0 and 1, lane 0 taking
// elements 0 and 2
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add(add(a, c), b);
}

// torch.sigmoid on the card: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, add(1.0f, expf(-x)));
}

struct Leaves {
  const float* means;
  const float* scales_log;
  const float* quats;
  const float* opacity;
  const float* sh_dc;
  const float* sh_rest;
};

struct Activated {
  float* rows;
  float* scales;
  float* inv_scales;
  float* rot9;
  float* densities;
};

__global__ void __launch_bounds__(kThreads)
param_table_forward_kernel(const Leaves in, const Activated out, int n) {
  __shared__ __align__(16) float s_m[kG * 3];
  __shared__ __align__(16) float s_sl[kG * 3];
  __shared__ __align__(16) float s_q[kG * 4];
  __shared__ __align__(16) float s_ol[kG];
  __shared__ __align__(16) float s_dc[kG * 3];
  __shared__ __align__(16) float s_rest[kG * kRest];
  __shared__ __align__(16) float s_geo[kG * kGeo];  // swizzled 16-byte units
  __shared__ __align__(16) float s_s[kG * 3];
  __shared__ __align__(16) float s_i[kG * 3];
  __shared__ __align__(16) float s_r[kG * 9];
  __shared__ __align__(16) float s_d[kG];

  const long long g0 = static_cast<long long>(blockIdx.x) * kG;
  const int nb = static_cast<int>(n - g0 < kG ? n - g0 : kG);  // >= 0
  const int nrows = nb < kG ? nb + 1 : kG;  // the last block has row N

  if (nb == kG) {
    float4 v_m[Slab<3>::kPer], v_sl[Slab<3>::kPer], v_q[Slab<4>::kPer],
        v_ol[Slab<1>::kPer], v_dc[Slab<3>::kPer], v_rest[Slab<kRest>::kPer];
    Slab<3>::load(v_m, in.means + g0 * 3);
    Slab<3>::load(v_sl, in.scales_log + g0 * 3);
    Slab<4>::load(v_q, in.quats + g0 * 4);
    Slab<1>::load(v_ol, in.opacity + g0);
    Slab<3>::load(v_dc, in.sh_dc + g0 * 3);
    Slab<kRest>::load(v_rest, in.sh_rest + g0 * kRest);
    Slab<3>::put(s_m, v_m);
    Slab<3>::put(s_sl, v_sl);
    Slab<4>::put(s_q, v_q);
    Slab<1>::put(s_ol, v_ol);
    Slab<3>::put(s_dc, v_dc);
    Slab<kRest>::put(s_rest, v_rest);
  } else if (nb > 0) {
    Slab<3>::copy(s_m, in.means + g0 * 3, nb);
    Slab<3>::copy(s_sl, in.scales_log + g0 * 3, nb);
    Slab<4>::copy(s_q, in.quats + g0 * 4, nb);
    Slab<1>::copy(s_ol, in.opacity + g0, nb);
    Slab<3>::copy(s_dc, in.sh_dc + g0 * 3, nb);
    Slab<kRest>::copy(s_rest, in.sh_rest + g0 * kRest, nb);
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < nb) {
    // normalize_quat: q / sqrt(sum(q * q))
    const float4 q = reinterpret_cast<const float4*>(s_q)[t];
    const float nrm = __fsqrt_rn(quat_norm2(q));
    const float w = __fdiv_rn(q.x, nrm), x = __fdiv_rn(q.y, nrm),
                y = __fdiv_rn(q.z, nrm), z = __fdiv_rn(q.w, nrm);
    // quat_to_rot9
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
    const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
    float r[9];
    r[0] = sub(1.0f, mul(2.0f, add(yy, zz)));
    r[1] = mul(2.0f, sub(xy, wz));
    r[2] = mul(2.0f, add(xz, wy));
    r[3] = mul(2.0f, add(xy, wz));
    r[4] = sub(1.0f, mul(2.0f, add(xx, zz)));
    r[5] = mul(2.0f, sub(yz, wx));
    r[6] = mul(2.0f, sub(xz, wy));
    r[7] = mul(2.0f, add(yz, wx));
    r[8] = sub(1.0f, mul(2.0f, add(xx, yy)));
    // scale_activation, 1.0 / scales (reciprocal), sigmoid
    float s[3], inv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s[i] = expf(s_sl[3 * t + i]);
      inv[i] = __fdiv_rn(1.0f, s[i]);
    }
    const float dens = sigmoid(s_ol[t]);
    const float m0 = s_m[3 * t], m1 = s_m[3 * t + 1], m2 = s_m[3 * t + 2];
    // param_rows: M[i, k] = inv_s[i] * R[k, i]; b_i = inv_s[i] (R^T m)_i
    float geo[kGeo];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k) geo[3 * i + k] = mul(inv[i], r[3 * k + i]);
      geo[9 + i] = mul(inv[i], add(add(mul(r[i], m0), mul(r[3 + i], m1)),
                                   mul(r[6 + i], m2)));
    }
    geo[12] = dens;
    geo[13] = geo[14] = geo[15] = 0.0f;
    // unit u of row t at 4 t + (u ^ ((t >> 1) & 3)): 8 threads' 16-byte
    // stores fall in distinct banks, and so do the rows' readers below
    float4* g4 = reinterpret_cast<float4*>(s_geo);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      g4[4 * t + (u ^ ((t >> 1) & 3))] =
          make_float4(geo[4 * u], geo[4 * u + 1], geo[4 * u + 2],
                      geo[4 * u + 3]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s_s[3 * t + i] = s[i];
      s_i[3 * t + i] = inv[i];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) s_r[9 * t + k] = r[k];
    s_d[t] = dens;
  }
  __syncthreads();

  if (nb > 0) {
    Slab<3>::store(out.scales + g0 * 3, s_s, nb);
    Slab<3>::store(out.inv_scales + g0 * 3, s_i, nb);
    Slab<9>::store(out.rot9 + g0 * 9, s_r, nb);
    Slab<1>::store(out.densities + g0, s_d, nb);
  }
  // the table's rows g0 .. g0 + nrows - 1, one 16-byte unit a thread at a
  // time: units 0-3 from s_geo, 4-15 the SH columns from s_dc and s_rest
  float4* rows4 = reinterpret_cast<float4*>(out.rows + g0 * kCols);
  const float4* g4 = reinterpret_cast<const float4*>(s_geo);
  for (int c = threadIdx.x; c < nrows * (kCols / 4); c += kThreads) {
    const int row = c >> 4, u = c & 15;
    float4 v;
    if (row == nb) {  // row N: the identity frame, zero density and SH
      v = make_float4(u < 3 ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f);
    } else if (u < 4) {
      v = g4[4 * row + (u ^ ((row >> 1) & 3))];
    } else {
      const int ch = (u - 4) >> 2;     // channel of columns 4u .. 4u + 3
      const int j0 = ((u - 4) & 3) * 4;  // its first coefficient
      float e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + k;
        e[k] = j == 0 ? s_dc[3 * row + ch]
                      : s_rest[kRest * row + 3 * (j - 1) + ch];
      }
      v = make_float4(e[0], e[1], e[2], e[3]);
    }
    rows4[c] = v;
  }
}

struct Grads {
  float* means;
  float* scales_log;
  float* quats;
  float* opacity;
  float* sh_dc;
  float* sh_rest;
};

__global__ void __launch_bounds__(kThreads)
param_table_backward_kernel(const float* __restrict__ g, const Leaves in,
                            const Grads out, int n) {
  // the cotangent rows at a stride of 68 floats: a thread's 16-byte reads
  // of its own row and the SH transposes' reads spread over the banks
  __shared__ __align__(16) float s_g[kG * kGStride];
  // the geometric leaves, overwritten in place by their gradients
  __shared__ __align__(16) float s_m[kG * 3];
  __shared__ __align__(16) float s_sl[kG * 3];
  __shared__ __align__(16) float s_q[kG * 4];
  __shared__ __align__(16) float s_ol[kG];

  const long long g0 = static_cast<long long>(blockIdx.x) * kG;
  const int nb = static_cast<int>(n - g0 < kG ? n - g0 : kG);  // >= 1

  const float* gb = g + g0 * kCols;
  if (nb == kG) {
    constexpr int kPer = kG * kCols / 4 / kThreads;
    float4 v_g[kPer];
    float4 v_m[Slab<3>::kPer], v_sl[Slab<3>::kPer], v_q[Slab<4>::kPer],
        v_ol[Slab<1>::kPer];
    const float4* g4 = reinterpret_cast<const float4*>(gb);
#pragma unroll
    for (int k = 0; k < kPer; ++k) v_g[k] = g4[threadIdx.x + k * kThreads];
    Slab<3>::load(v_m, in.means + g0 * 3);
    Slab<3>::load(v_sl, in.scales_log + g0 * 3);
    Slab<4>::load(v_q, in.quats + g0 * 4);
    Slab<1>::load(v_ol, in.opacity + g0);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int c = threadIdx.x + k * kThreads;
      reinterpret_cast<float4*>(s_g + (c >> 4) * kGStride)[c & 15] = v_g[k];
    }
    Slab<3>::put(s_m, v_m);
    Slab<3>::put(s_sl, v_sl);
    Slab<4>::put(s_q, v_q);
    Slab<1>::put(s_ol, v_ol);
  } else {
    for (int i = threadIdx.x; i < nb * kCols; i += kThreads)
      s_g[(i >> 6) * kGStride + (i & 63)] = gb[i];
    Slab<3>::copy(s_m, in.means + g0 * 3, nb);
    Slab<3>::copy(s_sl, in.scales_log + g0 * 3, nb);
    Slab<4>::copy(s_q, in.quats + g0 * 4, nb);
    Slab<1>::copy(s_ol, in.opacity + g0, nb);
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < nb) {
    const float4* row4 = reinterpret_cast<const float4*>(s_g + t * kGStride);
    const float4 c0 = row4[0], c1 = row4[1], c2 = row4[2], c3 = row4[3];
    // gM[i][k] = d M[i, k], gb[i] = d b_i
    const float gM[3][3] = {{c0.x, c0.y, c0.z}, {c0.w, c1.x, c1.y},
                            {c1.z, c1.w, c2.x}};
    const float gbv[3] = {c2.y, c2.z, c2.w};
    const float g12 = c3.x;
    const float m[3] = {s_m[3 * t], s_m[3 * t + 1], s_m[3 * t + 2]};

    // recompute the frame: u = 1/s, the unit quaternion (w, v), R
    float u[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = expf(-s_sl[3 * t + i]);
    const float4 q = reinterpret_cast<const float4*>(s_q)[t];
    const float qinv = __fdiv_rn(1.0f, __fsqrt_rn(quat_norm2(q)));
    const float qn[4] = {mul(q.x, qinv), mul(q.y, qinv), mul(q.z, qinv),
                         mul(q.w, qinv)};
    const float w = qn[0];
    const float v[3] = {qn[1], qn[2], qn[3]};
    const float w2 = mul(2.0f, w);
    const float a = mul(w2, v[0]), b = mul(w2, v[1]), c = mul(w2, v[2]);
    // R = 2 v v^T + 2 w [v]x, then its diagonal + (1 - its trace)
    const float skew[3][3] = {{0.0f, -c, b}, {c, 0.0f, -a}, {-b, a, 0.0f}};
    float R[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int l = 0; l < 3; ++l)
        R[k][l] = add(mul(mul(2.0f, v[k]), v[l]), skew[k][l]);
    const float fix = sub(1.0f, sum3(R[0][0], R[1][1], R[2][2]));
#pragma unroll
    for (int k = 0; k < 3; ++k) R[k][k] = add(R[k][k], fix);

    // chain rule: M[i, k] = u_i R[k, i], b_i = u_i (R^T m)_i
    float d_sl[3], ug[3], dRt[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float ti = sum3(mul(R[0][i], m[0]), mul(R[1][i], m[1]),
                            mul(R[2][i], m[2]));
      const float gr = sum3(mul(gM[i][0], R[0][i]), mul(gM[i][1], R[1][i]),
                            mul(gM[i][2], R[2][i]));
      d_sl[i] = mul(-u[i], add(gr, mul(gbv[i], ti)));
      ug[i] = mul(u[i], gbv[i]);
    }
    float d_m[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d_m[k] = sum3(mul(R[k][0], ug[0]), mul(R[k][1], ug[1]),
                    mul(R[k][2], ug[2]));
    // dRt[i][k] = d R[k, i] = u_i gM[i, k] + u_i gb_i m_k
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dRt[i][k] = add(mul(u[i], gM[i][k]), mul(ug[i], m[k]));

    // quaternion backward: d w = 2 s.v, d v = 2 (dR + dR^T) v - 4 tr(dR) v
    // + 2 w s, s = vee(dR - dR^T)
    const float s[3] = {sub(dRt[1][2], dRt[2][1]), sub(dRt[2][0], dRt[0][2]),
                        sub(dRt[0][1], dRt[1][0])};
    const float tr = sum3(dRt[0][0], dRt[1][1], dRt[2][2]);
    const float tr4 = mul(4.0f, tr);
    float dqn[4];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float sym = sum3(mul(add(dRt[i][0], dRt[0][i]), v[0]),
                             mul(add(dRt[i][1], dRt[1][i]), v[1]),
                             mul(add(dRt[i][2], dRt[2][i]), v[2]));
      dqn[1 + i] = sub(mul(2.0f, add(sym, mul(w, s[i]))), mul(tr4, v[i]));
    }
    dqn[0] = mul(2.0f, sum3(mul(s[0], v[0]), mul(s[1], v[1]),
                            mul(s[2], v[2])));
    // qn = q / |q|:  dq = (dqn - qn (qn . dqn)) / |q|
    const float dot = add(add(mul(qn[0], dqn[0]), mul(qn[2], dqn[2])),
                          add(mul(qn[1], dqn[1]), mul(qn[3], dqn[3])));
    float d_q[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) d_q[k] = mul(sub(dqn[k], mul(qn[k], dot)), qinv);

    // opacity: density = sigmoid(ol), column 12 its only consumer
    const float sig = sigmoid(s_ol[t]);
    const float d_ol = mul(mul(g12, sig), sub(1.0f, sig));

    // each thread overwrites the slots it alone read
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_m[3 * t + k] = d_m[k];
      s_sl[3 * t + k] = d_sl[k];
    }
    reinterpret_cast<float4*>(s_q)[t] =
        make_float4(d_q[0], d_q[1], d_q[2], d_q[3]);
    s_ol[t] = d_ol;
  }
  __syncthreads();

  Slab<3>::store(out.means + g0 * 3, s_m, nb);
  Slab<3>::store(out.scales_log + g0 * 3, s_sl, nb);
  Slab<4>::store(out.quats + g0 * 4, s_q, nb);
  Slab<1>::store(out.opacity + g0, s_ol, nb);
  // SH: table columns 16 + 16 c + j are channel-major [dc_c | rest_c];
  // sh_dc[:, c] = column 16 + 16 c, sh_rest[:, j - 1, c] = 16 + 16 c + j
  store_each(out.sh_dc + g0 * 3, nb * 3, [&](int e) {
    const int row = e / 3, ch = e - 3 * row;
    return s_g[row * kGStride + 16 + 16 * ch];
  });
  store_each(out.sh_rest + g0 * kRest, nb * kRest, [&](int e) {
    const int row = e / kRest, r = e - kRest * row;
    const int j = r / 3 + 1, ch = r - 3 * (j - 1);
    return s_g[row * kGStride + 16 + 16 * ch + j];
  });
}

}  // namespace

// Leaves: f32 on the card, contiguous, 16-byte aligned, n Gaussians
// (0 <= n < 2^31 - kG).  rows: (n + 1, 64); scales, inv_scales: (n, 3);
// rot9: (n, 9); densities: (n,), all f32 on the card, 16-byte aligned, not
// overlapping the leaves.  Every entry is written.  Launches on `stream`,
// does not synchronise; returns the CUDA error of the launch.
extern "C" int gvrt_param_table_forward(
    const float* means, const float* scales_log, const float* quats,
    const float* opacity_logit, const float* sh_dc, const float* sh_rest,
    float* rows, float* scales, float* inv_scales, float* rot9,
    float* densities, long long n, void* stream) {
  if (n < 0 || n > 0x7fffffffLL - kG)
    return static_cast<int>(cudaErrorInvalidValue);
  const Leaves in{means, scales_log, quats, opacity_logit, sh_dc, sh_rest};
  const Activated out{rows, scales, inv_scales, rot9, densities};
  const unsigned blocks = static_cast<unsigned>(n / kG + 1);  // row n too
  param_table_forward_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      in, out, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

// g: (n + 1, 64) f32 on the card, contiguous, 16-byte aligned; the four
// geometric leaves as for the forward (sh_dc and sh_rest are not read); the
// six gradients in the leaves' shapes, f32 on the card, contiguous, 16-byte
// aligned, not overlapping the inputs.  Row n of g is not read.  Every
// entry is written.  Launches on `stream`, does not synchronise; returns the
// CUDA error of the launch.
extern "C" int gvrt_param_table_backward(
    const float* g, const float* means, const float* scales_log,
    const float* quats, const float* opacity_logit, float* d_means,
    float* d_scales_log, float* d_quats, float* d_opacity_logit,
    float* d_sh_dc, float* d_sh_rest, long long n, void* stream) {
  if (n < 0 || n > 0x7fffffffLL - kG)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const Leaves in{means, scales_log, quats, opacity_logit, nullptr, nullptr};
  const Grads out{d_means, d_scales_log, d_quats, d_opacity_logit, d_sh_dc,
                  d_sh_rest};
  const unsigned blocks = static_cast<unsigned>((n + kG - 1) / kG);
  param_table_backward_kernel<<<blocks, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      g, in, out, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}
