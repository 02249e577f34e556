// Camera rays in the tile layout for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds its rays on the host in
// NumPy (`io/cameras.py::Camera.rays`, then `render/binning.py::tile_rays`),
// and the port did the same, then copied them to the card and cut them into
// tiles with some sixty small PyTorch ops.  The plain version of this
// kernel's function is `render/binning.py::tile_ray_rows` applied to
// `Camera.rays()`; the Python wrapper `camera_rays_kernel` in that module
// checks the inputs and launches this.
//
// What it computes: for an H x W camera cut into T tiles of ts x ts pixels
// (R = ts * ts rays a tile, nx = W / ts tiles a row), the (T, 24, R) f32
// rays that `tile_ray_rows` returns: rows [o, d, tmin, tmax, the 16 SH basis
// values of d (zero above (sh_degree + 1)^2)].  Ray r of tile t is pixel
// (y, x) = ((t / nx) * ts + r / ts, (t % nx) * ts + r % ts).
//
// Bound on this card: bytes.  Each ray is written once, 96 bytes (plus the
// 4-byte read of its tmax clip where one is given); its arithmetic is ~60
// f64 and ~50 f32 operations, noise beside the write.
//
// Design: one thread per ray, threads in output order (flat index t * R +
// r), so each of a warp's 24 row stores is one run of consecutive floats,
// for any R (a tile of 400 rays shares a warp with the next tile).  The
// camera travels by value in the kernel's parameters: no copy to the card.
// Arithmetic rounds op by op in the plain version's order (the idiom of
// `tile_common.cuh`: no FMA contraction): the direction in f64 as NumPy
// computes it in `Camera.rays`, rounded once to f32, and rows 6:24 in f32 as
// PyTorch computes them in `tile_ray_rows`, so on every ray whose direction
// equals NumPy's every row equals the plain version's bit for bit.  The f64
// sums may run in another order than NumPy's BLAS product, which may move a
// direction by one f32 ulp on rare rays.

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

using gvrt::add;
using gvrt::kRayRows;
using gvrt::mul;
using gvrt::sub;

constexpr int kThreads = 256;
constexpr int kBasis = kRayRows - 8;

// the constants of config.py and ops/aabb.py, as PyTorch rounds a Python
// float to f32
constexpr float kC0 = static_cast<float>(0.28209479177387814);
constexpr float kC1 = static_cast<float>(0.4886025119029199);
constexpr float kMinusC1 = static_cast<float>(-0.4886025119029199);
constexpr float kC2xy = static_cast<float>(1.0925484305920792);
constexpr float kC2yz = static_cast<float>(-1.0925484305920792);
constexpr float kC2zz = static_cast<float>(0.31539156525252005);
constexpr float kC2xz = static_cast<float>(-1.0925484305920792);
constexpr float kC2xxyy = static_cast<float>(0.5462742152960396);
constexpr float kC30 = static_cast<float>(-0.5900435899266435);
constexpr float kC31 = static_cast<float>(2.890611442640554);
constexpr float kC32 = static_cast<float>(-0.4570457994644658);
constexpr float kC33 = static_cast<float>(0.3731763325901154);
constexpr float kC34 = static_cast<float>(-0.4570457994644658);
constexpr float kC35 = static_cast<float>(1.445305721320277);
constexpr float kC36 = static_cast<float>(-0.5900435899266435);
constexpr float kTiny = static_cast<float>(1e-6);

// The camera and clip box, passed by value.
struct RayCamera {
  double p[3][4];  // proj_inverse, rows 0:3 (row-major: v' = M v)
  double v[3][3];  // view_inverse[:3, :3]
  float o[3];      // view_inverse[:3, 3], rounded to f32
  float lo[3];     // aabb[:3]
  float hi[3];     // aabb[3:]
};

__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }

// torch.minimum / torch.maximum / clamp_min: a NaN operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// ops/aabb.py::intersect_aabb's direction clamp
__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) < kTiny ? (d < 0.0f ? -kTiny : kTiny) : d;
}

__global__ void __launch_bounds__(kThreads)
camera_rays_kernel(const RayCamera cam, const float* __restrict__ clip,
                   float* __restrict__ out, int width, int height, int ts,
                   int nx, int R, long long n_rays, int sh_degree) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const int t = static_cast<int>(i / R);
  const int r = static_cast<int>(i - static_cast<long long>(t) * R);
  const int px = (t % nx) * ts + r % ts;
  const int py = (t / nx) * ts + r / ts;

  // Camera.rays: NDC of the pixel centre, then projInverse and viewInverse
  const double x = __dsub_rn(
      dmul(__ddiv_rn(dadd(static_cast<double>(px), 0.5), width), 2.0), 1.0);
  const double y = __dsub_rn(
      dmul(__ddiv_rn(dadd(static_cast<double>(py), 0.5), height), 2.0), 1.0);
  double tg[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    tg[k] = dadd(dadd(dadd(dmul(x, cam.p[k][0]), dmul(y, cam.p[k][1])),
                      cam.p[k][2]),
                 cam.p[k][3]);
  double dw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dw[k] = dadd(dadd(dmul(tg[0], cam.v[k][0]), dmul(tg[1], cam.v[k][1])),
                 dmul(tg[2], cam.v[k][2]));
  const double norm = __dsqrt_rn(
      dadd(dadd(dmul(dw[0], dw[0]), dmul(dw[1], dw[1])), dmul(dw[2], dw[2])));
  float d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = __double2float_rn(__ddiv_rn(dw[k], norm));

  // intersect_aabb: slab entry and exit, tmin clamped at 0
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float inv = __frcp_rn(safe_dir(d[k]));
    const float t0 = mul(sub(cam.lo[k], cam.o[k]), inv);
    const float t1 = mul(sub(cam.hi[k], cam.o[k]), inv);
    const float enter = nan_min(t0, t1), leave = nan_max(t0, t1);
    tmin = k == 0 ? enter : nan_max(tmin, enter);
    tmax = k == 0 ? leave : nan_min(tmax, leave);
  }
  tmin = tmin != tmin ? tmin : fmaxf(tmin, 0.0f);
  if (clip) tmax = nan_min(tmax, clip[static_cast<long long>(py) * width + px]);

  // sh_basis_components, in its order and association
  float b[kBasis];
#pragma unroll
  for (int k = 0; k < kBasis; ++k) b[k] = 0.0f;
  b[0] = kC0;
  const float dx = d[0], dy = d[1], dz = d[2];
  if (sh_degree > 0) {
    b[1] = mul(kMinusC1, dy);
    b[2] = mul(kC1, dz);
    b[3] = mul(kMinusC1, dx);
  }
  if (sh_degree > 1) {
    const float xx = mul(dx, dx), yy = mul(dy, dy), zz = mul(dz, dz);
    const float xy = mul(dx, dy), yz = mul(dy, dz), xz = mul(dx, dz);
    b[4] = mul(kC2xy, xy);
    b[5] = mul(kC2yz, yz);
    b[6] = mul(kC2zz, sub(sub(mul(2.0f, zz), xx), yy));
    b[7] = mul(kC2xz, xz);
    b[8] = mul(kC2xxyy, sub(xx, yy));
    if (sh_degree > 2) {
      b[9] = mul(mul(kC30, dy), sub(mul(3.0f, xx), yy));
      b[10] = mul(mul(kC31, xy), dz);
      b[11] = mul(mul(kC32, dy), sub(sub(mul(4.0f, zz), xx), yy));
      b[12] = mul(mul(kC33, dz),
                  sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      b[13] = mul(mul(kC34, dx), sub(sub(mul(4.0f, zz), xx), yy));
      b[14] = mul(mul(kC35, dz), sub(xx, yy));
      b[15] = mul(mul(kC36, dx), sub(xx, mul(3.0f, yy)));
    }
  }

  float* row = out + static_cast<long long>(t) * kRayRows * R + r;
  row[0 * R] = cam.o[0];
  row[1 * R] = cam.o[1];
  row[2 * R] = cam.o[2];
  row[3 * R] = dx;
  row[4 * R] = dy;
  row[5 * R] = dz;
  row[6 * R] = tmin;
  row[7 * R] = tmax;
#pragma unroll
  for (int k = 0; k < kBasis; ++k) row[static_cast<long long>(8 + k) * R] = b[k];
}

}  // namespace

// proj_inverse, view_inverse: (4, 4) f64 row-major on the host; aabb: 6 f32
// on the host; tmax_clip: (H, W) f32 on the card or null; out: (T, 24, R)
// f32 on the card, T = (H / ts) (W / ts), R = ts * ts.  H and W are
// multiples of ts.  Launches on `stream`, does not synchronise; returns the
// CUDA error of the launch.
extern "C" int gvrt_camera_rays(const double* proj_inverse,
                                const double* view_inverse, const float* aabb,
                                const float* tmax_clip, float* out, int width,
                                int height, int ts, int sh_degree,
                                void* stream) {
  if (width <= 0 || height <= 0 || ts <= 0 || width % ts || height % ts)
    return static_cast<int>(cudaErrorInvalidValue);
  RayCamera cam;
  for (int k = 0; k < 3; ++k) {
    for (int j = 0; j < 4; ++j) cam.p[k][j] = proj_inverse[4 * k + j];
    for (int j = 0; j < 3; ++j) cam.v[k][j] = view_inverse[4 * k + j];
    cam.o[k] = static_cast<float>(view_inverse[4 * k + 3]);
    cam.lo[k] = aabb[k];
    cam.hi[k] = aabb[3 + k];
  }
  const int R = ts * ts;
  const long long n_rays = static_cast<long long>(width) * height;
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  camera_rays_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      cam, tmax_clip, out, width, height, ts, width / ts, R, n_rays,
      sh_degree);
  return static_cast<int>(cudaGetLastError());
}
