// K-LOOKUP-BWD: the backward of the SDF lookups K-LOOKUP (bilinear) and
// K-LOOKUP3D (trilinear).
//
// No TPU kernel computes this: the JAX package replays an XLA formulation
// of the lookup under autodiff (dgpmp2_tpu/ops/pallas/sdf_lookup.py
// `_mxu_replay_bwd`), and so did the port's backward before this kernel
// (autograd through dgpmp2_tpu_torch/ops/sdf.py `bilinear_lookup` /
// `trilinear_lookup`).  Training backpropagates through one lookup per GN
// iteration; this is that step's kernel.
//
// Given the SDF, the points and the cotangents of the lookup's outputs,
// d_bar (B*P) and g_bar (B*P, NDIM), it writes the point cotangent p_bar
// (B*P, NDIM) and, when asked (s_bar not null), scatter-adds the SDF
// cotangent over each point's taps with atomicAdd (s_bar zeroed by the
// caller).  The function is the plain version's derivative as autograd
// takes it:
//
//   * the floor that picks the corners carries no gradient, so along each
//     axis the two weights move by -1 and +1 per pixel;
//   * the gradient output is itself differentiated: for the bilinear
//     blend, d(g_x)/d(p_y) != 0 inside a cell while d(g_x)/d(p_x) = 0
//     (the trilinear one has the three pairwise cross terms);
//   * world coordinates enter as x / res (y flipped), so p_bar is the
//     pixel-space cotangent divided by res (negated in y);
//   * in the "intended" OOB mode a point outside the world limits had a
//     constant value and zero gradient: its cotangent and taps get 0;
//     in the "reference" mode the weights come from the clamped corners.
//
// The arithmetic follows the order of autograd's graph of the plain
// version (the weights' gradients summed per corner, then differenced),
// each operation correctly rounded with no fused multiply-add
// (lookup_common.cuh), so that where two corners clamp to one cell their
// contributions cancel exactly as in the replay.  The SDF cotangent's
// atomics add in an order that changes from run to run.
//
// What bounds it on an H100: as the forward, the launch ramp and two
// dependent round trips (the point and its cotangents, then its taps); the
// bytes at B = 128, P = 101 are ~0.8 MB, 0.25 us at 3.35 TB/s.  Its design:
// the forward's one thread per point in blocks of 128 consecutive points
// and its launch plan (lookup_tiles.cuh, ops/cuda/_tiles.py), all tap loads
// issued before any is used, and no atomics when the SDF needs no
// gradient (the training path: the SDF is data).
#include <cuda_runtime.h>

#include <cstddef>

#include "lookup_common.cuh"
#include "lookup_tiles.cuh"

namespace {

using namespace dgpmp2;

template <typename T>
__device__ __forceinline__ void atomic_add(T* dst, T v) {
  atomicAdd(dst, v);
}

template <typename T>
struct BilinearBwd {
  const T* sdf;
  T* s_bar;  // null: no SDF cotangent
  int h, w, reference_mode;
  T res, orig_px, orig_py, x_lo, x_hi, y_lo, y_hi;

  __device__ __forceinline__ void operator()(const T (&pt)[2], int b,
                                             T d_bar, const T (&g_bar)[2],
                                             T (&p_bar)[2]) const {
    const T x = pt[0];
    const T y = pt[1];
    p_bar[0] = T(0);
    p_bar[1] = T(0);
    if (!reference_mode &&
        !((x >= x_lo) && (x <= x_hi) && (y >= y_lo) && (y <= y_hi)))
      return;
    const T px = add_rn(orig_px, div_rn(x, res));
    const T py = sub_rn(orig_py, div_rn(y, res));
    const T px1f = floor(px);
    const T py1f = floor(py);
    int px1c, px2c, py1c, py2c;
    corners(px1f, w, px1c, px2c);
    corners(py1f, h, py1c, py2c);

    const size_t base = static_cast<size_t>(b) * h * w;
    const T* img = sdf + base;
    const int i11 = py1c * w + px1c, i21 = py1c * w + px2c;
    const int i12 = py2c * w + px1c, i22 = py2c * w + px2c;
    const T d11 = __ldg(img + i11);
    const T d21 = __ldg(img + i21);
    const T d12 = __ldg(img + i12);
    const T d22 = __ldg(img + i22);

    T ax1, ax2, ay1, ay2;
    if (reference_mode) {
      ax1 = static_cast<T>(px2c) - px;
      ax2 = px - static_cast<T>(px1c);
      ay1 = static_cast<T>(py2c) - py;
      ay2 = py - static_cast<T>(py1c);
    } else {
      ax2 = sub_rn(px, px1f);
      ay2 = sub_rn(py, py1f);
      ax1 = T(1) - ax2;
      ay1 = T(1) - ay2;
    }
    // Cotangents of d, dd/dpx (gx = dd_dpx / res) and dd/dpy
    // (gy = -dd_dpy / res).
    const T gxs = div_rn(g_bar[0], res);
    const T gys = -div_rn(g_bar[1], res);
    const T r1 = blend(ax1, d11, ax2, d21);
    const T r2 = blend(ax1, d12, ax2, d22);
    const T gr1 = mul_rn(d_bar, ay1);
    const T gr2 = mul_rn(d_bar, ay2);
    const T e1 = sub_rn(d21, d11), e2 = sub_rn(d22, d12);
    const T f1 = sub_rn(d12, d11), f2 = sub_rn(d22, d21);
    const T g_ax1 = add_rn(blend(gr1, d11, gr2, d12), mul_rn(gys, f1));
    const T g_ax2 = add_rn(blend(gr1, d21, gr2, d22), mul_rn(gys, f2));
    const T g_ay1 = add_rn(mul_rn(d_bar, r1), mul_rn(gxs, e1));
    const T g_ay2 = add_rn(mul_rn(d_bar, r2), mul_rn(gxs, e2));
    p_bar[0] = div_rn(sub_rn(g_ax2, g_ax1), res);
    p_bar[1] = div_rn(-sub_rn(g_ay2, g_ay1), res);

    if (s_bar != nullptr) {
      T* out = s_bar + base;
      const T a1 = mul_rn(gxs, ay1), a2 = mul_rn(gxs, ay2);
      const T c1 = mul_rn(gys, ax1), c2 = mul_rn(gys, ax2);
      atomic_add(out + i11, sub_rn(sub_rn(mul_rn(gr1, ax1), a1), c1));
      atomic_add(out + i21, sub_rn(add_rn(mul_rn(gr1, ax2), a1), c2));
      atomic_add(out + i12, add_rn(sub_rn(mul_rn(gr2, ax1), a2), c1));
      atomic_add(out + i22, add_rn(add_rn(mul_rn(gr2, ax2), a2), c2));
    }
  }
};

template <typename T>
struct TrilinearBwd {
  const T* sdf;
  T* s_bar;
  int nz, h, w, reference_mode;
  T res, orig_px, orig_py, orig_pz, x_lo, x_hi, y_lo, y_hi, z_lo, z_hi;

  __device__ __forceinline__ void operator()(const T (&pt)[3], int b,
                                             T d_bar, const T (&g_bar)[3],
                                             T (&p_bar)[3]) const {
    const T x = pt[0];
    const T y = pt[1];
    const T z = pt[2];
    p_bar[0] = T(0);
    p_bar[1] = T(0);
    p_bar[2] = T(0);
    if (!reference_mode &&
        !((x >= x_lo) && (x <= x_hi) && (y >= y_lo) && (y <= y_hi) &&
          (z >= z_lo) && (z <= z_hi)))
      return;
    const T px = add_rn(orig_px, div_rn(x, res));
    const T py = sub_rn(orig_py, div_rn(y, res));
    const T pz = add_rn(orig_pz, div_rn(z, res));
    const T px1f = floor(px);
    const T py1f = floor(py);
    const T pz1f = floor(pz);
    int x1, x2, y1, y2, z1, z2;
    corners(px1f, w, x1, x2);
    corners(py1f, h, y1, y2);
    corners(pz1f, nz, z1, z2);

    const size_t plane = static_cast<size_t>(h) * w;
    const size_t base = static_cast<size_t>(b) * nz * plane;
    const T* vol = sdf + base;
    // Flat offsets of the taps within the problem's volume, d{z}{y}{x}.
    const size_t o111 = z1 * plane + y1 * w + x1, o112 = z1 * plane + y1 * w + x2;
    const size_t o121 = z1 * plane + y2 * w + x1, o122 = z1 * plane + y2 * w + x2;
    const size_t o211 = z2 * plane + y1 * w + x1, o212 = z2 * plane + y1 * w + x2;
    const size_t o221 = z2 * plane + y2 * w + x1, o222 = z2 * plane + y2 * w + x2;
    const T d111 = __ldg(vol + o111), d112 = __ldg(vol + o112);
    const T d121 = __ldg(vol + o121), d122 = __ldg(vol + o122);
    const T d211 = __ldg(vol + o211), d212 = __ldg(vol + o212);
    const T d221 = __ldg(vol + o221), d222 = __ldg(vol + o222);

    T ax1, ax2, ay1, ay2, az1, az2;
    if (reference_mode) {
      ax1 = static_cast<T>(x2) - px;
      ax2 = px - static_cast<T>(x1);
      ay1 = static_cast<T>(y2) - py;
      ay2 = py - static_cast<T>(y1);
      az1 = static_cast<T>(z2) - pz;
      az2 = pz - static_cast<T>(z1);
    } else {
      ax2 = sub_rn(px, px1f);
      ay2 = sub_rn(py, py1f);
      az2 = sub_rn(pz, pz1f);
      ax1 = T(1) - ax2;
      ay1 = T(1) - ay2;
      az1 = T(1) - az2;
    }
    // The forward's intermediates.
    const T dy11 = blend(ax1, d111, ax2, d112);
    const T dy12 = blend(ax1, d121, ax2, d122);
    const T dy21 = blend(ax1, d211, ax2, d212);
    const T dy22 = blend(ax1, d221, ax2, d222);
    const T dz1 = blend(ay1, dy11, ay2, dy12);
    const T dz2 = blend(ay1, dy21, ay2, dy22);
    const T e11 = sub_rn(d112, d111), e12 = sub_rn(d122, d121);
    const T e21 = sub_rn(d212, d211), e22 = sub_rn(d222, d221);
    const T qx1 = blend(ay1, e11, ay2, e12);
    const T qx2 = blend(ay1, e21, ay2, e22);
    // Cotangents of dd/dpx, dd/dpy (gy = -dd_dpy / res) and dd/dpz.
    const T ga = div_rn(g_bar[0], res);
    const T gc = -div_rn(g_bar[1], res);
    const T ge = div_rn(g_bar[2], res);
    const T gdz1 = sub_rn(mul_rn(d_bar, az1), ge);
    const T gdz2 = add_rn(mul_rn(d_bar, az2), ge);
    const T gq1 = mul_rn(ga, az1), gq2 = mul_rn(ga, az2);
    const T gdy11 = sub_rn(mul_rn(gdz1, ay1), mul_rn(gc, az1));
    const T gdy12 = add_rn(mul_rn(gdz1, ay2), mul_rn(gc, az1));
    const T gdy21 = sub_rn(mul_rn(gdz2, ay1), mul_rn(gc, az2));
    const T gdy22 = add_rn(mul_rn(gdz2, ay2), mul_rn(gc, az2));
    const T g_ax1 = add_rn(blend(gdy11, d111, gdy12, d121),
                           blend(gdy21, d211, gdy22, d221));
    const T g_ax2 = add_rn(blend(gdy11, d112, gdy12, d122),
                           blend(gdy21, d212, gdy22, d222));
    const T g_ay1 = add_rn(blend(gdz1, dy11, gdz2, dy21),
                           blend(gq1, e11, gq2, e21));
    const T g_ay2 = add_rn(blend(gdz1, dy12, gdz2, dy22),
                           blend(gq1, e12, gq2, e22));
    const T g_az1 = add_rn(add_rn(mul_rn(d_bar, dz1),
                                  mul_rn(gc, sub_rn(dy12, dy11))),
                           mul_rn(ga, qx1));
    const T g_az2 = add_rn(add_rn(mul_rn(d_bar, dz2),
                                  mul_rn(gc, sub_rn(dy22, dy21))),
                           mul_rn(ga, qx2));
    p_bar[0] = div_rn(sub_rn(g_ax2, g_ax1), res);
    p_bar[1] = div_rn(-sub_rn(g_ay2, g_ay1), res);
    p_bar[2] = div_rn(sub_rn(g_az2, g_az1), res);

    if (s_bar != nullptr) {
      T* out = s_bar + base;
      const T ge11 = mul_rn(gq1, ay1), ge12 = mul_rn(gq1, ay2);
      const T ge21 = mul_rn(gq2, ay1), ge22 = mul_rn(gq2, ay2);
      atomic_add(out + o111, sub_rn(mul_rn(gdy11, ax1), ge11));
      atomic_add(out + o112, add_rn(mul_rn(gdy11, ax2), ge11));
      atomic_add(out + o121, sub_rn(mul_rn(gdy12, ax1), ge12));
      atomic_add(out + o122, add_rn(mul_rn(gdy12, ax2), ge12));
      atomic_add(out + o211, sub_rn(mul_rn(gdy21, ax1), ge21));
      atomic_add(out + o212, add_rn(mul_rn(gdy21, ax2), ge21));
      atomic_add(out + o221, sub_rn(mul_rn(gdy22, ax1), ge22));
      atomic_add(out + o222, add_rn(mul_rn(gdy22, ax2), ge22));
    }
  }
};

// Point j = blockIdx.x * kTile + threadIdx.x of the flat (B*P, NDIM)
// points: its cotangents in, p_bar out.
template <typename T, int NDIM, class Bwd>
__global__ void __launch_bounds__(kTile)
    sdf_lookup_bwd_kernel(const T* __restrict__ points, const T* __restrict__ d_bar,
                      const T* __restrict__ g_bar, T* __restrict__ p_bar,
                      int n, unsigned int div_mul, int div_shift, Bwd f) {
  const int j = blockIdx.x * kTile + threadIdx.x;
  if (j >= n) return;
  T p[NDIM], gb[NDIM], pb[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) {
    p[k] = points[static_cast<size_t>(j) * NDIM + k];
    gb[k] = g_bar[static_cast<size_t>(j) * NDIM + k];
  }
  const int b = static_cast<int>(
      (static_cast<unsigned long long>(static_cast<unsigned>(j)) * div_mul) >>
      div_shift);
  f(p, b, d_bar[j], gb, pb);
#pragma unroll
  for (int k = 0; k < NDIM; ++k) p_bar[static_cast<size_t>(j) * NDIM + k] = pb[k];
}

template <typename T, int NDIM, class Bwd>
int launch(const LookupPlan* plan, const T* points, const T* d_bar,
           const T* g_bar, T* p_bar, const Bwd& f, void* stream) {
  if (plan->n <= 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(plan->device);
  sdf_lookup_bwd_kernel<T, NDIM, Bwd>
      <<<plan->tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
          points, d_bar, g_bar, p_bar, plan->n, plan->div_mul,
          plan->div_shift, f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch2d(const LookupPlan* plan, const T* sdf, const T* points,
             const T* d_bar, const T* g_bar, T* p_bar, T* s_bar,
             void* stream) {
  const BilinearBwd<T> f{sdf,
                         s_bar,
                         plan->h,
                         plan->w,
                         plan->reference_mode,
                         static_cast<T>(plan->res),
                         static_cast<T>(plan->orig[0]),
                         static_cast<T>(plan->orig[1]),
                         static_cast<T>(plan->lo[0]),
                         static_cast<T>(plan->hi[0]),
                         static_cast<T>(plan->lo[1]),
                         static_cast<T>(plan->hi[1])};
  return launch<T, 2>(plan, points, d_bar, g_bar, p_bar, f, stream);
}

template <typename T>
int launch3d(const LookupPlan* plan, const T* sdf, const T* points,
             const T* d_bar, const T* g_bar, T* p_bar, T* s_bar,
             void* stream) {
  const TrilinearBwd<T> f{sdf,
                          s_bar,
                          plan->nz,
                          plan->h,
                          plan->w,
                          plan->reference_mode,
                          static_cast<T>(plan->res),
                          static_cast<T>(plan->orig[0]),
                          static_cast<T>(plan->orig[1]),
                          static_cast<T>(plan->orig[2]),
                          static_cast<T>(plan->lo[0]),
                          static_cast<T>(plan->hi[0]),
                          static_cast<T>(plan->lo[1]),
                          static_cast<T>(plan->hi[1]),
                          static_cast<T>(plan->lo[2]),
                          static_cast<T>(plan->hi[2])};
  return launch<T, 3>(plan, points, d_bar, g_bar, p_bar, f, stream);
}

}  // namespace

// (plan, sdf, points, d_bar, g_bar, p_bar, s_bar or null, stream)
extern "C" int dgpmp2_sdf_lookup_bwd_f32(const dgpmp2::LookupPlan* plan,
                                         const float* sdf, const float* points,
                                         const float* d_bar,
                                         const float* g_bar, float* p_bar,
                                         float* s_bar, void* stream) {
  return launch2d<float>(plan, sdf, points, d_bar, g_bar, p_bar, s_bar,
                         stream);
}

extern "C" int dgpmp2_sdf_lookup_bwd_f64(const dgpmp2::LookupPlan* plan,
                                         const double* sdf,
                                         const double* points,
                                         const double* d_bar,
                                         const double* g_bar, double* p_bar,
                                         double* s_bar, void* stream) {
  return launch2d<double>(plan, sdf, points, d_bar, g_bar, p_bar, s_bar,
                          stream);
}

extern "C" int dgpmp2_sdf_lookup3d_bwd_f32(const dgpmp2::LookupPlan* plan,
                                           const float* sdf,
                                           const float* points,
                                           const float* d_bar,
                                           const float* g_bar, float* p_bar,
                                           float* s_bar, void* stream) {
  return launch3d<float>(plan, sdf, points, d_bar, g_bar, p_bar, s_bar,
                         stream);
}

extern "C" int dgpmp2_sdf_lookup3d_bwd_f64(const dgpmp2::LookupPlan* plan,
                                           const double* sdf,
                                           const double* points,
                                           const double* d_bar,
                                           const double* g_bar,
                                           double* p_bar, double* s_bar,
                                           void* stream) {
  return launch3d<double>(plan, sdf, points, d_bar, g_bar, p_bar, s_bar,
                          stream);
}
