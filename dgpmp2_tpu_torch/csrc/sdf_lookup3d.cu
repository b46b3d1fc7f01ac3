// K-LOOKUP3D: trilinear SDF value and 3-D spatial gradient at world points.
//
// Replaces the TPU kernel dgpmp2_tpu/ops/pallas/sdf_lookup3d.py
// `_make_kernel` (via `trilinear_lookup_pallas`).  Same function as the
// plain version dgpmp2_tpu_torch/ops/sdf.py `trilinear_lookup`:
//
//   px = -x_lo/res + x/res,  py = -y_lo/res - y/res,  pz = -z_lo/res + z/res
//   corners floor(p), floor(p)+1 clamped to the grid on each axis
//   d = trilinear blend of the 8 taps (x, then y, then z)
//   grad = (dd/dpx / res, -dd/dpy / res, dd/dpz / res)
//
// with both out-of-bounds modes: "intended" (weights from the unclamped
// fraction; outside the world limits d = x_hi - x_lo and zero gradient) and
// "reference" (weights from the clamped corner indices, no masking).
//
// Layout: sdf (B, D, H, W) as [z, row, col], points (B, P, 3), d (B, P),
// grad (B, P, 3), all row-major; d and grad are two views of one buffer.
//
// What bounds it on an H100: latency.  At B = 1024, P = 101, 64^3 float32
// the bytes (points, 8 taps, results) are 6.2 MB, 1.9 us at 3.35 TB/s; the
// SDF batch is 1 GiB, far over the 50 MB L2, so the taps come from device
// memory, and the time is the launch ramp plus two dependent round trips
// (the point, then its taps in 4 rows of two planes).  Consecutive states
// of one trajectory fall in neighbouring voxels and neighbouring threads,
// so a warp's taps share sectors.
//
// What the design does about it: one thread per point in blocks of 128
// consecutive points, a multiply in place of a 64-bit divide
// (lookup_tiles.cuh); here, all 8 tap loads are issued before any is used,
// through the non-coherent path, and the blend and the three partials stay
// in registers.  What the TPU kernel needed and this one does not: the
// brick tiling, the per-tile full-volume fallback, the one-hot MXU
// contractions, the host-side column layouts and the VMEM applicability
// guard.  Coordinates and blend round as the plain version
// does (lookup_common.cuh); the per-problem offset b*D*H*W is 64-bit.
#include <cuda_runtime.h>

#include "lookup_common.cuh"
#include "lookup_tiles.cuh"

namespace {

using namespace dgpmp2;

template <typename T>
struct Trilinear {
  const T* sdf;
  int nz, h, w, reference_mode;
  T res, orig_px, orig_py, orig_pz, x_lo, x_hi, y_lo, y_hi, z_lo, z_hi, max_d;

  __device__ __forceinline__ void operator()(const T (&pt)[3], int b, T& d,
                                             T (&g)[3]) const {
    const T x = pt[0];
    const T y = pt[1];
    const T z = pt[2];
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
    const T* vol = sdf + static_cast<size_t>(b) * nz * plane;
    const T* s1 = vol + z1 * plane;
    const T* s2 = vol + z2 * plane;
    // d{z}{y}{x}: 1 = low corner, 2 = high corner.
    const T d111 = __ldg(s1 + y1 * w + x1);
    const T d112 = __ldg(s1 + y1 * w + x2);
    const T d121 = __ldg(s1 + y2 * w + x1);
    const T d122 = __ldg(s1 + y2 * w + x2);
    const T d211 = __ldg(s2 + y1 * w + x1);
    const T d212 = __ldg(s2 + y1 * w + x2);
    const T d221 = __ldg(s2 + y2 * w + x1);
    const T d222 = __ldg(s2 + y2 * w + x2);

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
    const T dy11 = blend(ax1, d111, ax2, d112);
    const T dy12 = blend(ax1, d121, ax2, d122);
    const T dy21 = blend(ax1, d211, ax2, d212);
    const T dy22 = blend(ax1, d221, ax2, d222);
    const T dz1 = blend(ay1, dy11, ay2, dy12);
    const T dz2 = blend(ay1, dy21, ay2, dy22);
    d = blend(az1, dz1, az2, dz2);
    const T dd_dpx =
        blend(az1, blend(ay1, sub_rn(d112, d111), ay2, sub_rn(d122, d121)),
              az2, blend(ay1, sub_rn(d212, d211), ay2, sub_rn(d222, d221)));
    const T dd_dpy = blend(az1, sub_rn(dy12, dy11), az2, sub_rn(dy22, dy21));
    const T dd_dpz = sub_rn(dz2, dz1);
    g[0] = div_rn(dd_dpx, res);
    g[1] = div_rn(-dd_dpy, res);
    g[2] = div_rn(dd_dpz, res);

    if (!reference_mode &&
        !((x >= x_lo) && (x <= x_hi) && (y >= y_lo) && (y <= y_hi) &&
          (z >= z_lo) && (z <= z_hi))) {
      d = max_d;
      g[0] = T(0);
      g[1] = T(0);
      g[2] = T(0);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kTile)
    sdf_lookup3d_kernel(const T* __restrict__ points, T* __restrict__ d_out,
                        T* __restrict__ g_out, int n, unsigned int div_mul,
                        int div_shift, Trilinear<T> f) {
  lookup_point<T, 3>(points, d_out, g_out, n, div_mul, div_shift, f);
}

template <typename T>
int launch(const LookupPlan* plan, const T* sdf, const T* points, T* out,
           void* stream) {
  if (plan->n <= 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(plan->device);
  const Trilinear<T> f{sdf,
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
                       static_cast<T>(plan->hi[2]),
                       static_cast<T>(plan->max_d)};
  sdf_lookup3d_kernel<T>
      <<<plan->tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
          points, out, out + plan->g_offset, plan->n, plan->div_mul,
          plan->div_shift, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgpmp2_sdf_lookup3d_f32(const dgpmp2::LookupPlan* plan,
                                       const float* sdf, const float* points,
                                       float* out, void* stream) {
  return launch<float>(plan, sdf, points, out, stream);
}

extern "C" int dgpmp2_sdf_lookup3d_f64(const dgpmp2::LookupPlan* plan,
                                       const double* sdf,
                                       const double* points, double* out,
                                       void* stream) {
  return launch<double>(plan, sdf, points, out, stream);
}
