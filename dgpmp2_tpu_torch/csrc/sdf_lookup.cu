// K-LOOKUP: bilinear SDF value and spatial gradient at world-space points.
//
// Replaces the TPU kernels dgpmp2_tpu/ops/pallas/sdf_lookup.py
// `_make_kernel_v2` (via `bilinear_lookup_pallas_v2`, the TPU default of
// dgpmp2_tpu/ops/sdf.py `lookup`) and `_make_kernel` (v1, via
// `bilinear_lookup_pallas`, the "pallas" engine), which compute the same
// function; they differ only in TPU relayouts.  Same function as the plain
// version dgpmp2_tpu_torch/ops/sdf.py `bilinear_lookup`:
//
//   px = -x_lo/res + x/res,  py = -y_lo/res - y/res   (y is flipped)
//   corners floor(p), floor(p)+1 clamped to the grid
//   d = bilinear blend of the 4 taps, grad = (dd/dpx / res, -dd/dpy / res)
//
// with both out-of-bounds modes: "intended" (weights from the unclamped
// fraction; outside the world limits d = x_hi - x_lo and zero gradient) and
// "reference" (weights from the clamped corner indices, no masking).
//
// Layout: sdf (B, H, W), points (B, P, 2), d (B, P), grad (B, P, 2), all
// row-major; d and grad are two views of one buffer.
//
// What bounds it on an H100: latency.  At B = 1024, P = 101, 128 x 128 the
// bytes (points, 4 taps, results) are 3.7 MB, 1.1 us at 3.35 TB/s; the time
// is the launch ramp plus two dependent device-memory round trips (the
// point, then its taps).
//
// What the design does about it: one thread per point in blocks of 128
// consecutive points, a multiply in place of a 64-bit divide
// (lookup_tiles.cuh); here, the 4 taps are read through the non-coherent
// path, all issued before any is used.  The pixel coordinates and the blend
// are correctly rounded with no fused multiply-add (lookup_common.cuh), so
// the corner choice (a discontinuity of the gradient) and the result agree
// bit for bit with the plain version, far out-of-grid points in the
// "reference" mode included.
#include <cuda_runtime.h>

#include "lookup_common.cuh"
#include "lookup_tiles.cuh"

namespace {

using namespace dgpmp2;

template <typename T>
struct Bilinear {
  const T* sdf;
  int h, w, reference_mode;
  T res, orig_px, orig_py, x_lo, x_hi, y_lo, y_hi, max_d;

  __device__ __forceinline__ void operator()(const T (&pt)[2], int b, T& d,
                                             T (&g)[2]) const {
    const T x = pt[0];
    const T y = pt[1];
    const T px = add_rn(orig_px, div_rn(x, res));
    const T py = sub_rn(orig_py, div_rn(y, res));
    const T px1f = floor(px);
    const T py1f = floor(py);
    int px1c, px2c, py1c, py2c;
    corners(px1f, w, px1c, px2c);
    corners(py1f, h, py1c, py2c);

    const T* img = sdf + static_cast<size_t>(b) * h * w;
    const T d11 = __ldg(img + py1c * w + px1c);
    const T d21 = __ldg(img + py1c * w + px2c);
    const T d12 = __ldg(img + py2c * w + px1c);
    const T d22 = __ldg(img + py2c * w + px2c);

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
    d = blend(ay1, blend(ax1, d11, ax2, d21), ay2, blend(ax1, d12, ax2, d22));
    const T dd_dpx = blend(ay1, sub_rn(d21, d11), ay2, sub_rn(d22, d12));
    const T dd_dpy = blend(ax1, sub_rn(d12, d11), ax2, sub_rn(d22, d21));
    g[0] = div_rn(dd_dpx, res);
    g[1] = div_rn(-dd_dpy, res);

    if (!reference_mode &&
        !((x >= x_lo) && (x <= x_hi) && (y >= y_lo) && (y <= y_hi))) {
      d = max_d;
      g[0] = T(0);
      g[1] = T(0);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kTile)
    sdf_lookup_kernel(const T* __restrict__ points, T* __restrict__ d_out,
                      T* __restrict__ g_out, int n, unsigned int div_mul,
                      int div_shift, Bilinear<T> f) {
  lookup_point<T, 2>(points, d_out, g_out, n, div_mul, div_shift, f);
}

template <typename T>
int launch(const LookupPlan* plan, const T* sdf, const T* points, T* out,
           void* stream) {
  if (plan->n <= 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(plan->device);
  const Bilinear<T> f{sdf,
                      plan->h,
                      plan->w,
                      plan->reference_mode,
                      static_cast<T>(plan->res),
                      static_cast<T>(plan->orig[0]),
                      static_cast<T>(plan->orig[1]),
                      static_cast<T>(plan->lo[0]),
                      static_cast<T>(plan->hi[0]),
                      static_cast<T>(plan->lo[1]),
                      static_cast<T>(plan->hi[1]),
                      static_cast<T>(plan->max_d)};
  sdf_lookup_kernel<T>
      <<<plan->tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
          points, out, out + plan->g_offset, plan->n, plan->div_mul,
          plan->div_shift, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgpmp2_sdf_lookup_f32(const dgpmp2::LookupPlan* plan,
                                     const float* sdf, const float* points,
                                     float* out, void* stream) {
  return launch<float>(plan, sdf, points, out, stream);
}

extern "C" int dgpmp2_sdf_lookup_f64(const dgpmp2::LookupPlan* plan,
                                     const double* sdf, const double* points,
                                     double* out, void* stream) {
  return launch<double>(plan, sdf, points, out, stream);
}
