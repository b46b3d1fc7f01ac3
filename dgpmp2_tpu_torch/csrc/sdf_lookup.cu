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
// row-major; one thread per query point.
//
// What bounds it on an H100: memory latency of 4 dependent-free scattered
// reads per point.  At B = 1024, P = 101, 128 x 128 that is 0.1 M points and
// 1.7 MB of taps out of a 64 MB SDF batch, so it is far from any bandwidth or
// flop limit; consecutive threads query the same problem's SDF along one
// trajectory, so taps of a warp share cache lines.
//
// What the design does about it: reads the taps through the read-only cache
// and keeps everything else in registers.  The pixel coordinates and the
// blend are correctly rounded with no fused multiply-add
// (lookup_common.cuh), so the corner choice (a discontinuity of the
// gradient) and the result agree bit for bit with the plain version, far
// out-of-grid points in the "reference" mode included.
#include <cuda_runtime.h>

#include "lookup_common.cuh"

namespace {

using namespace dgpmp2;

template <typename T>
__global__ void sdf_lookup_kernel(const T* __restrict__ sdf,
                                  const T* __restrict__ points,
                                  T* __restrict__ d_out, T* __restrict__ g_out,
                                  int batch, int npts, int h, int w, T res,
                                  T orig_px, T orig_py, T x_lo, T x_hi, T y_lo,
                                  T y_hi, T max_d, int reference_mode) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * npts) return;
  const long long b = idx / npts;
  const T x = points[2 * idx];
  const T y = points[2 * idx + 1];

  const T px = add_rn(orig_px, div_rn(x, res));
  const T py = sub_rn(orig_py, div_rn(y, res));
  const T px1f = floor(px);
  const T py1f = floor(py);
  const T fx = sub_rn(px, px1f);
  const T fy = sub_rn(py, py1f);
  int px1c, px2c, py1c, py2c;
  corners(px1f, w, px1c, px2c);
  corners(py1f, h, py1c, py2c);

  const T* img = sdf + b * h * w;
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
    ax1 = T(1) - fx;
    ax2 = fx;
    ay1 = T(1) - fy;
    ay2 = fy;
  }
  T d = blend(ay1, blend(ax1, d11, ax2, d21), ay2, blend(ax1, d12, ax2, d22));
  const T dd_dpx = blend(ay1, sub_rn(d21, d11), ay2, sub_rn(d22, d12));
  const T dd_dpy = blend(ax1, sub_rn(d12, d11), ax2, sub_rn(d22, d21));
  T gx = div_rn(dd_dpx, res);
  T gy = div_rn(-dd_dpy, res);

  if (!reference_mode) {
    const bool inside = (x >= x_lo) && (x <= x_hi) && (y >= y_lo) && (y <= y_hi);
    if (!inside) {
      d = max_d;
      gx = T(0);
      gy = T(0);
    }
  }
  d_out[idx] = d;
  g_out[2 * idx] = gx;
  g_out[2 * idx + 1] = gy;
}

constexpr int kThreads = 128;

template <typename T>
int launch(const T* sdf, const T* points, T* d, T* g, int batch, int npts,
           int h, int w, double res, double orig_px, double orig_py,
           double x_lo, double x_hi, double y_lo, double y_hi, double max_d,
           int reference_mode, void* stream) {
  const long long n = static_cast<long long>(batch) * npts;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  sdf_lookup_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sdf, points, d, g, batch, npts, h, w, static_cast<T>(res),
      static_cast<T>(orig_px), static_cast<T>(orig_py), static_cast<T>(x_lo),
      static_cast<T>(x_hi), static_cast<T>(y_lo), static_cast<T>(y_hi),
      static_cast<T>(max_d), reference_mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgpmp2_sdf_lookup_f32(const float* sdf, const float* points,
                                     float* d, float* g, int batch, int npts,
                                     int h, int w, double res, double orig_px,
                                     double orig_py, double x_lo, double x_hi,
                                     double y_lo, double y_hi, double max_d,
                                     int reference_mode, void* stream) {
  return launch<float>(sdf, points, d, g, batch, npts, h, w, res, orig_px,
                       orig_py, x_lo, x_hi, y_lo, y_hi, max_d, reference_mode,
                       stream);
}

extern "C" int dgpmp2_sdf_lookup_f64(const double* sdf, const double* points,
                                     double* d, double* g, int batch, int npts,
                                     int h, int w, double res, double orig_px,
                                     double orig_py, double x_lo, double x_hi,
                                     double y_lo, double y_hi, double max_d,
                                     int reference_mode, void* stream) {
  return launch<double>(sdf, points, d, g, batch, npts, h, w, res, orig_px,
                        orig_py, x_lo, x_hi, y_lo, y_hi, max_d,
                        reference_mode, stream);
}
