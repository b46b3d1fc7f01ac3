// K-LOOKUP-LIMB: bilinear SDF value and gradient from an SDF stored as
// L = 1, 2 or 3 bf16 limbs (S ~ sum_l limb_l), intended out-of-bounds mode.
//
// Replaces the TPU kernel dgpmp2_tpu/ops/pallas/sdf_lookup.py
// `_make_kernel_v3` (via `bilinear_lookup_pallas_v3`; the limbs come from
// `_limb_split`).  Same function as the plain version
// dgpmp2_tpu_torch/ops/sdf.py `bilinear_lookup_limbs`: each of the 4 taps is
// the float32 sum of its limbs in order l = 0..L-1, then K-LOOKUP's
// intended-mode blend and coordinate arithmetic (outside the world limits
// d = x_hi - x_lo and zero gradient).
//
// Layout: limbs (B, L, H, W) bf16, points (B, P, 2) float32, d (B, P) and
// grad (B, P, 2) float32, all row-major; one thread per query point.
//
// On the TPU the limbs make every MXU pass a single bf16 pass.  Here the use
// that remains is storage: at L = 1 a tap reads 2 bytes instead of 4, and
// the SDF batch takes half the memory.  What bounds the kernel is what
// bounds K-LOOKUP: the latency of 4 * L independent scattered loads per
// point.  Coordinates and blend round as the plain version does
// (lookup_common.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lookup_common.cuh"

namespace {

using namespace dgpmp2;

template <int L>
__device__ __forceinline__ float tap(const __nv_bfloat16* __restrict__ limbs,
                                     long long stride, int offset) {
  float v = __bfloat162float(limbs[offset]);
#pragma unroll
  for (int l = 1; l < L; ++l) {
    v = add_rn(v, __bfloat162float(limbs[l * stride + offset]));
  }
  return v;
}

template <int L>
__global__ void sdf_lookup_limbs_kernel(
    const __nv_bfloat16* __restrict__ limbs, const float* __restrict__ points,
    float* __restrict__ d_out, float* __restrict__ g_out, int batch,
    int npts, int h, int w, float res, float orig_px, float orig_py,
    float x_lo, float x_hi, float y_lo, float y_hi, float max_d) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * npts) return;
  const long long b = idx / npts;
  const float x = points[2 * idx];
  const float y = points[2 * idx + 1];

  const float px = add_rn(orig_px, div_rn(x, res));
  const float py = sub_rn(orig_py, div_rn(y, res));
  const float px1f = floorf(px);
  const float py1f = floorf(py);
  const float ax2 = sub_rn(px, px1f);
  const float ay2 = sub_rn(py, py1f);
  const float ax1 = 1.0f - ax2;
  const float ay1 = 1.0f - ay2;
  int px1c, px2c, py1c, py2c;
  corners(px1f, w, px1c, px2c);
  corners(py1f, h, py1c, py2c);

  const long long plane = static_cast<long long>(h) * w;
  const __nv_bfloat16* img = limbs + b * L * plane;
  const float d11 = tap<L>(img, plane, py1c * w + px1c);
  const float d21 = tap<L>(img, plane, py1c * w + px2c);
  const float d12 = tap<L>(img, plane, py2c * w + px1c);
  const float d22 = tap<L>(img, plane, py2c * w + px2c);

  float d = blend(ay1, blend(ax1, d11, ax2, d21), ay2,
                  blend(ax1, d12, ax2, d22));
  float gx = div_rn(blend(ay1, sub_rn(d21, d11), ay2, sub_rn(d22, d12)), res);
  float gy =
      div_rn(-blend(ax1, sub_rn(d12, d11), ax2, sub_rn(d22, d21)), res);
  const bool inside = (x >= x_lo) && (x <= x_hi) && (y >= y_lo) && (y <= y_hi);
  if (!inside) {
    d = max_d;
    gx = 0.0f;
    gy = 0.0f;
  }
  d_out[idx] = d;
  g_out[2 * idx] = gx;
  g_out[2 * idx + 1] = gy;
}

constexpr int kThreads = 128;

template <int L>
void launch(const __nv_bfloat16* limbs, const float* points, float* d,
            float* g, int batch, int npts, int h, int w, float res,
            float orig_px, float orig_py, float x_lo, float x_hi, float y_lo,
            float y_hi, float max_d, long long n, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  sdf_lookup_limbs_kernel<L><<<grid, kThreads, 0, stream>>>(
      limbs, points, d, g, batch, npts, h, w, res, orig_px, orig_py, x_lo,
      x_hi, y_lo, y_hi, max_d);
}

}  // namespace

// Returns cudaGetLastError(), or cudaErrorInvalidValue for L outside 1..3.
extern "C" int dgpmp2_sdf_lookup_limbs(const void* limbs, const float* points,
                                       float* d, float* g, int batch,
                                       int npts, int n_limbs, int h, int w,
                                       double res, double orig_px,
                                       double orig_py, double x_lo,
                                       double x_hi, double y_lo, double y_hi,
                                       double max_d, void* stream) {
  const long long n = static_cast<long long>(batch) * npts;
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const auto* l = static_cast<const __nv_bfloat16*>(limbs);
  const auto s = static_cast<cudaStream_t>(stream);
  const float a[] = {static_cast<float>(res),  static_cast<float>(orig_px),
                     static_cast<float>(orig_py), static_cast<float>(x_lo),
                     static_cast<float>(x_hi), static_cast<float>(y_lo),
                     static_cast<float>(y_hi), static_cast<float>(max_d)};
  switch (n_limbs) {
    case 1:
      launch<1>(l, points, d, g, batch, npts, h, w, a[0], a[1], a[2], a[3],
                a[4], a[5], a[6], a[7], n, s);
      break;
    case 2:
      launch<2>(l, points, d, g, batch, npts, h, w, a[0], a[1], a[2], a[3],
                a[4], a[5], a[6], a[7], n, s);
      break;
    case 3:
      launch<3>(l, points, d, g, batch, npts, h, w, a[0], a[1], a[2], a[3],
                a[4], a[5], a[6], a[7], n, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
