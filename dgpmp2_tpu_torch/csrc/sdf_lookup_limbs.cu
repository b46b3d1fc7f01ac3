// K-LOOKUP-LIMB: bilinear SDF value and gradient from an SDF stored as
// L = 1, 2 or 3 bf16 limbs (S ~ sum_l limb_l), intended out-of-bounds mode.
//
// Replaces the TPU kernel dgpmp2_tpu/ops/pallas/sdf_lookup.py
// `_make_kernel_v3` (via `bilinear_lookup_pallas_v3`; the limbs come from
// `_limb_split`).  Same function as the plain version
// dgpmp2_tpu_torch/ops/sdf.py `bilinear_lookup_packed` (bit for bit
// `bilinear_lookup_limbs`): each of the 4 taps is the float32 sum of its
// limbs in order l = 0..L-1, then K-LOOKUP's intended-mode coordinates and
// blend (outside the world limits d = x_hi - x_lo and zero gradient), with
// the rounding of lookup_common.cuh.
//
// Layout: the packed limbs (B, H, W, S) of ops/sdf.py `limb_pack`, built
// once per plan (ops/sdf.py `LIMB_CACHE`): a cell's L limbs side by side in
// S = 1, 2 or 4 bf16 slots (slot 3 at L = 3 is never summed), so that one
// 2-, 4- or 8-byte load brings a tap where the (B, L, H, W) limb planes took
// L loads H*W*2 bytes apart.  Points (B, P, 2) float32; d (B, P) and grad
// (B, P, 2) float32, two views of one buffer.
//
// What bounds it on an H100: latency, as K-LOOKUP (sdf_lookup.cu).  At
// B = 1024, P = 101, L = 1 the bytes (points, taps, results) are 2.9 MB,
// 0.9 us at 3.35 TB/s; the time is the launch ramp and two dependent
// round trips to device memory, the point and then its taps, whose cold
// misses set it.  The packed cells cut a point's tap loads from 4 L to 4
// and the sectors they touch from up to 4 L to 2-4.  An x-paired layout,
// (B, H, W + 1, 2, S) with both x-taps of a row in one load, measured no
// faster at any L and made the split 3-4x dearer (PERF.md).  The launch is
// K-LOOKUP's: one thread per point in 128-point blocks behind a cached plan
// (lookup_tiles.cuh).
#include <cuda_runtime.h>

#include <cstddef>

#include "lookup_common.cuh"
#include "lookup_tiles.cuh"

namespace {

using namespace dgpmp2;

// float of the bf16 in the low or the high half of a 32-bit word (a bf16 is
// the top half of a float32; slot 0 of a cell lies at the lower address).
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// The raw slots of one cell, and the float32 sum of its L limbs in order
// l = 0..L-1.
template <int L>
struct Cells;
template <>
struct Cells<1> {
  using Cell = unsigned short;
  static __device__ __forceinline__ float sum(Cell c) {
    return __uint_as_float(static_cast<unsigned>(c) << 16);
  }
};
template <>
struct Cells<2> {
  using Cell = unsigned int;
  static __device__ __forceinline__ float sum(Cell c) {
    return add_rn(bf16_lo(c), bf16_hi(c));
  }
};
template <>
struct Cells<3> {
  using Cell = uint2;
  static __device__ __forceinline__ float sum(Cell c) {
    return add_rn(add_rn(bf16_lo(c.x), bf16_hi(c.x)), bf16_lo(c.y));
  }
};

template <int L>
struct LimbBilinear {
  const void* packed;
  int h, w;
  float res, orig_px, orig_py, x_lo, x_hi, y_lo, y_hi, max_d;

  __device__ __forceinline__ void operator()(const float (&pt)[2], int b,
                                             float& d, float (&g)[2]) const {
    using C = Cells<L>;
    const float x = pt[0];
    const float y = pt[1];
    const float px = add_rn(orig_px, div_rn(x, res));
    const float py = sub_rn(orig_py, div_rn(y, res));
    const float px1f = floorf(px);
    const float py1f = floorf(py);
    int px1c, px2c, py1c, py2c;
    corners(px1f, w, px1c, px2c);
    corners(py1f, h, py1c, py2c);

    // The four cells' loads all issued before any is used.
    const auto* img = static_cast<const typename C::Cell*>(packed) +
                      static_cast<size_t>(b) * h * w;
    const typename C::Cell c11 = __ldg(img + py1c * w + px1c);
    const typename C::Cell c21 = __ldg(img + py1c * w + px2c);
    const typename C::Cell c12 = __ldg(img + py2c * w + px1c);
    const typename C::Cell c22 = __ldg(img + py2c * w + px2c);
    const float d11 = C::sum(c11);
    const float d21 = C::sum(c21);
    const float d12 = C::sum(c12);
    const float d22 = C::sum(c22);

    const float ax2 = sub_rn(px, px1f);
    const float ay2 = sub_rn(py, py1f);
    const float ax1 = 1.0f - ax2;
    const float ay1 = 1.0f - ay2;
    d = blend(ay1, blend(ax1, d11, ax2, d21), ay2, blend(ax1, d12, ax2, d22));
    const float dd_dpx = blend(ay1, sub_rn(d21, d11), ay2, sub_rn(d22, d12));
    const float dd_dpy = blend(ax1, sub_rn(d12, d11), ax2, sub_rn(d22, d21));
    g[0] = div_rn(dd_dpx, res);
    g[1] = div_rn(-dd_dpy, res);
    if (!((x >= x_lo) && (x <= x_hi) && (y >= y_lo) && (y <= y_hi))) {
      d = max_d;
      g[0] = 0.0f;
      g[1] = 0.0f;
    }
  }
};

template <int L>
__global__ void __launch_bounds__(kTile)
    sdf_lookup_limbs_kernel(const float* __restrict__ points,
                            float* __restrict__ d_out,
                            float* __restrict__ g_out, int n,
                            unsigned int div_mul, int div_shift,
                            LimbBilinear<L> f) {
  lookup_point<float, 2>(points, d_out, g_out, n, div_mul, div_shift, f);
}

template <int L>
int launch(const LookupPlan* plan, const void* packed, const float* points,
           float* out, void* stream) {
  if (plan->n <= 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(plan->device);
  const LimbBilinear<L> f{packed,
                          plan->h,
                          plan->w,
                          static_cast<float>(plan->res),
                          static_cast<float>(plan->orig[0]),
                          static_cast<float>(plan->orig[1]),
                          static_cast<float>(plan->lo[0]),
                          static_cast<float>(plan->hi[0]),
                          static_cast<float>(plan->lo[1]),
                          static_cast<float>(plan->hi[1]),
                          static_cast<float>(plan->max_d)};
  sdf_lookup_limbs_kernel<L>
      <<<plan->tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
          points, out, out + plan->g_offset, plan->n, plan->div_mul,
          plan->div_shift, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One entry point per L: (plan, packed limbs, points, out, stream).
extern "C" int dgpmp2_sdf_lookup_limbs_l1(const dgpmp2::LookupPlan* plan,
                                          const void* packed,
                                          const float* points, float* out,
                                          void* stream) {
  return launch<1>(plan, packed, points, out, stream);
}

extern "C" int dgpmp2_sdf_lookup_limbs_l2(const dgpmp2::LookupPlan* plan,
                                          const void* packed,
                                          const float* points, float* out,
                                          void* stream) {
  return launch<2>(plan, packed, points, out, stream);
}

extern "C" int dgpmp2_sdf_lookup_limbs_l3(const dgpmp2::LookupPlan* plan,
                                          const void* packed,
                                          const float* points, float* out,
                                          void* stream) {
  return launch<3>(plan, packed, points, out, stream);
}
