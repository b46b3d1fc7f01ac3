// Arithmetic shared by the SDF lookup kernels (K-LOOKUP, K-LOOKUP-LIMB,
// K-LOOKUP3D); K-NORM (encoder_norm.cu) forms its LayerNorm outputs with
// the same correctly rounded operations.
//
// Every operation that decides or forms a lookup's result is correctly
// rounded and never contracted into a fused multiply-add, so a kernel
// rounds exactly as its plain PyTorch version, which runs one elementwise
// operation at a time:
//
// * the pixel coordinates p = orig + x / res, whose floor picks the
//   corners (a discontinuity of the gradient);
// * the blend of the taps.  In the "reference" OOB mode a point far
//   outside the grid has weights of opposite sign and huge magnitude
//   (a = n-1 - p and p - (n-1)) that cancel exactly only when each product
//   is rounded on its own.
#pragma once

#include <cuda_runtime.h>

namespace dgpmp2 {

__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// a*x + b*y with each product rounded on its own.
template <typename T>
__device__ __forceinline__ T blend(T a, T x, T b, T y) {
  return add_rn(mul_rn(a, x), mul_rn(b, y));
}

// The corners floor(p) and floor(p) + 1 of one axis, clamped to [0, n-1].
// The floor is clamped to [-1, n] while still a float: a cast of a value
// outside int range saturates, and floor + 1 would then overflow.  Within
// [-1, n] the clamped corners are those of the unclamped floor.
template <typename T>
__device__ __forceinline__ void corners(T p1f, int n, int& c1, int& c2) {
  const int p1 = static_cast<int>(min(max(p1f, T(-1)), static_cast<T>(n)));
  c1 = min(max(p1, 0), n - 1);
  c2 = min(max(p1 + 1, 0), n - 1);
}

}  // namespace dgpmp2
