// The launch of the SDF lookup kernels K-LOOKUP (sdf_lookup.cu), K-LOOKUP3D
// (sdf_lookup3d.cu) and K-LOOKUP-LIMB (sdf_lookup_limbs.cu): every part of a
// lookup that is not the blend of one point's taps.
//
// The B*P query points are one flat array, cut into tiles of kTile = 128
// consecutive points; a block of 128 threads takes a tile, a thread a point.
// The launch geometry (point and tile count, the divisor of the problem
// index, where grad starts in the output buffer) is computed once per shape
// on the host by ops/cuda/_tiles.py and handed over in a LookupPlan.
//
// The problem index of point j is (j * div_mul) >> div_shift, exact for
// j < 2^31 (the multiplier is ceil(2^(31 + ceil(log2 P)) / P)): no 64-bit
// divide per thread.  The ragged last tile is a bounds check.
//
// Not here, because it measured no faster on an H100 (PERF.md): a
// persistent grid walking the tiles, and points in and results out by bulk
// copies through a two-stage shared-memory ring.  The taps' round trip to
// device memory sets the time; the points and results are a small share.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace dgpmp2 {

constexpr int kTile = 128;

// Host-side launch plan, mirrored field for field by
// dgpmp2_tpu_torch/ops/cuda/_tiles.py `LookupPlan` (ctypes).  2-D lookups
// leave the z entries and nz unused.
struct LookupPlan {
  long long g_offset;  // elements from the output buffer to grad
  double res, orig[3], lo[3], hi[3], max_d;
  int nz, h, w;
  int n, tiles;  // points B*P, blocks
  unsigned int div_mul;
  int div_shift, reference_mode, device;
};

// Launch on the plan's device, whatever the calling thread's current one.
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    int cur = device;
    cudaGetDevice(&cur);
    if (cur != device) {
      prev = cur;
      cudaSetDevice(device);
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Runs `lookup(p, b, d, g)` for point j = blockIdx.x * kTile + threadIdx.x
// of the flat (B*P, NDIM) points, p of problem b, and writes d (B*P) and
// g (B*P, NDIM).  Call with kTile threads per block.
template <typename T, int NDIM, class Lookup>
__device__ __forceinline__ void lookup_point(const T* __restrict__ points,
                                             T* __restrict__ d_out,
                                             T* __restrict__ g_out, int n,
                                             unsigned int div_mul,
                                             int div_shift,
                                             const Lookup& lookup) {
  const int j = blockIdx.x * kTile + threadIdx.x;
  if (j >= n) return;
  T p[NDIM], d, g[NDIM];
#pragma unroll
  for (int k = 0; k < NDIM; ++k) p[k] = points[static_cast<size_t>(j) * NDIM + k];
  const int b = static_cast<int>(
      (static_cast<unsigned long long>(static_cast<unsigned>(j)) * div_mul) >>
      div_shift);
  lookup(p, b, d, g);
  d_out[j] = d;
#pragma unroll
  for (int k = 0; k < NDIM; ++k) g_out[static_cast<size_t>(j) * NDIM + k] = g[k];
}

}  // namespace dgpmp2
