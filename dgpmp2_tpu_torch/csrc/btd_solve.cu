// K-BTD: batched symmetric block-tridiagonal solve  Λ x = r  by block Thomas.
//
// Replaces the TPU kernels dgpmp2_tpu/ops/pallas/btd_solve.py:111
// `_make_kernel` (standard engine, via `btd_solve_pallas`) and
// dgpmp2_tpu/ops/pallas/btd_stream.py:117,189 `_make_fwd_kernel` /
// `_make_bwd_kernel` (stream engine).  The plain version is
// dgpmp2_tpu_torch/ops/tridiag.py `btd_solve`.  The recurrence, with
// U_t = Λ[t, t+1] and C_t the Schur pivots:
//
//   C_0 = D_0,  y_0 = r_0
//   C_t = D_t - U_{t-1}^T X_{t-1},   y_t = r_t - U_{t-1}^T z_{t-1}
//   [X_t | z_t] = C_t^{-1} [U_t | y_t]           (forward sweep, stored)
//   x_{T-1} = z_{T-1},  x_t = z_t - X_t x_{t+1}  (back sweep: one matvec)
//
// X_t is the transpose of the plain version's gain G_t = U_t^T C_t^{-1}.
//
// Layout: the public contract, row-major diag (B, T, D, D), off (B, T-1, D, D),
// rhs (B, T, D) and x (B, T, D), each 16-byte aligned.  Only the lower
// triangle of each diag block is read, as the TPU kernels' and the plain
// version's Cholesky read it: a system assembled in float32 is symmetric only
// to rounding (1e-9 relative on the bench problem), and reading both
// triangles would solve a system 1e-6 away in float64.  Scratch: gain
// (B, T-1, D, D) holds X_t; z_t is kept in x and overwritten by the back
// sweep.
//
// What bounds it on an H100.  The bytes are diag + off + rhs read once and x
// written once: 16.4 MB at B = 1024, T = 101, D = 4 in float32 (4.9 us at
// 3.35 TB/s) and 34.6 MB at D = 6 (10.3 us); the operations, ~(5 D^3 + 5 D^2)
// per step and problem, are 41 MFLOP at D = 4 (0.6 us at 67 TFLOP/s).  So the
// bound is memory, but the kernel is latency-bound: each problem is a chain of
// T dependent steps, each step a chain of D dependent pivots.
//
// What the design does about it:
// - A lane group per problem.  G = 2, 4, 8 and 16 lanes of one warp for
//   D = 1-2, 3-4, 5-8 and 9-16; lane r owns row r of every D x D block and
//   element r of every vector
//   (lanes r >= D, and the groups past the batch, carry identity rows and store
//   nothing).  The D x D algebra runs across the group through
//   __shfl_sync(..., width = G), which spreads one step's serial chain over D
//   lanes and keeps a lane's state small: 4 D + 2 values (a row of C_t, of
//   [U_t | y_t], of X_{t-1} and a column of U_{t-1}), 34 at D = 8 and 66 at
//   D = 16.
// - Gauss-Jordan on each step's augmented rows and a back sweep of one
//   matvec per step (btd_sweep.cuh, shared with K-STREAM).
// - Fill the card: one warp per block, 32 / G problems per warp, so B = 1024 is
//   128 blocks at D = 4, 256 at D = 5-8 and 512 at D = 9-16 over the 132
//   SMs.
// - Loads off the critical path: a ring of kStages steps in shared memory,
//   filled by cp.async.  Lane r copies its row of diag[t] and off[t] as 4-,
//   8- or 16-byte pieces, its columns of off[t] and diag[t] and rhs[t][r]
//   (the back sweep: its row of X_t and z_t[r]) kStages - 1 steps ahead of
//   the arithmetic, so no load waits behind the previous pivot.  Each lane
//   reads back only what it copied itself, so the ring needs no barrier.  The
//   ring stays in static shared memory (48 KB): in float64 at D = 11-16 it
//   has 3 or 2 stages in place of 4 (ring_stages).
// - Every D from 1 to 16 has its own instance (odd D too: the rows are
//   tiled by 4- or 8-byte pieces).
//
// D = 17-32 (arms of 9-16 links) takes btd_solve_kernel_wide: one problem
// per warp, D given at run time, the rows [C_t | U_t | y_t] of the step in
// shared memory.  Registers bind there: the lane state above is 4 D + 2
// values, 258 registers at D = 32 in float64, past the 255 a thread may
// hold.  So the wide kernel keeps each row in shared memory, where pivot row
// j is a broadcast read, and the loops run to D at run time: one instance
// per type, no spill.  Its step is a chain of D pivots, two warp barriers
// each, over shared memory; the loads of a step are not prefetched.  It is
// simple and right, not fast.
//
// D > 32 (arms of 17 links and more) takes btd_solve_kernel_block: a block of
// 32 x 8 threads per problem, the step's rows [C_t | U_t | y_t], the last
// step's [. | X_{t-1} | z_{t-1}] and U_{t-1} in one buffer of 5 D^2 + 3 D
// doubles (block_elems).  The loads, the Schur update and each Gauss-Jordan
// pivot run over the rows' elements (32 columns by 8 rows at a time), so
// the block's threads share a step's D^3 work; the pivots leave the rows
// unscaled, one barrier each, and the rows are scaled once at the end of the
// step.  The rows are float64 in both dtypes (see the kernel).  The buffer
// is dynamic shared memory, opted in up to the card's limit
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: up to D = 75 on an H100); past
// it, the same rows live in a global scratch buffer that the wrapper
// allocates (dgpmp2_btd_scratch_bytes says how large), and the code path is
// the same.  So every D runs on the card.
#include <cuda_runtime.h>

#include <cstddef>

#include "btd_sweep.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(kWarp)
    btd_solve_kernel(const T* __restrict__ diag, const T* __restrict__ off,
                     const T* __restrict__ rhs, T* __restrict__ x,
                     T* __restrict__ gain, int batch, int steps) {
  constexpr int G = group_lanes<D>();
  constexpr int DD = D * D;
  constexpr int SZ = static_cast<int>(sizeof(T));
  constexpr int P = 16 / SZ;  // elements per 16 B
  constexpr int DP = (D + P - 1) / P * P;
  constexpr int SLOT = ring_slot<T, D>();
  constexpr int S = ring_stages<T, D>();
  static_assert(SLOT == 4 * DP + P && S >= 2, "ring layout");
  __shared__ __align__(16) T ring[S][kWarp][SLOT];

  const int lane = threadIdx.x;
  const int r = lane % G;
  const int b = blockIdx.x * (kWarp / G) + lane / G;
  const bool valid = b < batch && r < D;
  const size_t bb = valid ? static_cast<size_t>(b) : 0;
  const int rr = valid ? r : 0;
  const T* dg = diag + bb * steps * DD + rr * D;
  const T* dg_col = diag + bb * steps * DD + rr;
  const T* of_row = off + bb * (steps - 1) * DD + rr * D;
  const T* of_col = off + bb * (steps - 1) * DD + rr;
  const T* rv = rhs + bb * steps * D + rr;
  T* xb = x + bb * steps * D + rr;
  T* gn = gain + bb * (steps - 1) * DD + rr * D;

  auto prefetch_fwd = [&](int t) {
    if (valid && t < steps) {
      T* s = ring[t % S][lane];
      cp_row<T, D>(s, dg + static_cast<size_t>(t) * DD);
#pragma unroll
      for (int k = 0; k < D; ++k)
        cp_async<SZ>(s + 3 * DP + k,
                     dg_col + static_cast<size_t>(t) * DD + k * D);
      if (t < steps - 1) {
        cp_row<T, D>(s + DP, of_row + static_cast<size_t>(t) * DD);
#pragma unroll
        for (int k = 0; k < D; ++k)
          cp_async<SZ>(s + 2 * DP + k,
                       of_col + static_cast<size_t>(t) * DD + k * D);
      }
      cp_async<SZ>(s + 4 * DP, rv + static_cast<size_t>(t) * D);
    }
    cp_commit();
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) prefetch_fwd(s);

  T xp[D];   // row r of X_{t-1}
  T ucp[D];  // column r of U_{t-1}
  T zp = T(0);
#pragma unroll
  for (int j = 0; j < D; ++j) xp[j] = ucp[j] = T(0);

  for (int t = 0; t < steps; ++t) {
    prefetch_fwd(t + S - 1);
    cp_wait<S - 1>();
    const T* s = ring[t % S][lane];
    const bool has_next = t < steps - 1;
    T c[D], bm[D + 1];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      // The lower triangle of diag[t], as the plain version's Cholesky
      // reads it: row r left of the diagonal, column r below it.
      c[j] = valid ? s[j <= r ? j : 3 * DP + j] : T(j == r);
      bm[j] = valid && has_next ? s[DP + j] : T(0);
    }
    bm[D] = valid ? s[4 * DP] : T(0);
    if (t > 0) narrow_schur<T, D, G>(c, bm, xp, ucp, zp);
    narrow_pivot<T, D, G>(c, bm, r);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      xp[j] = bm[j];
      ucp[j] = valid && has_next ? s[2 * DP + j] : T(0);
    }
    zp = bm[D];
    if (valid) {
      xb[static_cast<size_t>(t) * D] = zp;
      if (has_next) store_row<T, D>(gn + static_cast<size_t>(t) * DD, xp);
    }
  }

  // Back sweep from x_{T-1} = z_{T-1}; the ring now carries X_t and z_t,
  // which this lane wrote itself: the fence orders those stores before the
  // asynchronous copies that read them back.
  cp_wait<0>();
  __threadfence_block();
  narrow_back_sweep<T, T, D, G, S, SLOT>(ring, lane, valid, gn, xb, xb, steps,
                                         zp);
}

// D = 17-32: one warp per problem, lane r owns row r (lanes r >= d help load
// and otherwise idle).  Shared memory per warp: the rows [C_t | U_t | y_t]
// of this step and [. | X_{t-1} | z_{t-1}] of the last one (two buffers of
// kWarp rows, kWideRow columns), and U_{t-1} (row-major, stride kWarp + 1);
// 41.7 KB in float64, under the static limit.
template <typename T>
__global__ void __launch_bounds__(kWarp)
    btd_solve_kernel_wide(const T* __restrict__ diag,
                          const T* __restrict__ off,
                          const T* __restrict__ rhs, T* __restrict__ x,
                          T* __restrict__ gain, int steps, int d) {
  __shared__ T rows[2][kWarp][kWideRow];
  __shared__ T up[kWarp][kWarp + 1];
  const int r = threadIdx.x;
  const bool own = r < d;
  const size_t dd = static_cast<size_t>(d) * d;
  const size_t b = blockIdx.x;
  const T* dg = diag + b * steps * dd;
  const T* of = off + b * (steps - 1) * dd;
  const T* rv = rhs + b * steps * d;
  T* xb = x + b * steps * d;
  T* gn = gain + b * (steps - 1) * dd;
  const int cz = 2 * d;  // the column of y_t, then z_t

  for (int t = 0; t < steps; ++t) {
    T(*cur)[kWideRow] = rows[t & 1];
    const T(*prev)[kWideRow] = rows[(t + 1) & 1];
    const bool has_next = t < steps - 1;
    // The lower triangle of diag[t], mirrored (as the plain version's
    // Cholesky reads it), U_t = off[t] and y_t = rhs[t]: row i by lanes
    // r = column.
    for (int i = 0; i < d; ++i) {
      if (r <= i) {
        const T v = dg[t * dd + i * d + r];
        cur[i][r] = v;
        cur[r][i] = v;
      }
      if (own) cur[i][d + r] = has_next ? of[t * dd + i * d + r] : T(0);
    }
    if (own) cur[r][cz] = rv[static_cast<size_t>(t) * d + r];
    __syncwarp();
    wide_step<T>(cur, prev, up, t, d, r);
    if (own) {
      xb[static_cast<size_t>(t) * d + r] = cur[r][cz];
      if (has_next)
        for (int k = 0; k < d; ++k) gn[t * dd + r * d + k] = cur[r][d + k];
    }
  }
  wide_back_sweep<T, T>(gn, xb, xb, steps, d, r);
}

template <typename T, int D>
void launch_d(const T* diag, const T* off, const T* rhs, T* x, T* gain,
              int batch, int steps, cudaStream_t s) {
  constexpr int per_warp = kWarp / group_lanes<D>();
  const dim3 grid((batch + per_warp - 1) / per_warp);
  btd_solve_kernel<T, D><<<grid, kWarp, 0, s>>>(diag, off, rhs, x, gain,
                                                batch, steps);
}

// The instance of btd_solve_kernel for d, from D up to kNarrowMax.
template <typename T, int D = 1>
void launch_narrow(const T* diag, const T* off, const T* rhs, T* x, T* gain,
                   int batch, int steps, int d, cudaStream_t s) {
  if (d == D) {
    launch_d<T, D>(diag, off, rhs, x, gain, batch, steps, s);
  } else if constexpr (D < kNarrowMax) {
    launch_narrow<T, D + 1>(diag, off, rhs, x, gain, batch, steps, d, s);
  }
}

// D > kMaxD: one block of kBlockX x kBlockY threads per problem, x over the
// columns of a row and y over rows.  Row i of a step's buffer holds
// [C_t | U_t | y_t] at columns [0, d), [d, 2d) and 2d (stride w = 2d + 1).
// The rows are double in both instances: in float32, rows stored back in
// float32 after each of D pivots drift by ~D ulp (1.1e-6 relative at D = 48
// on an H100, 3x the plain version's error), so the float32 instance reads
// float32, works in float64 and writes float32.  `scratch` is null for the dynamic
// shared buffer, else a global buffer of block_elems(d) doubles per problem.
template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    btd_solve_kernel_block(const T* __restrict__ diag,
                           const T* __restrict__ off,
                           const T* __restrict__ rhs, T* __restrict__ x,
                           T* __restrict__ gain, double* __restrict__ scratch,
                           int steps, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t b = blockIdx.x;
  double* base = scratch ? scratch + b * block_elems(d)
                         : reinterpret_cast<double*>(smem);
  const int w = 2 * d + 1;
  const int cz = 2 * d;  // the column of y_t, then z_t
  const size_t step_elems = static_cast<size_t>(d) * w;
  double* up = base + 2 * step_elems;  // U_{t-1}, stride d + 1
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int dd = d * d;
  const T* dg = diag + b * steps * dd;
  const T* of = off + b * (steps - 1) * dd;
  const T* rv = rhs + b * steps * d;
  T* xb = x + b * steps * d;
  T* gn = gain + b * (steps - 1) * dd;

  for (int t = 0; t < steps; ++t) {
    double* cur = base + (t & 1) * step_elems;
    const double* prev = base + ((t + 1) & 1) * step_elems;
    const bool has_next = t < steps - 1;
    const size_t tdd = static_cast<size_t>(t) * dd;
    // The lower triangle of diag[t], mirrored (as the plain version's
    // Cholesky reads it), U_t = off[t] and y_t = rhs[t].
    for (int i = ty; i < d; i += kBlockY) {
      for (int c = tx; c < d; c += kBlockX) {
        if (c <= i) {
          const double v = dg[tdd + i * d + c];
          cur[i * w + c] = v;
          cur[c * w + i] = v;
        }
        cur[i * w + d + c] = has_next ? double(of[tdd + i * d + c]) : 0.0;
      }
      if (tx == 0) cur[i * w + cz] = rv[static_cast<size_t>(t) * d + i];
    }
    __syncthreads();
    block_step(cur, prev, up, t, d);
    for (int r = ty; r < d; r += kBlockY) {
      if (has_next)
        for (int c = tx; c < d; c += kBlockX)
          gn[tdd + r * d + c] = static_cast<T>(cur[r * w + d + c]);
      if (tx == 0)
        xb[static_cast<size_t>(t) * d + r] = static_cast<T>(cur[r * w + cz]);
    }
  }
  block_back_sweep<T, T>(base + ((steps - 1) & 1) * step_elems, up, gn, xb,
                         xb, steps, d);
}

template <typename T>
int launch_block(const T* diag, const T* off, const T* rhs, T* x, T* gain,
                 double* scratch, int batch, int steps, int d,
                 cudaStream_t s) {
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = block_elems(d) * sizeof(double);
    const cudaError_t e = cudaFuncSetAttribute(
        btd_solve_kernel_block<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  btd_solve_kernel_block<T><<<batch, dim3(kBlockX, kBlockY), smem, s>>>(
      diag, off, rhs, x, gain, scratch, steps, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* diag, const T* off, const T* rhs, T* x, T* gain,
           double* scratch, int batch, int steps, int d, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || steps <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= kNarrowMax) {
    launch_narrow<T>(diag, off, rhs, x, gain, batch, steps, d, s);
  } else if (d <= kMaxD) {
    btd_solve_kernel_wide<T><<<batch, kWarp, 0, s>>>(diag, off, rhs, x, gain,
                                                     steps, d);
  } else {
    return launch_block<T>(diag, off, rhs, x, gain, scratch, batch, steps, d,
                           s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of global scratch per problem that the wrapper must pass at D: 0
// where the kernel needs none (D <= 32, or the rows fit the device's opt-in
// shared memory).
extern "C" int dgpmp2_btd_scratch_bytes(int d, long long* bytes) {
  *bytes = 0;
  if (d <= kMaxD) return static_cast<int>(cudaSuccess);
  int optin = 0;
  const int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  const size_t n = block_elems(d) * sizeof(double);
  if (n > static_cast<size_t>(optin)) *bytes = static_cast<long long>(n);
  return static_cast<int>(cudaSuccess);
}

extern "C" int dgpmp2_btd_solve_f32(const float* diag, const float* off,
                                    const float* rhs, float* x, float* gain,
                                    double* scratch, int batch, int steps,
                                    int d, void* stream) {
  return launch<float>(diag, off, rhs, x, gain, scratch, batch, steps, d,
                       stream);
}

extern "C" int dgpmp2_btd_solve_f64(const double* diag, const double* off,
                                    const double* rhs, double* x, double* gain,
                                    double* scratch, int batch, int steps,
                                    int d, void* stream) {
  return launch<double>(diag, off, rhs, x, gain, scratch, batch, steps, d,
                        stream);
}
