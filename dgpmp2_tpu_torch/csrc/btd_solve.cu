// K-BTD: batched symmetric block-tridiagonal solve  Λ x = r  by block Thomas.
//
// Replaces the TPU kernels dgpmp2_tpu/ops/pallas/btd_solve.py `_make_kernel`
// (standard engine, via `btd_solve_pallas`) and
// dgpmp2_tpu/ops/pallas/btd_stream.py `_make_fwd_kernel`/`_make_bwd_kernel`
// (stream engine).  Same math as dgpmp2_tpu/ops/tridiag.py `btd_factor` +
// `btd_solve_factored`:
//
//   L_0 = chol(D_0),  y_0 = r_0
//   for i >= 1:  X = C_{i-1}^{-1} U_{i-1},  C_i = D_i - U_{i-1}^T X,
//                L_i = chol(C_i),           y_i = r_i - X^T y_{i-1}
//   x_{T-1} = C_{T-1}^{-1} y_{T-1},  x_i = C_i^{-1} (y_i - U_i x_{i+1})
//
// Layout: the public contract, row-major diag (B, T, D, D), off (B, T-1, D, D),
// rhs (B, T, D) and x (B, T, D); no transpose to a batch-contiguous layout.
// Scratch: chol (B, T, D*D) holds the pivot factors L_i; the forward-sweep
// vectors y_i are kept in the output x and overwritten by the back sweep.
//
// What bounds it on an H100: latency.  One thread owns one problem and walks
// its T steps in order, each step a chain of dependent D x D operations
// (about 3 D^3 flops); at B = 1024 that is 1024 threads on a card with 132
// SMs, so most of the card is idle and the time is T times the latency of one
// step.  Bytes are small (about 0.5 MB of diag/off/rhs at B = 1024, T = 101,
// D = 4) and stay in L2.  Each thread reads its own contiguous D*D block per
// step, so every sector it touches is used in full even without coalescing.
//
// What the design does about it: keeps the D x D algebra unrolled in registers
// (D is a template parameter, instantiated for 4 and 6), keeps the T loop in
// the thread so there is one launch per solve, and touches device memory only
// for inputs, the pivot factors and x.  Filling the card (several threads per
// problem, or a cyclic-reduction split of T) is left to a later change.
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T dsqrt(T v);
template <>
__device__ __forceinline__ float dsqrt<float>(float v) { return sqrtf(v); }
template <>
__device__ __forceinline__ double dsqrt<double>(double v) { return sqrt(v); }

// Lower Cholesky of the lower triangle of c, as in tridiag._chol_unrolled.
template <typename T, int D>
__device__ __forceinline__ void cholesky(const T (&c)[D][D], T (&l)[D][D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T s = c[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= l[j][k] * l[j][k];
    const T ljj = dsqrt<T>(s);
    const T inv = T(1) / ljj;
    l[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      T t = c[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= l[i][k] * l[j][k];
      l[i][j] = t * inv;
    }
#pragma unroll
    for (int i = 0; i < j; ++i) l[i][j] = T(0);
  }
}

// Solve (L L^T) v = b in place.
template <typename T, int D>
__device__ __forceinline__ void chol_solve(const T (&l)[D][D], T (&v)[D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T s = v[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[i][k] * v[k];
    v[i] = s / l[i][i];
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    T s = v[i];
#pragma unroll
    for (int k = i + 1; k < D; ++k) s -= l[k][i] * v[k];
    v[i] = s / l[i][i];
  }
}

template <typename T, int D>
__device__ __forceinline__ void load_mat(const T* __restrict__ p, T (&m)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) m[i][j] = p[i * D + j];
}

template <typename T, int D>
__global__ void btd_solve_kernel(const T* __restrict__ diag,
                                 const T* __restrict__ off,
                                 const T* __restrict__ rhs, T* __restrict__ x,
                                 T* __restrict__ chol, int batch, int steps) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  constexpr int DD = D * D;
  const T* dg = diag + static_cast<size_t>(b) * steps * DD;
  const T* of = off + static_cast<size_t>(b) * (steps - 1) * DD;
  const T* r = rhs + static_cast<size_t>(b) * steps * D;
  T* xb = x + static_cast<size_t>(b) * steps * D;
  T* lb = chol + static_cast<size_t>(b) * steps * DD;

  T c[D][D], l[D][D], u[D][D], xm[D][D], y[D];

  // Factorisation + forward sweep.
  load_mat<T, D>(dg, c);
  cholesky<T, D>(c, l);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    y[i] = r[i];
    xb[i] = y[i];
#pragma unroll
    for (int j = 0; j < D; ++j) lb[i * D + j] = l[i][j];
  }
  for (int t = 1; t < steps; ++t) {
    load_mat<T, D>(of + (t - 1) * DD, u);
    // X = C_{t-1}^{-1} U_{t-1}, one column at a time.
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T col[D];
#pragma unroll
      for (int i = 0; i < D; ++i) col[i] = u[i][j];
      chol_solve<T, D>(l, col);
#pragma unroll
      for (int i = 0; i < D; ++i) xm[i][j] = col[i];
    }
    // C_t = D_t - X^T U (lower triangle is all the Cholesky reads).
    load_mat<T, D>(dg + t * DD, c);
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T s = c[i][j];
#pragma unroll
        for (int k = 0; k < D; ++k) s -= xm[k][i] * u[k][j];
        c[i][j] = s;
      }
    cholesky<T, D>(c, l);
    // y_t = r_t - X^T y_{t-1}
    T yn[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T s = r[t * D + i];
#pragma unroll
      for (int k = 0; k < D; ++k) s -= xm[k][i] * y[k];
      yn[i] = s;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      y[i] = yn[i];
      xb[t * D + i] = y[i];
#pragma unroll
      for (int j = 0; j < D; ++j) lb[t * DD + i * D + j] = l[i][j];
    }
  }

  // Back substitution; l still holds L_{T-1} and y holds y_{T-1}.
  chol_solve<T, D>(l, y);
#pragma unroll
  for (int i = 0; i < D; ++i) xb[(steps - 1) * D + i] = y[i];
  for (int t = steps - 2; t >= 0; --t) {
    load_mat<T, D>(of + t * DD, u);
    load_mat<T, D>(lb + t * DD, l);
    T v[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T s = xb[t * D + i];
#pragma unroll
      for (int k = 0; k < D; ++k) s -= u[i][k] * y[k];
      v[i] = s;
    }
    chol_solve<T, D>(l, v);
#pragma unroll
    for (int i = 0; i < D; ++i) {
      y[i] = v[i];
      xb[t * D + i] = v[i];
    }
  }
}

constexpr int kThreads = 128;

template <typename T>
int launch(const T* diag, const T* off, const T* rhs, T* x, T* chol, int batch,
           int steps, int d, void* stream) {
  if (batch <= 0 || steps <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((batch + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 4:
      btd_solve_kernel<T, 4><<<grid, kThreads, 0, s>>>(diag, off, rhs, x, chol,
                                                       batch, steps);
      break;
    case 6:
      btd_solve_kernel<T, 6><<<grid, kThreads, 0, s>>>(diag, off, rhs, x, chol,
                                                       batch, steps);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dgpmp2_btd_solve_f32(const float* diag, const float* off,
                                    const float* rhs, float* x, float* chol,
                                    int batch, int steps, int d, void* stream) {
  return launch<float>(diag, off, rhs, x, chol, batch, steps, d, stream);
}

extern "C" int dgpmp2_btd_solve_f64(const double* diag, const double* off,
                                    const double* rhs, double* x, double* chol,
                                    int batch, int steps, int d, void* stream) {
  return launch<double>(diag, off, rhs, x, chol, batch, steps, d, stream);
}
