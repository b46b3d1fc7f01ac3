// The block-Thomas sweeps shared by K-BTD (btd_solve.cuh) and K-STREAM
// (btd_stream.cuh): each step's Schur update and Gauss-Jordan pivot, and the
// back sweep.  Which kernel runs which:
//
// - the lane group of D <= 16 (narrow_schur, narrow_pivot,
//   narrow_back_sweep): K-BTD's btd_solve_kernel and K-STREAM's lane-group
//   consumer;
// - the warp of D = 17-32 (wide_schur, wide_pivots, wide_back_sweep, rows
//   in shared memory) and the block of D > 32 (block_schur, block_pivots,
//   block_back_sweep on a Team): K-STREAM's wide and block consumers, and
//   K-BTD's global-scratch kernel past the shared memory (D >= 76 on an
//   H100).  K-BTD's wide and block kernels below that keep their rows in
//   registers instead (btd_solve.cuh); each output element goes through the
//   same operations in the same order there, so the two give the same bits.
//
// The recurrence, with U_t = Λ[t, t+1] and C_t the Schur pivots:
//
//   C_0 = D_0,  y_0 = r_0
//   C_t = D_t - U_{t-1}^T X_{t-1},   y_t = r_t - U_{t-1}^T z_{t-1}
//   [X_t | z_t] = C_t^{-1} [U_t | y_t]           (forward sweep, stored)
//   x_{T-1} = z_{T-1},  x_t = z_t - X_t x_{t+1}  (back sweep: one matvec)
//
// - Gauss-Jordan on the augmented rows [C_t | U_t y_t] in place of a Cholesky
//   and two triangular solves: pivot j and row j are broadcast from lane j, the
//   pivot's reciprocal is taken once (__frcp_rn / __drcp_rn, no divide and no
//   square root), and every other row is updated in parallel.  One step is D
//   dependent pivots, not 3 D, and leaves X_t and z_t in the RHS columns.
// - The back sweep is one matvec per step: no triangular solve, no division.
//
// The gain X_t and z_t are stored in a type TG (the working type), x in TR;
// K-BTD passes one buffer and one type for z and x.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kStages = 4;
constexpr int kStaticSmem = 48 * 1024;  // bytes of static shared memory
constexpr int kNarrowMax = 16;          // largest D of the lane-group kernels
constexpr int kMaxD = 32;               // largest D of the warp kernels
constexpr int kBlockX = 32;             // past kMaxD: threads along a row
constexpr int kBlockY = 8;              // and rows at a time

template <int D>
__host__ __device__ constexpr int group_lanes() {
  return D <= 2 ? 2 : D <= 4 ? 4 : D <= 8 ? 8 : 16;
}

// Elements of one lane's slot of a ring stage: a row of diag, a row of off,
// a column of off, a column of diag, an element of rhs (the back sweep: a
// row of X_t, z_t[r]), each piece padded to 16 bytes.
template <typename T, int D>
__host__ __device__ constexpr int ring_slot() {
  const int p = 16 / static_cast<int>(sizeof(T));
  return 4 * ((D + p - 1) / p * p) + p;
}

// kStages, or as many stages as fit the static shared-memory limit (3 at
// D = 11-14 and 2 at D = 15, 16 in float64).
template <typename T, int D>
__host__ __device__ constexpr int ring_stages() {
  const int fit =
      kStaticSmem / (kWarp * ring_slot<T, D>() * static_cast<int>(sizeof(T)));
  return fit < kStages ? fit : kStages;
}

__device__ __forceinline__ float recip(float v) { return __frcp_rn(v); }
__device__ __forceinline__ double recip(double v) { return __drcp_rn(v); }

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Widest piece (4, 8 or 16 bytes) that tiles a row of N elements of T; rows
// start at multiples of their own size, so the pieces stay aligned.
template <typename T, int N>
__host__ __device__ constexpr int piece_bytes() {
  return (N * sizeof(T)) % 16 == 0 ? 16 : (N * sizeof(T)) % 8 == 0 ? 8 : 4;
}

template <int BYTES>
struct Piece;
template <>
struct Piece<4> {
  using type = float;
};
template <>
struct Piece<8> {
  using type = float2;
};
template <>
struct Piece<16> {
  using type = float4;
};

template <typename T, int N>
__device__ __forceinline__ void cp_row(T* dst, const T* src) {
  constexpr int V = piece_bytes<T, N>();
#pragma unroll
  for (int i = 0; i < static_cast<int>(N * sizeof(T)) / V; ++i)
    cp_async<V>(reinterpret_cast<char*>(dst) + i * V,
                reinterpret_cast<const char*>(src) + i * V);
}

template <typename T, int N>
__device__ __forceinline__ void store_row(T* dst, const T (&v)[N]) {
  constexpr int V = piece_bytes<T, N>();
  constexpr int PER = V / static_cast<int>(sizeof(T));
  using W = typename Piece<V>::type;
#pragma unroll
  for (int i = 0; i < N / PER; ++i) {
    W w;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int q = 0; q < PER; ++q) e[q] = v[i * PER + q];
    reinterpret_cast<W*>(dst)[i] = w;
  }
}

// -- D <= 16: a lane group of G lanes per problem, lane r owns row r --------

// Schur update of row r with the previous step's X and z, broadcast row by
// row: c -= U_{t-1}^T X_{t-1} (ucp: column r of U_{t-1}), bm[D] -=
// U_{t-1}^T z_{t-1}.
template <typename T, int D, int G>
__device__ __forceinline__ void narrow_schur(T (&c)[D], T (&bm)[D + 1],
                                             const T (&xp)[D],
                                             const T (&ucp)[D], T zp) {
#pragma unroll
  for (int k = 0; k < D; ++k) {
    bm[D] -= ucp[k] * __shfl_sync(0xffffffffu, zp, k, G);
#pragma unroll
    for (int j = 0; j < D; ++j)
      c[j] -= ucp[k] * __shfl_sync(0xffffffffu, xp[j], k, G);
  }
}

// Gauss-Jordan: C_t becomes I, [U_t | y_t] becomes [X_t | z_t].
template <typename T, int D, int G>
__device__ __forceinline__ void narrow_pivot(T (&c)[D], T (&bm)[D + 1],
                                             int r) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const T inv = recip(__shfl_sync(0xffffffffu, c[j], j, G));
    const bool me = r == j;
    const T f = me ? T(0) : c[j] * inv;
#pragma unroll
    for (int k = j + 1; k < D; ++k) {
      const T pk = __shfl_sync(0xffffffffu, c[k], j, G);
      c[k] = me ? pk * inv : c[k] - f * pk;
    }
#pragma unroll
    for (int m = 0; m <= D; ++m) {
      const T pm = __shfl_sync(0xffffffffu, bm[m], j, G);
      bm[m] = me ? pm * inv : bm[m] - f * pm;
    }
  }
}

// Back sweep from x_{T-1} = z_{T-1} (zp, this lane's element): x_t = z_t -
// X_t x_{t+1}, lane r's row of X_t (gn, its row of step 0) and z_t (zb, its
// element of step 0) streamed through the ring's first DP + 1 elements
// kStages - 1 steps ahead, x_t written to xb.  Every store this lane made to
// gn and zb must be ordered before the call (cp_wait<0>, then
// __threadfence_block).
template <typename TG, typename TR, int D, int G, int S, int SLOT>
__device__ __forceinline__ void narrow_back_sweep(TG (*ring)[kWarp][SLOT],
                                                  int lane, bool valid,
                                                  const TG* gn, const TG* zb,
                                                  TR* xb, int steps, TG zp) {
  constexpr int DD = D * D;
  constexpr int SZ = static_cast<int>(sizeof(TG));
  constexpr int P = 16 / SZ;
  constexpr int DP = (D + P - 1) / P * P;
  static_assert(SLOT >= DP + 1, "ring slot");
  const int nb = steps - 1;
  auto prefetch_bwd = [&](int i) {  // i-th back step: t = nb - 1 - i
    if (valid && i < nb) {
      const size_t t = static_cast<size_t>(nb - 1 - i);
      TG* s = ring[i % S][lane];
      cp_row<TG, D>(s, gn + t * DD);
      cp_async<SZ>(s + DP, zb + t * D);
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) prefetch_bwd(i);
  TG xn = zp;
  for (int i = 0; i < nb; ++i) {
    prefetch_bwd(i + S - 1);
    cp_wait<S - 1>();
    const TG* s = ring[i % S][lane];
    TG acc0 = valid ? s[DP] : TG(0), acc1 = TG(0);
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const TG xk = __shfl_sync(0xffffffffu, xn, k, G);
      const TG g = valid ? s[k] : TG(0);
      if (k % 2 == 0)
        acc0 -= g * xk;
      else
        acc1 -= g * xk;
    }
    xn = acc0 + acc1;
    if (valid) xb[static_cast<size_t>(nb - 1 - i) * D] = static_cast<TR>(xn);
  }
}

// -- D = 17-32: one warp per problem, the rows in shared memory (K-STREAM) --

// row[k] -= f * piv[k] for k in [k0, k1), four columns a round with every
// load issued before the stores: the two rows may be the same array, so
// the compiler would otherwise wait out each store before the next load.
template <typename T>
__device__ __forceinline__ void sub_scaled(T* row, const T* piv, T f, int k0,
                                           int k1) {
  int k = k0;
  for (; k + 4 <= k1; k += 4) {
    T p[4], a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      p[q] = piv[k + q];
      a[q] = row[k + q];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) row[k + q] = a[q] - f * p[q];
  }
  for (; k < k1; ++k) row[k] -= f * piv[k];
}

// The Schur update of one step on the rows cur = [C_t | U_t | y_t] (y_t in
// column 2d; row r at cur + r * rs), formed and visible to the warp, with
// prev = [. | X_{t-1} | z_{t-1}] and up = U_{t-1} (row r at up + r * us):
// C_t -= U_{t-1}^T X_{t-1}, y_t -= U_{t-1}^T z_{t-1}, one row of X_{t-1} at a
// time.  Neither prev nor up is read after it returns.
template <typename T>
__device__ __forceinline__ void wide_schur(T* cur, const T* prev,
                                           const T* up, int rs, int us,
                                           int t, int d, int r) {
  const int cz = 2 * d;
  if (t > 0 && r < d) {
    T* row = cur + r * rs;
    for (int k = 0; k < d; ++k) {
      const T u = up[k * us + r];
      row[cz] -= u * prev[k * rs + cz];
      sub_scaled(row, prev + k * rs + d, u, 0, d);
    }
  }
  __syncwarp();
}

// The rest of the step: U_t into up, then Gauss-Jordan, which leaves
// [X_t | z_t] in cur.
template <typename T>
__device__ __forceinline__ void wide_pivots(T* cur, T* up, int rs, int us,
                                            int d, int r) {
  const bool own = r < d;
  const int cz = 2 * d;
  if (own)
    for (int k = 0; k < d; ++k) up[r * us + k] = cur[r * rs + d + k];
  // Gauss-Jordan: C_t becomes I, [U_t | y_t] becomes [X_t | z_t].  Rows
  // r != j read pivot row j before lane j scales it.
  for (int j = 0; j < d; ++j) {
    const T inv = recip(cur[j * rs + j]);
    if (own && r != j)
      sub_scaled(cur + r * rs, cur + j * rs, cur[r * rs + j] * inv, j + 1,
                 cz + 1);
    __syncwarp();
    if (r == j) {
#pragma unroll 4
      for (int k = j + 1; k <= cz; ++k) cur[j * rs + k] *= inv;
    }
    __syncwarp();
  }
}

// Back sweep from x_{T-1} = z_{T-1}: x_t = z_t - X_t x_{t+1}; each lane
// reads back its own row of X_t (gn) and its own z_t (zb), and writes x_t
// to xb (from t = T - 2 down; x_{T-1} is the caller's).
template <typename TG, typename TR>
__device__ __forceinline__ void wide_back_sweep(const TG* gn, const TG* zb,
                                                TR* xb, int steps, int d,
                                                int r) {
  const bool own = r < d;
  const size_t dd = static_cast<size_t>(d) * d;
  TG xn = own ? zb[static_cast<size_t>(steps - 1) * d + r] : TG(0);
  for (int t = steps - 2; t >= 0; --t) {
    TG acc = own ? zb[static_cast<size_t>(t) * d + r] : TG(0);
    for (int k = 0; k < d; ++k) {
      const TG xk = __shfl_sync(0xffffffffu, xn, k);
      if (own) acc -= gn[t * dd + r * d + k] * xk;
    }
    xn = acc;
    if (own) xb[static_cast<size_t>(t) * d + r] = static_cast<TR>(xn);
  }
}

// -- D > 32: a team of kBlockX x ny threads per problem (K-STREAM, and
//    K-BTD past the shared memory) ------------------------------------------

// Elements (double) of the block kernels' rows per problem: two steps of D
// rows of 2 D + 1 columns and U_{t-1} with D + 1 columns.
__host__ __device__ inline size_t block_elems(int d) {
  return static_cast<size_t>(d) * (2 * d + 1) * 2 +
         static_cast<size_t>(d) * (d + 1);
}

// The threads that run a block kernel's step: (tx, ty) in kBlockX x ny,
// each element of a step taken by one of them in the same order whatever
// ny is; synchronised by sync(): the whole block (bar 0, K-BTD: ny =
// kBlockY) or, in K-STREAM, its consumer warps on the named barrier `bar`.
struct Team {
  int tx, ty, ny;
  unsigned bar;
  __device__ __forceinline__ void sync() const {
    if (bar == 0)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(kBlockX * ny)
                   : "memory");
  }
};

__device__ __forceinline__ Team whole_block() {
  return Team{static_cast<int>(threadIdx.x), static_cast<int>(threadIdx.y),
              kBlockY, 0u};
}

// The Schur update of one step on the double rows cur (row i: [C_t | U_t |
// y_t] at columns [0, d), [d, 2d) and 2d, stride 2d + 1), formed and visible
// to the team, with prev and up = U_{t-1} (stride d + 1): C_t -= U_{t-1}^T
// X_{t-1}, y_t -= U_{t-1}^T z_{t-1}; the column c = d stands for y.  Neither
// prev nor up is read after it returns.
__device__ __forceinline__ void block_schur(double* cur, const double* prev,
                                            const double* up, int t, int d,
                                            const Team& tm) {
  const int w = 2 * d + 1;
  const int cz = 2 * d;
  if (t > 0) {
    for (int r = tm.ty; r < d; r += tm.ny) {
      for (int c = tm.tx; c <= d; c += kBlockX) {
        const int col = c < d ? c : cz;
        const int pcol = c < d ? d + c : cz;
        double acc = cur[r * w + col];
        for (int k = 0; k < d; ++k)
          acc -= up[k * (d + 1) + r] * prev[k * w + pcol];
        cur[r * w + col] = acc;
      }
    }
    tm.sync();
  }
}

// The rest of the step: U_t into up, and Gauss-Jordan, which leaves [X_t |
// z_t] in cur.
__device__ __forceinline__ void block_pivots(double* cur, double* up, int d,
                                             const Team& tm) {
  const int w = 2 * d + 1;
  const int cz = 2 * d;
  for (int i = tm.ty; i < d; i += tm.ny)
    for (int c = tm.tx; c < d; c += kBlockX)
      up[i * (d + 1) + c] = cur[i * w + d + c];
  tm.sync();
  // Gauss-Jordan without scaling: pivot j takes cur[r][j] / cur[j][j]
  // times row j from every other row, over columns j + 1 .. 2d.  Row j
  // and column j are only read in pass j, so one barrier per pivot; each
  // row is divided by its pivot at the end: [X_t | z_t].
  for (int j = 0; j < d; ++j) {
    const double inv = recip(cur[j * w + j]);
    for (int r = tm.ty; r < d; r += tm.ny) {
      if (r == j) continue;
      const double f = cur[r * w + j] * inv;
      for (int k = j + 1 + tm.tx; k <= cz; k += kBlockX)
        cur[r * w + k] -= f * cur[j * w + k];
    }
    tm.sync();
  }
  for (int r = tm.ty; r < d; r += tm.ny) {
    const double inv = recip(cur[r * w + r]);
    for (int k = d + tm.tx; k <= cz; k += kBlockX) cur[r * w + k] *= inv;
  }
  tm.sync();
}

// Back sweep from x_{T-1} = z_{T-1} (the last step's rows, `last`): x_t =
// z_t - X_t x_{t+1}, x_{t+1} held in the buffer of U (free now), a row per
// thread of the team; X_t from gn and z_t from zb, x_t written to xb from
// t = T - 2 down.
template <typename TG, typename TR>
__device__ __forceinline__ void block_back_sweep(const double* last,
                                                 double* up, const TG* gn,
                                                 const TG* zb, TR* xb,
                                                 int steps, int d,
                                                 const Team& tm) {
  const int w = 2 * d + 1;
  const int cz = 2 * d;
  const int dd = d * d;
  const int tid = tm.ty * kBlockX + tm.tx;
  const int nt = kBlockX * tm.ny;
  double* xa = up;
  double* xn = up + d;
  for (int i = tid; i < d; i += nt) xa[i] = last[i * w + cz];
  tm.sync();
  for (int t = steps - 2; t >= 0; --t) {
    const size_t tdd = static_cast<size_t>(t) * dd;
    for (int r = tid; r < d; r += nt) {
      double acc = zb[static_cast<size_t>(t) * d + r];
      for (int k = 0; k < d; ++k) acc -= double(gn[tdd + r * d + k]) * xa[k];
      xn[r] = acc;
      xb[static_cast<size_t>(t) * d + r] = static_cast<TR>(acc);
    }
    tm.sync();
    double* tmp = xa;
    xa = xn;
    xn = tmp;
  }
}

// Largest dynamic shared memory a block may opt in to on the current device.
inline int smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return static_cast<int>(e);
}

}  // namespace
