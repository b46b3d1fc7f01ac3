// K-STREAM: one damped Gauss-Newton step of the stream engine, the normal
// equations assembled from the residual pieces inside the block-Thomas
// sweeps, and solved there:  x = Λ⁻¹ r  with Λ and r formed step by step.
// The kernels; the entry points of the three instances are btd_stream.cu,
// btd_stream_f64.cu and btd_stream_mixed.cu, one nvcc process each.
//
// Replaces the stream engine's TPU path: dgpmp2_tpu/core/stream.py:219
// `stream_step` (assembly in the solve layout) feeding
// dgpmp2_tpu/ops/pallas/btd_stream.py:117,189 (the forward and back sweeps).
// The plain version is dgpmp2_tpu_torch/ops/cuda/btd_stream.py `plain`: the
// same system formed in PyTorch (`plain_system`) and solved by
// ops/tridiag.py `btd_solve`.
//
// For problem b and state t (0 <= t < T1), with the factor set of
// dgpmp2_tpu_torch/core/graph.py `assemble_from_residuals`:
//
//   diag_t = S_t + Σ_f H_{f,t}^T Λ_{f,t} H_{f,t} (+ diag_add_t)
//   rhs_t  = [t < T1-1] (Φ^T Q⁻¹ r_gp)_t - [t >= 1] (Q⁻¹ r_gp)_{t-1}
//            + [t = 0] Ks⁻¹ r_s + [t = T1-1] Kg⁻¹ r_g
//            + Σ_f (Λ_{f,t} H_{f,t})^T r_{f,t} (+ rhs_add_t)
//   off_t  = O_t (+ off_add_t)
//   LM:      diag_t,ii += δ_b diag_t,ii, after every addition
//
// S is the per-plan GP/prior diagonal with the GN damping folded in, O =
// -Φ^T Q⁻¹; the families f (obstacles, nonholonomic, velocity and joint
// limits, self-collision) have K residual rows each and Λ a K x K block or,
// with `diagonal`, its diagonal.  Only the lower triangle of each diag_t is
// formed (element (i, j), i >= j, as Σ_k H[k][i] (ΛH)[k][j], the standard
// assembly's form), as K-BTD and the plain Cholesky read only that triangle.
// Every input is a strided view (View): a per-plan block that every problem
// shares has batch stride 0 and is read from one copy.
//
// Three instances: float32 (TA = TR = float), float64, and the df32 engine's
// (TR = float residuals and x, TA = double blocks, assembly and pivots).  In
// every instance the assembly runs in float64 and each element of a step's
// rows is rounded once to TA: summed in float32, in another order than the
// standard assembly's, the float32 step's error against the float64 solve
// reached 2.1x the standard float32 engine's (4-link arm, GN, B = 1024, on
// an H100).  Past D = 16 the rows stay float64 through the pivots, as in
// K-BTD's block kernel.
//
// What bounds it on an H100.  The bytes are the residual pieces read once
// (r_gp, H and r of each family, r_s, r_g), the shared blocks once, x
// written once, and the gain X_t and z_t written and read back once: at the
// 2-D bench (B = 1024, T1 = 101, D = 4, one obstacle sphere) in float32 that
// is ~18 KB a problem, 18.9 MB in all, 5.6 us at 3.35 TB/s; there is no
// (B, T, D, D) diag or rhs in memory.  Like K-BTD it is latency-bound: each
// problem is a chain of T1 dependent steps.
//
// Design (simple and right, for every D; btd_sweep.cuh holds the sweeps):
// - D <= 16: K-BTD's lane group.  Lane r forms row r of the step's diag
//   block, its row and column of off and its element of rhs from the
//   residual pieces, read from global memory (synchronous loads; the
//   residuals of one step are a few hundred bytes), then the group pivots.
//   The back sweep streams X_t and z_t through K-BTD's ring.
// - D = 17-32: K-BTD's warp per problem with the rows in shared memory
//   (float64: 42.2 KB); lane r forms its row, each family row H[k] and
//   (ΛH)[k] formed once by the warp into shared memory; a family's sum is
//   kept apart (in the row's U columns) and added to the row once, as the
//   standard assembly adds each family's sum.
// - D > 32: K-BTD's block per problem with double rows, the block sharing
//   each family row's D² products.
// The gain and z are stored in TA, so the df32 instance keeps float64 from
// the first product to the last back-sweep step; x is written in TR.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "btd_sweep.cuh"

// The argument structs have external linkage: the extern "C" entry
// points take them (a type of an unnamed namespace would make those
// internal, and unexported).
namespace dgpmp2_stream {

constexpr int kMaxFamilies = 5;

// A strided view: element (i0, i1, i2, i3) at p[Σ ik sk] (elements).
struct View {
  const void* p;
  long long s[4];
};

// One unary family: H (b, t, k, j), r (b, t, k), Λ (b, t, k, l) or, with
// `diagonal`, (b, t, k).
struct Family {
  View h, r, w;
  int k, diagonal;
};

// The kernel's arguments (ops/cuda/btd_stream.py `_Args` mirrors them).
// Blocks, Λ, addends and δ are TA; r_gp (b, t, j), r_s and r_g (b, j), H
// and r are TR.  diag, off, phit_q, q_inv (b, t, i, j); ks, kg (b, i, j);
// the addends' p may be null, and delta's (b) is null under GN.
struct StreamArgs {
  View diag, off, phit_q, q_inv, ks, kg;
  View r_gp, r_s, r_g;
  View diag_add, off_add, rhs_add, delta;
  Family fam[kMaxFamilies];
  int nfam, batch, steps, d;
  void* x;        // (B, T1, D) TR
  void* z;        // (B, T1, D) TA, z_t; may be x where TA is TR
  void* gain;     // (B, T1 - 1, D, D) TA, X_t
  void* scratch;  // D > 32: the rows in global memory, or null
};

}  // namespace dgpmp2_stream

namespace {

using dgpmp2_stream::Family;
using dgpmp2_stream::kMaxFamilies;
using dgpmp2_stream::StreamArgs;
using dgpmp2_stream::View;

template <typename T>
__device__ __forceinline__ T at(const View& v, long long i0, long long i1,
                                long long i2 = 0, long long i3 = 0) {
  return static_cast<const T*>(
      v.p)[i0 * v.s[0] + i1 * v.s[1] + i2 * v.s[2] + i3 * v.s[3]];
}

// Element i of rhs_t from the GP and prior residuals, in float64.
template <typename TA, typename TR>
__device__ __forceinline__ double gp_rhs(const StreamArgs& a, int b, int t,
                                         int i, int d) {
  double y = 0.0;
  if (t < a.steps - 1) {
    double s = 0.0;
    for (int j = 0; j < d; ++j)
      s += double(at<TA>(a.phit_q, b, t, i, j)) * double(at<TR>(a.r_gp, b, t, j));
    y = s;
  }
  if (t >= 1) {
    double s = 0.0;
    for (int j = 0; j < d; ++j)
      s += double(at<TA>(a.q_inv, b, t - 1, i, j)) *
           double(at<TR>(a.r_gp, b, t - 1, j));
    y -= s;
  }
  if (t == 0) {
    double s = 0.0;
    for (int j = 0; j < d; ++j)
      s += double(at<TA>(a.ks, b, i, j)) * double(at<TR>(a.r_s, b, j));
    y += s;
  }
  if (t == a.steps - 1) {
    double s = 0.0;
    for (int j = 0; j < d; ++j)
      s += double(at<TA>(a.kg, b, i, j)) * double(at<TR>(a.r_g, b, j));
    y += s;
  }
  return y;
}

// (ΛH)[k][j] of family f at (b, t), in float64.
template <typename TA, typename TR>
__device__ __forceinline__ double lam_h(const Family& f, int b, int t, int k,
                                        int j) {
  if (f.diagonal)
    return double(at<TA>(f.w, b, t, k)) * double(at<TR>(f.h, b, t, k, j));
  double s = 0.0;
  for (int l = 0; l < f.k; ++l)
    s += double(at<TA>(f.w, b, t, k, l)) * double(at<TR>(f.h, b, t, l, j));
  return s;
}

// -- D <= 16 ----------------------------------------------------------------

// Lane r's part of step t: row r of the lower triangle of diag_t (c, row
// r left of the diagonal and column r below it), row r of off_t and
// rhs_t[r] (bm), column r of off_t (uc); formed in float64 and rounded
// once to TA.
template <typename TA, typename TR, int D>
__device__ __forceinline__ void narrow_rows(const StreamArgs& a, int b, int t,
                                            int r, TA (&c)[D], TA (&bm)[D + 1],
                                            TA (&uc)[D]) {
  const bool has_next = t < a.steps - 1;
  double cd[D];
#pragma unroll
  for (int j = 0; j < D; ++j)
    cd[j] = at<TA>(a.diag, b, t, j <= r ? r : j, j <= r ? j : r);
  double y = gp_rhs<TA, TR>(a, b, t, r, D);
  for (int n = 0; n < a.nfam; ++n) {
    const Family& f = a.fam[n];
    double acc[D];
#pragma unroll
    for (int j = 0; j < D; ++j) acc[j] = 0.0;
    double ry = 0.0;
    for (int k = 0; k < f.k; ++k) {
      const double hr = at<TR>(f.h, b, t, k, r);
      const double lr = lam_h<TA, TR>(f, b, t, k, r);
#pragma unroll
      for (int j = 0; j < D; ++j)
        acc[j] += j <= r ? hr * lam_h<TA, TR>(f, b, t, k, j)
                         : double(at<TR>(f.h, b, t, k, j)) * lr;
      ry += lr * double(at<TR>(f.r, b, t, k));
    }
#pragma unroll
    for (int j = 0; j < D; ++j) cd[j] += acc[j];
    y += ry;
  }
  if (a.diag_add.p) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      cd[j] += at<TA>(a.diag_add, b, t, j <= r ? r : j, j <= r ? j : r);
  }
  if (a.rhs_add.p) y += at<TA>(a.rhs_add, b, t, r);
  if (a.delta.p) {
    const double dl = at<TA>(a.delta, b, 0);
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (j == r) cd[j] = cd[j] + dl * cd[j];
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    double o = 0.0, u = 0.0;
    if (has_next) {
      o = at<TA>(a.off, b, t, r, j);
      u = at<TA>(a.off, b, t, j, r);
      if (a.off_add.p) {
        o += at<TA>(a.off_add, b, t, r, j);
        u += at<TA>(a.off_add, b, t, j, r);
      }
    }
    c[j] = TA(cd[j]);
    bm[j] = TA(o);
    uc[j] = TA(u);
  }
  bm[D] = TA(y);
}

template <typename TA, typename TR, int D>
__global__ void __launch_bounds__(kWarp)
    btd_stream_kernel(__grid_constant__ const StreamArgs a) {
  constexpr int G = group_lanes<D>();
  constexpr int DD = D * D;
  constexpr int P = 16 / static_cast<int>(sizeof(TA));
  constexpr int DP = (D + P - 1) / P * P;
  constexpr int SLOT = DP + P;  // the back sweep's row of X_t and z_t[r]
  __shared__ __align__(16) TA ring[kStages][kWarp][SLOT];

  const int lane = threadIdx.x;
  const int r = lane % G;
  const int b = blockIdx.x * (kWarp / G) + lane / G;
  const bool valid = b < a.batch && r < D;
  const size_t bb = valid ? static_cast<size_t>(b) : 0;
  const int rr = valid ? r : 0;
  const int steps = a.steps;
  TA* zb = static_cast<TA*>(a.z) + bb * steps * D + rr;
  TR* xb = static_cast<TR*>(a.x) + bb * steps * D + rr;
  TA* gn = static_cast<TA*>(a.gain) + bb * (steps - 1) * DD + rr * D;

  TA xp[D];   // row r of X_{t-1}
  TA ucp[D];  // column r of U_{t-1}
  TA zp = TA(0);
#pragma unroll
  for (int j = 0; j < D; ++j) xp[j] = ucp[j] = TA(0);

  for (int t = 0; t < steps; ++t) {
    TA c[D], bm[D + 1], uc[D];
    if (valid) {
      narrow_rows<TA, TR, D>(a, b, t, r, c, bm, uc);
    } else {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        c[j] = TA(j == r);
        bm[j] = uc[j] = TA(0);
      }
      bm[D] = TA(0);
    }
    if (t > 0) narrow_schur<TA, D, G>(c, bm, xp, ucp, zp);
    narrow_pivot<TA, D, G>(c, bm, r);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      xp[j] = bm[j];
      ucp[j] = uc[j];
    }
    zp = bm[D];
    if (valid) {
      zb[static_cast<size_t>(t) * D] = zp;
      if (t < steps - 1)
        store_row<TA, D>(gn + static_cast<size_t>(t) * DD, xp);
    }
  }
  if (valid) xb[static_cast<size_t>(steps - 1) * D] = static_cast<TR>(zp);
  // The ring's copies read back what this lane stored: order those stores
  // first.
  __threadfence_block();
  narrow_back_sweep<TA, TR, D, G, kStages, SLOT>(ring, lane, valid, gn, zb,
                                                 xb, steps, zp);
}

// -- D = 17-32 --------------------------------------------------------------

template <typename TA, typename TR>
__global__ void __launch_bounds__(kWarp)
    btd_stream_kernel_wide(__grid_constant__ const StreamArgs a) {
  __shared__ double rows[2][kWarp][kWideRow];
  __shared__ double up[kWarp][kWarp + 1];
  __shared__ double hk[kWarp];  // H[k] of the family row in hand
  __shared__ double lk[kWarp];  // (ΛH)[k]
  const int r = threadIdx.x;
  const int d = a.d;
  const bool own = r < d;
  const int steps = a.steps;
  const size_t dd = static_cast<size_t>(d) * d;
  const int b = blockIdx.x;
  TA* zb = static_cast<TA*>(a.z) + static_cast<size_t>(b) * steps * d;
  TR* xb = static_cast<TR*>(a.x) + static_cast<size_t>(b) * steps * d;
  TA* gn = static_cast<TA*>(a.gain) + static_cast<size_t>(b) * (steps - 1) * dd;
  const int cz = 2 * d;

  for (int t = 0; t < steps; ++t) {
    double(*cur)[kWideRow] = rows[t & 1];
    const double(*prev)[kWideRow] = rows[(t + 1) & 1];
    const bool has_next = t < steps - 1;
    double y = 0.0;
    if (own) {
      for (int j = 0; j < d; ++j)
        cur[r][j] = at<TA>(a.diag, b, t, j <= r ? r : j, j <= r ? j : r);
      y = gp_rhs<TA, TR>(a, b, t, r, d);
    }
    for (int n = 0; n < a.nfam; ++n) {
      const Family& f = a.fam[n];
      double ry = 0.0;
      if (own)
        for (int j = 0; j < d; ++j) cur[r][d + j] = 0.0;
      for (int k = 0; k < f.k; ++k) {
        if (own) {
          hk[r] = at<TR>(f.h, b, t, k, r);
          lk[r] = lam_h<TA, TR>(f, b, t, k, r);
        }
        __syncwarp();
        if (own) {
          const double hr = hk[r], lr = lk[r];
          for (int j = 0; j < d; ++j)
            cur[r][d + j] += j <= r ? hr * lk[j] : hk[j] * lr;
          ry += lr * double(at<TR>(f.r, b, t, k));
        }
        __syncwarp();
      }
      if (own) {
        for (int j = 0; j < d; ++j) cur[r][j] += cur[r][d + j];
        y += ry;
      }
    }
    if (own) {
      if (a.diag_add.p)
        for (int j = 0; j < d; ++j)
          cur[r][j] += at<TA>(a.diag_add, b, t, j <= r ? r : j, j <= r ? j : r);
      if (a.rhs_add.p) y += at<TA>(a.rhs_add, b, t, r);
      if (a.delta.p) cur[r][r] = cur[r][r] + at<TA>(a.delta, b, 0) * cur[r][r];
      for (int j = 0; j < d; ++j) {
        double o = 0.0;
        if (has_next) {
          o = at<TA>(a.off, b, t, r, j);
          if (a.off_add.p) o += at<TA>(a.off_add, b, t, r, j);
        }
        cur[r][d + j] = o;
      }
      cur[r][cz] = y;
    }
    __syncwarp();
    wide_step<double>(cur, prev, up, t, d, r);
    if (own) {
      zb[static_cast<size_t>(t) * d + r] = static_cast<TA>(cur[r][cz]);
      if (has_next)
        for (int k = 0; k < d; ++k)
          gn[t * dd + r * d + k] = static_cast<TA>(cur[r][d + k]);
    }
  }
  if (own)
    xb[static_cast<size_t>(steps - 1) * d + r] =
        static_cast<TR>(rows[(steps - 1) & 1][r][cz]);
  wide_back_sweep<TA, TR>(gn, zb, xb, steps, d, r);
}

// -- D > 32 -----------------------------------------------------------------

// Doubles per problem of the block kernel's buffer: K-BTD's rows, then the
// family row in hand, H[k] and (ΛH)[k].
__host__ __device__ inline size_t stream_block_elems(int d) {
  return block_elems(d) + 2 * static_cast<size_t>(d);
}

template <typename TA, typename TR>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    btd_stream_kernel_block(__grid_constant__ const StreamArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = a.d;
  const int steps = a.steps;
  const int b = blockIdx.x;
  double* base = a.scratch ? static_cast<double*>(a.scratch) +
                                 static_cast<size_t>(b) * stream_block_elems(d)
                           : reinterpret_cast<double*>(smem);
  const int w = 2 * d + 1;
  const int cz = 2 * d;
  const size_t step_elems = static_cast<size_t>(d) * w;
  double* up = base + 2 * step_elems;
  double* hk = base + block_elems(d);
  double* lk = hk + d;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBlockX + tx;
  const int dd = d * d;
  TA* zb = static_cast<TA*>(a.z) + static_cast<size_t>(b) * steps * d;
  TR* xb = static_cast<TR*>(a.x) + static_cast<size_t>(b) * steps * d;
  TA* gn = static_cast<TA*>(a.gain) + static_cast<size_t>(b) * (steps - 1) * dd;

  for (int t = 0; t < steps; ++t) {
    double* cur = base + (t & 1) * step_elems;
    const double* prev = base + ((t + 1) & 1) * step_elems;
    const bool has_next = t < steps - 1;
    const size_t tdd = static_cast<size_t>(t) * dd;
    // Thread (tx, ty) keeps element (i, c), c <= i, of the lower triangle
    // and, at tx = 0, rhs[i] through every phase of the assembly.
    for (int i = ty; i < d; i += kBlockY) {
      for (int c = tx; c <= i; c += kBlockX)
        cur[i * w + c] = double(at<TA>(a.diag, b, t, i, c));
      if (tx == 0) cur[i * w + cz] = gp_rhs<TA, TR>(a, b, t, i, d);
    }
    for (int n = 0; n < a.nfam; ++n) {
      const Family& f = a.fam[n];
      for (int k = 0; k < f.k; ++k) {
        __syncthreads();
        for (int j = tid; j < d; j += kBlockX * kBlockY) {
          hk[j] = double(at<TR>(f.h, b, t, k, j));
          lk[j] = lam_h<TA, TR>(f, b, t, k, j);
        }
        __syncthreads();
        const double rk = double(at<TR>(f.r, b, t, k));
        for (int i = ty; i < d; i += kBlockY) {
          for (int c = tx; c <= i; c += kBlockX)
            cur[i * w + c] += hk[i] * lk[c];
          if (tx == 0) cur[i * w + cz] += lk[i] * rk;
        }
      }
    }
    // Addends and damping on the lower triangle, then its mirror, U_t.
    for (int i = ty; i < d; i += kBlockY) {
      for (int c = tx; c < d; c += kBlockX) {
        if (c <= i) {
          double v = cur[i * w + c];
          if (a.diag_add.p) v += double(at<TA>(a.diag_add, b, t, i, c));
          if (c == i && a.delta.p) v = v + double(at<TA>(a.delta, b, 0)) * v;
          cur[i * w + c] = v;
          cur[c * w + i] = v;
        }
        double o = 0.0;
        if (has_next) {
          o = double(at<TA>(a.off, b, t, i, c));
          if (a.off_add.p) o += double(at<TA>(a.off_add, b, t, i, c));
        }
        cur[i * w + d + c] = o;
      }
      if (tx == 0 && a.rhs_add.p)
        cur[i * w + cz] += double(at<TA>(a.rhs_add, b, t, i));
    }
    __syncthreads();
    block_step(cur, prev, up, t, d);
    for (int r = ty; r < d; r += kBlockY) {
      if (has_next)
        for (int c = tx; c < d; c += kBlockX)
          gn[tdd + r * d + c] = static_cast<TA>(cur[r * w + d + c]);
      if (tx == 0)
        zb[static_cast<size_t>(t) * d + r] = static_cast<TA>(cur[r * w + cz]);
    }
  }
  const double* last = base + ((steps - 1) & 1) * step_elems;
  for (int r = tid; r < d; r += kBlockX * kBlockY)
    xb[static_cast<size_t>(steps - 1) * d + r] =
        static_cast<TR>(last[r * w + cz]);
  block_back_sweep<TA, TR>(last, up, gn, zb, xb, steps, d);
}

template <typename TA, typename TR, int D = 1>
void launch_narrow(const StreamArgs& a, cudaStream_t s) {
  if (a.d == D) {
    constexpr int per_warp = kWarp / group_lanes<D>();
    const dim3 grid((a.batch + per_warp - 1) / per_warp);
    btd_stream_kernel<TA, TR, D><<<grid, kWarp, 0, s>>>(a);
  } else if constexpr (D < kNarrowMax) {
    launch_narrow<TA, TR, D + 1>(a, s);
  }
}

template <typename TA, typename TR>
int launch(const StreamArgs* args, void* stream) {
  const StreamArgs& a = *args;
  if (a.d < 1 || a.nfam < 0 || a.nfam > kMaxFamilies)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch <= 0 || a.steps <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d <= kNarrowMax) {
    launch_narrow<TA, TR>(a, s);
  } else if (a.d <= kMaxD) {
    btd_stream_kernel_wide<TA, TR><<<a.batch, kWarp, 0, s>>>(a);
  } else {
    size_t smem = 0;
    if (a.scratch == nullptr) {
      smem = stream_block_elems(a.d) * sizeof(double);
      const cudaError_t e = cudaFuncSetAttribute(
          btd_stream_kernel_block<TA, TR>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    btd_stream_kernel_block<TA, TR>
        <<<a.batch, dim3(kBlockX, kBlockY), smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

