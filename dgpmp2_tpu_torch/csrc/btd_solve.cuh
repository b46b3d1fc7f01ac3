#pragma once
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
// D = 17-32 (arms of 9-16 links) takes btd_solve_kernel_wide, a warp a
// problem; D > 32 (arms of 17 links and more) btd_solve_kernel_block, a
// block a problem; both grids persistent (as many blocks as the card keeps
// resident, each taking problems in turn).  What bounds them on an H100:
// the bytes are ~0.034 ms at D = 18 and B = 1024, T = 41 in float32, and
// the float64 operations of
// Gauss-Jordan (~1.5 D^3 fused multiply-adds a step) ~0.125 ms at D = 34;
// but each problem is a chain of T steps of D dependent pivots, so the
// kernels are bound by that chain's latency and by the instructions of the
// blocks resident on an SM.  What the design does about it:
// - Loads off the chain: each step's diag_t, off_t and rhs_t are contiguous
//   blocks, staged into shared memory by every thread with one cp.async of
//   one element each (coalesced), at an odd row stride p = d | 1, so that
//   rows and columns read back free of bank conflicts.  Step t + 1 is staged
//   once step t's Schur update has read U_{t-1}, so its loads overlap the
//   step's D pivots.  The slot of diag_t takes X_{t-1} once its C_t has
//   been read, and that of rhs_t z_{t-1}; two slots hold U_t and U_{t-1}.
// - Rows in registers.  The wide kernel: lane r holds row r of [C_t | U_t |
//   y_t] as two arrays of W (D padded to 20, 24, 28 or 32: four instances a
//   type, d masked at run time) and a value.  Pivot row j is published by
//   lane j into one of two shared pivot buffers and read back by every lane
//   16 bytes at a time (a broadcast), one warp barrier a pivot; lane j then
//   divides its own row by its pivot, so the others read the row before
//   that division, as Gauss-Jordan does.  The Schur update reads U_{t-1}'s
//   column r and X_{t-1}'s rows (broadcast) from shared memory.  The block
//   kernel: thread (g, h) holds a tile of 16 consecutive elements of each
//   of rows 3g, 3g + 1, 3g + 2 of the step's float64 rows.  Each pivot
//   passes only row j, column j and 1 / pivot through double-buffered
//   shared memory, one block barrier a pivot; 16 pivot-row elements feed
//   48 fused multiply-adds, and a shared row's tiles lie 18 doubles apart,
//   so that a warp's 16-byte loads of them fall in different banks.  Every
//   element of a tile is updated each pivot, the dead columns left of the
//   pivot too, so no element waits on a predicate; the rows are divided by
//   their pivots once at the end of the step.
// - Gain traffic coalesced: the wide kernel copies X_t from its slot to
//   device memory by consecutive elements, the block kernel stores it from
//   its tiles a row segment a warp; the back sweep stages X_t and z_t one
//   back step ahead, again by cp.async.
// - Shared memory sized by d (wide_layout, block_layout), so that B = 1024
//   is resident in one wave where the registers and the SM's shared memory
//   allow (ops/cuda/btd_solve.py `plan` reports it).
// Each output element goes through the same operations in the same order
// as in the kernels these replaced (btd_sweep.cuh's wide and block sweeps,
// which K-STREAM still runs): the same bits.
//
// Past the shared memory (D >= 76 on an H100: the parent block kernel's
// 5 D^2 + 3 D doubles of rows exceed the opt-in limit), btd_solve_kernel_
// scratch keeps the rows in a global scratch buffer that the wrapper
// allocates (dgpmp2_btd_scratch_bytes says how large) and runs
// btd_sweep.cuh's block sweeps, for correctness only: every D runs on the
// card.
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

// -- D = 17-75: each step's blocks staged by cp.async, rows in registers ----

// Padded row stride of a staged (d, d) block: odd, so that lane r's row
// (r p + j) and its column (j p + r) are both read free of bank conflicts.
__host__ __device__ inline int pad_stride(int d) { return d | 1; }

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) / 16 * 16;
}

// The wide kernel's register width: the row [C_t | U_t | y_t] of D = 17-32
// held as two arrays of W (D padded to 20, 24, 28 or 32) and one value.
__host__ __device__ inline int wide_width(int d) {
  return d <= 20 ? 20 : d <= 24 ? 24 : d <= 28 ? 28 : 32;
}

// Byte offsets of the wide kernel's dynamic shared memory at (d, W): the
// staged diag_t (stride p; then X_{t-1}, stride W), rhs_t (then z_{t-1}),
// off_t and off_{t-1} (stride p), and two pivot rows [C | U | y] of 2W + 1.
// In the back sweep, X_t and z_t are staged in of[s] and pb[s].
struct WideLayout {
  size_t dg, rh, of0, of1, pb0, pb1, bytes;
};

__host__ __device__ inline WideLayout wide_layout(int d, int w, int sz) {
  const size_t p = pad_stride(d);
  WideLayout l;
  size_t at = 0;
  auto take = [&at](size_t n) {
    const size_t o = at;
    at += align16(n);
    return o;
  };
  l.dg = take(static_cast<size_t>(d) * (p > static_cast<size_t>(w) ? p : w) *
              sz);
  l.rh = take(static_cast<size_t>(d) * sz);
  l.of0 = take(static_cast<size_t>(d) * p * sz);
  l.of1 = take(static_cast<size_t>(d) * p * sz);
  l.pb0 = take(static_cast<size_t>(2 * w + 1) * sz);
  l.pb1 = take(static_cast<size_t>(2 * w + 1) * sz);
  l.bytes = at;
  return l;
}

// The block kernel's thread tile: kChunk consecutive elements of each of
// kTileRows rows of the step's float64 rows, held at positions q = h kChunk
// + m: C_t's columns at q < d, y_t at q = d, U_t's at d < q <= 2d, padding
// above.  A row is block_chunks(d) tiles, a block ceil(d / kTileRows)
// times that (threads rounded to warps, at most kBlockMaxThreads: D <= 75;
// that bound leaves a thread all 255 registers).  In shared memory a row's
// tiles lie kChunkStride apart (two doubles of padding), so that the
// 16-byte loads of a warp's tiles fall in different banks.
constexpr int kChunk = 16;
constexpr int kChunkStride = kChunk + 2;
constexpr int kTileRows = 3;
constexpr int kBlockMaxThreads = 256;

__host__ __device__ inline int block_chunks(int d) {
  return (2 * d + 1 + kChunk - 1) / kChunk;
}

// The shared-memory index of row position q.
__host__ __device__ inline int chunk_pos(int q) {
  return q / kChunk * kChunkStride + q % kChunk;
}

// Row stride of [X_{t-1} | z_{t-1}] in shared memory (positions 0..d),
// even (16-byte rows); kChunk elements of slack past the last row, which
// the tiles past z read and discard.
__host__ __device__ inline int xz_stride(int d) {
  return (chunk_pos(d) + 2) / 2 * 2;
}

// Byte offsets of the block kernel's dynamic shared memory at d: the
// staged diag_t (T, stride p; then [X_{t-1} | z_{t-1}] in double, stride
// xz_stride), rhs_t (T), off_t and off_{t-1} (T, stride p), two pivot rows
// (block_chunks tiles) and columns (d doubles), and the pivots'
// reciprocals.  In the back sweep X_t and z_t are staged in of[s] and
// col[s], x_{t+1} and x_t held in the two pivot rows.
struct BlockLayout {
  size_t dg, rh, of0, of1, row0, row1, col0, col1, dinv, bytes;
};

__host__ __device__ inline BlockLayout block_layout(int d, int sz) {
  const size_t p = pad_stride(d);
  const size_t xz = (static_cast<size_t>(d) * xz_stride(d) + kChunk) * 8;
  const size_t row = static_cast<size_t>(block_chunks(d)) * kChunkStride * 8;
  BlockLayout l;
  size_t at = 0;
  auto take = [&at](size_t n) {
    const size_t o = at;
    at += align16(n);
    return o;
  };
  l.dg = take(d * p * sz > xz ? d * p * sz : xz);
  l.rh = take(static_cast<size_t>(d) * sz);
  l.of0 = take(d * p * sz);
  l.of1 = take(d * p * sz);
  l.row0 = take(row);
  l.row1 = take(row);
  l.col0 = take(static_cast<size_t>(d) * 8);
  l.col1 = take(static_cast<size_t>(d) * 8);
  l.dinv = take(static_cast<size_t>(d) * 8);
  l.bytes = at;
  return l;
}

// Stage one (d, d) block, contiguous in device memory, into shared memory at
// row stride p: element e = i d + c to dst[i p + c], thread tid of n taking
// e = tid, tid + n, ..., one cp.async of one element each (neighbouring
// threads, neighbouring addresses: every request coalesced).
template <typename T>
__device__ __forceinline__ void stage_block(T* dst, const T* src, int d,
                                            int p, int tid, int n) {
  constexpr int SZ = static_cast<int>(sizeof(T));
  const int dd = d * d;
  const int di = n / d, dc = n - di * d;
  int i = tid / d, c = tid - i * d;
  for (int e = tid; e < dd; e += n) {
    cp_async<SZ>(dst + i * p + c, src + e);
    i += di;
    c += dc;
    if (c >= d) {
      c -= d;
      ++i;
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* src, int d,
                                          int tid, int n) {
  for (int e = tid; e < d; e += n)
    cp_async<static_cast<int>(sizeof(T))>(dst + e, src + e);
}

// Step t's diag_t, rhs_t and (but for the last step) off_t of one problem
// (dgb, rvb, ofb) into the slots dg, rh and of, as one cp.async group.
template <typename T>
__device__ __forceinline__ void stage_step(T* dg, T* rh, T* of, const T* dgb,
                                           const T* rvb, const T* ofb, int t,
                                           int steps, int d, int p, int tid,
                                           int n) {
  const size_t dd = static_cast<size_t>(d) * d;
  stage_block(dg, dgb + t * dd, d, p, tid, n);
  stage_vec(rh, rvb + static_cast<size_t>(t) * d, d, tid, n);
  if (t < steps - 1) stage_block(of, ofb + t * dd, d, p, tid, n);
  cp_commit();
}

// 16 bytes of shared memory as 16 / sizeof(T) values.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

template <typename T>
__device__ __forceinline__ void ld16(const T* src, T (&v)[kVec<T>]) {
  const typename Vec16<T>::type w =
      *reinterpret_cast<const typename Vec16<T>::type*>(src);
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int q = 0; q < kVec<T>; ++q) v[q] = e[q];
}

// dst[0, W) = v[0, W), 16 bytes at a time from k0 on (k0 a multiple of
// kVec).
template <typename T, int W>
__device__ __forceinline__ void st16(T* dst, const T (&v)[W], int k0) {
  using V = typename Vec16<T>::type;
#pragma unroll
  for (int k = 0; k < W; k += kVec<T>) {
    if (k < k0) continue;
    V w;
    T* e = reinterpret_cast<T*>(&w);
#pragma unroll
    for (int q = 0; q < kVec<T>; ++q) e[q] = v[k + q];
    *reinterpret_cast<V*>(dst + k) = w;
  }
}

// Lane j publishes its row [C | U | y] (C from column j on, the pivot
// included) as pivot row j, then divides its own row right of column j by
// the pivot: the value every other lane takes from pivot row j is the row
// before that division, as in Gauss-Jordan with the pivot row scaled after
// the other rows read it.
template <typename T, int W>
__device__ __forceinline__ void wide_publish(T* pb, T (&c)[W], T (&u)[W],
                                             T& y, int j) {
  st16<T, W>(pb, c, j / kVec<T> * kVec<T>);
  st16<T, W>(pb + W, u, 0);
  pb[2 * W] = y;
  const T inv = recip(c[j]);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (k > j) c[k] *= inv;
    u[k] *= inv;
  }
  y *= inv;
}

// D = 17-32: a warp solves one problem after another (a persistent grid);
// lane r holds row r of [C_t | U_t | y_t] in registers, D padded to W
// (lanes r >= d and columns k >= d carry zeros and store nothing).  See the
// header for the step.
template <typename T, int W>
__global__ void __launch_bounds__(kWarp)
    btd_solve_kernel_wide(const T* __restrict__ diag,
                          const T* __restrict__ off,
                          const T* __restrict__ rhs, T* __restrict__ x,
                          T* __restrict__ gain, double* __restrict__ scratch,
                          int batch, int steps, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = kVec<T>;
  const WideLayout l = wide_layout(d, W, sizeof(T));
  T* dg = reinterpret_cast<T*>(smem + l.dg);
  T* rh = reinterpret_cast<T*>(smem + l.rh);
  T* of0 = reinterpret_cast<T*>(smem + l.of0);
  T* of1 = reinterpret_cast<T*>(smem + l.of1);
  T* pb0 = reinterpret_cast<T*>(smem + l.pb0);
  T* pb1 = reinterpret_cast<T*>(smem + l.pb1);
  const int r = threadIdx.x;
  const bool own = r < d;
  const int p = pad_stride(d);
  const size_t dd = static_cast<size_t>(d) * d;
  for (size_t b = blockIdx.x; b < static_cast<size_t>(batch);
       b += gridDim.x) {
    const T* dgb = diag + b * steps * dd;
    const T* ofb = off + b * (steps - 1) * dd;
    const T* rvb = rhs + b * steps * d;
    T* xb = x + b * steps * d;
    T* gnb = gain + b * (steps - 1) * dd;

    auto stage = [&](int t) {
      stage_step(dg, rh, (t & 1) ? of1 : of0, dgb, rvb, ofb, t, steps, d, p,
                 r, kWarp);
    };
    stage(0);

    T c[W], u[W], y = T(0);  // row r: C_t, U_t then X_t, y_t then z_t
#pragma unroll
    for (int k = 0; k < W; ++k) c[k] = u[k] = T(0);

    for (int t = 0; t < steps; ++t) {
      const bool has_next = t < steps - 1;
      const T* ofc = (t & 1) ? of1 : of0;  // U_t
      const T* ofp = (t & 1) ? of0 : of1;  // U_{t-1}
      cp_wait<0>();
      __syncwarp();
      // Row r of C_t: the lower triangle of diag[t], mirrored (as the plain
      // version's Cholesky reads it): row r left of the diagonal, column r
      // below it.
#pragma unroll
      for (int j = 0; j < W; ++j)
        c[j] = own && j < d ? dg[j <= r ? r * p + j : j * p + r] : T(0);
      const T yn = own ? rh[r] : T(0);
      __syncwarp();
      // X_{t-1} and z_{t-1} into the slots just read, for the Schur update
      // and the coalesced store of X_{t-1}; then U_t and y_t into the row.
      if (t > 0 && own) {
        st16<T, W>(dg + r * W, u, 0);
        rh[r] = y;
      }
#pragma unroll
      for (int k = 0; k < W; ++k)
        u[k] = own && has_next && k < d ? ofc[r * p + k] : T(0);
      y = yn;
      __syncwarp();
      if (t > 0) {
        T* g = gnb + (t - 1) * dd;
        const int di = kWarp / d, dc = kWarp - di * d;
        int i = r / d, cc = r - i * d;
        for (size_t e = r; e < dd; e += kWarp) {
          g[e] = dg[i * W + cc];
          i += di;
          cc += dc;
          if (cc >= d) {
            cc -= d;
            ++i;
          }
        }
        // C_t -= U_{t-1}^T X_{t-1}, y_t -= U_{t-1}^T z_{t-1}, one row of
        // X_{t-1} at a time (each element's sum in the order of k).
        if (own) {
          for (int k = 0; k < d; ++k) {
            const T uk = ofp[k * p + r];
            y = y - uk * rh[k];
            const T* xk = dg + k * W;
#pragma unroll
            for (int m0 = 0; m0 < W; m0 += V) {
              T v[V];
              ld16(xk + m0, v);
#pragma unroll
              for (int q = 0; q < V; ++q) c[m0 + q] = c[m0 + q] - uk * v[q];
            }
          }
        }
      }
      if (r == 0) wide_publish<T, W>(pb0, c, u, y, 0);
      __syncwarp();
      // The slots of diag_t, rhs_t and U_{t-1} are free: stage step t + 1
      // while this one pivots.
      if (has_next) stage(t + 1);
      // Gauss-Jordan: C_t becomes I, [U_t | y_t] becomes [X_t | z_t].
      // Pivot row j comes from pivot buffer j & 1, one warp barrier a
      // pivot.
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (j >= d) continue;
        const T* pv = (j & 1) ? pb1 : pb0;
        if (own && r != j) {
          const T inv = recip(pv[j]);
          const T f = c[j] * inv;
#pragma unroll
          for (int m0 = (j + 1) / V * V; m0 < W; m0 += V) {
            T v[V];
            ld16(pv + m0, v);
#pragma unroll
            for (int q = 0; q < V; ++q)
              if (m0 + q > j) c[m0 + q] = c[m0 + q] - f * v[q];
          }
#pragma unroll
          for (int m0 = 0; m0 < W; m0 += V) {
            T v[V];
            ld16(pv + W + m0, v);
#pragma unroll
            for (int q = 0; q < V; ++q) u[m0 + q] = u[m0 + q] - f * v[q];
          }
          y = y - f * pv[2 * W];
        }
        if (r == j + 1 && j + 1 < d)
          wide_publish<T, W>((j & 1) ? pb0 : pb1, c, u, y, j + 1);
        __syncwarp();
      }
      if (own) xb[static_cast<size_t>(t) * d + r] = y;
    }

    // Back sweep from x_{T-1} = z_{T-1}: x_t = z_t - X_t x_{t+1}, X_t and z_t
    // staged one back step ahead into of[s] and pb[s]; x_{t+1} broadcast by
    // shuffle.  The fence orders this warp's stores of X and z before the
    // copies that read them back.
    const int nb = steps - 1;
    __threadfence_block();
    __syncwarp();
    auto stage_back = [&](int i) {  // i-th back step: t = nb - 1 - i
      if (i < nb) {
        const int t = nb - 1 - i;
        stage_block((i & 1) ? of1 : of0, gnb + t * dd, d, p, r, kWarp);
        stage_vec((i & 1) ? pb1 : pb0, xb + static_cast<size_t>(t) * d, d, r,
                  kWarp);
      }
      cp_commit();
    };
    stage_back(0);
    T xn = y;
    for (int i = 0; i < nb; ++i) {
      cp_wait<0>();
      __syncwarp();
      stage_back(i + 1);
      const T* g = (i & 1) ? of1 : of0;
      const T* z = (i & 1) ? pb1 : pb0;
      T acc = own ? z[r] : T(0);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const T xk = __shfl_sync(0xffffffffu, xn, k);
        if (own && k < d) acc = acc - g[r * p + k] * xk;
      }
      xn = acc;
      if (own) xb[static_cast<size_t>(nb - 1 - i) * d + r] = xn;
    }
    __syncwarp();
  }
}

// D = 33 up to the shared-memory limit: a block solves one problem after
// another (a persistent grid).  Thread (g, h) holds tile h of rows
// kTileRows g + i of the step's float64 rows (block_layout's positions) in
// registers.  Each pivot updates every element of a tile, dead columns
// left of the pivot included (never read again), so no element waits on a
// predicate; the pivot loop is unrolled by kChunk, so the tile element of
// pivot column j is known when it is compiled.  The rows are float64 in
// both instances: in float32, rows stored back in float32 after each of D
// pivots drift by ~D ulp (1.1e-6 relative at D = 48 on an H100, 3x the
// plain version's error), so the float32 instance reads float32, works in
// float64 and writes float32.
template <typename T>
__global__ void __launch_bounds__(kBlockMaxThreads)
    btd_solve_kernel_block(const T* __restrict__ diag,
                           const T* __restrict__ off,
                           const T* __restrict__ rhs, T* __restrict__ x,
                           T* __restrict__ gain, double* __restrict__ scratch,
                           int batch, int steps, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = kChunk, RS = kChunkStride, RY = kTileRows;
  const BlockLayout l = block_layout(d, sizeof(T));
  T* dg = reinterpret_cast<T*>(smem + l.dg);           // diag_t
  double* xz = reinterpret_cast<double*>(smem + l.dg);  // then X | z
  T* rh = reinterpret_cast<T*>(smem + l.rh);
  T* of0 = reinterpret_cast<T*>(smem + l.of0);
  T* of1 = reinterpret_cast<T*>(smem + l.of1);
  double* row0 = reinterpret_cast<double*>(smem + l.row0);
  double* row1 = reinterpret_cast<double*>(smem + l.row1);
  double* col0 = reinterpret_cast<double*>(smem + l.col0);
  double* col1 = reinterpret_cast<double*>(smem + l.col1);
  double* dinv = reinterpret_cast<double*>(smem + l.dinv);
  const int nh = block_chunks(d);
  const int sx = xz_stride(d);
  const int zx = chunk_pos(d);  // z's column in [X | z]
  const int tid = threadIdx.x, n = blockDim.x;
  const int g = tid / nh, h = tid - g * nh;
  const int q0 = h * R;    // the tile's first position
  const int s0 = h * RS;   // and its place in a shared row
  const int p = pad_stride(d);
  const size_t dd = static_cast<size_t>(d) * d;
  for (size_t b = blockIdx.x; b < static_cast<size_t>(batch);
       b += gridDim.x) {
    const T* dgb = diag + b * steps * dd;
    const T* ofb = off + b * (steps - 1) * dd;
    const T* rvb = rhs + b * steps * d;
    T* xb = x + b * steps * d;
    T* gnb = gain + b * (steps - 1) * dd;

    auto stage = [&](int t) {
      stage_step(dg, rh, (t & 1) ? of1 : of0, dgb, rvb, ofb, t, steps, d, p,
                 tid, n);
    };
    // Pivot row j's tile, column j and 1 / its pivot, from the thread that
    // holds element m of each row's tile hj (j = hj kChunk + m).
    auto publish = [&](double (&a)[RY][R], double* rowb, double* colb, int j,
                       int hj, int m) {
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int r = RY * g + i;
        if (r >= d) continue;
        if (r == j) st16<double, R>(rowb + s0, a[i], 0);
        if (h == hj) {
          colb[r] = a[i][m];
          if (r == j) dinv[j] = recip(a[i][m]);
        }
      }
    };
    stage(0);

    double a[RY][R];
#pragma unroll
    for (int i = 0; i < RY; ++i)
#pragma unroll
      for (int m = 0; m < R; ++m) a[i][m] = 0.0;

    for (int t = 0; t < steps; ++t) {
      const bool has_next = t < steps - 1;
      const T* ofc = (t & 1) ? of1 : of0;  // U_t
      const T* ofp = (t & 1) ? of0 : of1;  // U_{t-1}
      cp_wait<0>();
      __syncthreads();
      // C_t: the lower triangle of diag[t], mirrored (as the plain
      // version's Cholesky reads it), and y_t; the other positions still
      // hold X_{t-1} and z_{t-1}.
      double yn[RY];
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int r = RY * g + i;
        yn[i] = 0.0;
        if (r >= d) continue;
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const int q = q0 + m;
          if (q < d) a[i][m] = double(q <= r ? dg[r * p + q] : dg[q * p + r]);
          if (q == d) yn[i] = double(rh[r]);
        }
      }
      __syncthreads();
      // [X_{t-1} | z_{t-1}] into the slot just read, for the Schur update.
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int r = RY * g + i;
        if (r >= d) continue;
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const int q = q0 + m;
          if (t > 0 && q > d && q <= 2 * d)
            xz[r * sx + chunk_pos(q - d - 1)] = a[i][m];
          if (q == d) {
            if (t > 0) xz[r * sx + zx] = a[i][m];
            a[i][m] = yn[i];
          }
        }
      }
      __syncthreads();
      if (t > 0 && q0 <= d) {
        // C_t -= U_{t-1}^T X_{t-1}, y_t -= U_{t-1}^T z_{t-1}: each
        // element's sum in the order of k.  Positions past z take the
        // rows' next elements and are overwritten by U_t below.
#pragma unroll 1
        for (int k = 0; k < d; ++k) {
          double uk[RY];
#pragma unroll
          for (int i = 0; i < RY; ++i) {
            const int r = RY * g + i;
            uk[i] = r < d ? double(ofp[k * p + r]) : 0.0;
          }
          const double* xk = xz + k * sx + s0;
#pragma unroll
          for (int m = 0; m < R; m += 2) {
            double v[2];
            ld16(xk + m, v);
#pragma unroll
            for (int i = 0; i < RY; ++i) {
              a[i][m] = a[i][m] - uk[i] * v[0];
              a[i][m + 1] = a[i][m + 1] - uk[i] * v[1];
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int r = RY * g + i;
        if (r >= d) continue;
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const int q = q0 + m;
          if (q > d && q <= 2 * d)
            a[i][m] = has_next ? double(ofc[r * p + q - d - 1]) : 0.0;
        }
      }
      publish(a, row0, col0, 0, 0, 0);
      __syncthreads();
      // The slots of diag_t, rhs_t and U_{t-1} are free: stage step t + 1
      // while this one pivots.
      if (has_next) stage(t + 1);
      // Gauss-Jordan without scaling: pivot j takes cur[r][j] / cur[j][j]
      // times row j from every other row; row j and column j come from
      // buffer j & 1, one barrier a pivot.
      for (int j0 = 0, hb = 0; j0 < d; j0 += R, ++hb) {
#pragma unroll
        for (int jj = 0; jj < R; ++jj) {
          const int j = j0 + jj;
          if (j < d) {
            const double* rw = (jj & 1) ? row1 : row0;
            const double* cl = (jj & 1) ? col1 : col0;
            const double inv = dinv[j];
            double f[RY];
#pragma unroll
            for (int i = 0; i < RY; ++i) {
              const int r = RY * g + i;
              // Row j and rows past d take nothing.
              f[i] = r < d && r != j ? cl[r] * inv : 0.0;
            }
            if (RY * g < d) {
#pragma unroll
              for (int m = 0; m < R; m += 2) {
                double v[2];
                ld16(rw + s0 + m, v);
#pragma unroll
                for (int i = 0; i < RY; ++i) {
                  const int r = RY * g + i;
                  if (r != j) {
                    a[i][m] = a[i][m] - f[i] * v[0];
                    a[i][m + 1] = a[i][m + 1] - f[i] * v[1];
                  }
                }
              }
            }
            if (j + 1 < d)
              publish(a, (jj & 1) ? row0 : row1, (jj & 1) ? col0 : col1,
                      j + 1, jj + 1 < R ? hb : hb + 1, (jj + 1) % R);
            __syncthreads();
          }
        }
      }
      // Each row divided by its pivot: [X_t | z_t], stored to x and gain.
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        const int r = RY * g + i;
        if (r >= d) continue;
        const double inv = dinv[r];
#pragma unroll
        for (int m = 0; m < R; ++m) {
          const int q = q0 + m;
          if (q < d || q > 2 * d) continue;
          a[i][m] *= inv;
          if (q == d)
            xb[static_cast<size_t>(t) * d + r] = static_cast<T>(a[i][m]);
          else if (has_next)
            gnb[t * dd + static_cast<size_t>(r) * d + q - d - 1] =
                static_cast<T>(a[i][m]);
        }
      }
    }

    // Back sweep from x_{T-1} = z_{T-1} (in double, as the last step left
    // it): x_t = z_t - X_t x_{t+1}, X_t and z_t staged one back step ahead
    // into of[s] and col[s], a row a thread, x_{t+1} and x_t in the pivot
    // rows.  The barrier orders the stores of X and z before the copies
    // that read them back.
    double* xa = row0;
    double* xn = row1;
#pragma unroll
    for (int i = 0; i < RY; ++i)
#pragma unroll
      for (int m = 0; m < R; ++m)
        if (RY * g + i < d && q0 + m == d) xa[RY * g + i] = a[i][m];
    const int nb = steps - 1;
    __threadfence_block();
    __syncthreads();
    auto stage_back = [&](int i) {  // i-th back step: t = nb - 1 - i
      if (i < nb) {
        const int t = nb - 1 - i;
        stage_block((i & 1) ? of1 : of0, gnb + t * dd, d, p, tid, n);
        stage_vec(reinterpret_cast<T*>((i & 1) ? col1 : col0),
                  xb + static_cast<size_t>(t) * d, d, tid, n);
      }
      cp_commit();
    };
    stage_back(0);
    for (int i = 0; i < nb; ++i) {
      cp_wait<0>();
      __syncthreads();
      stage_back(i + 1);
      const T* gk = (i & 1) ? of1 : of0;
      const T* z = reinterpret_cast<const T*>((i & 1) ? col1 : col0);
      const size_t t = nb - 1 - i;
      for (int rr = tid; rr < d; rr += n) {
        double acc = z[rr];
        for (int k = 0; k < d; ++k) acc -= double(gk[rr * p + k]) * xa[k];
        xn[rr] = acc;
        xb[t * d + rr] = static_cast<T>(acc);
      }
      __syncthreads();
      double* tmp = xa;
      xa = xn;
      xn = tmp;
    }
    __syncthreads();
  }
}

// Past the shared memory (D >= 76 on an H100): one block of kBlockX x
// kBlockY threads per problem, the step's rows [C_t | U_t | y_t], the last
// step's [. | X_{t-1} | z_{t-1}] and U_{t-1} (block_elems(d) doubles) in a
// global scratch buffer per problem, run by the sweeps of btd_sweep.cuh.
// For correctness only: every D runs on the card.
template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    btd_solve_kernel_scratch(const T* __restrict__ diag,
                             const T* __restrict__ off,
                             const T* __restrict__ rhs, T* __restrict__ x,
                             T* __restrict__ gain,
                             double* __restrict__ scratch, int batch,
                             int steps, int d) {
  const size_t b = blockIdx.x;
  double* base = scratch + b * block_elems(d);
  const int w = 2 * d + 1;
  const int cz = 2 * d;  // the column of y_t, then z_t
  const size_t step_elems = static_cast<size_t>(d) * w;
  double* up = base + 2 * step_elems;  // U_{t-1}, stride d + 1
  const Team tm = whole_block();
  const int tx = tm.tx, ty = tm.ty;
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
    block_schur(cur, prev, up, t, d, tm);
    block_pivots(cur, up, d, tm);
    for (int r = ty; r < d; r += kBlockY) {
      if (has_next)
        for (int c = tx; c < d; c += kBlockX)
          gn[tdd + r * d + c] = static_cast<T>(cur[r * w + d + c]);
      if (tx == 0)
        xb[static_cast<size_t>(t) * d + r] = static_cast<T>(cur[r * w + cz]);
    }
  }
  block_back_sweep<T, T>(base + ((steps - 1) & 1) * step_elems, up, gn, xb,
                         xb, steps, d, tm);
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

// The lane-group instance of d (D <= kNarrowMax), for its attributes.
template <typename T, int D = 1>
const void* narrow_kernel(int d) {
  if (d == D) return reinterpret_cast<const void*>(btd_solve_kernel<T, D>);
  if constexpr (D < kNarrowMax) return narrow_kernel<T, D + 1>(d);
  return nullptr;
}

// The launch plan of d at batch (ops/cuda/btd_solve.py `plan` is its plain
// Python twin, held equal to it on the card): the regime (0: lane group,
// 1: wide, 2: block, 3: global scratch), its instance (D, W, RX or 0),
// threads and dynamic shared bytes a block, blocks, and the kernel.  The
// wide and block grids are persistent: as many blocks as the card keeps
// resident, up to one a problem, each taking a problem after another, so
// none waits for another to finish.
struct Plan {
  int kind, instance, threads;
  size_t smem;
  int grid, resident, sms;
  const void* kernel;
};

template <typename T>
const void* wide_kernel(int w) {
  switch (w) {
    case 20:
      return reinterpret_cast<const void*>(btd_solve_kernel_wide<T, 20>);
    case 24:
      return reinterpret_cast<const void*>(btd_solve_kernel_wide<T, 24>);
    case 28:
      return reinterpret_cast<const void*>(btd_solve_kernel_wide<T, 28>);
    default:
      return reinterpret_cast<const void*>(btd_solve_kernel_wide<T, 32>);
  }
}

// Opt the plan's kernel in to its shared memory, with the carveout at
// shared memory first (the wide plan keeps 8 blocks of up to 27 KB an SM).
inline int prepare(const Plan& pl) {
  if (pl.kind == 0 || pl.kind == 3) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(pl.smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(pl.kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(e);
}

// Blocks an SM of the plan's kernel, and the SMs, once per device and D.
template <typename T>
int occupancy(int d, Plan* pl) {
  constexpr int kDevices = 16, kD = 128;
  static int cache[kDevices][kD][2];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int* c = dev < kDevices && d < kD ? cache[dev][d] : nullptr;
  if (c == nullptr || c[0] == 0) {
    int rc = prepare(*pl);
    if (rc != 0) return rc;
    int res = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&res, pl->kernel,
                                                      pl->threads, pl->smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (res < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (c == nullptr) {
      pl->resident = res;
      pl->sms = sms;
      return 0;
    }
    c[1] = sms;
    c[0] = res;
  }
  pl->resident = c[0];
  pl->sms = c[1];
  return 0;
}

template <typename T>
int make_plan(int d, int batch, Plan* pl) {
  constexpr int sz = static_cast<int>(sizeof(T));
  if (d <= kNarrowMax) {
    const int per_warp = kWarp / (d <= 2 ? 2 : d <= 4 ? 4 : d <= 8 ? 8 : 16);
    *pl = Plan{0, d, kWarp, 0, (batch + per_warp - 1) / per_warp, 0, 0,
               narrow_kernel<T>(d)};
    return 0;
  }
  int optin = 0;
  int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  if (d <= kMaxD) {
    const int w = wide_width(d);
    *pl = Plan{1, w, kWarp, wide_layout(d, w, sz).bytes, batch, 0, 0,
               wide_kernel<T>(w)};
  } else if (block_elems(d) * sizeof(double) > static_cast<size_t>(optin)) {
    *pl = Plan{3, 0, kBlockX * kBlockY, 0, batch, 0, 0,
               reinterpret_cast<const void*>(btd_solve_kernel_scratch<T>)};
    return 0;
  } else {
    const int rows = (d + kTileRows - 1) / kTileRows;
    const int threads =
        (rows * block_chunks(d) + kWarp - 1) / kWarp * kWarp;
    const size_t smem = block_layout(d, sz).bytes;
    if (threads > kBlockMaxThreads || smem > static_cast<size_t>(optin))
      return static_cast<int>(cudaErrorInvalidConfiguration);
    *pl = Plan{2, kChunk, threads, smem, batch, 0, 0,
               reinterpret_cast<const void*>(btd_solve_kernel_block<T>)};
  }
  rc = occupancy<T>(d, pl);
  if (rc != 0) return rc;
  const long long most = static_cast<long long>(pl->resident) * pl->sms;
  if (most < batch) pl->grid = static_cast<int>(most);
  return 0;
}

template <typename T>
int launch(const T* diag, const T* off, const T* rhs, T* x, T* gain,
           double* scratch, int batch, int steps, int d, void* stream) {
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch <= 0 || steps <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= kNarrowMax) {
    launch_narrow<T>(diag, off, rhs, x, gain, batch, steps, d, s);
    return static_cast<int>(cudaGetLastError());
  }
  Plan pl;
  int rc = make_plan<T>(d, batch, &pl);
  if (rc == 0) rc = prepare(pl);
  if (rc != 0) return rc;
  if (pl.kind == 3 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // The scratch kernel's team is kBlockX x kBlockY (whole_block).
  const dim3 block = pl.kind == 3 ? dim3(kBlockX, kBlockY) : dim3(pl.threads);
  void* args[] = {&diag, &off, &rhs, &x, &gain, &scratch, &batch, &steps, &d};
  rc = static_cast<int>(
      cudaLaunchKernel(pl.kernel, dim3(pl.grid), block, args, pl.smem, s));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The plan of d at batch into out[0..9]: regime, instance, threads,
// dynamic shared bytes, registers and local bytes a thread, blocks an SM
// resident, blocks, SMs, and static shared bytes.
template <typename T>
int plan_query(int d, int batch, int* out) {
  if (d < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  int rc = make_plan<T>(d, batch, &pl);
  if (rc == 0) rc = prepare(pl);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, pl.kernel);
  int resident = pl.resident, sms = pl.sms, dev = 0;
  if (e == cudaSuccess && pl.resident == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, pl.kernel, pl.threads, pl.smem);
  if (e == cudaSuccess && sms == 0) e = cudaGetDevice(&dev);
  if (e == cudaSuccess && sms == 0)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int v[10] = {pl.kind,
                     pl.instance,
                     pl.threads,
                     static_cast<int>(pl.smem),
                     attr.numRegs,
                     static_cast<int>(attr.localSizeBytes),
                     resident,
                     pl.grid,
                     sms,
                     static_cast<int>(attr.sharedSizeBytes)};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

}  // namespace
