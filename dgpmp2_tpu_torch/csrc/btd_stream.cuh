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
// Design (btd_sweep.cuh holds the sweeps):
// - D <= 16: producer warps and one consumer warp a block, 32 / G problems
//   (K-BTD's lane groups of G lanes, lane r owning row r).  The assembly of
//   step t depends on no earlier step; only the Schur update and the pivots
//   form a chain.  So the producer warps form steps ahead of the sweep: lane
//   r of a producer forms row r of diag_t (the lower triangle), its row and
//   column of off_t and rhs_t[r] in float64 from the residual pieces (typed
//   read-only loads, no store to global memory, so a step's loads issue
//   together), rounds each element once to TA and writes them into a ring
//   of stages in dynamic shared memory in K-BTD's slot layout.  Each stage
//   has a full and an empty mbarrier.  The consumer warp runs K-BTD's forward
//   sweep from the ring (narrow_schur, narrow_pivot), stores X_t and z_t,
//   and runs K-BTD's back sweep through the same shared memory.  The
//   consumer holds K-BTD's state alone; the float64 accumulators are the
//   producers'.  The producer count is chosen at launch (narrow_plan) so
//   that every block of the grid is resident at once where it can be
//   (B = 1024: 1, 1, 2 and 4 blocks an SM at D = 1-2, 3-4, 5-8, 9-16).
//   Each element is summed in one fixed order (narrow_form), so x does not
//   depend on which warp formed a step.
// - D = 17-32: K-BTD's warp per problem with the rows in shared memory
//   (float64: 42.2 KB); lane r forms its row, each family row H[k] and
//   (ΛH)[k] formed once by the warp into shared memory; a family's sum is
//   kept apart (in the row's U columns) and added to the row once, as the
//   standard assembly adds each family's sum.  Its loads are synchronous.
// - D > 32: K-BTD's block per problem with double rows, the block sharing
//   each family row's D² products.
// The gain and z are stored in TA, so the df32 instance keeps float64 from
// the first product to the last back-sweep step; x is written in TR.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

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

// The most producer warps a lane-group block takes (0: the kernel's
// kMaxProducers); set by dgpmp2_btd_stream_set_producers, defined in
// btd_stream.cu.
extern int producer_cap;

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

// Producer warps of a lane-group block: at most kMaxProducers (a block of 8
// warps; on an H100 at the 2-D bench 7 beat 3 and 1 in float32 and tied
// 3 in float64),
// fewer where the registers or the ring would keep a block of the launch
// from being resident (narrow_plan).
constexpr int kMaxProducers = 7;
constexpr int kMaxDevices = 16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive with release semantics: this thread's shared-memory writes (and
// reads) are ordered before the phase completes.
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait, with acquire semantics, until the phase of parity `parity` has
// completed (a fresh barrier counts the phase before its first as done).
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A read-only load through the non-coherent path: the producers store
// nothing to global memory, so the compiler may issue a step's loads
// together, ahead of its arithmetic.
template <typename T>
__device__ __forceinline__ T ld(const View& v, long long i0, long long i1,
                                long long i2 = 0, long long i3 = 0) {
  return __ldg(static_cast<const T*>(v.p) + (i0 * v.s[0] + i1 * v.s[1] +
                                             i2 * v.s[2] + i3 * v.s[3]));
}

// gp_rhs at a compile-time D, through ld, four columns' loads at a time
// (fully unrolled at D = 16, the loads hoisted ahead of the sums spilled).
template <typename TA, typename TR, int D>
__device__ __forceinline__ double narrow_gp_rhs(const StreamArgs& a, int b,
                                                int t, int i) {
  double y = 0.0;
  if (t < a.steps - 1) {
    double s = 0.0;
#pragma unroll 4
    for (int j = 0; j < D; ++j)
      s += double(ld<TA>(a.phit_q, b, t, i, j)) *
           double(ld<TR>(a.r_gp, b, t, j));
    y = s;
  }
  if (t >= 1) {
    double s = 0.0;
#pragma unroll 4
    for (int j = 0; j < D; ++j)
      s += double(ld<TA>(a.q_inv, b, t - 1, i, j)) *
           double(ld<TR>(a.r_gp, b, t - 1, j));
    y -= s;
  }
  if (t == 0) {
    double s = 0.0;
#pragma unroll 4
    for (int j = 0; j < D; ++j)
      s += double(ld<TA>(a.ks, b, i, j)) * double(ld<TR>(a.r_s, b, j));
    y += s;
  }
  if (t == a.steps - 1) {
    double s = 0.0;
#pragma unroll 4
    for (int j = 0; j < D; ++j)
      s += double(ld<TA>(a.kg, b, i, j)) * double(ld<TR>(a.r_g, b, j));
    y += s;
  }
  return y;
}

// A producer lane's part of step t, in float64: row r of the lower
// triangle of diag_t (cd: element (max(r, j), min(r, j))) with the
// families, the addends and the LM damping; returns rhs_t[r].  Lane r forms
// (ΛH)[k][r] once and takes (ΛH)[k][j] and H[k][j] from lane j of its group:
// each (ΛH)[k][.] is formed once per problem, step and k.  Every sum runs
// in one order: the families in order, k in order (each product rounded,
// then added), a family's sum added to the row once, the addends, then δ.
template <typename TA, typename TR, int D, int G>
__device__ __forceinline__ double narrow_form(const StreamArgs& a, int b,
                                              int t, int r, double (&cd)[D]) {
  double y = narrow_gp_rhs<TA, TR, D>(a, b, t, r);
#pragma unroll
  for (int j = 0; j < D; ++j)
    cd[j] = ld<TA>(a.diag, b, t, j <= r ? r : j, j <= r ? j : r);
  for (int n = 0; n < a.nfam; ++n) {
    const Family& f = a.fam[n];
    double acc[D];
#pragma unroll
    for (int j = 0; j < D; ++j) acc[j] = 0.0;
    double ry = 0.0;
#pragma unroll 1
    for (int k = 0; k < f.k; ++k) {
      const double hr = ld<TR>(f.h, b, t, k, r);
      double lr;  // (ΛH)[k][r]
      if (f.diagonal) {
        lr = double(ld<TA>(f.w, b, t, k)) * double(ld<TR>(f.h, b, t, k, r));
      } else {
        lr = 0.0;
#pragma unroll 1
        for (int l = 0; l < f.k; ++l)
          lr += double(ld<TA>(f.w, b, t, k, l)) *
                double(ld<TR>(f.h, b, t, l, r));
      }
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const double lj = __shfl_sync(0xffffffffu, lr, j, G);
        const double hj = __shfl_sync(0xffffffffu, hr, j, G);
        // The product rounded, then added: no fused multiply-add.
        acc[j] = __dadd_rn(acc[j], __dmul_rn(j <= r ? hr : hj,
                                             j <= r ? lj : lr));
      }
      ry += lr * double(ld<TR>(f.r, b, t, k));
    }
#pragma unroll
    for (int j = 0; j < D; ++j) cd[j] += acc[j];
    y += ry;
  }
  if (a.diag_add.p) {
#pragma unroll
    for (int j = 0; j < D; ++j)
      cd[j] += ld<TA>(a.diag_add, b, t, j <= r ? r : j, j <= r ? j : r);
  }
  if (a.rhs_add.p) y += ld<TA>(a.rhs_add, b, t, r);
  if (a.delta.p) {
    const double dl = ld<TA>(a.delta, b, 0);
#pragma unroll
    for (int j = 0; j < D; ++j)
      if (j == r) cd[j] = cd[j] + dl * cd[j];
  }
  return y;
}

// Bytes of a lane-group block's dynamic shared memory: each stage's full
// and empty mbarrier, then the ring of `stages` steps in K-BTD's slot layout
// (ring_slot: a row of diag, a row of off, a column of off, a column of diag
// and an element of rhs, each padded to 16 bytes, for each of the 32 lanes).
__host__ __device__ constexpr int narrow_bar_bytes(int stages) {
  return (2 * stages * 8 + 15) / 16 * 16;
}

template <typename TA, int D>
__host__ __device__ constexpr size_t narrow_smem(int stages) {
  return narrow_bar_bytes(stages) + static_cast<size_t>(stages) * kWarp *
                                        ring_slot<TA, D>() * sizeof(TA);
}

// Ring stages at np producer warps: two steps for each producer, and at
// least K-BTD's back-sweep ring (ring_stages), which the consumer reuses.
template <typename TA, int D>
__host__ __device__ constexpr int narrow_stages(int np) {
  return 2 * np > ring_stages<TA, D>() ? 2 * np : ring_stages<TA, D>();
}

// Warp 0 is the consumer, warps 1..np the producers; lane `lane` of every
// warp stands for row r = lane % G of problem blockIdx.x * 32 / G + lane / G.
// Producer warp w forms steps w - 1, w - 1 + np, ... into the ring's stage
// t % stages once the consumer has released it (empty), and marks it full;
// the consumer runs K-BTD's forward sweep from the ring, in order, releasing
// each stage after its pivots, then K-BTD's back sweep.
template <typename TA, typename TR, int D>
__global__ void __launch_bounds__(kWarp * (1 + kMaxProducers), 1)
    btd_stream_kernel(__grid_constant__ const StreamArgs a, int stages) {
  constexpr int G = group_lanes<D>();
  constexpr int DD = D * D;
  constexpr int P = 16 / static_cast<int>(sizeof(TA));
  constexpr int DP = (D + P - 1) / P * P;
  constexpr int SLOT = ring_slot<TA, D>();
  constexpr int SB = ring_stages<TA, D>();
  static_assert(SLOT == 4 * DP + P && SB >= 2, "ring layout");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + stages;
  TA(*ring)[kWarp][SLOT] = reinterpret_cast<TA(*)[kWarp][SLOT]>(
      smem + narrow_bar_bytes(stages));

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int r = lane % G;
  const int b = blockIdx.x * (kWarp / G) + lane / G;
  const bool valid = b < a.batch && r < D;
  const int bb = valid ? b : 0;
  const int rr = valid ? r : 0;
  const int steps = a.steps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, kWarp);
      mbar_init(empty + s, kWarp);
    }
  }
  __syncthreads();

  if (warp > 0) {
    // Lanes past the batch, and past D, form a row of problem 0 that no
    // one reads: every lane of the warp takes part in the shuffles.
    const int np = static_cast<int>(blockDim.x) / kWarp - 1;
    for (int t = warp - 1; t < steps; t += np) {
      double cd[D];
      const double y = narrow_form<TA, TR, D, G>(a, bb, t, rr, cd);
      const int st = t % stages;
      mbar_wait(empty + st, ((t / stages) & 1) ^ 1);
      TA* s = ring[st][lane];
#pragma unroll
      for (int j = 0; j < D; ++j) s[j] = s[3 * DP + j] = TA(cd[j]);
      s[4 * DP] = TA(y);
      const bool has_next = t < steps - 1;
#pragma unroll 4  // as narrow_gp_rhs
      for (int j = 0; j < D; ++j) {
        double o = 0.0, u = 0.0;
        if (has_next) {
          o = ld<TA>(a.off, bb, t, rr, j);
          u = ld<TA>(a.off, bb, t, j, rr);
          if (a.off_add.p) {
            o += ld<TA>(a.off_add, bb, t, rr, j);
            u += ld<TA>(a.off_add, bb, t, j, rr);
          }
        }
        s[DP + j] = TA(o);
        s[2 * DP + j] = TA(u);
      }
      mbar_arrive(full + st);
    }
    return;
  }

  const size_t bz = static_cast<size_t>(bb);
  TA* zb = static_cast<TA*>(a.z) + bz * steps * D + rr;
  TR* xb = static_cast<TR*>(a.x) + bz * steps * D + rr;
  TA* gn = static_cast<TA*>(a.gain) + bz * (steps - 1) * DD + rr * D;
  TA xp[D];   // row r of X_{t-1}
  TA ucp[D];  // column r of U_{t-1}
  TA zp = TA(0);
#pragma unroll
  for (int j = 0; j < D; ++j) xp[j] = ucp[j] = TA(0);

  for (int t = 0; t < steps; ++t) {
    const int st = t % stages;
    mbar_wait(full + st, (t / stages) & 1);
    const TA* s = ring[st][lane];
    const bool has_next = t < steps - 1;
    TA c[D], bm[D + 1];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      // The lower triangle of diag_t: row r left of the diagonal, column r
      // below it.
      c[j] = valid ? s[j <= r ? j : 3 * DP + j] : TA(j == r);
      bm[j] = valid && has_next ? s[DP + j] : TA(0);
    }
    bm[D] = valid ? s[4 * DP] : TA(0);
    if (t > 0) narrow_schur<TA, D, G>(c, bm, xp, ucp, zp);
    narrow_pivot<TA, D, G>(c, bm, r);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      xp[j] = bm[j];
      ucp[j] = valid && has_next ? s[2 * DP + j] : TA(0);
    }
    mbar_arrive(empty + st);
    zp = bm[D];
    if (valid) {
      zb[static_cast<size_t>(t) * D] = zp;
      if (has_next) store_row<TA, D>(gn + static_cast<size_t>(t) * DD, xp);
    }
  }
  if (valid) xb[static_cast<size_t>(steps - 1) * D] = static_cast<TR>(zp);
  // Every producer has written its last stage before the consumer took it,
  // so the ring is the consumer's now.  The back sweep's copies read back
  // what this lane stored: order those stores first.
  __threadfence_block();
  narrow_back_sweep<TA, TR, D, G, SB, SLOT>(ring, lane, valid, gn, zb, xb,
                                            steps, zp);
}

// Blocks an SM holds at each producer count, per device, asked once:
// dynamic shared memory is opted in to the device's limit and the carveout
// set to shared memory first, so that the occupancy is the ring's and the
// registers' alone.
struct NarrowTable {
  int made, rc, sms;
  int occ[kMaxProducers + 1];
};

template <typename TA, typename TR, int D>
int narrow_table(NarrowTable* out) {
  static std::mutex mu;
  static NarrowTable tabs[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  NarrowTable& n = tabs[dev];
  if (!n.made) {
    const auto kernel = btd_stream_kernel<TA, TR, D>;
    int optin = 0;
    e = cudaDeviceGetAttribute(&n.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    for (int np = 1; e == cudaSuccess && np <= kMaxProducers; ++np) {
      const size_t smem = narrow_smem<TA, D>(narrow_stages<TA, D>(np));
      n.occ[np] = 0;
      if (smem <= static_cast<size_t>(optin))
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n.occ[np], kernel, kWarp * (1 + np), smem);
    }
    n.rc = static_cast<int>(e);
    n.made = 1;
  }
  *out = n;
  return n.rc;
}

// The launch of `batch` problems: 32 / G problems a block; the most
// producer warps up to the cap (kMaxProducers, or producer_cap where set)
// with which every block of the grid is resident at once (need blocks an
// SM), or, where no count reaches that, as many blocks an SM as one
// producer allows.
struct Narrow {
  int producers, stages, threads, grid, resident, need;
  size_t smem;
};

template <typename TA, typename TR, int D>
int narrow_plan(int batch, Narrow* g) {
  NarrowTable tab;
  const int rc = narrow_table<TA, TR, D>(&tab);
  if (rc != 0) return rc;
  if (tab.occ[1] < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int per = kWarp / group_lanes<D>();
  const int cap = dgpmp2_stream::producer_cap > 0 &&
                          dgpmp2_stream::producer_cap < kMaxProducers
                      ? dgpmp2_stream::producer_cap
                      : kMaxProducers;
  g->grid = (batch + per - 1) / per;
  g->need = (g->grid + tab.sms - 1) / tab.sms;
  const int target = g->need < tab.occ[1] ? g->need : tab.occ[1];
  int np = cap;
  while (np > 1 && tab.occ[np] < target) --np;
  g->producers = np;
  g->stages = narrow_stages<TA, D>(np);
  g->threads = kWarp * (1 + np);
  g->smem = narrow_smem<TA, D>(g->stages);
  g->resident = tab.occ[np];
  return 0;
}

template <typename TA, typename TR, int D = 1>
int launch_narrow(const StreamArgs& a, cudaStream_t s) {
  if (a.d == D) {
    Narrow g;
    const int rc = narrow_plan<TA, TR, D>(a.batch, &g);
    if (rc != 0) return rc;
    btd_stream_kernel<TA, TR, D><<<g.grid, g.threads, g.smem, s>>>(a,
                                                                  g.stages);
    return 0;
  }
  if constexpr (D < kNarrowMax) return launch_narrow<TA, TR, D + 1>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch plan of D <= 16 at `batch` into out[0..9]: producer warps,
// stages, threads a block, dynamic shared bytes, blocks an SM resident,
// blocks an SM needed, grid, registers a thread, local (spill) bytes a
// thread, SMs.
template <typename TA, typename TR, int D = 1>
int narrow_geometry(int d, int batch, int* out) {
  if (d == D) {
    Narrow g;
    const int rc = narrow_plan<TA, TR, D>(batch, &g);
    if (rc != 0) return rc;
    cudaFuncAttributes attr;
    const cudaError_t e =
        cudaFuncGetAttributes(&attr, btd_stream_kernel<TA, TR, D>);
    if (e != cudaSuccess) return static_cast<int>(e);
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int v[10] = {g.producers, g.stages, g.threads,
                       static_cast<int>(g.smem), g.resident, g.need, g.grid,
                       attr.numRegs, static_cast<int>(attr.localSizeBytes),
                       sms};
    for (int i = 0; i < 10; ++i) out[i] = v[i];
    return 0;
  }
  if constexpr (D < kNarrowMax)
    return narrow_geometry<TA, TR, D + 1>(d, batch, out);
  return static_cast<int>(cudaErrorInvalidValue);
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

template <typename TA, typename TR>
int launch(const StreamArgs* args, void* stream) {
  const StreamArgs& a = *args;
  if (a.d < 1 || a.nfam < 0 || a.nfam > kMaxFamilies)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.batch <= 0 || a.steps <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.d <= kNarrowMax) {
    const int rc = launch_narrow<TA, TR>(a, s);
    if (rc != 0) return rc;
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

