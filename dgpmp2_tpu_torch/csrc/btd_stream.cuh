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
// - D > 16: a persistent grid of blocks, each a producer warp staging the
//   family rows into a ring of stages by cp.async, former warps forming a
//   step's rows [C_t | U_t | y_t] from the stages (2 x 2 tiles of the lower
//   triangle a thread), and consumer warps running K-BTD's wide (D = 17-32:
//   one warp) or block (D > 32: four warps) step on them while the
//   formers form the next step (the section "D > 16" below).  The rows stay
//   float64 through the pivots, as in K-BTD's block kernel.
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

// The launch plan of the wide and block kernels (D > 16), made by
// ops/cuda/btd_stream.py `rows_plan` (`_RowsPlan` mirrors it): the grid,
// the former warps, the stages of the ring of family rows and the rows of a
// diagonal family a stage takes, the buffers of a step's rows (two: the
// formers form step t + 1 into the one the consumer's Schur update of step
// t has released), and the dynamic shared memory's layout in bytes: the
// stages' and row buffers' mbarriers at 0, then ry (the rhs's family sums,
// D doubles), each kept Λ (lam[f], -1 where staged), a chunk's ΛH (lh)
// and, for float32 residuals, its H and r in float64 (hd: chunk_elems
// doubles of H, then r), the stages, and the rows with U_{t-1} after them
// (rows_off), or, with scratch_block, those in scratch at scratch_block
// bytes a block.
struct RowsPlan {
  int grid, formers, stages, chunk_rows, row_buffers, stage_bytes;
  int rows_off, ry_off, lh_off, hd_off, chunk_elems, stage_off;
  int lam[kMaxFamilies];
  int smem;
  long long scratch_block;
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
  RowsPlan plan;  // D > 16
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

// Element i of rhs_t from the GP and prior residuals, in float64, at a
// compile-time D, through ld, four columns' loads at a time (fully
// unrolled at D = 16, the loads hoisted ahead of the sums spilled).
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

// -- D > 16: the wide (D = 17-32) and block (D > 32) kernels -----------------
//
// A persistent grid: block i takes problems i, i + grid, ... one after
// another, and each block has three roles.
// - One producer warp (the last) stages each step's family rows into a ring
//   of `stages` stages in shared memory, ahead of their use: per family, the
//   rows H (K x D), r (K) and, unless the launch keeps it, Λ (K x K, or K
//   when diagonal), by cp.async (16-byte pieces where a run of H is
//   contiguous, else element by element), completing on each stage's full
//   mbarrier (cp.async.mbarrier.arrive); the formers release a stage on its
//   empty mbarrier.  A family with a full Λ takes one stage whole; a diagonal
//   one (the self-collision pairs: 115 x 18 on the 9-link arm, 411 x 34 on
//   the 17-link arm) is streamed `chunk_rows` rows a stage.  A Λ that every
//   problem and step shares (batch and time stride 0) is loaded once per
//   block and kept.
// - Former warps form each step's rows [C_t | U_t | y_t] (double) into two
//   buffers.  rhs_t's GP and prior terms a row a
//   thread and diag_t's lower triangle first; then, for each stage, the
//   formers convert its H and r to float64 once (float32 residuals: once a
//   chunk, not once a tile) and form its ΛH in shared memory, Λ_k H[k][j]
//   for a diagonal Λ, Σ_l Λ[k][l] H[l][j] for a full one; then each thread
//   takes the stage's rows into its 2 x 2 tiles of the lower triangle, with
//   two or three barriers a stage, none a residual row.  Last, U_t by every
//   former (coalesced loads of off_t), the addends, δ and the mirror.  The
//   GP/prior blocks, addends and δ are read straight from global memory,
//   each element once a step, none of them in a chain.
// - Consumer warps (one, or kBlockConsumers past D = 32) run K-BTD's step
//   on the rows (wide_schur + wide_pivots, or block_schur + block_pivots,
//   each element's sums as in K-BTD whatever the team's size), release
//   the previous step's rows once the Schur update has read them, store X_t
//   and z_t, and run K-BTD's back sweep after each problem's last step.  So
//   the formers form step t + 1 while the consumer pivots step t.
// The warps, stages, chunk rows and the shared-memory layout
// are the launch plan (ops/cuda/btd_stream.py `rows_plan`, plain Python):
// the most blocks an SM that the registers and shared memory allow.  Past
// the shared memory, the rows go to a global scratch buffer per block.
//
// What bounds it on an H100: the bytes are the family rows, read once (the
// self-collision H dominates: 0.81 ms at the 17-link arm, B = 1024, in
// float32), and the chain of T1 steps of D pivots each, as in K-BTD's wide
// and block kernels.  The staging overlaps the rows' bytes with the chain,
// and the formers take the assembly off it.
//
// Every element's sums keep the order of the kernels they replace: the wide
// kernel keeps each family's sum apart (in the U columns) and adds it to the
// row once; the block kernel adds each product straight into the row; ΛH
// sums over l in order; then the addends and δ.

// Most former warps a block takes (the plan chooses fewer where that keeps
// more blocks an SM), the block kernel's consumer warps, and launch bounds
// that leave the registers room not to spill while the arms' plans stay
// resident at B = 1024 (see rows_plan): the wide kernel up to 80
// registers, so 8 blocks of 3 warps an SM (6 of 4); the block kernel up to
// 96, 2 blocks of 10 warps.  Four consumer warps pivot a step about as
// fast as K-BTD's eight (a chain of D barriers), and leave the registers
// to formers.
constexpr int kWideFormers = 2;
constexpr int kBlockFormers = 5;
constexpr int kBlockConsumers = 4;

// madd(a, b, c) = a b + c, fused or with the product rounded first.  Each
// sum rounds as in the kernels these replace (their SASS on the H100): the
// rhs products, ΛH of a full Λ and LM's δ fused in both; the family
// products into a row fused in the block kernel but rounded first in the
// wide one, where a select between the two triangles' products kept the
// compiler from fusing them (kFuseRow<APART>).
template <bool FUSED>
__device__ __forceinline__ double madd(double a, double b, double c) {
  return FUSED ? __fma_rn(a, b, c) : __dadd_rn(c, __dmul_rn(a, b));
}

template <bool APART>
constexpr bool kFuseRow = !APART;
constexpr bool kFuseRhs = true;
constexpr bool kFuseLamH = true;
constexpr bool kFuseDelta = true;

__host__ __device__ constexpr int align16(int n) { return (n + 15) / 16 * 16; }

// Byte offsets of a stage's r and Λ pieces for `rows` family rows (H first,
// with 16 bytes to spare for matching its source's alignment).
template <typename TR>
__host__ __device__ inline int stage_r_off(int rows, int d) {
  return align16(rows * d * static_cast<int>(sizeof(TR)) + 16);
}
template <typename TR>
__host__ __device__ inline int stage_w_off(int rows, int d) {
  return stage_r_off<TR>(rows, d) +
         align16(rows * static_cast<int>(sizeof(TR)));
}

// Rows a stage takes of family f: the whole family (at least one chunk,
// empty for K = 0) where Λ is full, else chunk_rows.
__device__ __forceinline__ int chunk_step(const Family& f, int chunk_rows) {
  return f.diagonal ? chunk_rows : (f.k > 1 ? f.k : 1);
}

template <typename TR>
__device__ __forceinline__ const TR* h_rows(const Family& f, int b, int t,
                                            int k0) {
  return static_cast<const TR*>(f.h.p) +
         (b * f.h.s[0] + t * f.h.s[1] + k0 * f.h.s[2]);
}

// Whether a chunk's H rows are one contiguous run, and where in the stage
// they start: a contiguous run sits at its source's offset modulo 16, so
// that its body copies in 16-byte pieces.
template <typename TR>
__device__ __forceinline__ int h_shift(const Family& f, const TR* src,
                                       int rows, int d) {
  const bool run = f.h.s[3] == 1 && (f.h.s[2] == d || rows <= 1);
  return run ? static_cast<int>(reinterpret_cast<size_t>(src) & 15) : -1;
}

__device__ __forceinline__ void cp_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The producer warp's copies of one chunk into stage st.
template <typename TA, typename TR>
__device__ __forceinline__ void stage_chunk(const Family& f, bool kept, int b,
                                            int t, int k0, int rows, int d,
                                            unsigned char* st, int lane) {
  constexpr int SR = static_cast<int>(sizeof(TR));
  constexpr int SA = static_cast<int>(sizeof(TA));
  if (rows == 0) return;
  const TR* src = h_rows<TR>(f, b, t, k0);
  const int n = rows * d;
  const int shift = h_shift<TR>(f, src, rows, d);
  if (shift >= 0) {
    unsigned char* dst = st + shift;
    int head = ((16 - shift) & 15) / SR;
    head = head < n ? head : n;
    const int body = (n - head) * SR / 16;
    const int tail = head + body * 16 / SR;
    for (int i = lane; i < head; i += kWarp)
      cp_async<SR>(dst + i * SR, src + i);
    for (int i = lane; i < body; i += kWarp)
      cp_async<16>(dst + head * SR + i * 16,
                   reinterpret_cast<const unsigned char*>(src + head) + i * 16);
    for (int i = tail + lane; i < n; i += kWarp)
      cp_async<SR>(dst + i * SR, src + i);
  } else {
    for (int e = lane; e < n; e += kWarp) {
      const int k = e / d;
      const int j = e - k * d;
      cp_async<SR>(st + e * SR, src + (k * f.h.s[2] + j * f.h.s[3]));
    }
  }
  unsigned char* rs = st + stage_r_off<TR>(rows, d);
  const TR* r0 = static_cast<const TR*>(f.r.p) +
                 (b * f.r.s[0] + t * f.r.s[1] + k0 * f.r.s[2]);
  for (int k = lane; k < rows; k += kWarp)
    cp_async<SR>(rs + k * SR, r0 + k * f.r.s[2]);
  if (kept) return;
  unsigned char* ws = st + stage_w_off<TR>(rows, d);
  const TA* w0 = static_cast<const TA*>(f.w.p) +
                 (b * f.w.s[0] + t * f.w.s[1] + k0 * f.w.s[2]);
  if (f.diagonal) {
    for (int k = lane; k < rows; k += kWarp)
      cp_async<SA>(ws + k * SA, w0 + k * f.w.s[2]);
  } else {
    for (int e = lane; e < rows * f.k; e += kWarp) {
      const int k = e / f.k;
      const int l = e - k * f.k;
      cp_async<SA>(ws + e * SA, w0 + (k * f.w.s[2] + l * f.w.s[3]));
    }
  }
}

// Tile e of the lower triangle in 2 x 2 tiles: rows 2 ip, 2 ip + 1 and
// columns 2 cp, 2 cp + 1, cp <= ip, e = ip (ip + 1) / 2 + cp.
__device__ __forceinline__ void tile_of(int e, int& ip, int& cp) {
  int i = static_cast<int>((sqrtf(8.0f * e + 1.0f) - 1.0f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  while (i * (i + 1) / 2 > e) --i;
  ip = i;
  cp = e - i * (i + 1) / 2;
}

__device__ __forceinline__ void named_sync(unsigned id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The rows k of a chunk into one tile's accumulators, k in order, from the
// chunk's H and ΛH in float64.
template <bool APART>
__device__ __forceinline__ void tile_rows(const double* hd, const double* lh,
                                          const double* rd, int rows, int d,
                                          int i0, int i1, int c0, int c1,
                                          bool dg, double& x00, double& x10,
                                          double& x01, double& x11,
                                          double& y0, double& y1) {
  for (int k = 0; k < rows; ++k) {
    const double* hk = hd + k * d;
    const double* lk = lh + k * d;
    const double h0 = hk[i0], h1 = hk[i1], l0 = lk[c0], l1 = lk[c1];
    x00 = madd<kFuseRow<APART>>(h0, l0, x00);
    x10 = madd<kFuseRow<APART>>(h1, l0, x10);
    x01 = madd<kFuseRow<APART>>(h0, l1, x01);
    x11 = madd<kFuseRow<APART>>(h1, l1, x11);
    if (dg) {
      y0 = madd<kFuseRhs>(l0, rd[k], y0);
      y1 = madd<kFuseRhs>(l1, rd[k], y1);
    }
  }
}

// The formers' part of one chunk: each thread's tiles take the chunk's rows
// k in order into their accumulators.  APART (the wide kernel): a family's
// sums start at 0 in the U columns (and ry for the rhs), and are added to
// the row at the family's last chunk; else (the block kernel) each product
// goes straight into the row.
template <bool APART>
__device__ __forceinline__ void form_chunk(double* cur, double* ry,
                                           const double* hd, const double* lh,
                                           const double* rd, bool first,
                                           bool last, int rows, int d,
                                           int ftid, int nft) {
  const int w = 2 * d + 1;
  const int cz = 2 * d;
  const int hp = (d + 1) / 2;
  const int ntiles = hp * (hp + 1) / 2;
  // Accumulators at element (i, j) of the rows: U's column j (APART) or
  // C's; the rhs's at ry[i] (APART) or y.
  const int acc = APART ? d : 0;
  for (int e = ftid; e < ntiles; e += nft) {
    int ip, cp;
    tile_of(e, ip, cp);
    const int i0 = 2 * ip, c0 = 2 * cp;
    const bool dg = ip == cp;
    const bool v1 = i0 + 1 < d;  // row i0 + 1 exists
    const int i1 = v1 ? i0 + 1 : i0;
    const int c1 = c0 + 1 < d ? c0 + 1 : c0;
    // (i0, c0), (i1, c0), (i0, c1), (i1, c1); the rhs of i0, i1 on a
    // diagonal tile.
    double x00 = 0.0, x10 = 0.0, x01 = 0.0, x11 = 0.0, y0 = 0.0, y1 = 0.0;
    if (!(APART && first)) {
      x00 = cur[i0 * w + acc + c0];
      x10 = cur[i1 * w + acc + c0];
      x11 = cur[i1 * w + acc + c1];
      if (!dg) x01 = cur[i0 * w + acc + c1];
      if (dg) {
        y0 = APART ? ry[i0] : cur[i0 * w + cz];
        y1 = APART ? ry[i1] : cur[i1 * w + cz];
      }
    }
    tile_rows<APART>(hd, lh, rd, rows, d, i0, i1, c0, c1, dg, x00, x10, x01,
                     x11, y0, y1);
    const bool has01 = !dg && c0 + 1 < d;
    const bool has11 = v1 && c0 + 1 < d;
    if (APART && last) {
      // The family's sums, added to the row once.
      cur[i0 * w + c0] = __dadd_rn(cur[i0 * w + c0], x00);
      if (v1) cur[i1 * w + c0] = __dadd_rn(cur[i1 * w + c0], x10);
      if (has01) cur[i0 * w + c1] = __dadd_rn(cur[i0 * w + c1], x01);
      if (has11) cur[i1 * w + c1] = __dadd_rn(cur[i1 * w + c1], x11);
      if (dg) {
        cur[i0 * w + cz] = __dadd_rn(cur[i0 * w + cz], y0);
        if (v1) cur[i1 * w + cz] = __dadd_rn(cur[i1 * w + cz], y1);
      }
    } else {
      cur[i0 * w + acc + c0] = x00;
      if (v1) cur[i1 * w + acc + c0] = x10;
      if (has01) cur[i0 * w + acc + c1] = x01;
      if (has11) cur[i1 * w + acc + c1] = x11;
      if (dg) {
        if (APART) {
          ry[i0] = y0;
          if (v1) ry[i1] = y1;
        } else {
          cur[i0 * w + cz] = y0;
          if (v1) cur[i1 * w + cz] = y1;
        }
      }
    }
  }
}

// Element i of rhs_t from the GP and prior residuals, in float64, through
// ld, eight columns' loads at a time; each product fused into its sum, as
// the kernels these replace did.
template <typename TA, typename TR>
__device__ __forceinline__ double rows_gp_rhs(const StreamArgs& a, int b,
                                              int t, int i, int d) {
  auto dot = [&](const View& m, int tm, const View& v, int tv, bool timed) {
    double s = 0.0;
#pragma unroll 8
    for (int j = 0; j < d; ++j)
      s = __fma_rn(double(timed ? ld<TA>(m, b, tm, i, j) : ld<TA>(m, b, i, j)),
                   double(timed ? ld<TR>(v, b, tv, j) : ld<TR>(v, b, j)), s);
    return s;
  };
  double y = 0.0;
  if (t < a.steps - 1) y = dot(a.phit_q, t, a.r_gp, t, true);
  if (t >= 1) y -= dot(a.q_inv, t - 1, a.r_gp, t - 1, true);
  if (t == 0) y += dot(a.ks, 0, a.r_s, 0, false);
  if (t == a.steps - 1) y += dot(a.kg, 0, a.r_g, 0, false);
  return y;
}

// Element (i, j) of U_t: off_t (+ off_add_t), 0 at the last step.
template <typename TA>
__device__ __forceinline__ double u_elem(const StreamArgs& a, int b, int t,
                                         bool has_next, int i, int j) {
  if (!has_next) return 0.0;
  const double o = double(ld<TA>(a.off, b, t, i, j));
  return a.off_add.p ? __dadd_rn(o, double(ld<TA>(a.off_add, b, t, i, j)))
                     : o;
}

// The formers' step (b, t) into cur, taking stages c, c + 1, ... of the
// ring; returns the next stage's count.
template <typename TA, typename TR, bool APART>
__device__ __forceinline__ int form_step(
    const StreamArgs& a, unsigned char* smem, double* cur, int b, int t, int c,
    unsigned long long* full, unsigned long long* empty, int ftid, int nft) {
  // b opaque to the compiler: each step recomputes its addresses rather than
  // holding every view's per-problem base in registers across the steps.
  asm volatile("" : "+r"(b));
  const dgpmp2_stream::RowsPlan& pl = a.plan;
  const int d = a.d;
  const int w = 2 * d + 1;
  const int cz = 2 * d;
  const int hp = (d + 1) / 2;
  const int ntiles = hp * (hp + 1) / 2;
  double* ry = reinterpret_cast<double*>(smem + pl.ry_off);
  double* lh = reinterpret_cast<double*>(smem + pl.lh_off);
  // rhs_t from the GP and prior terms, a row a thread; the lower triangle of
  // diag_t, each tile's loads issued before its stores.
  for (int i = ftid; i < d; i += nft)
    cur[i * w + cz] = rows_gp_rhs<TA, TR>(a, b, t, i, d);
  for (int e = ftid; e < ntiles; e += nft) {
    int ip, cp;
    tile_of(e, ip, cp);
    const int i0 = 2 * ip, c0 = 2 * cp;
    const bool v1 = i0 + 1 < d, has01 = ip != cp && c0 + 1 < d;
    const bool has11 = v1 && c0 + 1 < d;
    const double d00 = double(ld<TA>(a.diag, b, t, i0, c0));
    const double d10 = v1 ? double(ld<TA>(a.diag, b, t, i0 + 1, c0)) : 0.0;
    const double d01 = has01 ? double(ld<TA>(a.diag, b, t, i0, c0 + 1)) : 0.0;
    const double d11 =
        has11 ? double(ld<TA>(a.diag, b, t, i0 + 1, c0 + 1)) : 0.0;
    cur[i0 * w + c0] = d00;
    if (v1) cur[(i0 + 1) * w + c0] = d10;
    if (has01) cur[i0 * w + c0 + 1] = d01;
    if (has11) cur[(i0 + 1) * w + c0 + 1] = d11;
  }
  // rhs_t is the diagonal tiles' owners' from here.
  named_sync(1, nft);
  for (int n = 0; n < a.nfam; ++n) {
    const Family& f = a.fam[n];
    const int step = chunk_step(f, pl.chunk_rows);
    const TA* kept = pl.lam[n] >= 0
                         ? reinterpret_cast<const TA*>(smem + pl.lam[n])
                         : nullptr;
    for (int k0 = 0; k0 == 0 || k0 < f.k; k0 += step, ++c) {
      const int rows = f.k - k0 < step ? f.k - k0 : step;
      const int s = c % pl.stages;
      mbar_wait(full + s, (c / pl.stages) & 1);
      const unsigned char* st = smem + pl.stage_off + s * pl.stage_bytes;
      const int shift = rows ? h_shift<TR>(f, h_rows<TR>(f, b, t, k0), rows, d)
                             : 0;
      const TR* hs = reinterpret_cast<const TR*>(st + (shift > 0 ? shift : 0));
      const TR* rs = reinterpret_cast<const TR*>(st + stage_r_off<TR>(rows, d));
      const TA* ws =
          kept ? kept + (f.diagonal ? k0 : 0)
               : reinterpret_cast<const TA*>(st + stage_w_off<TR>(rows, d));
      // The chunk's H and r in float64 (float32 residuals converted once
      // here, not once a tile), and a diagonal Λ's (ΛH)[k][j] = Λ_k H[k][j];
      // then a full Λ's (ΛH)[k][j] = Σ_l Λ[k][l] H[l][j], l in order.
      const bool wide64 = sizeof(TR) == sizeof(double);
      double* hw = reinterpret_cast<double*>(smem + pl.hd_off);
      double* rw = hw + pl.chunk_elems;
      const double* hd =
          wide64 ? reinterpret_cast<const double*>(hs) : hw;
      const double* rd =
          wide64 ? reinterpret_cast<const double*>(rs) : rw;
      named_sync(1, nft);  // the last chunk's tiles are done with hd and lh
      for (int e = ftid; e < rows * d; e += nft) {
        const double h = double(hs[e]);
        if (!wide64) hw[e] = h;
        if (f.diagonal) lh[e] = __dmul_rn(double(ws[e / d]), h);
      }
      if (!wide64)
        for (int k = ftid; k < rows; k += nft) rw[k] = double(rs[k]);
      if (!f.diagonal) {
        named_sync(1, nft);
        for (int e = ftid; e < rows * d; e += nft) {
          const int k = e / d;
          const int j = e - k * d;
          const TA* wk = ws + k * f.k;
          double acc = 0.0;
#pragma unroll 4
          for (int l = 0; l < f.k; ++l)
            acc = madd<kFuseLamH>(double(wk[l]), hd[l * d + j], acc);
          lh[e] = acc;
        }
      }
      named_sync(1, nft);
      form_chunk<APART>(cur, ry, hd, lh, rd, k0 == 0, k0 + step >= f.k, rows,
                        d, ftid, nft);
      mbar_arrive(empty + s);
    }
  }
  // Every family sum is in (the U columns are free), so U_t by every
  // former thread, a row's elements to consecutive threads; rhs_t's addend
  // a row a thread; then the addends and δ on each tile's lower triangle,
  // and its mirror.
  named_sync(1, nft);
  const bool has_next = t < a.steps - 1;
#pragma unroll 4
  for (int e = ftid; e < d * d; e += nft) {
    const int i = e / d;
    const int j = e - i * d;
    cur[i * w + d + j] = u_elem<TA>(a, b, t, has_next, i, j);
  }
  if (a.rhs_add.p)
    for (int i = ftid; i < d; i += nft)
      cur[i * w + cz] =
          __dadd_rn(cur[i * w + cz], double(ld<TA>(a.rhs_add, b, t, i)));
  const double dl = a.delta.p ? double(ld<TA>(a.delta, b, 0)) : 0.0;
  for (int e = ftid; e < ntiles; e += nft) {
    int ip, cp;
    tile_of(e, ip, cp);
    for (int i = 2 * ip; i < 2 * ip + 2 && i < d; ++i) {
      for (int j = 2 * cp; j < 2 * cp + 2 && j <= i; ++j) {
        double v = cur[i * w + j];
        if (a.diag_add.p)
          v = __dadd_rn(v, double(ld<TA>(a.diag_add, b, t, i, j)));
        if (i == j && a.delta.p) v = madd<kFuseDelta>(dl, v, v);
        cur[i * w + j] = v;
        cur[j * w + i] = v;
      }
    }
  }
  return c;
}

// SMEM: the rows in shared memory (scratch_block 0), so that the compiler
// addresses them as shared memory, not through generic pointers.
template <typename TA, typename TR, bool BLOCK, bool SMEM>
__device__ __forceinline__ void rows_kernel(const StreamArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const dgpmp2_stream::RowsPlan& pl = a.plan;
  const int d = a.d;
  const int w = 2 * d + 1;
  const int cz = 2 * d;
  const int steps = a.steps;
  const int ns = pl.stages, nr = pl.row_buffers;
  const int nc = BLOCK ? kBlockConsumers : 1;
  const int nf = pl.formers;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + ns;
  unsigned long long* rfull = empty + ns;
  unsigned long long* rempty = rfull + nr;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const size_t step_elems = static_cast<size_t>(d) * w;
  double* rows =
      SMEM ? reinterpret_cast<double*>(smem + pl.rows_off)
           : reinterpret_cast<double*>(static_cast<unsigned char*>(a.scratch) +
                                       blockIdx.x * pl.scratch_block);
  double* up = rows + nr * step_elems;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full + s, kWarp);
      mbar_init(empty + s, nf * kWarp);
    }
    for (int q = 0; q < nr; ++q) {
      mbar_init(rfull + q, nf * kWarp);
      mbar_init(rempty + q, nc * kWarp);
    }
  }
  // Each Λ the launch keeps, loaded once.
  for (int n = 0; n < a.nfam; ++n) {
    const Family& f = a.fam[n];
    if (pl.lam[n] < 0) continue;
    TA* dst = reinterpret_cast<TA*>(smem + pl.lam[n]);
    const int m = f.diagonal ? f.k : f.k * f.k;
    for (int e = threadIdx.x; e < m; e += blockDim.x)
      dst[e] = f.diagonal ? at<TA>(f.w, 0, 0, e)
                          : at<TA>(f.w, 0, 0, e / f.k, e % f.k);
  }
  __syncthreads();

  if (warp >= nc + nf) {
    // The producer warp.
    int c = 0;
    for (int b = blockIdx.x; b < a.batch; b += gridDim.x)
      for (int t = 0; t < steps; ++t)
        for (int n = 0; n < a.nfam; ++n) {
          const Family& f = a.fam[n];
          const int step = chunk_step(f, pl.chunk_rows);
          for (int k0 = 0; k0 == 0 || k0 < f.k; k0 += step, ++c) {
            const int s = c % ns;
            mbar_wait(empty + s, ((c / ns) & 1) ^ 1);
            stage_chunk<TA, TR>(f, pl.lam[n] >= 0, b, t, k0,
                                f.k - k0 < step ? f.k - k0 : step, d,
                                smem + pl.stage_off + s * pl.stage_bytes, lane);
            cp_arrive(full + s);
          }
        }
    cp_wait_all();
    return;
  }

  if (warp >= nc) {
    // The former warps.
    const int ftid = threadIdx.x - nc * kWarp;
    const int nft = nf * kWarp;
    int g = 0, c = 0;
    for (int b = blockIdx.x; b < a.batch; b += gridDim.x)
      for (int t = 0; t < steps; ++t, ++g) {
        const int q = g % nr;
        mbar_wait(rempty + q, ((g / nr) & 1) ^ 1);
        c = form_step<TA, TR, !BLOCK>(a, smem, rows + q * step_elems, b, t, c,
                                      full, empty, ftid, nft);
        mbar_arrive(rfull + q);
      }
    return;
  }

  // The consumer warps.
  const Team tm{lane, warp, kBlockConsumers, 2u};
  const int dd = d * d;
  int g = 0;
  for (int b = blockIdx.x; b < a.batch; b += gridDim.x) {
    TA* zb = static_cast<TA*>(a.z) + static_cast<size_t>(b) * steps * d;
    TR* xb = static_cast<TR*>(a.x) + static_cast<size_t>(b) * steps * d;
    TA* gn = static_cast<TA*>(a.gain) +
             static_cast<size_t>(b) * (steps - 1) * dd;
    for (int t = 0; t < steps; ++t, ++g) {
      const int q = g % nr;
      mbar_wait(rfull + q, (g / nr) & 1);
      double* cur = rows + q * step_elems;
      const double* prev = rows + ((g + nr - 1) % nr) * step_elems;
      const bool has_next = t < steps - 1;
      if (BLOCK)
        block_schur(cur, prev, up, t, d, tm);
      else
        wide_schur(cur, prev, up, w, d + 1, t, d, lane);
      // The previous step's rows are free for the formers.
      if (g > 0) mbar_arrive(rempty + (g - 1) % nr);
      const size_t tdd = static_cast<size_t>(t) * dd;
      if (BLOCK) {
        block_pivots(cur, up, d, tm);
        for (int r = tm.ty; r < d; r += kBlockConsumers) {
          if (has_next)
            for (int c = tm.tx; c < d; c += kBlockX)
              gn[tdd + r * d + c] = static_cast<TA>(cur[r * w + d + c]);
          if (tm.tx == 0)
            zb[static_cast<size_t>(t) * d + r] =
                static_cast<TA>(cur[r * w + cz]);
        }
      } else {
        wide_pivots(cur, up, w, d + 1, d, lane);
        if (lane < d) {
          zb[static_cast<size_t>(t) * d + lane] =
              static_cast<TA>(cur[lane * w + cz]);
          if (has_next)
            for (int k = 0; k < d; ++k)
              gn[tdd + lane * d + k] = static_cast<TA>(cur[lane * w + d + k]);
        }
      }
    }
    const double* last = rows + ((g + nr - 1) % nr) * step_elems;
    const int tid = BLOCK ? warp * kWarp + lane : lane;
    for (int r = tid; r < d; r += nc * kWarp)
      xb[static_cast<size_t>(steps - 1) * d + r] =
          static_cast<TR>(last[r * w + cz]);
    if (BLOCK)
      block_back_sweep<TA, TR>(last, up, gn, zb, xb, steps, d, tm);
    else
      wide_back_sweep<TA, TR>(gn, zb, xb, steps, d, lane);
  }
}


template <typename TA, typename TR>
__global__ void __launch_bounds__(kWarp * (2 + kWideFormers), 6)
    btd_stream_kernel_wide(__grid_constant__ const StreamArgs a) {
  rows_kernel<TA, TR, false, true>(a);  // D <= 32: the rows always fit
}

template <typename TA, typename TR>
__global__ void __launch_bounds__(kWarp * (1 + kBlockConsumers + kBlockFormers),
                                  2)
    btd_stream_kernel_block(__grid_constant__ const StreamArgs a) {
  if (a.plan.scratch_block)
    rows_kernel<TA, TR, true, false>(a);
  else
    rows_kernel<TA, TR, true, true>(a);
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
    return static_cast<int>(cudaGetLastError());
  }
  const dgpmp2_stream::RowsPlan& pl = a.plan;
  const bool block = a.d > kMaxD;
  const int formers_max = block ? kBlockFormers : kWideFormers;
  if (pl.grid < 1 || pl.formers < 1 || pl.formers > formers_max ||
      pl.stages < 1 || pl.row_buffers < 2 || pl.chunk_rows < 1 ||
      (pl.scratch_block && (a.scratch == nullptr || !block)))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto kernel = block ? btd_stream_kernel_block<TA, TR>
                            : btd_stream_kernel_wide<TA, TR>;
  // Opt in to the device's limit, not to this plan's bytes: the plan's
  // occupancy queries (rows_occupancy) assume that limit.
  int optin = 0;
  int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  if (pl.smem > optin) return static_cast<int>(cudaErrorInvalidConfiguration);
  rc = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin));
  if (rc != 0) return rc;
  const int threads =
      kWarp * ((block ? kBlockConsumers : 1) + pl.formers + 1);
  kernel<<<pl.grid, threads, pl.smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The wide (block = 0) or block kernel's registers, local bytes a thread
// and most threads a block into out[0..2], the device's opt-in shared
// memory and SMs into out[3..4]; opts the kernel in to that shared memory
// with the carveout at shared memory first.
template <typename TA, typename TR>
int rows_attrs(int block, int* out) {
  const auto kernel = block ? btd_stream_kernel_block<TA, TR>
                            : btd_stream_kernel_wide<TA, TR>;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int v[5] = {attr.numRegs, static_cast<int>(attr.localSizeBytes),
                    attr.maxThreadsPerBlock, optin, sms};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// Blocks an SM of the wide or block kernel at `threads` and `smem` dynamic
// shared bytes (after rows_attrs).
template <typename TA, typename TR>
int rows_occupancy(int block, int threads, int smem, int* out) {
  const auto kernel = block ? btd_stream_kernel_block<TA, TR>
                            : btd_stream_kernel_wide<TA, TR>;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel, threads, smem));
}

}  // namespace

