// K-NORM: the learned encoder's per-pixel LayerNorm, ReLU and 2x2 (2x2x2)
// max-pool in one pass (dgpmp2_tpu_torch/models/conv_encoder.py), and its
// backward.
//
// No TPU kernel computes this: the JAX package leaves flax's LayerNorm,
// ReLU and max-pool to XLA (dgpmp2_tpu/models/conv_encoder.py:45, :74).
// The port ran them as three library calls; PyTorch's LayerNorm kernel,
// built for long rows, spent its time on per-row overhead over rows of 16
// or 32 channels (47 % of the learned cell's device time).
//
// Each block of the encoder writes, for every output pixel o and channel c,
//
//   out[o, c] = relu(max over the window W(o) of y[p, c]),
//   y[p, c]   = (x[p, c] - mean_p) * rsqrt(var_p + eps) * gamma[c] + beta[c],
//
// mean and the biased variance over the C channels of input pixel p (two
// passes, in the working type).  The window is 2x2 (2x2x2 in 3-D) at
// stride 2, floored at odd sizes as max_pool2d/3d do, or the pixel alone in
// the last block.  relu(max y) = max(relu y), so ReLU runs once an output
// value.  The max follows max_pool's rule, `y > m || isnan(y)` in window
// order (z, then y, then x), so a NaN propagates and a tie keeps the first.
//
// The backward recomputes the window's statistics and argmax from the saved
// input x (nothing else is stored): the output cotangent goes to the
// argmax pixel of its channel where the max is not <= 0 (ReLU's mask on
// its output), then through that pixel's LayerNorm backward,
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),  g = gy * gamma;
// every other input pixel's cotangent is 0.  dgamma and dbeta are summed
// per block in a fixed order into `partial` (blocks, 2, C), which the
// wrapper sums: no atomics, the same bits on every run.  Forward and
// backward form y with the same correctly rounded operations (the
// multiplies and adds of lookup_common.cuh, an explicit fma), so the
// backward's argmax is the forward's.
//
// What bounds it on an H100: bytes.  A pixel is 64 or 128 bytes in float32
// and needs ~6 operations a value; the first block of the 2-D encoder at
// B = 1024 reads 1.07 GB and writes 0.27 GB (0.40 ms at 3.35 TB/s).  Its
// design: a lane holds 64 bytes of a pixel (16 float32 or 8 float64
// channels), so one to four adjacent lanes own an output pixel and reduce
// its channels by shuffles; a warp covers adjacent output pixels, so each
// window row it reads is one contiguous span, loaded as 16-byte vectors,
// up to four window pixels in flight a lane before any is used; gamma and
// beta are read once a block into shared memory; one 16-byte store a lane
// and vector.  One pass over a grid of one thread a lane-part of an output
// pixel (the backward: a grid-stride loop over as many blocks as the
// wrapper asks for, that many partial sums).
#include <cuda_runtime.h>

#include <cstddef>

#include "lookup_common.cuh"

namespace {

using namespace dgpmp2;

constexpr int kThreads = 256;

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

__device__ __forceinline__ void unpack(const float4& u, float* v) {
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}
__device__ __forceinline__ void unpack(const double2& u, double* v) {
  v[0] = u.x;
  v[1] = u.y;
}
__device__ __forceinline__ float4 pack(const float* v) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ double2 pack(const double* v) {
  return make_double2(v[0], v[1]);
}

__device__ __forceinline__ float inv_sqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ double inv_sqrt(double a) { return rsqrt(a); }

// One instance: working type T, C channels, NDIM spatial axes, pooled or
// not.  A lane holds VPL channels (64 bytes) of a pixel; LANES adjacent
// lanes hold one pixel.
template <typename T, int C, int NDIM, bool POOL>
struct Cfg {
  static constexpr int VPL = 64 / static_cast<int>(sizeof(T));
  static constexpr int LANES = C / VPL;
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  static constexpr int WZ = (NDIM == 3 && POOL) ? 2 : 1;
  static constexpr int WXY = POOL ? 2 : 1;
  static constexpr int WIN = WZ * WXY * WXY;
  static_assert(C % VPL == 0, "a pixel is whole lanes");
  static_assert(LANES >= 1 && LANES <= 32 && (LANES & (LANES - 1)) == 0,
                "a pixel's lanes are a power of two within a warp");
};

struct Shape {
  int depth, height, width;    // input spatial axes (depth 1 in 2-D)
  int out_d, out_h, out_w;     // output spatial axes
  unsigned n_out;              // output pixels, batch included
};

// The lanes of this lane's pixel.
template <int LANES>
__device__ __forceinline__ unsigned group_mask() {
  if (LANES == 32) return 0xffffffffu;
  const unsigned lane = threadIdx.x & 31u;
  return ((1u << LANES) - 1u) << (lane & ~static_cast<unsigned>(LANES - 1));
}

template <int LANES, typename T>
__device__ __forceinline__ T group_sum(T s, unsigned mask) {
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) s = add_rn(s, __shfl_xor_sync(mask, s, o));
  return s;
}

// This lane's 64 bytes of a pixel, as 16-byte vectors.
template <typename T, int VPL>
__device__ __forceinline__ void load64(const T* __restrict__ p, T (&v)[VPL]) {
  using V = typename Vec16<T>::type;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const V* q = reinterpret_cast<const V*>(p);
#pragma unroll
  for (int k = 0; k < VPL / VEC; ++k) unpack(__ldg(q + k), v + k * VEC);
}

template <typename T, int VPL>
__device__ __forceinline__ void store64(T* __restrict__ p, const T (&v)[VPL]) {
  using V = typename Vec16<T>::type;
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  V* q = reinterpret_cast<V*>(p);
#pragma unroll
  for (int k = 0; k < VPL / VEC; ++k) q[k] = pack(v + k * VEC);
}

// v becomes x - mean of the pixel; returns rsqrt(biased var + eps).
template <int C, int LANES, typename T, int VPL>
__device__ __forceinline__ T centre(T (&v)[VPL], T eps, unsigned mask) {
  T s = v[0];
#pragma unroll
  for (int i = 1; i < VPL; ++i) s = add_rn(s, v[i]);
  const T mean = mul_rn(group_sum<LANES>(s, mask), T(1) / T(C));
  T q = T(0);
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    v[i] = sub_rn(v[i], mean);
    q = fma(v[i], v[i], q);
  }
  const T var = mul_rn(group_sum<LANES>(q, mask), T(1) / T(C));
  return inv_sqrt(add_rn(var, eps));
}

// y of a centred value d: d * (rstd * gamma) + beta.
template <typename T>
__device__ __forceinline__ T affine(T d, T rstd, T g, T b) {
  return fma(d, mul_rn(rstd, g), b);
}

// max_pool's update: a larger value or a NaN replaces the running max.
template <typename T>
__device__ __forceinline__ bool takes(T y, T m) {
  return y > m || y != y;
}

// Offset in elements of window pixel w from the window's first pixel.
template <int WZ, int WXY>
__device__ __forceinline__ size_t window_offset(int w, const Shape& s, int c) {
  const int dz = w / (WXY * WXY);
  const int dy = (w / WXY) % WXY;
  const int dx = w % WXY;
  return ((static_cast<size_t>(dz) * s.height + dy) * s.width + dx) * c;
}

// Element offset of output pixel o's window's first input pixel.
template <int WZ, int WXY, int C>
__device__ __forceinline__ size_t window_base(unsigned o, const Shape& s) {
  const unsigned ox = o % static_cast<unsigned>(s.out_w);
  o /= static_cast<unsigned>(s.out_w);
  const unsigned oy = o % static_cast<unsigned>(s.out_h);
  o /= static_cast<unsigned>(s.out_h);
  const unsigned oz = o % static_cast<unsigned>(s.out_d);
  const unsigned b = o / static_cast<unsigned>(s.out_d);
  return (((static_cast<size_t>(b) * s.depth + oz * WZ) * s.height +
           oy * WXY) * s.width + ox * WXY) * C;
}

template <typename T, int C, int NDIM, bool POOL>
__global__ void __launch_bounds__(kThreads)
    encoder_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                        const T* __restrict__ beta, T* __restrict__ out,
                        Shape s, T eps) {
  using K = Cfg<T, C, NDIM, POOL>;
  constexpr int VPL = K::VPL, LANES = K::LANES, WIN = K::WIN;
  constexpr int CHUNK = WIN < 4 ? WIN : 4;
  __shared__ T sg[C], sb[C];
  if (threadIdx.x < C) {
    sg[threadIdx.x] = gamma[threadIdx.x];
    sb[threadIdx.x] = beta[threadIdx.x];
  }
  __syncthreads();
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long pix = t / LANES;
  if (pix >= s.n_out) return;  // a pixel's lanes leave together
  const int part = threadIdx.x % LANES;
  const unsigned mask = group_mask<LANES>();
  const T* base = x + window_base<K::WZ, K::WXY, C>(
                          static_cast<unsigned>(pix), s) + part * VPL;
  T g[VPL], b[VPL], m[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    g[i] = sg[part * VPL + i];
    b[i] = sb[part * VPL + i];
  }
#pragma unroll
  for (int w0 = 0; w0 < WIN; w0 += CHUNK) {
    T v[CHUNK][VPL];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      load64(base + window_offset<K::WZ, K::WXY>(w0 + j, s, C), v[j]);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      const T rstd = centre<C, LANES>(v[j], eps, mask);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const T y = affine(v[j][i], rstd, g[i], b[i]);
        if (w0 + j == 0 || takes(y, m[i])) m[i] = y;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) m[i] = m[i] <= T(0) ? T(0) : m[i];
  store64(out + static_cast<size_t>(pix) * C + part * VPL, m);
}

template <typename T, int C, int NDIM, bool POOL>
__global__ void __launch_bounds__(kThreads)
    encoder_norm_bwd_kernel(const T* __restrict__ x,
                            const T* __restrict__ gamma,
                            const T* __restrict__ beta,
                            const T* __restrict__ gout, T* __restrict__ dx,
                            T* __restrict__ partial, Shape s, T eps) {
  using K = Cfg<T, C, NDIM, POOL>;
  constexpr int VPL = K::VPL, LANES = K::LANES, WIN = K::WIN;
  constexpr int WARPS = kThreads / 32;
  __shared__ T sg[C], sb[C];
  __shared__ T red[WARPS][2][C];
  if (threadIdx.x < C) {
    sg[threadIdx.x] = gamma[threadIdx.x];
    sb[threadIdx.x] = beta[threadIdx.x];
  }
  __syncthreads();
  const int part = threadIdx.x % LANES;
  const unsigned mask = group_mask<LANES>();
  T g[VPL], b[VPL], dg[VPL], db[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    g[i] = sg[part * VPL + i];
    b[i] = sb[part * VPL + i];
    dg[i] = T(0);
    db[i] = T(0);
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long t = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       t / LANES < s.n_out; t += stride) {
    const long long pix = t / LANES;
    const size_t off = window_base<K::WZ, K::WXY, C>(
                           static_cast<unsigned>(pix), s) + part * VPL;
    T go[VPL], m[VPL];
    int arg[VPL];
    load64(gout + static_cast<size_t>(pix) * C + part * VPL, go);
    // One window pixel at a time (no unrolling): the backward keeps its
    // registers for the pixel's values rather than the window's.
#pragma unroll 1
    for (int w = 0; w < WIN; ++w) {
      T v[VPL];
      load64(x + off + window_offset<K::WZ, K::WXY>(w, s, C), v);
      const T rstd = centre<C, LANES>(v, eps, mask);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const T y = affine(v[i], rstd, g[i], b[i]);
        if (w == 0 || takes(y, m[i])) {
          m[i] = y;
          arg[i] = w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (m[i] <= T(0)) go[i] = T(0);
#pragma unroll 1
    for (int w = 0; w < WIN; ++w) {
      const size_t at = off + window_offset<K::WZ, K::WXY>(w, s, C);
      T v[VPL], gg[VPL];
      load64(x + at, v);
      const T rstd = centre<C, LANES>(v, eps, mask);
      T sum_g = T(0), sum_gx = T(0);
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        v[i] = v[i] * rstd;  // xhat
        const T gy = arg[i] == w ? go[i] : T(0);
        dg[i] += gy * v[i];
        db[i] += gy;
        gg[i] = gy * g[i];
        sum_g += gg[i];
        sum_gx += gg[i] * v[i];
      }
      const T mean_g = group_sum<LANES>(sum_g, mask) / T(C);
      const T mean_gx = group_sum<LANES>(sum_gx, mask) / T(C);
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        gg[i] = rstd * (gg[i] - mean_g - v[i] * mean_gx);
      store64(dx + at, gg);
    }
  }
  // dgamma and dbeta of the block, in a fixed order: the warp's lanes of
  // one part by a butterfly, then the warps in turn.
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      dg[i] += __shfl_xor_sync(0xffffffffu, dg[i], o);
      db[i] += __shfl_xor_sync(0xffffffffu, db[i], o);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < LANES) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      red[warp][0][lane * VPL + i] = dg[i];
      red[warp][1][lane * VPL + i] = db[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * C) {
    const int k = threadIdx.x / C, c = threadIdx.x % C;
    T acc = red[0][k][c];
    for (int w = 1; w < WARPS; ++w) acc += red[w][k][c];
    partial[static_cast<size_t>(blockIdx.x) * 2 * C + threadIdx.x] = acc;
  }
}

template <typename T>
struct Args {
  const T* x;
  const T* gamma;
  const T* beta;
  const T* gout;  // null: the forward
  T* out;         // the forward's output, or the backward's dx
  T* partial;
  int blocks;     // the backward's grid
  Shape shape;
  int channels, ndim, pool;
  double eps;
};

template <typename T, int C, int NDIM, bool POOL>
int run(const Args<T>& a, cudaStream_t stream) {
  using K = Cfg<T, C, NDIM, POOL>;
  if (a.gout == nullptr) {
    const long long threads =
        static_cast<long long>(a.shape.n_out) * K::LANES;
    const unsigned blocks =
        static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    encoder_norm_kernel<T, C, NDIM, POOL><<<blocks, kThreads, 0, stream>>>(
        a.x, a.gamma, a.beta, a.out, a.shape, static_cast<T>(a.eps));
  } else {
    encoder_norm_bwd_kernel<T, C, NDIM, POOL>
        <<<a.blocks, kThreads, 0, stream>>>(a.x, a.gamma, a.beta, a.gout,
                                            a.out, a.partial, a.shape,
                                            static_cast<T>(a.eps));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int C, int NDIM>
int run_pool(const Args<T>& a, cudaStream_t stream) {
  return a.pool ? run<T, C, NDIM, true>(a, stream)
                : run<T, C, NDIM, false>(a, stream);
}

template <typename T, int C>
int run_ndim(const Args<T>& a, cudaStream_t stream) {
  if (a.ndim == 2) return run_pool<T, C, 2>(a, stream);
  if (a.ndim == 3) return run_pool<T, C, 3>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instances: C = 16 or 32, 2-D or 3-D, pooled or not.
template <typename T>
int run_any(Args<T> a, int batch, int depth, int height, int width,
            void* stream) {
  const int w = a.pool ? 2 : 1;
  const int wz = (a.pool && a.ndim == 3) ? 2 : 1;
  if (a.ndim == 2) depth = 1;
  a.shape = Shape{depth, height, width, depth / wz, height / w, width / w, 0};
  const long long n = static_cast<long long>(batch) * a.shape.out_d *
                      a.shape.out_h * a.shape.out_w;
  if (batch < 0 || n <= 0 || n > 0x7fffffffLL ||
      (a.gout != nullptr && a.blocks < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  a.shape.n_out = static_cast<unsigned>(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.channels == 16) return run_ndim<T, 16>(a, st);
  if (a.channels == 32) return run_ndim<T, 32>(a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int forward(const T* x, const T* gamma, const T* beta, T* out, int batch,
             int depth, int height, int width, int channels, int ndim,
             int pool, double eps, void* stream) {
  Args<T> a{x, gamma, beta, nullptr, out, nullptr, 0, Shape{}, channels,
            ndim, pool, eps};
  return run_any(a, batch, depth, height, width, stream);
}

template <typename T>
int backward(const T* x, const T* gamma, const T* beta, const T* gout,
             T* dx, T* partial, int blocks, int batch, int depth, int height,
             int width, int channels, int ndim, int pool, double eps,
             void* stream) {
  Args<T> a{x, gamma, beta, gout, dx, partial, blocks, Shape{}, channels,
            ndim, pool, eps};
  return run_any(a, batch, depth, height, width, stream);
}

}  // namespace

// (x, gamma, beta, out, batch, depth, height, width, channels, ndim, pool,
//  eps, stream): x (batch, [depth,] height, width, channels) contiguous.
extern "C" int dgpmp2_encoder_norm_f32(const float* x, const float* gamma,
                                       const float* beta, float* out,
                                       int batch, int depth, int height,
                                       int width, int channels, int ndim,
                                       int pool, double eps, void* stream) {
  return forward(x, gamma, beta, out, batch, depth, height, width, channels,
                 ndim, pool, eps, stream);
}

extern "C" int dgpmp2_encoder_norm_f64(const double* x, const double* gamma,
                                       const double* beta, double* out,
                                       int batch, int depth, int height,
                                       int width, int channels, int ndim,
                                       int pool, double eps, void* stream) {
  return forward(x, gamma, beta, out, batch, depth, height, width, channels,
                 ndim, pool, eps, stream);
}

// (x, gamma, beta, gout, dx, partial, blocks, batch, depth, height, width,
//  channels, ndim, pool, eps, stream): dx like x, written at every pixel of
//  a window (the wrapper zeroes it where odd sizes leave pixels out);
//  partial (blocks, 2, channels).
extern "C" int dgpmp2_encoder_norm_bwd_f32(
    const float* x, const float* gamma, const float* beta, const float* gout,
    float* dx, float* partial, int blocks, int batch, int depth, int height,
    int width, int channels, int ndim, int pool, double eps, void* stream) {
  return backward(x, gamma, beta, gout, dx, partial, blocks, batch, depth,
                  height, width, channels, ndim, pool, eps, stream);
}

extern "C" int dgpmp2_encoder_norm_bwd_f64(
    const double* x, const double* gamma, const double* beta,
    const double* gout, double* dx, double* partial, int blocks, int batch,
    int depth, int height, int width, int channels, int ndim, int pool,
    double eps, void* stream) {
  return backward(x, gamma, beta, gout, dx, partial, blocks, batch, depth,
                  height, width, channels, ndim, pool, eps, stream);
}
