// Row LayerNorm and row softmax over the last axis, fp32, bf16 and fp16,
// for Hopper (sm_90a).
//
// Replaces incubator_mxnet_tpu/ops/pallas/fused_norm.py: _ln_kernel (reached
// through _ln_call and fused_layer_norm) and _softmax_kernel (reached through
// _softmax_core and fused_softmax), in both element types the JAX package
// gives them: fp32, bf16 under ShardedTrainer's compute_dtype or
// param_dtype, and fp16 under its compute_dtype (x, gamma and beta all of
// the one 16-bit type, as the JAX cast leaves them).
//
// What bounds it on the H100: bytes. Each element is read once and written
// once, and the arithmetic is a few operations per element, far below the
// ~20 fp32 operations per byte at which the CUDA cores would be the limit.
// At (R, C) = (1024, 768) the 6.3 MB of fp32 traffic needs about 1.9 us at
// 3.35 TB/s (bf16 and fp16: half). A decode step's LayerNorm (8 rows) or a prefill
// chunk's (32 rows) moves 25-100 KB, far less than a launch costs: there
// what bounds a call is latency, the launch's own and one trip to memory.
//
// Every kernel is a template over the element type T (float,
// __nv_bfloat16 or __half): loads widen to fp32, the arithmetic is fp32,
// and the result rounds to T once, to nearest even, where the TPU kernel's
// .astype(o_ref.dtype) rounds. fp16 rounds with __float2half_rn: a value
// past 65504 becomes inf and one below 2**-14 an fp16 subnormal, as
// jnp's astype gives them (no saturation, no flush to zero; the build has
// no --use_fast_math).
//
// LayerNorm's routes, picked by the wrapper (ops/kernels/fused_norm.py
// _route) and checked here:
//   warp (C <= 1024, C a multiple of a 16-byte vector: 4 floats or 8
//     16-bit values,
//     the four bases 16-byte aligned): one warp owns a row in registers,
//     read and written with 16-byte accesses, neighbouring lanes on
//     neighbouring vectors. Each C bucket (128 floats or 256 16-bit, one
//     vector a lane) has its own instantiation, so a lane holds exactly the
//     vectors its row needs (C = 768: six float4 or three 8-wide vectors,
//     none masked). gamma and beta are loaded with x, before the two
//     shuffle reductions, so their latency hides behind x's. Four rows a
//     block.
//   warp_scalar (the vector's multiple or an alignment fails): the same
//     kernel instantiated on single elements.
//   long (C > 1024): one block a row of 256 threads reading the row once a
//     pass; L2 holds it between passes.
// A block a row over several warps at few rows was timed on the card
// against the warp route at 1 to 256 rows of 768 and was no faster at any
// count: spreading 8 or 32 rows over more SMs does not shorten a call
// whose time is a launch and one trip to memory.
// Any row count: the grid masks the ragged end, so the TPU kernel's rows % 8
// and vector-memory rules do not apply here.
//
// Softmax's routes. fp32 takes one warp a row of up to 1024 values (ceil(C
// / 32) a lane) and a block a row above. bf16 and fp16 take a route code
// from the wrapper (ops/kernels/fused_norm.py _softmax_route), checked here:
//   vec (C <= 1024, C a multiple of 8, both bases 16-byte aligned): a group
//     of G lanes (a power of two sized to C's bucket) owns a row, read and
//     written as 16-byte vectors of 8 values and reduced by shuffles inside
//     the group. At C = 128 that is 16 lanes a row, two rows to each
//     warp-wide access. Each lane holds kVecLoads vectors, so a warp has
//     several rows' loads in flight before its first reduction (the count
//     is a sweep's choice on the card: PERF.md §6).
//   scalar (the other rows up to 1024): the fp32 warp kernel on T.
//   long (C > 1024): the fp32 block kernel on T.
// Bytes bound the vec route (about 5 fp32 operations for the 4 bytes a
// value moves); what the earlier one-value-a-lane kernel (the scalar route
// now) spent at C = 128 was issue slots (a 2-byte load and store, a bounds
// test, an expf and an IEEE division for each value) and the latency of
// one 256-byte row a warp with nothing else in flight.
//
// Numerics follow the TPU kernels: LayerNorm takes the mean, then the
// centred variance, then (x - mean) * rsqrt(var + eps) * gamma + beta.
// Softmax takes the max, exp(x - max), the sum, then divides; a row that is
// partly -inf gives 0 there, and a row that is all -inf gives NaN, as
// jax.nn.softmax does. The vec route computes exp as 2^((x - max) *
// log2(e)) by ex2.approx.ftz and the quotient as a product by the row's
// one reciprocal: each moves the fp32 value by a couple of ulps before the
// one rounding to 16 bits (a probability below 2^-126 becomes 0, inside
// the plain version's limits).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "ex2.cuh"

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;    // rows per block on the warp path
constexpr int kRowThreads = 256;     // threads per block on the long-row path

// The sum (max) over the G lanes of an aligned group of the warp, G a power
// of two (the whole warp by default); every lane of the warp takes part.
template <int G = kWarp>
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int G = kWarp>
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions for the long-row path; `red` holds one float per warp.
// The leading barrier lets a second call reuse `red` safely.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < (int)(blockDim.x / kWarp); ++i) t += red[i];
  return t;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if (threadIdx.x % kWarp == 0) red[threadIdx.x / kWarp] = v;
  __syncthreads();
  float t = -INFINITY;
  for (int i = 0; i < (int)(blockDim.x / kWarp); ++i) t = fmaxf(t, red[i]);
  return t;
}

// ------------------------------------------------------------ element types

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

// elements of T in one 16-byte access
template <typename T>
constexpr int kVec16 = 16 / (int)sizeof(T);

// VW consecutive elements at p as floats (VW = kVec16<T>: one 16-byte
// access; VW = 1: one element)
template <typename T, int VW>
__device__ __forceinline__ void load_vec(float* v, const T* p) {
  if constexpr (VW == 1) {
    v[0] = widen(*p);
  } else {
    static_assert(VW == kVec16<T>, "a vector is one 16-byte access");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VW; ++k) v[k] = widen(e[k]);
  }
}

template <typename T, int VW>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (VW == 1) {
    *p = narrow<T>(v[0]);
  } else {
    static_assert(VW == kVec16<T>, "a vector is one 16-byte access");
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < VW; ++k) e[k] = narrow<T>(v[k]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// ---------------------------------------------------------------- LayerNorm

constexpr int kMaxWarpC = 1024;    // longest row of the warp routes

// One warp a row: NV vectors of VW elements a lane, 32 * NV * VW >= C and
// C % VW == 0. x, gamma and beta are all requested before the first sum.
template <typename T, int VW, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
ln_warp_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
               const T* __restrict__ beta, T* __restrict__ y, int rows, int C,
               float eps) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;   // the whole warp leaves together
  const int nvec = C / VW;
  const T* xr = x + row * C;
  float v[NV][VW], g[NV][VW], b[NV][VW];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + i * kWarp;
    if (j < nvec) {
      load_vec<T, VW>(v[i], xr + j * VW);
      load_vec<T, VW>(g[i], gamma + j * VW);
      load_vec<T, VW>(b[i], beta + j * VW);
    } else {
#pragma unroll
      for (int k = 0; k < VW; ++k) v[i][k] = g[i][k] = b[i][k] = 0.f;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < VW; ++k) s += v[i][k];
  const float mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const bool live = lane + i * kWarp < nvec;
#pragma unroll
    for (int k = 0; k < VW; ++k) {
      const float d = live ? v[i][k] - mean : 0.f;
      v[i][k] = d;
      q += d * d;
    }
  }
  const float inv = rsqrtf(warp_sum(q) / C + eps);
  T* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = lane + i * kWarp;
    if (j < nvec) {
      float o[VW];
#pragma unroll
      for (int k = 0; k < VW; ++k) o[k] = v[i][k] * inv * g[i][k] + b[i][k];
      store_vec<T, VW>(yr + j * VW, o);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
ln_block_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                const T* __restrict__ beta, T* __restrict__ y, int C,
                float eps) {
  __shared__ float red[kRowThreads / kWarp];
  const long long row = blockIdx.x;
  const T* xr = x + row * C;
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) s += widen(xr[c]);
  const float mean = block_sum(s, red) / C;
  float q = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float d = widen(xr[c]) - mean;
    q += d * d;
  }
  const float inv = rsqrtf(block_sum(q, red) / C + eps);
  T* yr = y + row * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    yr[c] = narrow<T>((widen(xr[c]) - mean) * inv * widen(gamma[c]) +
                      widen(beta[c]));
}

// ------------------------------------------------------------------ softmax

template <typename T, int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
softmax_warp_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                    int C) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const T* xr = x + row * C;
  float v[VPL];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + i * kWarp;
    v[i] = c < C ? widen(xr[c]) : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + i * kWarp;
    const float e = c < C ? expf(v[i] - m) : 0.f;
    v[i] = e;
    s += e;
  }
  s = warp_sum(s);
  T* yr = y + row * C;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + i * kWarp;
    if (c < C) yr[c] = narrow<T>(v[i] / s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
softmax_block_kernel(const T* __restrict__ x, T* __restrict__ y, int C) {
  __shared__ float red[kRowThreads / kWarp];
  const long long row = blockIdx.x;
  const T* xr = x + row * C;
  float m = -INFINITY;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    m = fmaxf(m, widen(xr[c]));
  m = block_max(m, red);
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    s += expf(widen(xr[c]) - m);
  s = block_sum(s, red);
  T* yr = y + row * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    yr[c] = narrow<T>(expf(widen(xr[c]) - m) / s);
}

// 16-byte vectors a lane holds in flight on the vec route: the rows a lane
// group takes at once are this over the row's vectors a lane, at least 1.
// A sweep on an H100 at the training path's (64, 12, 128, 128) chose it
// (PERF.md §6; µs a call, bf16 and fp16 alike): 1 vector 16.6-16.8,
// 2 15.8-16.1, 4 16.3-16.5, 8 19.6-19.8 (96 registers a thread).
constexpr int kVecLoads = 2;
template <int NV>
constexpr int kVecRows = kVecLoads / NV > 0 ? kVecLoads / NV : 1;

constexpr float kLog2e = 1.4426950408889634f;

// The vec route: a group of G lanes owns a row of C 16-bit values (C % 8 ==
// 0, C <= G * NV * 8), NV 16-byte vectors a lane, neighbouring lanes on
// neighbouring vectors; a warp holds 32 / G rows at each access, and R =
// kVecRows<NV> of those accesses, all requested before the first max. A
// vector past the row's end, or of a row past `rows`, reads as -inf and is
// not stored. Loads and stores are load_vec / store_vec (one 16-byte
// access, narrow<T>'s round to nearest even: fp16 subnormals kept).
//
// exp: (x - max) then * log2(e) then ex2. One FFMA, x * log2(e) - max *
// log2(e), would save an FADD but carry max * log2(e)'s rounding, |max| *
// 2^-24 in the exponent, into every value: at fp16's range that is several
// fp16 steps. x - max is exact near the max, so this form keeps a couple of
// ulps. A row whose max is -inf (all -inf) gets -inf - (-inf) = NaN, so its
// output is NaN, as the plain version's is.
// Quotient: one correctly rounded reciprocal a row, then a product a value
// (two roundings where a division has one).
template <typename T, int G, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
softmax_vec_kernel(const T* __restrict__ x, T* __restrict__ y, int rows,
                   int C) {
  constexpr int VW = kVec16<T>;
  constexpr int kGroups = kWarp / G;
  constexpr int R = kVecRows<NV>;
  const int lane = threadIdx.x % kWarp;
  const int sub = lane % G;
  const long long first =
      ((long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / kWarp) *
          (kGroups * R) + lane / G;
  const int nvec = C / VW;
  float v[R][NV][VW];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = first + r * kGroups;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = sub + i * G;
      if (row < rows && j < nvec) {
        load_vec<T, VW>(v[r][i], x + row * C + j * VW);
      } else {
#pragma unroll
        for (int k = 0; k < VW; ++k) v[r][i][k] = -INFINITY;
      }
    }
  }
  float m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int k = 0; k < VW; ++k) m[r] = fmaxf(m[r], v[r][i][k]);
    m[r] = warp_max<G>(m[r]);
  }
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int k = 0; k < VW; ++k) {
        const float e = ex2_ftz((v[r][i][k] - m[r]) * kLog2e);
        v[r][i][k] = e;
        s[r] += e;
      }
    s[r] = warp_sum<G>(s[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = first + r * kGroups;
    const float inv = __frcp_rn(s[r]);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = sub + i * G;
      if (row < rows && j < nvec) {
#pragma unroll
        for (int k = 0; k < VW; ++k) v[r][i][k] *= inv;
        store_vec<T, VW>(y + row * C + j * VW, v[r][i]);
      }
    }
  }
}

unsigned warp_grid(int rows) {
  return (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// LayerNorm's route codes, as ops/kernels/fused_norm.py ROUTES gives them.
enum LnRoute { kLnWarp = 0, kLnWarpScalar = 1, kLnLong = 2 };

template <typename T, int VW, int NV>
void launch_ln_warp(const T* x, const T* gamma, const T* beta, T* y,
                    int rows, int C, float eps, cudaStream_t stream) {
  ln_warp_kernel<T, VW, NV><<<warp_grid(rows), kWarpsPerBlock * kWarp, 0,
                              stream>>>(x, gamma, beta, y, rows, C, eps);
}

// The warp route's instantiation for C's bucket: kBucket elements a bucket,
// NB buckets at most (kBucket * NB = 1024), a bucket PB vectors a lane.
template <typename T, int VW>
void launch_ln_warp_bucket(const T* x, const T* gamma, const T* beta, T* y,
                           int rows, int C, float eps, cudaStream_t stream) {
  // a vector a lane for each bucket of 16-byte vectors (128 floats, 256
  // 16-bit values); four elements a lane for each 128 of the scalar
  // instantiation
  constexpr int kBucket = VW == 1 ? 128 : kWarp * VW;
  constexpr int PB = kBucket / (kWarp * VW);
  switch ((C + kBucket - 1) / kBucket) {
    case 1:
      return launch_ln_warp<T, VW, 1 * PB>(x, gamma, beta, y, rows, C, eps,
                                           stream);
    case 2:
      return launch_ln_warp<T, VW, 2 * PB>(x, gamma, beta, y, rows, C, eps,
                                           stream);
    case 3:
      return launch_ln_warp<T, VW, 3 * PB>(x, gamma, beta, y, rows, C, eps,
                                           stream);
    case 4:
      return launch_ln_warp<T, VW, 4 * PB>(x, gamma, beta, y, rows, C, eps,
                                           stream);
    default:
      if constexpr (kBucket * 4 >= kMaxWarpC) {
        return;   // unreachable: the entry point refuses C > 1024
      } else {
        switch ((C + kBucket - 1) / kBucket) {
          case 5:
            return launch_ln_warp<T, VW, 5 * PB>(x, gamma, beta, y, rows, C,
                                                 eps, stream);
          case 6:
            return launch_ln_warp<T, VW, 6 * PB>(x, gamma, beta, y, rows, C,
                                                 eps, stream);
          case 7:
            return launch_ln_warp<T, VW, 7 * PB>(x, gamma, beta, y, rows, C,
                                                 eps, stream);
          default:
            return launch_ln_warp<T, VW, 8 * PB>(x, gamma, beta, y, rows, C,
                                                 eps, stream);
        }
      }
  }
}

// Make `device` current for this library's runtime unless it already is:
// the query is a thread-local read, the switch is not.
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return e;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// y = LayerNorm(x) over rows of C on the wrapper's route (LnRoute); a route
// whose conditions fail is refused with cudaErrorInvalidValue, so the
// wrapper and this file cannot disagree.
template <typename T>
int layer_norm(const T* x, const T* gamma, const T* beta, T* y, int rows,
               int C, float eps, int route, int device, void* stream_ptr) {
  constexpr int VW = kVec16<T>;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = C % VW == 0 && aligned16(x) && aligned16(gamma) &&
                   aligned16(beta) && aligned16(y);
  const bool ok = route == kLnLong         ? C > kMaxWarpC
                  : route == kLnWarp       ? C <= kMaxWarpC && vec
                  : route == kLnWarpScalar ? C <= kMaxWarpC
                                           : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  switch (route) {
    case kLnWarp:
      launch_ln_warp_bucket<T, VW>(x, gamma, beta, y, rows, C, eps, stream);
      break;
    case kLnWarpScalar:
      launch_ln_warp_bucket<T, 1>(x, gamma, beta, y, rows, C, eps, stream);
      break;
    default:
      ln_block_kernel<T><<<(unsigned)rows, kRowThreads, 0, stream>>>(
          x, gamma, beta, y, C, eps);
  }
  return (int)cudaGetLastError();
}

// Softmax's 16-bit route codes, as ops/kernels/fused_norm.py
// SOFTMAX_ROUTES gives them.
enum SoftmaxRoute { kSmVec = 0, kSmScalar = 1, kSmLong = 2 };

template <typename T, int G, int NV>
void launch_softmax_vec(const T* x, T* y, int rows, int C,
                        cudaStream_t stream) {
  constexpr long long kRows = kWarpsPerBlock * (kWarp / G) * kVecRows<NV>;
  const unsigned grid = (unsigned)((rows + kRows - 1) / kRows);
  softmax_vec_kernel<T, G, NV><<<grid, kWarpsPerBlock * kWarp, 0, stream>>>(
      x, y, rows, C);
}

// The vec route's instantiation for C's bucket: the fewest lanes (a power
// of two) that hold a row at one vector each, then 2-4 vectors a lane.
template <typename T>
void launch_softmax_vec_bucket(const T* x, T* y, int rows, int C,
                               cudaStream_t stream) {
  const int nvec = C / kVec16<T>;
  if (nvec <= 1) return launch_softmax_vec<T, 1, 1>(x, y, rows, C, stream);
  if (nvec <= 2) return launch_softmax_vec<T, 2, 1>(x, y, rows, C, stream);
  if (nvec <= 4) return launch_softmax_vec<T, 4, 1>(x, y, rows, C, stream);
  if (nvec <= 8) return launch_softmax_vec<T, 8, 1>(x, y, rows, C, stream);
  if (nvec <= 16) return launch_softmax_vec<T, 16, 1>(x, y, rows, C, stream);
  if (nvec <= 32) return launch_softmax_vec<T, 32, 1>(x, y, rows, C, stream);
  if (nvec <= 64) return launch_softmax_vec<T, 32, 2>(x, y, rows, C, stream);
  if (nvec <= 96) return launch_softmax_vec<T, 32, 3>(x, y, rows, C, stream);
  return launch_softmax_vec<T, 32, 4>(x, y, rows, C, stream);
}

// fp32's kernels, and the 16-bit scalar and long routes: a warp a row up
// to 1024 values, a block a row above
template <typename T>
void launch_softmax_rows(const T* x, T* y, int rows, int C,
                         cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * kWarp);
  if (C <= 128) {
    softmax_warp_kernel<T, 4><<<warp_grid(rows), block, 0, stream>>>(
        x, y, rows, C);
  } else if (C <= 256) {
    softmax_warp_kernel<T, 8><<<warp_grid(rows), block, 0, stream>>>(
        x, y, rows, C);
  } else if (C <= 512) {
    softmax_warp_kernel<T, 16><<<warp_grid(rows), block, 0, stream>>>(
        x, y, rows, C);
  } else if (C <= kMaxWarpC) {
    softmax_warp_kernel<T, 32><<<warp_grid(rows), block, 0, stream>>>(
        x, y, rows, C);
  } else {
    softmax_block_kernel<T><<<(unsigned)rows, kRowThreads, 0, stream>>>(
        x, y, C);
  }
}

int softmax_f32(const float* x, float* y, int rows, int C, int device,
                void* stream_ptr) {
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  launch_softmax_rows<float>(x, y, rows, C,
                             static_cast<cudaStream_t>(stream_ptr));
  return (int)cudaGetLastError();
}

// y = softmax(x) over rows of C 16-bit values on the wrapper's route
// (SoftmaxRoute); a route whose conditions fail is refused with
// cudaErrorInvalidValue.
template <typename T>
int softmax_half(const T* x, T* y, int rows, int C, int route, int device,
                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (rows <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = C % kVec16<T> == 0 && aligned16(x) && aligned16(y);
  const bool ok = route == kSmLong     ? C > kMaxWarpC
                  : route == kSmVec    ? C <= kMaxWarpC && vec
                  : route == kSmScalar ? C <= kMaxWarpC
                                       : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  if (route == kSmVec)
    launch_softmax_vec_bucket<T>(x, y, rows, C, stream);
  else
    launch_softmax_rows<T>(x, y, rows, C, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. Each makes `device` current for this
// library's runtime, launches on `stream` (PyTorch's current stream),
// allocates nothing, and returns cudaGetLastError() so that a refused launch
// surfaces in the caller.
//
// LayerNorm: `route` is the wrapper's choice (LnRoute): warp takes C <= 1024
// with C a multiple of the 16-byte vector (4 floats, 8 16-bit values) and
// four 16-byte aligned bases, warp_scalar C <= 1024, and long C > 1024. The
// bf16 entries take x, gamma, beta and y all bf16 (__nv_bfloat16), the f16
// entries all fp16 (__half).
extern "C" int mxtpu_layer_norm_f32(const float* x, const float* gamma,
                                    const float* beta, float* y, int rows,
                                    int C, float eps, int route, int device,
                                    void* stream_ptr) {
  return layer_norm<float>(x, gamma, beta, y, rows, C, eps, route, device,
                           stream_ptr);
}

extern "C" int mxtpu_layer_norm_bf16(const void* x, const void* gamma,
                                     const void* beta, void* y, int rows,
                                     int C, float eps, int route, int device,
                                     void* stream_ptr) {
  using B = __nv_bfloat16;
  return layer_norm<B>(static_cast<const B*>(x), static_cast<const B*>(gamma),
                       static_cast<const B*>(beta), static_cast<B*>(y), rows,
                       C, eps, route, device, stream_ptr);
}

extern "C" int mxtpu_layer_norm_f16(const void* x, const void* gamma,
                                    const void* beta, void* y, int rows,
                                    int C, float eps, int route, int device,
                                    void* stream_ptr) {
  using H = __half;
  return layer_norm<H>(static_cast<const H*>(x), static_cast<const H*>(gamma),
                       static_cast<const H*>(beta), static_cast<H*>(y), rows,
                       C, eps, route, device, stream_ptr);
}

// Softmax: the fp32 entry picks its kernel from C; the bf16 and f16
// entries take `route` (SoftmaxRoute): vec takes C <= 1024 with C % 8 == 0
// and both bases 16-byte aligned, scalar C <= 1024, long C > 1024.
extern "C" int mxtpu_softmax_f32(const float* x, float* y, int rows, int C,
                                 int device, void* stream_ptr) {
  return softmax_f32(x, y, rows, C, device, stream_ptr);
}

extern "C" int mxtpu_softmax_bf16(const void* x, void* y, int rows, int C,
                                  int route, int device, void* stream_ptr) {
  using B = __nv_bfloat16;
  return softmax_half<B>(static_cast<const B*>(x), static_cast<B*>(y), rows,
                         C, route, device, stream_ptr);
}

extern "C" int mxtpu_softmax_f16(const void* x, void* y, int rows, int C,
                                 int route, int device, void* stream_ptr) {
  using H = __half;
  return softmax_half<H>(static_cast<const H*>(x), static_cast<H*>(y), rows,
                         C, route, device, stream_ptr);
}
