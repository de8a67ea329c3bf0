// ShardedTrainer's fused optimizer updates over many fp32 tensors in one
// launch (a multi-tensor apply), for Hopper (sm_90a): Adam / AdamW and SGD
// with momentum.
//
// Replaces incubator_mxnet_tpu/ops/pallas/fused_optim.py: _trainer_adam_kernel
// (reached through multi_trainer_adam) and _sgd_mom_kernel as
// multi_trainer_sgd_mom calls it (rescale 1, clip off), both from
// parallel/trainer.py _apply_fused.
//
// What bounds them on the H100: bytes. Adam reads w, g, m, v and writes w,
// m, v: 28 bytes an element for about 15 operations. BERT-base pretraining
// updates 110,106,428 elements in 206 tensors, 3.08 GB, 0.92 ms at
// 3.35 TB/s. SGD with momentum reads w, g, m and writes w, m: 20 bytes for
// 6 operations. ResNet-50 v1 updates 25,575,912 elements in 193 tensors,
// 511.5 MB, 0.153 ms.
//
// What the design does about it: the TPU kernels update one flat buffer
// that the caller had packed from every tensor and split again afterwards,
// two extra copies of all the state. Here a small device table holds each
// tensor's pointers, its length n and its first chunk, and the kernel
// updates the tensors where they lie, in place: block b finds its tensor by
// a binary search over the tensors' first chunks and updates one chunk of
// kChunk elements with float4 loads and stores (scalar where a tensor's
// pointers are not 16-byte aligned, and for the last n % 4 elements), so
// every byte moves once.
//
// Arithmetic: the TPU kernels', in their order, with every operation
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: no contraction into FMA), so each update equals its plain
// PyTorch version (multi_trainer_adam_reference,
// multi_trainer_sgd_mom_reference) bitwise. The host passes the scalars as
// the f32 values those versions use.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 32768;   // elements a block updates
constexpr int kAdamFields = 6;        // w, g, m, v, n, first chunk
constexpr int kSgdFields = 5;         // w, g, m, n, first chunk

// The row of the last tensor whose first chunk (the row's last field) is at
// or before this block, found by thread 0 and shared with the block.
template <int kFields>
__device__ __forceinline__ const long long* find_row(const long long* table,
                                                     int n_tensors) {
  __shared__ int tensor;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n_tensors - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid * kFields + kFields - 1] <= (long long)blockIdx.x) lo = mid;
      else hi = mid - 1;
    }
    tensor = lo;
  }
  __syncthreads();
  return table + tensor * kFields;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

struct AdamScalars {
  float lr, wd, b1, b2, one_minus_b1, one_minus_b2, bias1, bias2, eps, lrwd;
};

template <bool kAdamW>
__device__ __forceinline__ void update(float& w, float g, float& m, float& v,
                                       const AdamScalars& s) {
  if (!kAdamW) g = __fadd_rn(g, __fmul_rn(s.wd, w));
  m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.one_minus_b2, g), g));
  const float mhat = __fdiv_rn(m, s.bias1);
  const float vhat = __fdiv_rn(v, s.bias2);
  float upd = __fdiv_rn(__fmul_rn(s.lr, mhat), __fadd_rn(__fsqrt_rn(vhat), s.eps));
  if (kAdamW) upd = __fadd_rn(upd, __fmul_rn(s.lrwd, w));
  w = __fsub_rn(w, upd);
}

template <bool kAdamW>
__global__ void __launch_bounds__(kThreads)
trainer_adam_kernel(const long long* __restrict__ table, int n_tensors,
                    AdamScalars s) {
  const long long* e = find_row<kAdamFields>(table, n_tensors);
  float* w = reinterpret_cast<float*>(e[0]);
  const float* g = reinterpret_cast<const float*>(e[1]);
  float* m = reinterpret_cast<float*>(e[2]);
  float* v = reinterpret_cast<float*>(e[3]);
  const long long start = ((long long)blockIdx.x - e[5]) * kChunk;
  const long long len = min(kChunk, e[4] - start);
  w += start;
  g += start;
  m += start;
  v += start;

  long long done = 0;
  if (aligned16(w, g, m, v)) {
    const long long n4 = len / 4;
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      float4 wv = w4[i], mv = m4[i], vv = v4[i];
      const float4 gv = g4[i];
      update<kAdamW>(wv.x, gv.x, mv.x, vv.x, s);
      update<kAdamW>(wv.y, gv.y, mv.y, vv.y, s);
      update<kAdamW>(wv.z, gv.z, mv.z, vv.z, s);
      update<kAdamW>(wv.w, gv.w, mv.w, vv.w, s);
      w4[i] = wv;
      m4[i] = mv;
      v4[i] = vv;
    }
    done = n4 * 4;
  }
  for (long long i = done + threadIdx.x; i < len; i += kThreads) {
    float wi = w[i], mi = m[i], vi = v[i];
    update<kAdamW>(wi, g[i], mi, vi, s);
    w[i] = wi;
    m[i] = mi;
    v[i] = vi;
  }
}

// _sgd_mom_kernel with rescale 1 and clip off (multiplying by 1 and the
// untaken clip change no bit): mom = momentum * mom - lr * (g + wd * w),
// then w = w + mom.
__device__ __forceinline__ void sgd_mom(float& w, float g, float& m,
                                        float lr, float wd, float momentum) {
  m = __fsub_rn(__fmul_rn(momentum, m),
                __fmul_rn(lr, __fadd_rn(g, __fmul_rn(wd, w))));
  w = __fadd_rn(w, m);
}

__global__ void __launch_bounds__(kThreads)
trainer_sgd_mom_kernel(const long long* __restrict__ table, int n_tensors,
                       float lr, float wd, float momentum) {
  const long long* e = find_row<kSgdFields>(table, n_tensors);
  float* w = reinterpret_cast<float*>(e[0]);
  const float* g = reinterpret_cast<const float*>(e[1]);
  float* m = reinterpret_cast<float*>(e[2]);
  const long long start = ((long long)blockIdx.x - e[4]) * kChunk;
  const long long len = min(kChunk, e[3] - start);
  w += start;
  g += start;
  m += start;

  long long done = 0;
  if (aligned16(w, g, m, m)) {
    const long long n4 = len / 4;
    float4* w4 = reinterpret_cast<float4*>(w);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      float4 wv = w4[i], mv = m4[i];
      const float4 gv = g4[i];
      sgd_mom(wv.x, gv.x, mv.x, lr, wd, momentum);
      sgd_mom(wv.y, gv.y, mv.y, lr, wd, momentum);
      sgd_mom(wv.z, gv.z, mv.z, lr, wd, momentum);
      sgd_mom(wv.w, gv.w, mv.w, lr, wd, momentum);
      w4[i] = wv;
      m4[i] = mv;
    }
    done = n4 * 4;
  }
  for (long long i = done + threadIdx.x; i < len; i += kThreads) {
    float wi = w[i], mi = m[i];
    sgd_mom(wi, g[i], mi, lr, wd, momentum);
    w[i] = wi;
    m[i] = mi;
  }
}

}  // namespace

// C entry point, bound with ctypes. `table`: (n_tensors, 6) int64 on the
// device, one row (w, g, m, v, n, first chunk) per tensor of n > 0 fp32
// elements, first chunks ascending from 0 by ceil(n / 32768); n_chunks is
// the total. The scalars are the f32 values of the plain version: lr, wd,
// b1, b2, 1 - b1, 1 - b2, 1 - b1^t, 1 - b2^t, eps and lr * wd. Updates w, m
// and v in place on `stream`, allocates nothing, and returns
// cudaGetLastError().
extern "C" int mxtpu_trainer_adam_f32(
    const long long* table, int n_tensors, int n_chunks, float lr, float wd,
    float b1, float b2, float one_minus_b1, float one_minus_b2, float bias1,
    float bias2, float eps, float lrwd, int adamw, int device,
    void* stream_ptr) {
  if (n_tensors <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const AdamScalars s{lr, wd, b1, b2, one_minus_b1, one_minus_b2,
                      bias1, bias2, eps, lrwd};
  if (adamw)
    trainer_adam_kernel<true><<<n_chunks, kThreads, 0, stream>>>(
        table, n_tensors, s);
  else
    trainer_adam_kernel<false><<<n_chunks, kThreads, 0, stream>>>(
        table, n_tensors, s);
  return (int)cudaGetLastError();
}

// C entry point, bound with ctypes. `table`: (n_tensors, 5) int64 on the
// device, one row (w, g, mom, n, first chunk) per tensor of n > 0 fp32
// elements, first chunks ascending from 0 by ceil(n / 32768); n_chunks is
// the total. lr, wd and momentum are the f32 values of the plain version.
// Updates w and mom in place on `stream`, allocates nothing, and returns
// cudaGetLastError().
extern "C" int mxtpu_trainer_sgd_mom_f32(const long long* table,
                                         int n_tensors, int n_chunks,
                                         float lr, float wd, float momentum,
                                         int device, void* stream_ptr) {
  if (n_tensors <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  trainer_sgd_mom_kernel<<<n_chunks, kThreads, 0,
                           static_cast<cudaStream_t>(stream_ptr)>>>(
      table, n_tensors, lr, wd, momentum);
  return (int)cudaGetLastError();
}
