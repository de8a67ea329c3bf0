// Fused optimizer updates over many tensors in one launch (a multi-tensor
// apply), for Hopper (sm_90a): ShardedTrainer's Adam / AdamW and SGD with
// momentum (fp32), and the eager seam's flat SGD-momentum, Adam and AdamW
// with their rescale / clip prologue (fp32, bf16 and fp16).
//
// Replaces incubator_mxnet_tpu/ops/pallas/fused_optim.py:
// - _trainer_adam_kernel (reached through multi_trainer_adam, from
//   parallel/trainer.py _apply_fused);
// - _sgd_mom_kernel, both as multi_trainer_sgd_mom calls it (rescale 1, clip
//   off) and as fused_sgd_mom_flat calls it (the eager seam,
//   ops/_optim_kernels.py _multi_sgd_mom_update): one kernel, the prologue
//   is a bitwise no-op at rescale 1 with the clip off;
// - _adam_kernel and _adamw_kernel through _launch (fused_adam_flat,
//   fused_adamw_flat, from _multi_adam_update / _multi_adamw_update);
// - the same three flat kernels on bf16 and on fp16 buffers (dt = bfloat16
//   or float16 there).
//
// What bounds them on the H100: bytes. Adam reads w, g, m, v and writes w,
// m, v: 28 bytes an element for about 15 operations. SGD with momentum
// reads w, g, m and writes w, m: 20 bytes for about 8 operations. ResNet-50
// v1 updates 25,575,912 elements in 193 tensors: 511.5 MB (0.153 ms at
// 3.35 TB/s) for SGD, 716.1 MB (0.214 ms) for Adam; BERT-base pretraining
// 110,106,428 elements in 206 tensors, 3.08 GB (0.92 ms) for Adam. In bf16
// and fp16 every byte count halves: 10 and 14 bytes an element, 0.076 and
// 0.107 ms for ResNet-50's tensors.
//
// What the design does about it: the TPU kernels update one flat buffer
// that the caller had packed from every tensor (flatten_group) and split
// again afterwards (split_group), two extra copies of all the state. Here a
// small device table holds each tensor's pointers, its length n and its
// first chunk, and the kernel updates the tensors where they lie, in place:
// block b finds its tensor by a binary search over the tensors' first chunks
// and updates one chunk of kChunk elements with 16-byte loads and stores (4
// fp32 or 8 bf16 values; scalar where a tensor's pointers are not 16-byte
// aligned, and for the last n % 4 or n % 8 elements), so every byte moves
// once. A 16-bit storage type holds 8 elements a 16-byte access.
//
// Arithmetic: the TPU kernels', in their order, with every operation
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: no contraction into FMA), so each update equals its plain
// PyTorch version bitwise. The host passes the scalars as the f32 values
// those versions use; the t-dependent ones (Adam's coef, AdamW's 1 - b^t)
// are computed once on the host. The gradient clip lets a NaN through, as
// jnp.clip and torch.clamp do (fminf / fmaxf would drop it).
//
// bf16: the arithmetic is in f32 and every operation's result is rounded to
// bf16 (__float2bfloat16_rn) where the TPU kernel's bf16 arithmetic rounds
// it, so the update equals the per-parameter rules of
// ops/_optim_kernels.py on bf16 tensors bit for bit. The host passes every
// scalar already rounded to bf16, as the TPU kernel's `.astype(dt)` rounds
// it; the rounding policy is a template argument, the identity for fp32, so
// the fp32 instantiations compute what they computed before.
//
// fp16: the bf16 arithmetic on another policy (__float2half_rn,
// __half2float): one rounding to fp16 per operation, never a contraction of
// a product into the add after it. (XLA on a CPU with native fp16 FMA
// contracts there, with one rounding for the pair; the JAX source asks for
// an fp16 result of each operation, which this computes, and the plain
// PyTorch version can express no single-rounded fp16 FMA; ROADMAP Queue 3
// item 14.) fp16's range is narrow: a conversion past 65504 gives inf (no
// .satfinite, no clamp), so Adam's g * g overflows to inf for |g'| > 256,
// as the JAX rules do. Results below 2^-14 stay fp16 subnormals: the build
// flushes nothing (no -ftz, no --use_fast_math). eps = 1e-8 rounds to 0 in
// fp16, so Adam divides by sqrt(v) + 0 there, as the JAX rules do.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 32768;   // elements a block updates

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

// Storage type and rounding of each operation's f32 result: none for fp32,
// to the nearest bf16 or fp16 (ties to even) for bf16 and fp16.
struct F32 {
  using T = float;
  static __device__ __forceinline__ float r(float x) { return x; }
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

struct BF16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

struct F16 {
  using T = __half;
  static __device__ __forceinline__ float r(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __forceinline__ float load(__half x) {
    return __half2float(x);
  }
  static __device__ __forceinline__ __half store(float x) {
    return __float2half_rn(x);
  }
};

// One correctly rounded operation of the storage type each.
template <class R>
__device__ __forceinline__ float op_mul(float a, float b) {
  return R::r(__fmul_rn(a, b));
}
template <class R>
__device__ __forceinline__ float op_add(float a, float b) {
  return R::r(__fadd_rn(a, b));
}
template <class R>
__device__ __forceinline__ float op_sub(float a, float b) {
  return R::r(__fsub_rn(a, b));
}
template <class R>
__device__ __forceinline__ float op_div(float a, float b) {
  return R::r(__fdiv_rn(a, b));
}
template <class R>
__device__ __forceinline__ float op_sqrt(float a) {
  return R::r(__fsqrt_rn(a));
}

// The eager kernels' prologue: g * rescale, then the clip to [-clip, clip]
// when clip > 0. A NaN gradient fails both comparisons and passes through.
template <class R>
__device__ __forceinline__ float prologue(float g, float rescale,
                                          float clip) {
  g = op_mul<R>(g, rescale);
  if (clip > 0.f) g = g < -clip ? -clip : (g > clip ? clip : g);
  return g;
}

// _sgd_mom_kernel: mom = momentum * mom - lr * (g + wd * w), w = w + mom.
template <class R>
struct SgdMom {
  float lr, wd, momentum, rescale, clip;
  __device__ __forceinline__ void operator()(float& w, float g, float& m,
                                             float&) const {
    g = prologue<R>(g, rescale, clip);
    m = op_sub<R>(op_mul<R>(momentum, m),
                  op_mul<R>(lr, op_add<R>(g, op_mul<R>(wd, w))));
    w = op_add<R>(w, m);
  }
};

// _adam_kernel: g += wd * w; m, v moved; w -= coef * m / (sqrt(v) + eps)
// with coef = lr * sqrt(1 - b2^t) / (1 - b1^t) from the host.
template <class R>
struct FlatAdam {
  float coef, wd, b1, b2, one_minus_b1, one_minus_b2, eps, rescale, clip;
  __device__ __forceinline__ void operator()(float& w, float g, float& m,
                                             float& v) const {
    g = op_add<R>(prologue<R>(g, rescale, clip), op_mul<R>(wd, w));
    m = op_add<R>(op_mul<R>(b1, m), op_mul<R>(one_minus_b1, g));
    v = op_add<R>(op_mul<R>(b2, v),
                  op_mul<R>(op_mul<R>(one_minus_b2, g), g));
    w = op_sub<R>(w, op_div<R>(op_mul<R>(coef, m),
                               op_add<R>(op_sqrt<R>(v), eps)));
  }
};

// _adamw_kernel: m, v moved by the clipped gradient; mhat = m / (1 - b1^t),
// vhat = v / (1 - b2^t); w -= eta * (lr * mhat / (sqrt(vhat) + eps) + wd * w).
template <class R>
struct FlatAdamW {
  float lr, wd, eta, b1, b2, one_minus_b1, one_minus_b2, bias1, bias2, eps,
      rescale, clip;
  __device__ __forceinline__ void operator()(float& w, float g, float& m,
                                             float& v) const {
    g = prologue<R>(g, rescale, clip);
    m = op_add<R>(op_mul<R>(b1, m), op_mul<R>(one_minus_b1, g));
    v = op_add<R>(op_mul<R>(b2, v),
                  op_mul<R>(op_mul<R>(one_minus_b2, g), g));
    const float mhat = op_div<R>(m, bias1);
    const float vhat = op_div<R>(v, bias2);
    const float upd = op_div<R>(op_mul<R>(lr, mhat),
                                op_add<R>(op_sqrt<R>(vhat), eps));
    w = op_sub<R>(w, op_mul<R>(eta, op_add<R>(upd, op_mul<R>(wd, w))));
  }
};

// _trainer_adam_kernel: Adam through mhat / vhat; Adam adds wd * w to g,
// AdamW adds lr * wd * w to the update (lrwd rounded once on the host).
template <bool kAdamW>
struct TrainerAdam {
  float lr, wd, b1, b2, one_minus_b1, one_minus_b2, bias1, bias2, eps, lrwd;
  __device__ __forceinline__ void operator()(float& w, float g, float& m,
                                             float& v) const {
    if (!kAdamW) g = __fadd_rn(g, __fmul_rn(wd, w));
    m = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(one_minus_b1, g));
    v = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(one_minus_b2, g), g));
    const float mhat = __fdiv_rn(m, bias1);
    const float vhat = __fdiv_rn(v, bias2);
    float upd = __fdiv_rn(__fmul_rn(lr, mhat), __fadd_rn(__fsqrt_rn(vhat), eps));
    if (kAdamW) upd = __fadd_rn(upd, __fmul_rn(lrwd, w));
    w = __fsub_rn(w, upd);
  }
};

// One chunk of one tensor: rows are (w, g, state 0 [, state 1], n, first
// chunk); `op` updates one element of w and its states from g, in f32; R
// names the storage type and its rounding.
template <int kStates, class Op, class R>
__global__ void __launch_bounds__(kThreads)
multi_tensor_kernel(const long long* __restrict__ table, int n_tensors,
                    Op op) {
  using T = typename R::T;
  constexpr int kVec = 16 / sizeof(T);   // elements of one 16-byte access
  constexpr int kFields = 2 + kStates + 2;
  const long long* e = find_row<kFields>(table, n_tensors);
  T* w = reinterpret_cast<T*>(e[0]);
  const T* g = reinterpret_cast<const T*>(e[1]);
  T* m = reinterpret_cast<T*>(e[2]);
  T* v = kStates > 1 ? reinterpret_cast<T*>(e[3]) : m;
  const long long start = ((long long)blockIdx.x - e[kFields - 1]) * kChunk;
  const long long len = min(kChunk, e[kFields - 2] - start);
  w += start;
  g += start;
  m += start;
  v += start;

  long long done = 0;
  if (aligned16(w, g, m, v)) {
    const long long nv = len / kVec;
    uint4* w4 = reinterpret_cast<uint4*>(w);
    const uint4* g4 = reinterpret_cast<const uint4*>(g);
    uint4* m4 = reinterpret_cast<uint4*>(m);
    uint4* v4 = reinterpret_cast<uint4*>(v);
    for (long long i = threadIdx.x; i < nv; i += kThreads) {
      uint4 wr = w4[i], mr = m4[i], vr = mr;
      if (kStates > 1) vr = v4[i];
      const uint4 gr = g4[i];
      T* we = reinterpret_cast<T*>(&wr);
      T* me = reinterpret_cast<T*>(&mr);
      T* ve = reinterpret_cast<T*>(&vr);
      const T* ge = reinterpret_cast<const T*>(&gr);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        float wj = R::load(we[j]), mj = R::load(me[j]);
        float vj = kStates > 1 ? R::load(ve[j]) : mj;
        op(wj, R::load(ge[j]), mj, vj);
        we[j] = R::store(wj);
        me[j] = R::store(mj);
        if (kStates > 1) ve[j] = R::store(vj);
      }
      w4[i] = wr;
      m4[i] = mr;
      if (kStates > 1) v4[i] = vr;
    }
    done = nv * kVec;
  }
  for (long long i = done + threadIdx.x; i < len; i += kThreads) {
    float wi = R::load(w[i]), mi = R::load(m[i]);
    float vi = kStates > 1 ? R::load(v[i]) : mi;
    op(wi, R::load(g[i]), mi, vi);
    w[i] = R::store(wi);
    m[i] = R::store(mi);
    if (kStates > 1) v[i] = R::store(vi);
  }
}

template <int kStates, class R = F32, class Op>
int launch(const long long* table, int n_tensors, int n_chunks, const Op& op,
           int device, void* stream_ptr) {
  if (n_tensors <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  multi_tensor_kernel<kStates, Op, R>
      <<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
          table, n_tensors, op);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. `table`: (n_tensors, 4 + states) int64
// on the device, one row (w, g, state..., n, first chunk) per tensor of
// n > 0 elements (fp32, or bf16 / fp16 for the *_bf16 / *_f16 entries),
// first chunks ascending from 0 by ceil(n / 32768); n_chunks is the total.
// The scalars are the values of the plain versions: f32, or f32 values that
// bf16 (fp16) holds exactly for the *_bf16 (*_f16) entries. Each updates w
// and its states in place on `stream`, allocates nothing, and returns
// cudaGetLastError().

// rows (w, g, m, v, n, first chunk); scalars lr, wd, b1, b2, 1 - b1, 1 - b2,
// 1 - b1^t, 1 - b2^t, eps and lr * wd.
extern "C" int mxtpu_trainer_adam_f32(
    const long long* table, int n_tensors, int n_chunks, float lr, float wd,
    float b1, float b2, float one_minus_b1, float one_minus_b2, float bias1,
    float bias2, float eps, float lrwd, int adamw, int device,
    void* stream_ptr) {
  if (adamw)
    return launch<2>(table, n_tensors, n_chunks,
                     TrainerAdam<true>{lr, wd, b1, b2, one_minus_b1,
                                       one_minus_b2, bias1, bias2, eps, lrwd},
                     device, stream_ptr);
  return launch<2>(table, n_tensors, n_chunks,
                   TrainerAdam<false>{lr, wd, b1, b2, one_minus_b1,
                                      one_minus_b2, bias1, bias2, eps, lrwd},
                   device, stream_ptr);
}

// rows (w, g, mom, n, first chunk); scalars lr, wd, momentum, rescale and
// clip (clip <= 0: no clip). The trainer calls it with rescale 1, clip -1.
extern "C" int mxtpu_trainer_sgd_mom_f32(const long long* table,
                                         int n_tensors, int n_chunks,
                                         float lr, float wd, float momentum,
                                         float rescale, float clip,
                                         int device, void* stream_ptr) {
  return launch<1>(table, n_tensors, n_chunks,
                   SgdMom<F32>{lr, wd, momentum, rescale, clip}, device,
                   stream_ptr);
}

// rows (w, g, m, v, n, first chunk); scalars coef, wd, b1, b2, 1 - b1,
// 1 - b2, eps, rescale and clip.
extern "C" int mxtpu_flat_adam_f32(const long long* table, int n_tensors,
                                   int n_chunks, float coef, float wd,
                                   float b1, float b2, float one_minus_b1,
                                   float one_minus_b2, float eps,
                                   float rescale, float clip, int device,
                                   void* stream_ptr) {
  return launch<2>(table, n_tensors, n_chunks,
                   FlatAdam<F32>{coef, wd, b1, b2, one_minus_b1,
                                 one_minus_b2, eps, rescale, clip},
                   device, stream_ptr);
}

// rows (w, g, m, v, n, first chunk); scalars lr, wd, eta, b1, b2, 1 - b1,
// 1 - b2, 1 - b1^t, 1 - b2^t, eps, rescale and clip.
extern "C" int mxtpu_flat_adamw_f32(
    const long long* table, int n_tensors, int n_chunks, float lr, float wd,
    float eta, float b1, float b2, float one_minus_b1, float one_minus_b2,
    float bias1, float bias2, float eps, float rescale, float clip,
    int device, void* stream_ptr) {
  return launch<2>(table, n_tensors, n_chunks,
                   FlatAdamW<F32>{lr, wd, eta, b1, b2, one_minus_b1,
                                  one_minus_b2, bias1, bias2, eps, rescale,
                                  clip},
                   device, stream_ptr);
}

// The bf16 and fp16 flavours of the three eager entries above, with their
// rows and scalars (each scalar rounded to the storage type on the host;
// clip -1 when off): one body each, on the storage type's policy R.
namespace {

template <class R>
int flat_sgd_mom(const long long* table, int n_tensors, int n_chunks,
                 float lr, float wd, float momentum, float rescale,
                 float clip, int device, void* stream_ptr) {
  return launch<1, R>(table, n_tensors, n_chunks,
                      SgdMom<R>{lr, wd, momentum, rescale, clip}, device,
                      stream_ptr);
}

template <class R>
int flat_adam(const long long* table, int n_tensors, int n_chunks,
              float coef, float wd, float b1, float b2, float one_minus_b1,
              float one_minus_b2, float eps, float rescale, float clip,
              int device, void* stream_ptr) {
  return launch<2, R>(table, n_tensors, n_chunks,
                      FlatAdam<R>{coef, wd, b1, b2, one_minus_b1,
                                  one_minus_b2, eps, rescale, clip},
                      device, stream_ptr);
}

template <class R>
int flat_adamw(const long long* table, int n_tensors, int n_chunks,
               float lr, float wd, float eta, float b1, float b2,
               float one_minus_b1, float one_minus_b2, float bias1,
               float bias2, float eps, float rescale, float clip, int device,
               void* stream_ptr) {
  return launch<2, R>(table, n_tensors, n_chunks,
                      FlatAdamW<R>{lr, wd, eta, b1, b2, one_minus_b1,
                                   one_minus_b2, bias1, bias2, eps, rescale,
                                   clip},
                      device, stream_ptr);
}

}  // namespace

#define MXTPU_FLAT_ENTRIES(SUFFIX, R)                                        \
  extern "C" int mxtpu_flat_sgd_mom_##SUFFIX(                                \
      const long long* table, int n_tensors, int n_chunks, float lr,         \
      float wd, float momentum, float rescale, float clip, int device,       \
      void* stream_ptr) {                                                    \
    return flat_sgd_mom<R>(table, n_tensors, n_chunks, lr, wd, momentum,     \
                           rescale, clip, device, stream_ptr);               \
  }                                                                          \
  extern "C" int mxtpu_flat_adam_##SUFFIX(                                   \
      const long long* table, int n_tensors, int n_chunks, float coef,       \
      float wd, float b1, float b2, float one_minus_b1, float one_minus_b2,  \
      float eps, float rescale, float clip, int device, void* stream_ptr) {  \
    return flat_adam<R>(table, n_tensors, n_chunks, coef, wd, b1, b2,        \
                        one_minus_b1, one_minus_b2, eps, rescale, clip,      \
                        device, stream_ptr);                                 \
  }                                                                          \
  extern "C" int mxtpu_flat_adamw_##SUFFIX(                                  \
      const long long* table, int n_tensors, int n_chunks, float lr,         \
      float wd, float eta, float b1, float b2, float one_minus_b1,           \
      float one_minus_b2, float bias1, float bias2, float eps,               \
      float rescale, float clip, int device, void* stream_ptr) {             \
    return flat_adamw<R>(table, n_tensors, n_chunks, lr, wd, eta, b1, b2,    \
                         one_minus_b1, one_minus_b2, bias1, bias2, eps,      \
                         rescale, clip, device, stream_ptr);                 \
  }

MXTPU_FLAT_ENTRIES(bf16, BF16)
MXTPU_FLAT_ENTRIES(f16, F16)
