// Attention forward with an online softmax (flash attention), fp32, for
// Hopper (sm_90a).
//
// Replaces incubator_mxnet_tpu/ops/pallas/flash_attention.py: _fwd_kernel
// (reached through _fwd_call, _flash_core and flash_attention).
//
// What bounds it on the H100: operations. At (B*H, T, D) = (96, 512, 64) the
// two products take 4 * BH * T * T * D = 6.4 GFLOP against about 50 MB of q,
// k, v and out: some 130 operations per byte. This kernel multiplies in fp32
// on the CUDA cores (67 TFLOP/s), so its bound there is about 0.1 ms; the
// bytes alone would take 0.015 ms.
//
// What the design does about it: one block per (64-row Q tile, b*h), eight
// warps of eight query rows each. The block walks the 64-key K/V tiles in
// order, staged in shared memory, so each K/V tile is read from device
// memory once per Q tile and the T x T scores never leave the SM. A lane
// scores two keys for each of its warp's eight rows from float4 reads of Q
// (a broadcast) and of K (rows padded by 4 floats, so the reads do not
// conflict); it then updates the running max m, sum l and the output
// accumulator, all in registers, writes its probabilities to the warp's rows
// of a shared P tile, and accumulates P.V with two (or D / 32) output columns
// per lane, reading V from shared memory without conflicts. Tensor cores
// (wgmma, with TMA feeding the tiles) are later work.
//
// Semantics follow the TPU kernel: the additive per-key bias (kv_mask as
// where(live, 0, -1e30), plus a learned kv_bias) is added to the scaled
// scores; causal masking replaces scores above the diagonal by -1e30 and
// skips K tiles that lie wholly above it; a query row whose running max stays
// at or below -0.5e30 (all its keys masked) gives exact zeros and lse = 0.
// Any T: positions past T in the last Q and K tiles are masked out. lse is
// emitted as (B*H, T), without the TPU's 8-sublane replication.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlockQ / kWarps;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <int D>
struct Tile {
  static constexpr int kKStride = D + 4;   // padded K row (floats)
  static constexpr int kQ = kBlockQ * D;
  static constexpr int kK = kBlockK * kKStride;
  static constexpr int kV = kBlockK * D;
  static constexpr int kP = kBlockQ * kBlockK;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kK + kV + kP);
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int T,
                 float scale, int causal) {
  constexpr int KS = Tile<D>::kKStride;
  constexpr int D4 = D / 4;
  constexpr int DV = D / 32;   // output columns per lane

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + Tile<D>::kQ;
  float* Vs = Ks + Tile<D>::kK;
  float* Ps = Vs + Tile<D>::kV;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int row0 = (tid / 32) * kRowsPerWarp;   // this warp's first tile row
  const int q0 = blockIdx.x * kBlockQ;
  const long long bh = blockIdx.y;
  const long long base = bh * T * D;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  // Q tile, zero past T
  for (int i = tid; i < kBlockQ * D4; i += kThreads) {
    const int r = i / D4, c4 = i % D4;
    float4 val = zero4;
    if (q0 + r < T)
      val = reinterpret_cast<const float4*>(q + base + (long long)(q0 + r) * D)[c4];
    reinterpret_cast<float4*>(Qs + r * D)[c4] = val;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DV];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + kBlockQ, T) - 1;
  const int n_tiles = (T + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    if (causal && k0 > q_last) break;   // uniform across the block
    __syncthreads();                     // the previous tile is consumed
    for (int i = tid; i < kBlockK * D4; i += kThreads) {
      const int r = i / D4, c4 = i % D4;
      float4 kv = zero4, vv = zero4;
      if (k0 + r < T) {
        const long long off = base + (long long)(k0 + r) * D;
        kv = reinterpret_cast<const float4*>(k + off)[c4];
        vv = reinterpret_cast<const float4*>(v + off)[c4];
      }
      reinterpret_cast<float4*>(Ks + r * KS)[c4] = kv;
      reinterpret_cast<float4*>(Vs + r * D)[c4] = vv;
    }
    __syncthreads();

    // scores for keys k0 + lane and k0 + lane + 32
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    const float4* ka = reinterpret_cast<const float4*>(Ks + lane * KS);
    const float4* kb = reinterpret_cast<const float4*>(Ks + (lane + 32) * KS);
#pragma unroll 4
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 a = ka[d4];
      const float4 b = kb[d4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qa = reinterpret_cast<const float4*>(Qs + (row0 + r) * D)[d4];
        s[r][0] = dot4(qa, a, s[r][0]);
        s[r][1] = dot4(qa, b, s[r][1]);
      }
    }

    const int key_a = k0 + lane, key_b = k0 + lane + 32;
    const bool in_a = key_a < T, in_b = key_b < T;
    float bias_a = 0.f, bias_b = 0.f;
    if (bias != nullptr) {
      if (in_a) bias_a = bias[bh * T + key_a];
      if (in_b) bias_b = bias[bh * T + key_b];
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + row0 + r;
      float sa = s[r][0] * scale + bias_a;
      float sb = s[r][1] * scale + bias_b;
      if (causal) {
        if (key_a > qi) sa = kNegInf;
        if (key_b > qi) sb = kNegInf;
      }
      if (!in_a) sa = -INFINITY;
      if (!in_b) sb = -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(sa, sb)));
      const float pa = in_a ? expf(sa - m_new) : 0.f;
      const float pb = in_b ? expf(sb - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pa + pb);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[r][c] *= alpha;
      Ps[(row0 + r) * kBlockK + lane] = pa;
      Ps[(row0 + r) * kBlockK + lane + 32] = pb;
    }
    __syncwarp();

    const int kn = min(kBlockK, T - k0);
    for (int j = 0; j < kn; ++j) {
      float vv[DV];
#pragma unroll
      for (int c = 0; c < DV; ++c) vv[c] = Vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = Ps[(row0 + r) * kBlockK + j];
#pragma unroll
        for (int c = 0; c < DV; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
    __syncwarp();   // P is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= T) continue;
    const bool dead = m[r] <= 0.5f * kNegInf;
    const float l_safe = fmaxf(l[r], 1e-30f);
    float* o = out + base + (long long)qi * D;
#pragma unroll
    for (int c = 0; c < DV; ++c)
      o[lane + 32 * c] = dead ? 0.f : acc[r][c] / l_safe;
    if (lane == 0) lse[bh * T + qi] = dead ? 0.f : m[r] + logf(l_safe);
  }
}

constexpr int kMaxDevices = 64;

// Above 48 KB a block's shared memory must be asked for explicitly. The
// setting holds per device and instantiation, so it is made on the first
// launch of each and remembered (a device numbered past kMaxDevices asks on
// every launch).
template <int D>
cudaError_t allow_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && done[device].load(std::memory_order_acquire))
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Tile<D>::kBytes);
  if (e == cudaSuccess && known)
    done[device].store(true, std::memory_order_release);
  return e;
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* out, float* lse, int bh, int T, float scale, int causal,
           int device, cudaStream_t stream) {
  const cudaError_t e = allow_smem<D>(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((T + kBlockQ - 1) / kBlockQ), (unsigned)bh);
  flash_fwd_kernel<D><<<grid, kThreads, Tile<D>::kBytes, stream>>>(
      q, k, v, bias, out, lse, T, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. q, k, v, out: (bh, T, D) contiguous fp32,
// 16-byte aligned; bias: (bh, T) fp32 or null; lse: (bh, T) fp32. D is 32, 64
// or 128. Makes `device` current for this library's runtime, launches on
// `stream`, allocates nothing, and returns cudaGetLastError().
extern "C" int mxtpu_flash_attention_fwd_f32(
    const float* q, const float* k, const float* v, const float* bias,
    float* out, float* lse, int bh, int T, int D, float scale, int causal,
    int device, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bh <= 0 || bh > 65535 || T <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  switch (D) {
    case 32:
      return launch<32>(q, k, v, bias, out, lse, bh, T, scale, causal, device,
                        stream);
    case 64:
      return launch<64>(q, k, v, bias, out, lse, bh, T, scale, causal, device,
                        stream);
    case 128:
      return launch<128>(q, k, v, bias, out, lse, bh, T, scale, causal,
                         device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
