// Attention backward from the saved log-sum-exp (flash attention), fp32, for
// Hopper (sm_90a): one kernel for dQ and one for dK and dV.
//
// Replaces incubator_mxnet_tpu/ops/pallas/flash_attention.py: _dq_kernel and
// _dkv_kernel, the latter with and without has_dbias (reached through
// _bwd_call and the custom VJP _flash_bwd of _flash_core). delta =
// rowsum(dO * O) is one PyTorch reduction in the wrapper, as it is one jnp
// reduction in _bwd_call.
//
// What bounds it on the H100: operations. The gradient needs five T x T x D
// products per (batch, head): S = Q K^T, dP = dO V^T, dQ = dS K, dK = dS^T Q
// and dV = P^T dO, 10 * T * T * D operations, against some 7 * T * D * 4 bytes
// of q, k, v, out, dO, dq, dk, dv. At (B*H, T, D) = (96, 512, 64) that is
// 16.1 GFLOP, 0.24 ms at the 67 TFLOP/s of fp32 on the CUDA cores, while the
// bytes would take 0.03 ms.
//
// What the design does about it: the JAX split. The dQ kernel gives one
// block to each (64-row Q tile, b*h); it keeps the Q and dO tiles in shared
// memory and walks the 64-key K/V tiles, recomputing P = exp(S - lse) and
// dP, forming dS = P * (dP - delta) * scale in registers, and accumulating
// dQ += dS K with the accumulator in registers. The dK/dV kernel gives one
// block to each (64-key K tile, b*h), keeps the K and V tiles and walks the
// Q tiles, accumulating dV += P^T dO and dK += dS^T Q in registers. Both
// recompute S and dP, so together they do seven products where five would
// do; in exchange neither needs atomics or a second pass. The layout is the
// forward kernel's: eight warps of eight rows, a lane scores two columns
// from float4 reads of the warp's (broadcast) row and of its padded column
// rows, writes them to a shared 64 x 64 tile, and accumulates D / 32 output
// columns per lane from conflict-free reads. Tensor cores (wgmma with TMA)
// are later work.
//
// The cotangent of a learned per-key bias (has_dbias): dbias[key] = sum over
// query rows of P * (dP - delta), the unscaled dS. The dK/dV kernel forms it
// beside dS: each lane sums its two query rows of every Q tile into its own
// partial for each of its warp's eight keys, and the warp adds its lanes'
// partials once, at the end, with shuffles. It costs one add a score and
// writes (B*H, T) floats, where the TPU kernel writes (B*H, 8, T) with only
// sublane 0 live. A null dbias pointer launches the kernel without it, the
// instruction stream of the dK/dV kernel as it was before dbias existed.
//
// Semantics follow the TPU kernels: s = q.k * scale + bias[key], causal
// scores above the diagonal are -1e30, and p = exp(s - lse). A query row
// whose keys are all masked has lse = 0 and out = 0 from the forward; its
// scores keep the -1e30 bias, so p = 0, its dq is exactly 0 and it adds
// nothing to dk and dv. Causal tiles wholly above the diagonal are skipped.
// Any T: rows and keys past T are zero-filled in the tiles and get p = 0.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kBlock = 64;        // rows of a Q tile and keys of a K tile
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = kBlock / kWarps;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;

template <int D>
struct BwdTile {
  static constexpr int kPadded = D + 4;   // a row read by one lane each
  static constexpr int kDense = kBlock * D;
  static constexpr int kPad = kBlock * kPadded;
  static constexpr int kSq = kBlock * kBlock;
  // dQ: Q and dO dense, K and V padded, one dS tile
  static constexpr size_t kDqBytes = sizeof(float) * (2 * kDense + 2 * kPad + kSq);
  // dK/dV: K and V dense, Q and dO padded, a P tile and a dS tile
  static constexpr size_t kDkvBytes =
      sizeof(float) * (2 * kDense + 2 * kPad + 2 * kSq);
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [r0, r0 + kBlock) of a (T, D) matrix into shared memory with row
// stride `stride` floats, zero past T
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const float* src, int r0, int T) {
  constexpr int D4 = D / 4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < kBlock * D4; i += kThreads) {
    const int r = i / D4, c4 = i % D4;
    float4 val = zero4;
    if (r0 + r < T)
      val = reinterpret_cast<const float4*>(src + (long long)(r0 + r) * D)[c4];
    reinterpret_cast<float4*>(dst + r * stride)[c4] = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, float* __restrict__ dq,
                    int T, float scale, int causal) {
  constexpr int KS = BwdTile<D>::kPadded;
  constexpr int D4 = D / 4;
  constexpr int DV = D / 32;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BwdTile<D>::kDense;
  float* Ks = dOs + BwdTile<D>::kDense;
  float* Vs = Ks + BwdTile<D>::kPad;
  float* dSs = Vs + BwdTile<D>::kPad;

  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kRowsPerWarp;
  const int q0 = blockIdx.x * kBlock;
  const long long bh = blockIdx.y;
  const long long base = bh * T * D;

  load_tile<D>(Qs, D, q + base, q0, T);
  load_tile<D>(dOs, D, dout + base, q0, T);

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][DV];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    lse_r[r] = qi < T ? lse[bh * T + qi] : 0.f;
    delta_r[r] = qi < T ? delta[bh * T + qi] : 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + kBlock, T) - 1;
  const int n_tiles = (T + kBlock - 1) / kBlock;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlock;
    if (causal && k0 > q_last) break;   // uniform across the block
    __syncthreads();                     // the previous tile is consumed
    load_tile<D>(Ks, KS, k + base, k0, T);
    load_tile<D>(Vs, KS, v + base, k0, T);
    __syncthreads();

    // s = q.k and dp = do.v for keys k0 + lane and k0 + lane + 32
    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    const float4* ka = reinterpret_cast<const float4*>(Ks + lane * KS);
    const float4* kb = reinterpret_cast<const float4*>(Ks + (lane + 32) * KS);
    const float4* va = reinterpret_cast<const float4*>(Vs + lane * KS);
    const float4* vb = reinterpret_cast<const float4*>(Vs + (lane + 32) * KS);
#pragma unroll 2
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 a = ka[d4], b = kb[d4], x = va[d4], y = vb[d4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qr = reinterpret_cast<const float4*>(Qs + (row0 + r) * D)[d4];
        const float4 orow = reinterpret_cast<const float4*>(dOs + (row0 + r) * D)[d4];
        s[r][0] = dot4(qr, a, s[r][0]);
        s[r][1] = dot4(qr, b, s[r][1]);
        dp[r][0] = dot4(orow, x, dp[r][0]);
        dp[r][1] = dot4(orow, y, dp[r][1]);
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
      const float pa = in_a ? expf(sa - lse_r[r]) : 0.f;
      const float pb = in_b ? expf(sb - lse_r[r]) : 0.f;
      dSs[(row0 + r) * kBlock + lane] = pa * (dp[r][0] - delta_r[r]) * scale;
      dSs[(row0 + r) * kBlock + lane + 32] = pb * (dp[r][1] - delta_r[r]) * scale;
    }
    __syncwarp();

    // dq[r] += sum_j ds[r, j] k[j]
    const int kn = min(kBlock, T - k0);
    for (int j = 0; j < kn; ++j) {
      float kk[DV];
#pragma unroll
      for (int c = 0; c < DV; ++c) kk[c] = Ks[j * KS + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float ds = dSs[(row0 + r) * kBlock + j];
#pragma unroll
        for (int c = 0; c < DV; ++c) acc[r][c] = fmaf(ds, kk[c], acc[r][c]);
      }
    }
    __syncwarp();   // dS is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= T) continue;
    float* o = dq + base + (long long)qi * D;
#pragma unroll
    for (int c = 0; c < DV; ++c) o[lane + 32 * c] = acc[r][c];
  }
}

template <int D, bool kDbias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, float* __restrict__ dk,
                     float* __restrict__ dv, float* __restrict__ dbias,
                     int T, float scale, int causal) {
  constexpr int QS = BwdTile<D>::kPadded;
  constexpr int D4 = D / 4;
  constexpr int DV = D / 32;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BwdTile<D>::kDense;
  float* Qs = Vs + BwdTile<D>::kDense;
  float* dOs = Qs + BwdTile<D>::kPad;
  float* Ps = dOs + BwdTile<D>::kPad;     // [key row][query]
  float* dSs = Ps + BwdTile<D>::kSq;

  const int lane = threadIdx.x % 32;
  const int row0 = (threadIdx.x / 32) * kRowsPerWarp;   // this warp's keys
  const int k0 = blockIdx.x * kBlock;
  const long long bh = blockIdx.y;
  const long long base = bh * T * D;

  load_tile<D>(Ks, D, k + base, k0, T);
  load_tile<D>(Vs, D, v + base, k0, T);

  float bias_j[kRowsPerWarp], dk_acc[kRowsPerWarp][DV], dv_acc[kRowsPerWarp][DV];
  float db_acc[kRowsPerWarp];   // this lane's query rows, each of the keys
#pragma unroll
  for (int jj = 0; jj < kRowsPerWarp; ++jj) {
    const int kj = k0 + row0 + jj;
    bias_j[jj] = (bias != nullptr && kj < T) ? bias[bh * T + kj] : 0.f;
    db_acc[jj] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) dk_acc[jj][c] = dv_acc[jj][c] = 0.f;
  }

  // causal: the Q tiles before this K tile see none of its keys
  const int n_tiles = (T + kBlock - 1) / kBlock;
  for (int t = causal ? blockIdx.x : 0; t < n_tiles; ++t) {
    const int q0 = t * kBlock;
    __syncthreads();                     // the previous tile is consumed
    load_tile<D>(Qs, QS, q + base, q0, T);
    load_tile<D>(dOs, QS, dout + base, q0, T);
    __syncthreads();

    const int ra = q0 + lane, rb = q0 + lane + 32;
    const bool in_a = ra < T, in_b = rb < T;
    const float lse_a = in_a ? lse[bh * T + ra] : 0.f;
    const float lse_b = in_b ? lse[bh * T + rb] : 0.f;
    const float delta_a = in_a ? delta[bh * T + ra] : 0.f;
    const float delta_b = in_b ? delta[bh * T + rb] : 0.f;

    // s = k.q and dp = v.do for query rows ra and rb
    float s[kRowsPerWarp][2], dp[kRowsPerWarp][2];
#pragma unroll
    for (int jj = 0; jj < kRowsPerWarp; ++jj)
      s[jj][0] = s[jj][1] = dp[jj][0] = dp[jj][1] = 0.f;
    const float4* qa = reinterpret_cast<const float4*>(Qs + lane * QS);
    const float4* qb = reinterpret_cast<const float4*>(Qs + (lane + 32) * QS);
    const float4* oa = reinterpret_cast<const float4*>(dOs + lane * QS);
    const float4* ob = reinterpret_cast<const float4*>(dOs + (lane + 32) * QS);
#pragma unroll 2
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 a = qa[d4], b = qb[d4], x = oa[d4], y = ob[d4];
#pragma unroll
      for (int jj = 0; jj < kRowsPerWarp; ++jj) {
        const float4 kr = reinterpret_cast<const float4*>(Ks + (row0 + jj) * D)[d4];
        const float4 vr = reinterpret_cast<const float4*>(Vs + (row0 + jj) * D)[d4];
        s[jj][0] = dot4(a, kr, s[jj][0]);
        s[jj][1] = dot4(b, kr, s[jj][1]);
        dp[jj][0] = dot4(x, vr, dp[jj][0]);
        dp[jj][1] = dot4(y, vr, dp[jj][1]);
      }
    }

#pragma unroll
    for (int jj = 0; jj < kRowsPerWarp; ++jj) {
      const int kj = k0 + row0 + jj;
      float sa = s[jj][0] * scale + bias_j[jj];
      float sb = s[jj][1] * scale + bias_j[jj];
      if (causal) {
        if (kj > ra) sa = kNegInf;
        if (kj > rb) sb = kNegInf;
      }
      const bool live = kj < T;
      const float pa = (live && in_a) ? expf(sa - lse_a) : 0.f;
      const float pb = (live && in_b) ? expf(sb - lse_b) : 0.f;
      // dL/ds, unscaled: the bias cotangent's terms; dS is it times scale
      const float dsa = pa * (dp[jj][0] - delta_a);
      const float dsb = pb * (dp[jj][1] - delta_b);
      Ps[(row0 + jj) * kBlock + lane] = pa;
      Ps[(row0 + jj) * kBlock + lane + 32] = pb;
      dSs[(row0 + jj) * kBlock + lane] = dsa * scale;
      dSs[(row0 + jj) * kBlock + lane + 32] = dsb * scale;
      if (kDbias) db_acc[jj] += dsa + dsb;
    }
    __syncwarp();

    // dv[j] += sum_r p[r, j] do[r];  dk[j] += sum_r ds[r, j] q[r]
    const int qn = min(kBlock, T - q0);
    for (int r = 0; r < qn; ++r) {
      float oo[DV], qq[DV];
#pragma unroll
      for (int c = 0; c < DV; ++c) {
        oo[c] = dOs[r * QS + lane + 32 * c];
        qq[c] = Qs[r * QS + lane + 32 * c];
      }
#pragma unroll
      for (int jj = 0; jj < kRowsPerWarp; ++jj) {
        const float p = Ps[(row0 + jj) * kBlock + r];
        const float ds = dSs[(row0 + jj) * kBlock + r];
#pragma unroll
        for (int c = 0; c < DV; ++c) {
          dv_acc[jj][c] = fmaf(p, oo[c], dv_acc[jj][c]);
          dk_acc[jj][c] = fmaf(ds, qq[c], dk_acc[jj][c]);
        }
      }
    }
    __syncwarp();   // P and dS are rewritten by the next tile
  }

  if (kDbias) {
#pragma unroll
    for (int jj = 0; jj < kRowsPerWarp; ++jj) {
      float sum = db_acc[jj];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const int kj = k0 + row0 + jj;
      if (lane == 0 && kj < T) dbias[bh * T + kj] = sum;
    }
  }

#pragma unroll
  for (int jj = 0; jj < kRowsPerWarp; ++jj) {
    const int kj = k0 + row0 + jj;
    if (kj >= T) continue;
    float* ok = dk + base + (long long)kj * D;
    float* ov = dv + base + (long long)kj * D;
#pragma unroll
    for (int c = 0; c < DV; ++c) {
      ok[lane + 32 * c] = dk_acc[jj][c];
      ov[lane + 32 * c] = dv_acc[jj][c];
    }
  }
}

constexpr int kMaxDevices = 64;

// Above 48 KB a block's shared memory must be asked for explicitly. The
// setting holds per device and kernel, so it is made on the first launch of
// each and remembered (a device numbered past kMaxDevices asks every time).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, int device,
                       std::atomic<bool>* done) {
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && done[device].load(std::memory_order_acquire))
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && known)
    done[device].store(true, std::memory_order_release);
  return e;
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              const float* bias, float* dq, int bh, int T, float scale,
              int causal, int device, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>,
                                   BwdTile<D>::kDqBytes, device, done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((T + kBlock - 1) / kBlock), (unsigned)bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, BwdTile<D>::kDqBytes, stream>>>(
      q, k, v, dout, lse, delta, bias, dq, T, scale, causal);
  return (int)cudaGetLastError();
}

template <int D, bool kDbias>
int launch_dkv_kernel(const float* q, const float* k, const float* v,
                      const float* dout, const float* lse, const float* delta,
                      const float* bias, float* dk, float* dv, float* dbias,
                      int bh, int T, float scale, int causal, int device,
                      cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e = allow_smem(flash_bwd_dkv_kernel<D, kDbias>,
                                   BwdTile<D>::kDkvBytes, device, done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((T + kBlock - 1) / kBlock), (unsigned)bh);
  flash_bwd_dkv_kernel<D, kDbias>
      <<<grid, kThreads, BwdTile<D>::kDkvBytes, stream>>>(
          q, k, v, dout, lse, delta, bias, dk, dv, dbias, T, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               const float* bias, float* dk, float* dv, float* dbias, int bh,
               int T, float scale, int causal, int device,
               cudaStream_t stream) {
  if (dbias != nullptr)
    return launch_dkv_kernel<D, true>(q, k, v, dout, lse, delta, bias, dk,
                                      dv, dbias, bh, T, scale, causal,
                                      device, stream);
  return launch_dkv_kernel<D, false>(q, k, v, dout, lse, delta, bias, dk, dv,
                                     nullptr, bh, T, scale, causal, device,
                                     stream);
}

int check_args(int bh, int T, int device) {
  if (bh <= 0 || bh > 65535 || T <= 0) return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

}  // namespace

// C entry points, bound with ctypes. q, k, v, dout (and dq, dk, dv): (bh, T,
// D) contiguous fp32, 16-byte aligned; lse, delta: (bh, T) fp32; bias: (bh,
// T) fp32 or null; dbias: (bh, T) fp32 output, or null for none. D is 32, 64
// or 128. Each makes `device` current for this
// library's runtime, launches on `stream`, allocates nothing, and returns
// cudaGetLastError().
extern "C" int mxtpu_flash_attention_bwd_dq_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, const float* bias, float* dq,
    int bh, int T, int D, float scale, int causal, int device,
    void* stream_ptr) {
  const int rc = check_args(bh, T, device);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (D) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, delta, bias, dq, bh, T, scale,
                           causal, device, stream);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, bias, dq, bh, T, scale,
                           causal, device, stream);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, bias, dq, bh, T, scale,
                            causal, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mxtpu_flash_attention_bwd_dkv_f32(
    const float* q, const float* k, const float* v, const float* dout,
    const float* lse, const float* delta, const float* bias, float* dk,
    float* dv, float* dbias, int bh, int T, int D, float scale, int causal,
    int device, void* stream_ptr) {
  const int rc = check_args(bh, T, device);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (D) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, delta, bias, dk, dv, dbias,
                            bh, T, scale, causal, device, stream);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, bias, dk, dv, dbias,
                            bh, T, scale, causal, device, stream);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, bias, dk, dv, dbias,
                             bh, T, scale, causal, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
