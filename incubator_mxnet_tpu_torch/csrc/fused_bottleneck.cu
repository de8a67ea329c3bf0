// One ResNet stage-1 bottleneck unit in inference mode, fused, for Hopper
// (sm_90a): 1x1 conv -> BN -> ReLU -> 3x3 conv (pad 1) -> BN -> ReLU ->
// 1x1 conv -> BN -> + residual -> ReLU, NHWC, BN folded into per-channel
// scale and shift, fp32 or bf16 in and out, fp32 accumulation.
//
// Replaces incubator_mxnet_tpu/ops/pallas/fused_bottleneck.py: _kernel
// (reached through fused_bottleneck, whose consumer is bench.py
// bench_fused_block).
//
// What bounds it on the H100: at the stage-1 shape (B = 128, 56 x 56,
// C = 256, M = 64, bf16) the unit reads x once and writes the output once,
// 411 MB, 0.123 ms at 3.35 TB/s; its 55.9 GFLOP take 0.057 ms at the bf16
// tensor-core peak, so bytes bound it. This kernel does its products on the
// CUDA cores in fp32 (FMA), where the same operations take 0.83 ms at
// 67 TFLOP/s: the operations bind it, several times over its byte bound.
// Tensor-core products (mma.sync or wgmma on bf16) are later work.
//
// What the design does about it: the TPU kernel holds one whole image
// (~17 MB) in VMEM; an SM has 227 KB of shared memory. Here one block owns
// an 8 x 8 tile of output pixels and keeps the unit's intermediates on the
// SM, never in device memory:
//   1. h1 = relu(x . w1 * s1 + b1) on the tile plus a one-pixel halo
//      (10 x 10 pixels; halo pixels are recomputed by the neighbouring
//      tiles), streaming x and w1 through shared memory 32 input channels
//      at a time; halo pixels outside the image are the 3x3 conv's zero
//      padding. h1 stays in shared memory, channel-major.
//   2. h2 = relu(sum over the 9 taps of h1(shifted) . w2[tap] * s2 + b2) on
//      the 64 tile pixels, one tap of w2 in shared memory at a time; h2
//      stays in shared memory.
//   3. out = relu(h2 . w3 * s3 + b3 + x) in passes of 256 output channels,
//      w3 streamed 16 rows at a time, x re-read for the residual (it was
//      read moments before, so it comes from L2), written once.
// Each product is a register tile: 256 threads as 16 x 16, a thread owning
// pixels tp + 16 i and channels tn + 16 j, so that a warp reads two
// pixels' values (broadcast) and 16 consecutive channels from shared
// memory, conflict-free (channel-major rows padded to an odd stride).
//
// Arithmetic: fp32 FMA accumulation; each BN is a multiply and an add
// rounded on their own (__fmul_rn, __fadd_rn), as the plain version does
// them; h1 and h2 are rounded to x's dtype exactly where the TPU kernel
// calls .astype(x.dtype). The sums run in another order than cuDNN's, so
// the kernel is held to its plain version within a tolerance, not bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;                   // output tile: kTile x kTile px
constexpr int kHalo = kTile + 2;           // the tile plus a one-pixel halo
constexpr int kHaloPx = kHalo * kHalo;     // 100
constexpr int kTilePx = kTile * kTile;     // 64
constexpr int kMaxM = 64;                  // widest bottleneck (stage 1)
constexpr int kKC = 32;                    // input channels a step, phase 1
constexpr int kCC = 256;                   // output channels a pass, phase 3
constexpr int kK3 = 16;                    // rows of w3 a step, phase 3
constexpr int kHaloStride = kHaloPx + 1;   // odd row strides: no conflicts
constexpr int kPxStride = kTilePx + 1;
constexpr int kP1 = 7;                     // halo pixels a thread: 7 x 16 >= 100

constexpr int cmax(int a, int b) { return a > b ? a : b; }

constexpr int kH1Floats = kMaxM * kHaloStride;
constexpr int kH2Floats = kMaxM * kPxStride;
// one phase's staging at a time: x and w1 chunks, a tap of w2, rows of w3
constexpr int kScratchFloats = cmax(kKC * kHaloStride + kKC * kMaxM,
                                    cmax(kMaxM * kMaxM, kK3 * kCC));
constexpr size_t kSmemBytes =
    (size_t)(kH1Floats + kH2Floats + kScratchFloats) * sizeof(float);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back: .astype(x.dtype) of the TPU kernel
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// BN (folded) then ReLU, the multiply and the add rounded on their own
__device__ __forceinline__ float bn_relu(float acc, float s, float b) {
  return fmaxf(__fadd_rn(__fmul_rn(acc, s), b), 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                        const float* __restrict__ s1,
                        const float* __restrict__ b1,
                        const T* __restrict__ w2,
                        const float* __restrict__ s2,
                        const float* __restrict__ b2,
                        const T* __restrict__ w3,
                        const float* __restrict__ s3,
                        const float* __restrict__ b3, T* __restrict__ out,
                        int H, int W, int C, int M, int tiles_x) {
  extern __shared__ float smem[];
  float* h1s = smem;                        // [kMaxM][kHaloStride]
  float* h2s = h1s + kH1Floats;             // [kMaxM][kPxStride]
  float* scratch = h2s + kH2Floats;

  const int tid = threadIdx.x;
  const int tn = tid % 16, tp = tid / 16;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const long long img = (long long)blockIdx.y * H * W;  // first pixel

  // ---- 1. h1 on the tile and its halo: (100, C) . (C, M)
  {
    float* xs = scratch;                          // [kKC][kHaloStride]
    float* w1s = scratch + kKC * kHaloStride;     // [kKC][kMaxM]
    float acc[kP1][4];
#pragma unroll
    for (int i = 0; i < kP1; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int c0 = 0; c0 < C; c0 += kKC) {
      for (int e = tid; e < kHaloPx * kKC; e += kThreads) {
        const int k = e % kKC, p = e / kKC;
        const int gy = y0 - 1 + p / kHalo, gx = x0 - 1 + p % kHalo;
        float v = 0.f;
        if (c0 + k < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = to_f(x[(img + (long long)gy * W + gx) * C + c0 + k]);
        xs[k * kHaloStride + p] = v;
      }
      for (int e = tid; e < kKC * kMaxM; e += kThreads) {
        const int k = e / kMaxM, n = e % kMaxM;
        w1s[e] = (c0 + k < C && n < M)
                     ? to_f(w1[(long long)(c0 + k) * M + n]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        float a[kP1], b[4];
#pragma unroll
        for (int i = 0; i < kP1; ++i)
          a[i] = xs[k * kHaloStride + min(tp + 16 * i, kHaloPx - 1)];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = w1s[k * kMaxM + tn + 16 * j];
#pragma unroll
        for (int i = 0; i < kP1; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kP1; ++i) {
      const int p = tp + 16 * i;
      if (p >= kHaloPx) continue;
      const int gy = y0 - 1 + p / kHalo, gx = x0 - 1 + p % kHalo;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tn + 16 * j;
        if (n < M)
          h1s[n * kHaloStride + p] =
              inside ? round_to<T>(bn_relu(acc[i][j], s1[n], b1[n])) : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- 2. h2 on the tile: 9 shifted (64, M) . (M, M) products
  {
    float* w2s = scratch;                         // [kMaxM][kMaxM], one tap
    float acc[4][4];
    int base[4];                                  // halo index at tap (0, 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = tp + 16 * i;
      base[i] = (p / kTile) * kHalo + p % kTile;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int tap = 0; tap < 9; ++tap) {
      for (int e = tid; e < kMaxM * kMaxM; e += kThreads) {
        const int k = e / kMaxM, n = e % kMaxM;
        w2s[e] = (k < M && n < M)
                     ? to_f(w2[((long long)tap * M + k) * M + n]) : 0.f;
      }
      __syncthreads();
      const int off = (tap / 3) * kHalo + tap % 3;
#pragma unroll 4
      for (int k = 0; k < M; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = h1s[k * kHaloStride + base[i] + off];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = w2s[k * kMaxM + tn + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tn + 16 * j;
        if (n < M)
          h2s[n * kPxStride + tp + 16 * i] =
              round_to<T>(bn_relu(acc[i][j], s2[n], b2[n]));
      }
  }
  __syncthreads();

  // ---- 3. out = relu(h2 . w3 * s3 + b3 + x): (64, M) . (M, C)
  float* w3s = scratch;                           // [kK3][kCC]
  for (int c0 = 0; c0 < C; c0 += kCC) {
    float acc[4][16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < M; k0 += kK3) {
      for (int e = tid; e < kK3 * kCC; e += kThreads) {
        const int k = e / kCC, n = e % kCC;
        w3s[e] = (k0 + k < M && c0 + n < C)
                     ? to_f(w3[(long long)(k0 + k) * C + c0 + n]) : 0.f;
      }
      __syncthreads();
      const int kn = min(kK3, M - k0);
#pragma unroll 2
      for (int k = 0; k < kn; ++k) {
        float a[4], b[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = h2s[(k0 + k) * kPxStride + tp + 16 * i];
#pragma unroll
        for (int j = 0; j < 16; ++j) b[j] = w3s[k * kCC + tn + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = tp + 16 * i;
      const int gy = y0 + p / kTile, gx = x0 + p % kTile;
      if (gy >= H || gx >= W) continue;
      const long long pix = (img + (long long)gy * W + gx) * C;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = c0 + tn + 16 * j;
        if (c >= C) continue;
        const float h3 = __fadd_rn(__fmul_rn(acc[i][j], s3[c]), b3[c]);
        out[pix + c] = from_f<T>(fmaxf(__fadd_rn(h3, to_f(x[pix + c])), 0.f));
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w1, const float* s1, const float* b1,
           const void* w2, const float* s2, const float* b2, const void* w3,
           const float* s3, const float* b3, void* out, int B, int H, int W,
           int C, int M, cudaStream_t stream) {
  auto kernel = fused_bottleneck_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (W + kTile - 1) / kTile;
  const int tiles_y = (H + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), s1, b1,
      static_cast<const T*>(w2), s2, b2, static_cast<const T*>(w3), s3, b3,
      static_cast<T*>(out), H, W, C, M, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. x, out: (B, H, W, C) contiguous NHWC;
// w1 (C, M), w2 (9, M, M) with taps ky * 3 + kx, w3 (M, C), all of x's
// dtype (bf16 when `bf16` is 1, else fp32); s1, b1 (M), s2, b2 (M), s3, b3
// (C) fp32. 1 <= M <= 64, 1 <= B <= 65535. Launches on `stream`,
// allocates nothing, and returns the first CUDA error (0 on success).
extern "C" int mxtpu_fused_bottleneck(const void* x, const void* w1,
                                      const float* s1, const float* b1,
                                      const void* w2, const float* s2,
                                      const float* b2, const void* w3,
                                      const float* s3, const float* b3,
                                      void* out, int B, int H, int W, int C,
                                      int M, int bf16, int device,
                                      void* stream_ptr) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || M <= 0 ||
      M > kMaxM)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bf16)
    return launch<__nv_bfloat16>(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, out,
                                 B, H, W, C, M, stream);
  return launch<float>(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, out, B, H, W,
                       C, M, stream);
}
