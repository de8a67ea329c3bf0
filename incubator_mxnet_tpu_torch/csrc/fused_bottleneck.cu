// One ResNet stage-1 bottleneck unit in inference mode, fused, for Hopper
// (sm_90a): 1x1 conv -> BN -> ReLU -> 3x3 conv (pad 1) -> BN -> ReLU ->
// 1x1 conv -> BN -> + residual -> ReLU, NHWC, BN folded into per-channel
// scale and shift, fp32, bf16 or fp16 in and out, fp32 accumulation.
//
// Replaces incubator_mxnet_tpu/ops/pallas/fused_bottleneck.py: _kernel
// (reached through fused_bottleneck, whose consumer is bench.py
// bench_fused_block).
//
// What bounds it on the H100: at the stage-1 shape (B = 128, 56 x 56,
// C = 256, M = 64, bf16) the unit reads x once and writes the output once,
// 411 MB, 0.123 ms at 3.35 TB/s; its 55.9 GFLOP take 0.057 ms at the bf16
// tensor-core peak, so bytes bound it; fp16 moves the same bytes at the
// same peak. In fp32 the same operations take 0.83 ms on the CUDA cores at
// 67 TFLOP/s and 0.34 ms as three TF32 tensor-core products each (494.7 / 3
// TFLOP/s), against 0.25 ms for the 822 MB of x and output: the operations
// bound it.
//
// Two kernels, one for fp32 and one for the 16-bit types, picked by the C
// entry's route (the Python wrapper's _route). The TPU kernel holds one
// whole image (~17 MB) in VMEM; an SM has 227 KB of shared memory. Here
// one block of 8 warps owns an 8 x 14 output tile (112 pixels, 7 rows of
// 16 of the mma; at 56 x 56 the tiles cover the image without waste in
// 4 x 7) and keeps the unit's intermediates on the SM, never in device
// memory:
//   1. h1 = relu(x . w1 * s1 + b1) on the tile plus a one-pixel halo
//      (10 x 16 = 160 pixels, 10 rows of 16; halo pixels are recomputed by
//      the neighbouring tiles, 1.43 x the tile's pixels), streaming x and w1
//      through shared memory; halo pixels outside the image are the 3x3
//      conv's zero padding (0, not relu(b1)).
//   2. h2 = relu(sum over the 9 taps of h1(shifted) . w2[tap] * s2 + b2) on
//      the 112 tile pixels: 9 products whose A rows are h1's rows shifted
//      by the tap, no copy per tap.
//   3. out = relu(h2 . w3 * s3 + b3 + x) in passes of 64 output channels.
// h1 and h2 live in shared memory pixel-major, each pixel's 64 channels
// (M zero-padded) in a padded row. x's halo and every weight chunk arrive by
// cp.async, double-buffered, zero-filled outside the image and past C and
// M. The epilogues read nothing from device memory but the residual: the BN
// scales and shifts come from shared memory (s3, b3 copied with each chunk
// of w3). A block re-reads the weights for 112 pixels (272 KB in fp32, 139
// KB in bf16).
//
// fp32 (f32::fused_bottleneck_f32_kernel): the three products on the tensor
// cores (mma.sync m16n8k8, tf32) in 3xTF32, each operand split at its
// fragment load into hi = tf32(v) and lo = v - hi (which the tensor cores
// read cut to tf32): a * b = hi*lo + lo*hi + hi*hi. The tensor cores cut an
// mma's sum toward zero (chip_smoke.py's tc_rounding line), so the products
// of each group of k-steps go into a fresh accumulator, cross terms first,
// which is then added to the running fp32 sum on the CUDA cores: one k-step
// a group in phase 1, whose three m16 tiles a warp leave no registers for
// more, two in phases 2 and 3. Those adds and the splits are most of the
// issue slots around the products. Rows of x's chunk, h1 and h2 are padded
// to 4 mod 32 floats (A reads, rows g and columns t, hit 32 banks), rows of
// a weight tile to 8 mod 32 (B reads, rows t and columns g). Each warp owns
// 32 output channels and every fourth m16 row of the tile. x and w1 come 32
// channels a step, a tap of w2 and 64 output channels of w3 a step; h2 is
// written over h1 once phase 2 is done, so that two blocks fit an SM (108
// KB of shared memory each, 16 warps; 128 registers a thread, a few spilled).
// A pass's residual is read after its products, all of its loads before the
// first store. C, M and bases that allow it (C % 4 == 0, M % 4 == 0,
// 16-byte aligned) take 16-byte copies and 8-byte residual loads and
// stores; any other operands take the same kernel with 4-byte copies and
// element-wise loads and stores.
//
// bf16 and fp16 (tc::fused_bottleneck_tc_kernel<E, VEC>, one body over the
// element type E): the same three phases as E x E -> fp32 products on the
// tensor cores (mma.sync.m16n8k16, operands from shared memory through
// ldmatrix, .trans for the (K, N) row-major
// weights), the same tile and halo. h1 and h2 live in shared memory in
// E, each pixel's 64 (zero-padded) channels in a 144-byte row, so that
// ldmatrix reads them conflict-free. x's halo and every weight chunk arrive
// by 16-byte cp.async, double-buffered (64 channels of x and w1 a step, a
// tap of w2, 64 output channels of w3). Phase 3 stages bn3's fp32 result in
// shared memory so that the residual is read and the output written 16
// bytes a thread; its residual is loaded into registers before its
// products. 101 KB of shared memory a block: two blocks an SM, 16 warps.
// With so few warps the latency of each step between two barriers weighs
// more than its bytes or its tensor-core operations, hence the epilogues
// that read from shared memory. A C or M that is not a multiple
// of 8, or a base that is not 16-byte aligned, takes the same kernel with
// element-wise loads and stores. fp16 differs from bf16 only in the mma's
// operand type and in the conversions (Elt<E>): h1, h2 and the output round
// with __floats2half2_rn / __float2half_rn, never .satfinite, so a value past
// 65504 becomes inf as jnp's astype makes it (and an inf h1 times a 0 weight
// is NaN in the next product, as in the JAX kernel); fp16 subnormals are
// kept (the build flushes nothing).
//
// Arithmetic: fp32 accumulation; each BN is a multiply and an add rounded
// on their own (__fmul_rn, __fadd_rn), as the plain version does them; h1
// and h2 are rounded to x's dtype exactly where the TPU kernel calls
// .astype(x.dtype) (in fp32, not at all), and the padding of h1 is 0, not
// relu(b1). ReLU passes a NaN through, as jnp.maximum and torch.relu do
// (fmaxf alone would make it 0). The sums run in another order than
// cuDNN's, and fp32's products carry 3xTF32's error (~2^-21 of each
// product), so the kernels are held to their plain version within a
// tolerance, not bitwise; two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// The flash kernels' 3xTF32 and cp.async helpers, included as they are, in
// a namespace of their own: the block constants there are the flash
// kernels'.
namespace tf32x3 {
#include "flash_tf32.cuh"
}  // namespace tf32x3

constexpr int kMaxM = 64;                  // widest bottleneck (stage 1)

// ReLU that passes a NaN through, in one instruction (max.NaN: a NaN
// operand gives NaN). A select on isnan in front of fmaxf cost the bf16
// route 8 % and the fp32 route 2 % of their time on the card.
__device__ __forceinline__ float relu(float v) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(0.f));
  return r;
}

// BN (folded) then ReLU, the multiply and the add rounded on their own
__device__ __forceinline__ float bn_relu(float acc, float s, float b) {
  return relu(__fadd_rn(__fmul_rn(acc, s), b));
}

// -------------------------------------------- fp32: on tensor cores, 3xTF32
namespace f32 {

using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::mma_tf32;

// x = hi + lo for a 3xTF32 product, in three operations where
// tf32x3::split takes five: hi = tf32(x) (to nearest, ties away), lo = x -
// hi (exact in fp32) left with its low 13 bits, which the tensor cores do
// not read: they take lo cut toward zero to tf32, within 2^-21 |x| of x.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

constexpr int kThreads = 256;                 // 8 warps
constexpr int kTH = 8, kTW = 14;              // output tile
constexpr int kHW = kTW + 2;                  // halo width (16)
constexpr int kHaloPx = (kTH + 2) * kHW;      // 160 = 10 m16 tiles
constexpr int kTilePx = kTH * kTW;            // 112 = 7 m16 tiles
constexpr int kMp = 64;                       // M padded
constexpr int kXC = 32;                       // channels of x a phase-1 step
constexpr int kOC = 64;                       // output channels a pass
// k-steps a fresh accumulator takes, phase by phase: two in phases 2 and
// 3; one in phase 1, whose three m16 tiles a warp leave no registers for two
constexpr int kG1 = 1, kG2 = 2, kG3 = 2;
constexpr int kXRow = kXC + 4;                // floats a row: x chunk,
constexpr int kHRow = kMp + 4;                // h1 and h2 (A reads),
constexpr int kWRow = kMp + 8;                // weight tiles (B reads)

// shared memory, in bytes: h (h1 on the halo, then h2 on the tile over it),
// then one region that holds two (x chunk, w1 chunk) buffers in phase 1 and
// two weight tiles (a tap of w2, a chunk of w3) in phases 2 and 3
constexpr int kH = kHaloPx * kHRow * 4;       // 43520
constexpr int kXBuf = kHaloPx * kXRow * 4;    // 23040
constexpr int kP1Buf = kXBuf + kXC * kWRow * 4;   // 32256
constexpr int kWBuf = kMp * kWRow * 4;        // 18432
constexpr int kRegion = 2 * kP1Buf;           // 64512
static_assert(2 * kWBuf <= kRegion, "the weight tiles fit the region");
constexpr int kSmemBytes = kH + kRegion;      // 108032

// rows [0, rows) x 64 columns of a weight tile from a row-major source with
// `ld` floats a row: element (r, n) is src[(r0 + r) * ld + n0 + n] where
// r0 + r < r_end and n0 + n < n_end, else 0. VEC: 16-byte copies (ld, n0
// and n_end multiples of 4, src 16-byte aligned); else 4-byte copies.
template <bool VEC>
__device__ __forceinline__ void load_w(float* dst, const float* src,
                                       long long ld, int r0, int r_end,
                                       int n0, int n_end, int rows) {
  constexpr int kV = VEC ? 4 : 1;
  constexpr int kPer = kMp / kV;               // copies a row
  for (int e = threadIdx.x; e < rows * kPer; e += kThreads) {
    const int r = e / kPer, n = kV * (e % kPer);
    const bool ok = r0 + r < r_end && n0 + n < n_end;
    const float* s = ok ? src + (long long)(r0 + r) * ld + n0 + n : src;
    if constexpr (VEC)
      cp_async16(dst + r * kWRow + n, s, ok);
    else
      cp_async4(dst + r * kWRow + n, s, ok);
  }
}

// channels c0 .. c0 + 31 of x on the tile's 160 halo pixels (hy, hx) ->
// image (y0 - 1 + hy, x0 - 1 + hx); 0 outside the image and past C
template <bool VEC>
__device__ __forceinline__ void load_x_halo(float* dst, const float* x,
                                            long long img, int y0, int x0,
                                            int H, int W, int C, int c0) {
  constexpr int kV = VEC ? 4 : 1;
  constexpr int kPer = kXC / kV;
  for (int e = threadIdx.x; e < kHaloPx * kPer; e += kThreads) {
    const int px = e / kPer, c = kV * (e % kPer);
    const int gy = y0 - 1 + px / kHW, gx = x0 - 1 + px % kHW;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < C;
    const float* s =
        ok ? x + (img + (long long)gy * W + gx) * C + c0 + c : x;
    if constexpr (VEC)
      cp_async16(dst + px * kXRow + c, s, ok);
    else
      cp_async4(dst + px * kXRow + c, s, ok);
  }
}

// tf32 halves of an A fragment: k-slots t and t + 4 of fragment rows g (at
// a[0]) and g + 8 (at b[0]); a and b already point at the lane's column t
__device__ __forceinline__ void frag_a(const float* a, const float* b,
                                       unsigned* hi, unsigned* lo) {
  split(a[0], hi[0], lo[0]);
  split(b[0], hi[1], lo[1]);
  split(a[4], hi[2], lo[2]);
  split(b[4], hi[3], lo[3]);
}

// tf32 halves of the B fragments of four n8 tiles (columns 8 j apart) at
// one k-step of a weight tile; w points at the lane's element (row t,
// column g of the first tile)
__device__ __forceinline__ void frag_b(const float* w, unsigned (*hi)[2],
                                       unsigned (*lo)[2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split(w[8 * j], hi[j][0], lo[j][0]);
    split(w[4 * kWRow + 8 * j], hi[j][1], lo[j][1]);
  }
}

// acc[i][j] += A . B over K contraction values, for the warp's m16 tiles
// i < ni and its four n8 tiles j: a[i][0] and a[i][1] point at fragment
// rows g and g + 8 of tile i, w at the lane's element of a weight tile, all
// at k-step 0. Each group of G k-steps goes into a fresh accumulator, the
// cross terms (hi*lo, lo*hi) before hi*hi, which is then added to acc.
template <int MI, int K, int G>
__device__ __forceinline__ void products(float (*acc)[4][4],
                                         const float* (*a)[2], int ni,
                                         const float* w) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8 * G) {
    unsigned bhi[G][4][2], blo[G][4][2];
#pragma unroll
    for (int s = 0; s < G; ++s)
      frag_b(w + (k0 + 8 * s) * kWRow, bhi[s], blo[s]);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      if (i >= ni) continue;
      unsigned ahi[G][4], alo[G][4];
#pragma unroll
      for (int s = 0; s < G; ++s)
        frag_a(a[i][0] + k0 + 8 * s, a[i][1] + k0 + 8 * s, ahi[s], alo[s]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s = 0; s < G; ++s) {
          mma_tf32(t, ahi[s], blo[s][j], t);
          mma_tf32(t, alo[s], bhi[s][j], t);
        }
#pragma unroll
        for (int s = 0; s < G; ++s) mma_tf32(t, ahi[s], bhi[s][j], t);
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] += t[v];
      }
    }
  }
}

// VEC: x, out, w1, w2, w3 16-byte aligned, C % 4 == 0 and M % 4 == 0
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
fused_bottleneck_f32_kernel(const float* __restrict__ x,
                            const float* __restrict__ w1,
                            const float* __restrict__ s1,
                            const float* __restrict__ b1,
                            const float* __restrict__ w2,
                            const float* __restrict__ s2,
                            const float* __restrict__ b2,
                            const float* __restrict__ w3,
                            const float* __restrict__ s3,
                            const float* __restrict__ b3,
                            float* __restrict__ out, int H, int W, int C,
                            int M, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  // the BN scales and shifts, read by the epilogues from shared memory:
  // s1, b1, s2, b2 (0 past M), and s3, b3 of a pass's 64 channels (a ring
  // of two, copied with the pass's chunk of w3)
  __shared__ float bn12[4][kMp];
  __shared__ float bn3[2][2][kOC];
  float* hs = reinterpret_cast<float*>(smem_f32);   // [160 | 112][kHRow]
  unsigned char* region = smem_f32 + kH;
  auto xbuf = [&](int b) {
    return reinterpret_cast<float*>(region + b * kP1Buf);
  };
  auto w1buf = [&](int b) {
    return reinterpret_cast<float*>(region + b * kP1Buf + kXBuf);
  };
  auto wbuf = [&](int b) {
    return reinterpret_cast<float*>(region + b * kWBuf);
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = 32 * (warp & 1);          // the warp's 32 columns
  const int mr = warp >> 1;                // its m16 tiles: mr + 4 i
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const long long img = (long long)blockIdx.y * H * W;
  const int bcol = t * kWRow + n0 + g;     // the lane's B element, k-step 0
  // the warp's m16 tiles that exist: of the halo's 10, of the tile's 7
  const int ni1 = (kHaloPx / 16 - mr + 3) / 4;
  const int ni23 = (kTilePx / 16 - mr + 3) / 4;

  for (int i = threadIdx.x; i < kMp; i += kThreads) {
    const bool ok = i < M;
    bn12[0][i] = ok ? s1[i] : 0.f;
    bn12[1][i] = ok ? b1[i] : 0.f;
    bn12[2][i] = ok ? s2[i] : 0.f;
    bn12[3][i] = ok ? b2[i] : 0.f;
  }
  // s3, b3 of channels c0 .. c0 + 63 into ring slot `slot` (0 past C)
  auto load_bn3 = [&](int slot, int c0) {
    for (int i = threadIdx.x; i < 2 * kOC; i += kThreads) {
      const int c = c0 + i % kOC;
      const float* src = i < kOC ? s3 : b3;
      cp_async4(&bn3[slot][i / kOC][i % kOC], c < C ? src + c : src, c < C);
    }
  };

  // ---- 1. h1 on the halo: (160, C) . (C, 64)
  const int nch = (C + kXC - 1) / kXC;
  load_x_halo<VEC>(xbuf(0), x, img, y0, x0, H, W, C, 0);
  load_w<VEC>(w1buf(0), w1, M, 0, C, 0, M, kXC);
  cp_async_commit();
  {
    float acc[3][4][4] = {};
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait<0>();
      __syncthreads();   // chunk ch is in; chunk ch - 1's buffer is free
      if (ch + 1 < nch) {
        const int b = (ch + 1) & 1;
        load_x_halo<VEC>(xbuf(b), x, img, y0, x0, H, W, C, (ch + 1) * kXC);
        load_w<VEC>(w1buf(b), w1, M, (ch + 1) * kXC, C, 0, M, kXC);
      }
      cp_async_commit();
      const float* xs = xbuf(ch & 1) + g * kXRow + t;
      const float* a[3][2];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a[i][0] = xs + (mr + 4 * i) * 16 * kXRow;
        a[i][1] = a[i][0] + 8 * kXRow;
      }
      products<3, kXC, kG1>(acc, a, ni1, w1buf(ch & 1) + bcol);
    }
    __syncthreads();     // every warp is done with the phase-1 buffers
    load_w<VEC>(wbuf(0), w2, M, 0, M, 0, M, kMp);        // tap 0 of w2
    cp_async_commit();
    // h1 = relu(bn1); 0 at halo pixels outside the image (the 3x3 conv's
    // padding) and in the padded channels
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int mt = mr + 4 * i;
      if (mt >= kHaloPx / 16) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        const int gy = y0 - 1 + p / kHW, gx = x0 - 1 + p % kHW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = inside && n + e < M
                       ? bn_relu(acc[i][j][2 * h + e], bn12[0][n + e],
                                 bn12[1][n + e])
                       : 0.f;
          *reinterpret_cast<float2*>(hs + p * kHRow + n) =
              make_float2(v[0], v[1]);
        }
      }
    }
  }

  // ---- 2. h2 on the tile: 9 shifted (112, 64) . (64, 64) products
  {
    float acc[2][4][4] = {};
    const float* arow[2][2];   // the lane's A rows g, g + 8 at tap (0, 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mr + 4 * i) * 16 + g + 8 * h;
        arow[i][h] = hs + ((p / kTW) * kHW + p % kTW) * kHRow + t;
      }
    for (int tap = 0; tap < 9; ++tap) {
      cp_async_wait<0>();
      __syncthreads();   // tap in (and h1 written); the other buffer free
      if (tap + 1 < 9)
        load_w<VEC>(wbuf((tap + 1) & 1), w2 + (long long)(tap + 1) * M * M,
                    M, 0, M, 0, M, kMp);
      cp_async_commit();
      const int off = ((tap / 3) * kHW + tap % 3) * kHRow;
      const float* a[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) a[i][h] = arow[i][h] + off;
      products<2, kMp, kG2>(acc, a, ni23, wbuf(tap & 1) + bcol);
    }
    __syncthreads();     // every warp is done with h1 and w2's buffers
    load_w<VEC>(wbuf(0), w3, C, 0, M, 0, C, kMp);        // chunk 0 of w3
    load_bn3(0, 0);
    cp_async_commit();
    // h2 = relu(bn2), over h1's rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = mr + 4 * i;
      if (mt >= kTilePx / 16) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = n + e < M
                       ? bn_relu(acc[i][j][2 * h + e], bn12[2][n + e],
                                 bn12[3][n + e])
                       : 0.f;
          *reinterpret_cast<float2*>(hs + p * kHRow + n) =
              make_float2(v[0], v[1]);
        }
      }
    }
  }

  // ---- 3. out = relu(h2 . w3 * s3 + b3 + x): (112, 64) . (64, C) in
  // passes of 64 output channels, straight from the accumulator fragments
  // (a quad of lanes covers 8 channels, 32 contiguous bytes)
  const float* h2a = hs + g * kHRow + t;
  for (int c0 = 0, pass = 0; c0 < C; c0 += kOC, ++pass) {
    cp_async_wait<0>();
    __syncthreads();     // chunk in (and h2 written); the other buffer free
    if (c0 + kOC < C) {
      load_w<VEC>(wbuf((pass + 1) & 1), w3, C, 0, M, c0 + kOC, C, kMp);
      load_bn3((pass + 1) & 1, c0 + kOC);
    }
    cp_async_commit();
    float acc[2][4][4] = {};
    const float* a[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      a[i][0] = h2a + (mr + 4 * i) * 16 * kHRow;
      a[i][1] = a[i][0] + 8 * kHRow;
    }
    products<2, kMp, kG3>(acc, a, ni23, wbuf(pass & 1) + bcol);
    // this pass's residual at the lane's channels c0 + n0 + 8 j + 2 t (+ 1)
    // of fragment rows g + 8 h: read after the products (before them, its
    // 32 values a thread crowd their registers into local memory), all of
    // it before the first store (read beside each store, it ran slower).
    // at[i][h]: x's element at channel c0 + n0 + 2 t, or -1 outside the image
    long long at[2][2];
    float xr[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (mr + 4 * i) * 16 + g + 8 * h;
        const int gy = y0 + p / kTW, gx = x0 + p % kTW;
        at[i][h] = p < kTilePx && gy < H && gx < W
                       ? (img + (long long)gy * W + gx) * C + c0 + n0 + 2 * t
                       : -1;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + n0 + 8 * j + 2 * t;
          const long long e0 = at[i][h] + 8 * j;
          if constexpr (VEC) {
            const float2 v =
                at[i][h] >= 0 && c < C
                    ? __ldg(reinterpret_cast<const float2*>(x + e0))
                    : make_float2(0.f, 0.f);
            xr[i][j][2 * h] = v.x;
            xr[i][j][2 * h + 1] = v.y;
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              xr[i][j][2 * h + e] =
                  at[i][h] >= 0 && c + e < C ? __ldg(x + e0 + e) : 0.f;
          }
        }
      }
    const float* s3c = bn3[pass & 1][0];
    const float* b3c = bn3[pass & 1][1];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (at[i][h] < 0) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = relu(__fadd_rn(__fadd_rn(__fmul_rn(acc[i][j][2 * h + e],
                                                      s3c[n + e]),
                                            b3c[n + e]),
                                  xr[i][j][2 * h + e]));
          float* o = out + at[i][h] + 8 * j;
          if constexpr (VEC) {
            if (c0 + n < C)
              *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (c0 + n + e < C) o[e] = v[e];
          }
        }
      }
  }
}

template <bool VEC>
int launch(const void* x, const void* w1, const float* s1, const float* b1,
           const void* w2, const float* s2, const float* b2, const void* w3,
           const float* s3, const float* b3, void* out, int B, int H, int W,
           int C, int M, cudaStream_t stream) {
  auto kernel = fused_bottleneck_f32_kernel<VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_y = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_x * tiles_y, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), s1, b1,
      static_cast<const float*>(w2), s2, b2, static_cast<const float*>(w3),
      s3, b3, static_cast<float*>(out), H, W, C, M, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------ bf16 and fp16: on tensor cores
// The 16-bit unit as three E x E -> fp32 products on mma.sync
// m16n8k16, fed by ldmatrix. Output tile 8 x 14 pixels: at 56 x 56 it
// covers the image without waste in 4 x 7 tiles, and its halo is 10 x 16 =
// 160 pixels, 10 rows of 16 of the mma (phase 1 computes 1.43 x the tile's
// pixels, against 1.56 x for 8 x 8). M is zero-padded to 64.
namespace tc {

constexpr int kThreads = 256;                 // 8 warps
constexpr int kTH = 8, kTW = 14;              // output tile
constexpr int kHW = kTW + 2;                  // halo width (16)
constexpr int kHaloPx = (kTH + 2) * kHW;      // 160 = 10 m16 tiles
constexpr int kTilePx = kTH * kTW;            // 112 = 7 m16 tiles
constexpr int kMp = 64;                       // M padded
constexpr int kKC = 64;                       // channels a chunk: x, w1, w3
constexpr int kRow = 72;                      // E a smem row: 144 bytes,
                                              // conflict-free for ldmatrix
constexpr int kStageRow = 72;                 // fp32 a row of the out stage

// shared memory, in bytes: h1 (halo px x kRow), h2 (tile px x kRow), then
// one region that holds, phase by phase, two (x chunk, w1 chunk) buffers;
// two taps of w2; two chunks of w3 and the fp32 output stage
constexpr int kH1 = kHaloPx * kRow * 2;                  // 23040
constexpr int kH2 = kTilePx * kRow * 2;                  // 16128
constexpr int kWBuf = kMp * kRow * 2;                    // 9216: 64 rows
constexpr int kXBuf = kHaloPx * kRow * 2;                // 23040
constexpr int kP1Buf = kXBuf + kWBuf;                    // 32256
constexpr int kStage = kTilePx * kStageRow * 4;          // 32256
constexpr int kRegion = 2 * kP1Buf > 2 * kWBuf + kStage ? 2 * kP1Buf
                                                        : 2 * kWBuf + kStage;
constexpr int kSmemBytes = kH1 + kH2 + kRegion;          // 103680

typedef __nv_bfloat16 bf16;
typedef __half f16;

// What differs between the two element types: the mma's operand type and
// the conversions. Rounding is to nearest even, inf past fp16's 65504.
template <typename E>
struct Elt;

template <>
struct Elt<bf16> {
  // c (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
  static __device__ __forceinline__ void mma(float* c, const unsigned* a,
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ bf16 zero() {
    return __float2bfloat16(0.f);
  }
  static __device__ __forceinline__ bf16 round(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float widen(bf16 v) {
    return __bfloat162float(v);
  }
  // two floats rounded, lo in the low half
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(unsigned u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
};

template <>
struct Elt<f16> {
  // c (16 x 8 fp32) += a (16 x 16 fp16, row) * b (16 x 8 fp16, col)
  static __device__ __forceinline__ void mma(float* c, const unsigned* a,
                                             unsigned b0, unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ f16 zero() { return __float2half(0.f); }
  static __device__ __forceinline__ f16 round(float v) {
    return __float2half_rn(v);
  }
  static __device__ __forceinline__ float widen(f16 v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
  static __device__ __forceinline__ float2 unpack(unsigned u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; ok false writes 4 zero bytes instead
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// B fragments of four n8 tiles (columns n0 .. n0 + 31) at k-step k0 of a
// (k, n) row-major E tile with rows of kRow: two ldmatrix.x4.trans.
__device__ __forceinline__ void load_b(unsigned tile, int k0, int n0,
                                       int lane, unsigned (*b)[2]) {
  const int k = k0 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int jp = 0; jp < 2; ++jp) {
    unsigned r[4];
    ldsm_x4_trans(tile + 2 * (k * kRow + n0 + 16 * jp + 8 * (lane >> 4)), r);
    b[2 * jp][0] = r[0];
    b[2 * jp][1] = r[1];
    b[2 * jp + 1][0] = r[2];
    b[2 * jp + 1][1] = r[3];
  }
}

// rows [0, rows) x 64 columns of an E tile with rows of kRow from a
// row-major source with `ld` elements a row: element (r, n) is
// src[(r0 + r) * ld + n0 + n] where r0 + r < r_end and n0 + n < n_end,
// else 0. VEC: 16-byte cp.async (ld, n0 and n_end multiples of 8, src
// 16-byte aligned); else element by element.
template <typename E, bool VEC>
__device__ __forceinline__ void load_tile(E* dst, const E* src,
                                          long long ld, int r0, int r_end,
                                          int n0, int n_end, int rows) {
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < rows * 8; e += kThreads) {
      const int r = e >> 3, n = 8 * (e & 7);
      const bool ok = r0 + r < r_end && n0 + n < n_end;
      cp_async16(dst + r * kRow + n,
                 ok ? src + (long long)(r0 + r) * ld + n0 + n : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * 64; e += kThreads) {
      const int r = e >> 6, n = e & 63;
      const bool ok = r0 + r < r_end && n0 + n < n_end;
      dst[r * kRow + n] =
          ok ? src[(long long)(r0 + r) * ld + n0 + n] : Elt<E>::zero();
    }
  }
}

// channels c0 .. c0 + 63 of x on the tile's 160 halo pixels (hy, hx) ->
// image (y0 - 1 + hy, x0 - 1 + hx); 0 outside the image and past C
template <typename E, bool VEC>
__device__ __forceinline__ void load_x_halo(E* dst, const E* x,
                                            long long img, int y0, int x0,
                                            int H, int W, int C, int c0) {
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < kHaloPx * 8; e += kThreads) {
      const int px = e >> 3, c = 8 * (e & 7);
      const int gy = y0 - 1 + px / kHW, gx = x0 - 1 + px % kHW;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < C;
      cp_async16(dst + px * kRow + c,
                 ok ? x + (img + (long long)gy * W + gx) * C + c0 + c : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kHaloPx * 64; e += kThreads) {
      const int px = e >> 6, c = e & 63;
      const int gy = y0 - 1 + px / kHW, gx = x0 - 1 + px % kHW;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < C;
      dst[px * kRow + c] = ok ? x[(img + (long long)gy * W + gx) * C + c0 + c]
                              : Elt<E>::zero();
    }
  }
}

// E: bf16 or f16. VEC: x, out, w1, w2, w3 16-byte aligned, C % 8 == 0 and
// M % 8 == 0
template <typename E, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
fused_bottleneck_tc_kernel(const E* __restrict__ x,
                           const E* __restrict__ w1,
                           const float* __restrict__ s1,
                           const float* __restrict__ b1,
                           const E* __restrict__ w2,
                           const float* __restrict__ s2,
                           const float* __restrict__ b2,
                           const E* __restrict__ w3,
                           const float* __restrict__ s3,
                           const float* __restrict__ b3,
                           E* __restrict__ out, int H, int W, int C,
                           int M, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  // the BN scales and shifts, read by the epilogues from shared memory:
  // s1, b1, s2, b2 (0 past M), and s3, b3 of a pass's 64 channels (a ring
  // of two, copied with the pass's chunk of w3)
  __shared__ float bn12[4][kMp];
  __shared__ float bn3[2][2][kKC];
  E* h1s = reinterpret_cast<E*>(smem_tc);                       // [160][kRow]
  E* h2s = reinterpret_cast<E*>(smem_tc + kH1);                 // [112][kRow]
  unsigned char* region = smem_tc + kH1 + kH2;
  // phase 1: buffer b holds the x chunk then the w1 chunk
  auto xbuf = [&](int b) {
    return reinterpret_cast<E*>(region + b * kP1Buf);
  };
  auto w1buf = [&](int b) {
    return reinterpret_cast<E*>(region + b * kP1Buf + kXBuf);
  };
  // phases 2 and 3: two weight buffers (a tap of w2, a chunk of w3)
  auto wbuf = [&](int b) {
    return reinterpret_cast<E*>(region + b * kWBuf);
  };
  float* stage = reinterpret_cast<float*>(region + 2 * kWBuf);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = 32 * (warp & 1);          // the warp's 32 columns
  const int mr = warp >> 1;                // its m16 tiles: mr + 4 i
  const int y0 = (blockIdx.x / tiles_x) * kTH;
  const int x0 = (blockIdx.x % tiles_x) * kTW;
  const long long img = (long long)blockIdx.y * H * W;
  // ldmatrix A lanes: row lane % 16 of an m16 tile, k half lane / 16
  const int a_row = lane & 15, a_k = 8 * (lane >> 4);

  for (int i = threadIdx.x; i < kMp; i += kThreads) {
    const bool ok = i < M;
    bn12[0][i] = ok ? s1[i] : 0.f;
    bn12[1][i] = ok ? b1[i] : 0.f;
    bn12[2][i] = ok ? s2[i] : 0.f;
    bn12[3][i] = ok ? b2[i] : 0.f;
  }
  // s3, b3 of channels c0 .. c0 + 63 into ring slot `slot` (0 past C)
  auto load_bn3 = [&](int slot, int c0) {
    for (int i = threadIdx.x; i < 2 * kKC; i += kThreads) {
      const int c = c0 + i % kKC;
      const float* src = i < kKC ? s3 : b3;
      cp_async4(&bn3[slot][i / kKC][i % kKC], c < C ? src + c : src, c < C);
    }
  };
  // output item e of a pass: 8 channels c0 + 8 (e % 8) .. of tile pixel
  // e / 8, at element `at` of x and out; false outside the image, past C
  // or past the tile
  auto out_item = [&](int e, int c0, long long& at) {
    const int p = e >> 3, n = 8 * (e & 7);
    const int gy = y0 + p / kTW, gx = x0 + p % kTW;
    at = (img + (long long)gy * W + gx) * C + c0 + n;
    return e < kTilePx * 8 && gy < H && gx < W && c0 + n < C;
  };

  // ---- 1. h1 on the halo: (160, C) . (C, 64)
  const int nch = (C + kKC - 1) / kKC;
  load_x_halo<E, VEC>(xbuf(0), x, img, y0, x0, H, W, C, 0);
  load_tile<E, VEC>(w1buf(0), w1, M, 0, C, 0, M, kKC);
  cp_async_commit();
  {
    float acc[3][4][4];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      cp_async_wait_all();
      __syncthreads();   // chunk ch is in; chunk ch - 1's buffer is free
      if (ch + 1 < nch) {
        const int b = (ch + 1) & 1;
        load_x_halo<E, VEC>(xbuf(b), x, img, y0, x0, H, W, C,
                            (ch + 1) * kKC);
        load_tile<E, VEC>(w1buf(b), w1, M, (ch + 1) * kKC, C, 0, M, kKC);
      }
      cp_async_commit();
      const unsigned xs = smem_u32(xbuf(ch & 1));
      const unsigned ws = smem_u32(w1buf(ch & 1));
#pragma unroll
      for (int ks = 0; ks < kKC; ks += 16) {
        unsigned b[4][2];
        load_b(ws, ks, n0, lane, b);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int mt = mr + 4 * i;
          if (mt >= kHaloPx / 16) continue;
          unsigned a[4];
          ldsm_x4(xs + 2 * ((mt * 16 + a_row) * kRow + ks + a_k), a);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Elt<E>::mma(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }
    __syncthreads();     // every warp is done with the phase-1 buffers
    load_tile<E, VEC>(wbuf(0), w2, M, 0, M, 0, M, kMp);   // tap 0 of w2
    cp_async_commit();
    // h1 = relu(bn1), rounded to E; 0 at halo pixels outside the image
    // (the 3x3 conv's padding) and in the padded channels
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int mt = mr + 4 * i;
      if (mt >= kHaloPx / 16) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        const int gy = y0 - 1 + p / kHW, gx = x0 - 1 + p % kHW;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = inside && n + e < M
                       ? bn_relu(acc[i][j][2 * h + e], bn12[0][n + e],
                                 bn12[1][n + e])
                       : 0.f;
          *reinterpret_cast<unsigned*>(h1s + p * kRow + n) =
              Elt<E>::pack(v[0], v[1]);
        }
      }
    }
  }

  // ---- 2. h2 on the tile: 9 shifted (112, 64) . (64, 64) products
  {
    float acc[2][4][4];
    int base[2];          // the lane's A row at tap (0, 0), as a halo index
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = (mr + 4 * i) * 16 + a_row;
      base[i] = (p / kTW) * kHW + p % kTW;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
    }
    const unsigned h1a = smem_u32(h1s);
    for (int tap = 0; tap < 9; ++tap) {
      cp_async_wait_all();
      __syncthreads();   // tap in (and h1 written); the other buffer free
      if (tap + 1 < 9)
        load_tile<E, VEC>(wbuf((tap + 1) & 1),
                          w2 + (long long)(tap + 1) * M * M, M, 0, M, 0, M,
                          kMp);
      cp_async_commit();
      const unsigned ws = smem_u32(wbuf(tap & 1));
      const int off = (tap / 3) * kHW + tap % 3;
#pragma unroll
      for (int ks = 0; ks < kMp; ks += 16) {
        unsigned b[4][2];
        load_b(ws, ks, n0, lane, b);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (mr + 4 * i >= kTilePx / 16) continue;
          unsigned a[4];
          ldsm_x4(h1a + 2 * ((base[i] + off) * kRow + ks + a_k), a);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            Elt<E>::mma(acc[i][j], a, b[j][0], b[j][1]);
        }
      }
    }
    __syncthreads();     // every warp is done with w2's buffers
    load_tile<E, VEC>(wbuf(0), w3, C, 0, M, 0, C, kMp);   // chunk 0 of w3
    load_bn3(0, 0);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = mr + 4 * i;
      if (mt >= kTilePx / 16) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = n + e < M
                       ? bn_relu(acc[i][j][2 * h + e], bn12[2][n + e],
                                 bn12[3][n + e])
                       : 0.f;
          *reinterpret_cast<unsigned*>(h2s + p * kRow + n) =
              Elt<E>::pack(v[0], v[1]);
        }
      }
    }
  }

  // ---- 3. out = relu(h2 . w3 * s3 + b3 + x): (112, 64) . (64, C) in
  // chunks of 64 output channels, staged in fp32 through shared memory so
  // that x is read and the output written 16 bytes a thread
  const unsigned h2a = smem_u32(h2s);
  for (int c0 = 0, pass = 0; c0 < C; c0 += kKC, ++pass) {
    cp_async_wait_all();
    __syncthreads();     // chunk in (and h2 written); the stage is free
    if (c0 + kKC < C) {
      load_tile<E, VEC>(wbuf((pass + 1) & 1), w3, C, 0, M, c0 + kKC, C, kMp);
      load_bn3((pass + 1) & 1, c0 + kKC);
    }
    cp_async_commit();
    // this pass's residual, read now so that its latency hides behind the
    // products and the stage
    constexpr int kItems = (kTilePx * 8 + kThreads - 1) / kThreads;
    [[maybe_unused]] uint4 xres[kItems];
    if constexpr (VEC) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        long long at;
        xres[it] = out_item(threadIdx.x + it * kThreads, c0, at)
                       ? __ldg(reinterpret_cast<const uint4*>(x + at))
                       : make_uint4(0, 0, 0, 0);
      }
    }
    const unsigned ws = smem_u32(wbuf(pass & 1));
    const float* s3c = bn3[pass & 1][0];
    const float* b3c = bn3[pass & 1][1];
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kMp; ks += 16) {
      unsigned b[4][2];
      load_b(ws, ks, n0, lane, b);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int mt = mr + 4 * i;
        if (mt >= kTilePx / 16) continue;
        unsigned a[4];
        ldsm_x4(h2a + 2 * ((mt * 16 + a_row) * kRow + ks + a_k), a);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Elt<E>::mma(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
    // h3 = bn3(acc) in fp32 -> the stage
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int mt = mr + 4 * i;
      if (mt >= kTilePx / 16) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = c0 + n + e < C
                       ? __fadd_rn(__fmul_rn(acc[i][j][2 * h + e],
                                             s3c[n + e]),
                                   b3c[n + e])
                       : 0.f;
          *reinterpret_cast<float2*>(stage + p * kStageRow + n) =
              make_float2(v[0], v[1]);
        }
      }
    }
    __syncthreads();
    if constexpr (VEC) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int e = threadIdx.x + it * kThreads;
        long long at;
        if (!out_item(e, c0, at)) continue;
        const int p = e >> 3, n = 8 * (e & 7);
        const float4 lo = *reinterpret_cast<const float4*>(
            stage + p * kStageRow + n);
        const float4 hi = *reinterpret_cast<const float4*>(
            stage + p * kStageRow + n + 4);
        const unsigned* xp = reinterpret_cast<const unsigned*>(&xres[it]);
        const float h3[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        uint4 ov;
        unsigned* op = reinterpret_cast<unsigned*>(&ov);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 xf = Elt<E>::unpack(xp[q]);
          op[q] = Elt<E>::pack(relu(__fadd_rn(h3[2 * q], xf.x)),
                               relu(__fadd_rn(h3[2 * q + 1], xf.y)));
        }
        *reinterpret_cast<uint4*>(out + at) = ov;
      }
    } else {
      for (int e = threadIdx.x; e < kTilePx * kKC; e += kThreads) {
        const int p = e >> 6, n = e & 63;
        const int gy = y0 + p / kTW, gx = x0 + p % kTW;
        if (gy >= H || gx >= W || c0 + n >= C) continue;
        const long long at = (img + (long long)gy * W + gx) * C + c0 + n;
        out[at] = Elt<E>::round(relu(
            __fadd_rn(stage[p * kStageRow + n], Elt<E>::widen(x[at]))));
      }
    }
  }
}

template <typename E, bool VEC>
int launch(const void* x, const void* w1, const float* s1, const float* b1,
           const void* w2, const float* s2, const float* b2, const void* w3,
           const float* s3, const float* b3, void* out, int B, int H, int W,
           int C, int M, cudaStream_t stream) {
  auto kernel = fused_bottleneck_tc_kernel<E, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (W + kTW - 1) / kTW;
  const int tiles_y = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_x * tiles_y, B);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const E*>(x), static_cast<const E*>(w1), s1, b1,
      static_cast<const E*>(w2), s2, b2, static_cast<const E*>(w3), s3, b3,
      static_cast<E*>(out), H, W, C, M, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace tc

// Make `device` current for this library's runtime unless it already is:
// the query is a thread-local read, the switch is not.
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return e;
  return current == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

// C entry point, bound with ctypes. x, out: (B, H, W, C) contiguous NHWC;
// w1 (C, M), w2 (9, M, M) with taps ky * 3 + kx, w3 (M, C), all of x's
// dtype; s1, b1 (M), s2, b2 (M), s3, b3 (C) fp32. 1 <= M <= 64,
// 1 <= B <= 65535. `route` is the wrapper's choice: 0 fp32 on the tensor
// cores in 3xTF32 (any operands: 16-byte copies where x, w1, w2, w3 and out
// are 16-byte aligned and C % 4 == 0 and M % 4 == 0, else 4-byte ones); 1
// bf16 on the tensor cores with 16-byte loads (x, w1, w2, w3 and out
// 16-byte aligned, C % 8 == 0 and M % 8 == 0, else refused with
// cudaErrorInvalidValue); 2 bf16 on the tensor cores with element-wise
// loads (any operands); 3 and 4 the same two routes in fp16 (3 under 1's
// conditions). Makes `device` current if it is not, launches on
// `stream`, allocates nothing, and returns the first CUDA error (0 on
// success).
extern "C" int mxtpu_fused_bottleneck(const void* x, const void* w1,
                                      const float* s1, const float* b1,
                                      const void* w2, const float* s2,
                                      const float* b2, const void* w3,
                                      const float* s3, const float* b3,
                                      void* out, int B, int H, int W, int C,
                                      int M, int route, int device,
                                      void* stream_ptr) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C <= 0 || M <= 0 ||
      M > kMaxM || route < 0 || route > 4)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w1) |
                          reinterpret_cast<uintptr_t>(w2) |
                          reinterpret_cast<uintptr_t>(w3) |
                          reinterpret_cast<uintptr_t>(out);
  if ((route == 1 || route == 3) &&
      (bases % 16 != 0 || C % 8 != 0 || M % 8 != 0))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = use_device(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (route == 1)
    return tc::launch<tc::bf16, true>(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                                      out, B, H, W, C, M, stream);
  if (route == 2)
    return tc::launch<tc::bf16, false>(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                                       out, B, H, W, C, M, stream);
  if (route == 3)
    return tc::launch<tc::f16, true>(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                                     out, B, H, W, C, M, stream);
  if (route == 4)
    return tc::launch<tc::f16, false>(x, w1, s1, b1, w2, s2, b2, w3, s3, b3,
                                      out, B, H, W, C, M, stream);
  if (bases % 16 == 0 && C % 4 == 0 && M % 4 == 0)
    return f32::launch<true>(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, out, B,
                             H, W, C, M, stream);
  return f32::launch<false>(x, w1, s1, b1, w2, s2, b2, w3, s3, b3, out, B, H,
                            W, C, M, stream);
}
