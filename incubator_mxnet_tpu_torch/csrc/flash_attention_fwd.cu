// Attention forward with an online softmax (flash attention), fp32, bf16 and
// fp16, for Hopper (sm_90a).
//
// Replaces incubator_mxnet_tpu/ops/pallas/flash_attention.py: _fwd_kernel
// (reached through _fwd_call, _flash_core and flash_attention), in the three
// input dtypes the JAX package gives it. The fp32 route is described first;
// the 16-bit route's notes (bf16 and fp16, one kernel over the element type)
// stand above its kernel, further down.
//
// What bounds it on the H100: operations. At (B*H, T, D) = (96, 512, 64) the
// two products take 4 * BH * T * T * D = 6.4 GFLOP against about 50 MB of q,
// k, v and out: some 130 operations per byte. On the fp32 CUDA cores (67
// TFLOP/s) that is 96 us; as three TF32 tensor-core products each (494.7 / 3
// TFLOP/s) 39 us; the bytes alone would take 15 us. With a padding mask the
// work is what the live keys need.
//
// What the design does about it (the building blocks, shared with the
// backward, are in flash_tf32.cuh):
// - Both products, S = Q K^T and O += P V, run on the tensor cores (mma.sync
//   m16n8k8, tf32) in 3xTF32, each k-step's three products into a fresh
//   accumulator added on the CUDA cores: fp32-accurate, where plain TF32
//   would miss the port's 2e-5 by orders of magnitude.
// - One block owns a 64-row Q tile of one b*h; four warps own 16 rows each.
//   The Q tile is split into tf32 halves once; at D <= 64 each warp then
//   holds its rows' hi and lo A fragments in registers for the whole key
//   walk (D registers a thread), at D = 128 they stay split in shared memory
//   and are read per k-step (the registers would spill).
// - K, V and the key bias stream in 32-key stages through a two-stage
//   cp.async ring: stage i + 1 lands while stage i's products run. Once a
//   stage has landed, the block splits K and V into tf32 halves in shared
//   memory (hi in place, lo beside), so each value is split once.
// - P never leaves registers: the contraction index of P V is permuted
//   (frag_acc / pre_b_kn), so S's accumulator fragments, turned into
//   probabilities in place, are P V's A fragments.
// - The online softmax keeps m per fragment row (rows g and g + 8 of the
//   warp), reduced over the quad of threads that share a row with two
//   shuffles a tile; each thread sums its own columns' p into l, rescaled
//   with m, and the quad adds its four partial sums once at the end.
// - Key tiles with no live key are skipped. A key whose bias is at or below
//   -0.5e30 (the mask's -1e30, plus any learned bias) gets p = exp(s - m) =
//   0 exactly whenever its row has a live key, and a row without one comes
//   out as zeros: the block votes once on each 32-key tile's biases (a warp
//   per tile) and walks only tiles with a live key. A Q tile with none
//   writes zeros and lse 0 without a pass over K. Tiles wholly above the
//   causal diagonal are not visited either.
// - 70 KB of shared memory a block at D = 64 (Q's hi, two stages, the
//   remainders of K and V, over which Q's remainder is staged before the
//   walk) and registers capped at 168 a thread: three blocks of four warps
//   an SM.
//
// Semantics follow the TPU kernel: the additive per-key bias (kv_mask as
// where(live, 0, -1e30), plus a learned kv_bias) is added to the scaled
// scores; causal masking replaces scores above the diagonal by -1e30; a
// query row whose running max stays at or below -0.5e30 (all its keys
// masked) gives exact zeros and lse = 0. Any T: positions past T in the
// last Q and K tiles are zero-filled and masked out. lse is emitted as
// (B*H, T), without the TPU's 8-sublane replication.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

#include "flash_tf32.cuh"
#include "flash_b16.cuh"

constexpr int kFwdKeys = 32;      // keys of a K/V stage

template <int D>
struct FwdTile {
  static constexpr int kLd = D + 4;           // padded row of a tile
  static constexpr int kTile = kBlock * kLd;  // floats of a 64 x D tile
  static constexpr int kNT = D / 8;           // mma n-tiles across D
  // Q's A fragments in registers for the whole walk (D a thread)
  static constexpr bool kQRegs = D <= 64;
  // a stage: K and V (kFwdKeys rows each), then the keys' bias
  static constexpr int kStage = 2 * kFwdKeys * kLd + kFwdKeys;
  // the tf32 remainders of a stage's K and V: 64 padded rows, a tile's
  // size, which holds Q's remainder while Q's fragments are taken (at D =
  // 128, where they are read all along, Q's remainder has its own tile)
  static constexpr int kLo = 2 * kFwdKeys * kLd;
  // Q's hi, two stages, the remainders (and Q's); the count and the list
  // of live key tiles follow (an int each, sized at launch)
  static constexpr size_t kBytes =
      sizeof(float) * (kTile + 2 * kStage + kLo + (kQRegs ? 0 : kTile));
  // blocks an SM that the registers are capped for: three at D <= 64 (168
  // registers a thread, a few spilled), which their 37-70 KB of shared
  // memory allow; one at D = 128. Timed against no hint in turns on the
  // card, the hint was faster at every D.
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
};

template <int D>
__global__ void __launch_bounds__(kThreads, FwdTile<D>::kMinBlocks)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int T,
                 float scale, int causal) {
  using Tile = FwdTile<D>;
  constexpr int NT = Tile::kNT, KT = kFwdKeys, NJ = KT / 8, KK = D / 8;
  constexpr bool kQRegs = Tile::kQRegs;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* stages = Qs + Tile::kTile;            // K, V, key bias; two of them
  float* lo_k = stages + 2 * Tile::kStage;     // the tf32 remainders
  float* lo_v = lo_k + KT * Tile::kLd;
  float* lo_q = kQRegs ? lo_k : lo_k + Tile::kLo;
  int* n_live = reinterpret_cast<int*>(lo_q + Tile::kTile);
  int* tiles = n_live + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBlock;
  const long long bh = blockIdx.y;
  const long long base = bh * T * D;
  const float* brow = bias == nullptr ? nullptr : bias + bh * T;

  // the 32-key tiles to walk: up to the causal diagonal, and only those with
  // a live key
  int n_tiles = (T + KT - 1) / KT;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlock, T) - 1) / KT + 1);
  for (int i = warp; i < n_tiles; i += kWarps) {
    const bool live = __any_sync(0xffffffffu, live_key(brow, i * KT + lane, T));
    if (lane == 0) tiles[i] = live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (tiles[i]) tiles[n++] = i;
    *n_live = n;
  }
  __syncthreads();
  const int nl = *n_live;

  // this thread's rows row_a and row_b; columns 8n + 2t and + 1. m is the
  // rows' running max (the quad's), l this thread's share of their sums.
  const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  if (nl > 0) {
    auto issue = [&](int i) {
      float* st = stages + (i & 1) * Tile::kStage;
      const int k0 = tiles[i] * KT;
      load_tile<D, KT>(st, k + base, k0, T);
      load_tile<D, KT>(st + KT * Tile::kLd, v + base, k0, T);
      if (brow != nullptr) load_row<KT>(st + 2 * KT * Tile::kLd, brow, k0, T);
    };
    load_tile<D>(Qs, q + base, q0, T);
    cp_async_commit();
    issue(0);
    cp_async_commit();

    // Q into tf32 halves, once
    cp_async_wait<1>();
    __syncthreads();
    split_tile<D, kBlock>(Qs, lo_q);
    __syncthreads();
    unsigned qh[kQRegs ? KK : 1][4], ql[kQRegs ? KK : 1][4];
    if constexpr (kQRegs) {
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
        pre_a<D>(Qs, lo_q, 16 * warp + g, 8 * kk + t, qh[kk], ql[kk]);
    }
    // (the walk's first barrier orders these reads before lo_k is written)

    for (int i = 0; i < nl; ++i) {
      if (i + 1 < nl) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();                // stage i has landed
      __syncthreads();
      float* Kw = stages + (i & 1) * Tile::kStage;
      split_tile<D, KT>(Kw, lo_k);
      split_tile<D, KT>(Kw + KT * Tile::kLd, lo_v);
      __syncthreads();
      const float* Ks = Kw;
      const float* Vs = Ks + KT * Tile::kLd;
      const float* Bs = Vs + KT * Tile::kLd;
      const int k0 = tiles[i] * KT;

      // S = Q K^T over the stage's keys
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
        unsigned ah[4], al[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qh[kk][e];
            al[e] = ql[kk][e];
          }
        } else {
          pre_a<D>(Qs, lo_q, 16 * warp + g, 8 * kk + t, ah, al);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          unsigned kh[2], kl[2];
          pre_b_nk<D>(Ks, lo_k, 8 * j + g, 8 * kk + t, kh, kl);
          mma3(s[j], ah, al, kh, kl);
        }
      }

      // scale, bias and masks; the rows' new max over the quad
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int key = k0 + col;
          const bool lo_row = e < 2;
          float x = s[j][e] * scale + (brow != nullptr ? Bs[col] : 0.f);
          if (causal && key > (lo_row ? row_a : row_b)) x = kNegInf;
          if (key >= T) x = -INFINITY;
          s[j][e] = x;
          if (lo_row) mx_a = fmaxf(mx_a, x);
          else mx_b = fmaxf(mx_b, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float alpha_a = expf(m_a - mx_a), alpha_b = expf(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      l_a *= alpha_a;
      l_b *= alpha_b;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo_row = e < 2;
          const float p = expf(s[j][e] - (lo_row ? m_a : m_b));
          s[j][e] = p;
          if (lo_row) l_a += p;
          else l_b += p;
        }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= alpha_a;
        acc[n][1] *= alpha_a;
        acc[n][2] *= alpha_b;
        acc[n][3] *= alpha_b;
      }

      // O += P V over the stage's keys, P straight from the registers
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        unsigned ph[4], pl[4];
        frag_acc(s[j], ph, pl);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          unsigned vh[2], vl[2];
          pre_b_kn<D>(Vs, lo_v, 8 * j + 2 * t, 8 * n + g, vh, vl);
          mma3(acc[n], ph, pl, vh, vl);
        }
      }
      __syncthreads();                   // the stage is refilled next
    }
  }

  // the quad's four shares of each row's sum
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const bool dead_a = m_a <= 0.5f * kNegInf, dead_b = m_b <= 0.5f * kNegInf;
  const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t;
    if (row_a < T)
      *reinterpret_cast<float2*>(out + base + (long long)row_a * D + col) =
          dead_a ? make_float2(0.f, 0.f)
                 : make_float2(acc[n][0] / la, acc[n][1] / la);
    if (row_b < T)
      *reinterpret_cast<float2*>(out + base + (long long)row_b * D + col) =
          dead_b ? make_float2(0.f, 0.f)
                 : make_float2(acc[n][2] / lb, acc[n][3] / lb);
  }
  if (t == 0) {
    if (row_a < T) lse[bh * T + row_a] = dead_a ? 0.f : m_a + logf(la);
    if (row_b < T) lse[bh * T + row_b] = dead_b ? 0.f : m_b + logf(lb);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* out, float* lse, int bh, int T, float scale, int causal,
           int device, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e = allow_smem(flash_fwd_kernel<D>, device, done);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = FwdTile<D>::kBytes +
                       sizeof(int) * ((T + kFwdKeys - 1) / kFwdKeys + 1);
  const dim3 grid((unsigned)((T + kBlock - 1) / kBlock), (unsigned)bh);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, bias, out, lse, T, scale, causal);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16 and fp16
//
// The 16-bit flavours (the TPU kernel on bf16 or fp16 q, k, v under the
// trainer's compute_dtype), one kernel over the element type E: both
// products on the tensor cores as mma.sync m16n8k16 with E operands and
// fp32 accumulators, one product where the fp32 route takes three. What
// bounds it: operations, 4 * BH * T * T * D at the bf16 and fp16 rate (989
// TFLOP/s), 6.5 us for the dense (96, 512, 64), against 25 MB of 16-bit q,
// k, v and out (7.5 us): near the ridge, so both matter.
// Design, a simple one first (wgmma and TMA are later work):
// - One block a 64-row Q tile of one b*h, four warps of 16 rows; Q's A
//   fragments are read once with ldmatrix and stay in registers.
// - K, V and the keys' bias stream in 64-key stages through a two-stage
//   cp.async ring; K's B fragments come by ldmatrix, V's by ldmatrix.trans.
// - S stays in registers: its fp32 accumulators become p = exp(s - m) in
//   place, l sums them in fp32, and p is rounded to E as it is packed
//   into P V's A fragments, where the TPU kernel rounds p to v's dtype (in
//   fp16 a p below 2**-14 stays a subnormal). O rounds to E once.
// - The dead-tile vote, the causal walk, the dead-row rule (exact zeros,
//   lse 0) and the fp32 lse are the fp32 route's.

constexpr int kFwdKeysB = 64;     // keys of a 16-bit K/V stage

template <int D>
struct FwdTileB {
  static constexpr int kLd = D + 8;           // elements a padded row
  static constexpr int kTile = kBlock * kLd;  // elements of a 64-row tile
  static constexpr int kStage = 2 * kFwdKeysB * kLd;   // a stage's K and V
  // Q, two stages of K and V, then two stages of the keys' bias (fp32); the
  // count and the list of live key tiles follow (an int each, sized at
  // launch)
  static constexpr size_t kBytes = kB16Bytes * (kTile + 2 * kStage) +
                                   sizeof(float) * 2 * kFwdKeysB;
};

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_b16_kernel(const E* __restrict__ q, const E* __restrict__ k,
                     const E* __restrict__ v, const float* __restrict__ bias,
                     E* __restrict__ out, float* __restrict__ lse, int T,
                     float scale, int causal) {
  using Tile = FwdTileB<D>;
  constexpr int KT = kFwdKeysB, NJ = KT / 8, KK = D / 16, NT = D / 8;

  extern __shared__ float4 smem4[];
  E* Qs = reinterpret_cast<E*>(smem4);
  E* stages = Qs + Tile::kTile;             // K, V; two of them
  float* biases = reinterpret_cast<float*>(stages + 2 * Tile::kStage);
  int* n_live = reinterpret_cast<int*>(biases + 2 * KT);
  int* tiles = n_live + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBlock;
  const long long bh = blockIdx.y;
  const long long base = bh * T * D;
  const float* brow = bias == nullptr ? nullptr : bias + bh * T;

  // the 64-key tiles to walk: up to the causal diagonal, and only those with
  // a live key
  int n_tiles = (T + KT - 1) / KT;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kBlock, T) - 1) / KT + 1);
  for (int i = warp; i < n_tiles; i += kWarps) {
    const bool live = any_live<KT>(brow, i * KT, T);
    if (lane == 0) tiles[i] = live;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < n_tiles; ++i)
      if (tiles[i]) tiles[n++] = i;
    *n_live = n;
  }
  __syncthreads();
  const int nl = *n_live;

  // this thread's rows row_a and row_b; columns 8n + 2t and + 1. m is the
  // rows' running max (the quad's), l this thread's share of their sums.
  const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;

  if (nl > 0) {
    auto issue = [&](int i) {
      E* st = stages + (i & 1) * Tile::kStage;
      const int k0 = tiles[i] * KT;
      load_tile16<D, KT>(st, k + base, k0, T);
      load_tile16<D, KT>(st + KT * Tile::kLd, v + base, k0, T);
      if (brow != nullptr) load_row<KT>(biases + (i & 1) * KT, brow, k0, T);
    };
    load_tile16<D, kBlock>(Qs, q + base, q0, T);
    cp_async_commit();
    issue(0);
    cp_async_commit();
    cp_async_wait<1>();                  // Q has landed
    __syncthreads();
    unsigned qf[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk)
      frag_a16<D>(qf[kk], Qs, 16 * warp, 16 * kk);

    for (int i = 0; i < nl; ++i) {
      if (i + 1 < nl) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();                // stage i has landed
      __syncthreads();
      const E* Ks = stages + (i & 1) * Tile::kStage;
      const E* Vs = Ks + KT * Tile::kLd;
      const float* Bs = biases + (i & 1) * KT;
      const int k0 = tiles[i] * KT;

      // S = Q K^T over the stage's keys
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int j2 = 0; j2 < NJ / 2; ++j2) {
          unsigned b[4];
          frag_b_nk<D>(b, Ks, 16 * j2, 16 * kk);
          mma16<E>(s[2 * j2], qf[kk], b);
          mma16<E>(s[2 * j2 + 1], qf[kk], b + 2);
        }

      // scale, bias and masks; the rows' new max over the quad
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int key = k0 + col;
          const bool lo_row = e < 2;
          float x = s[j][e] * scale + (brow != nullptr ? Bs[col] : 0.f);
          if (causal && key > (lo_row ? row_a : row_b)) x = kNegInf;
          if (key >= T) x = -INFINITY;
          s[j][e] = x;
          if (lo_row) mx_a = fmaxf(mx_a, x);
          else mx_b = fmaxf(mx_b, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float alpha_a = expf(m_a - mx_a), alpha_b = expf(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      l_a *= alpha_a;
      l_b *= alpha_b;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo_row = e < 2;
          const float p = expf(s[j][e] - (lo_row ? m_a : m_b));
          s[j][e] = p;
          if (lo_row) l_a += p;
          else l_b += p;
        }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= alpha_a;
        acc[n][1] *= alpha_a;
        acc[n][2] *= alpha_b;
        acc[n][3] *= alpha_b;
      }

      // O += P V over the stage's keys, P rounded to E in the registers
#pragma unroll
      for (int kp = 0; kp < KT / 16; ++kp) {
        unsigned a[4];
        pack_a<E>(a, s[2 * kp], s[2 * kp + 1]);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          unsigned b[4];
          frag_b_kn<D>(b, Vs, 16 * kp, 16 * n2);
          mma16<E>(acc[2 * n2], a, b);
          mma16<E>(acc[2 * n2 + 1], a, b + 2);
        }
      }
      __syncthreads();                   // the stage is refilled next
    }
  }

  // the quad's four shares of each row's sum
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const bool dead_a = m_a <= 0.5f * kNegInf, dead_b = m_b <= 0.5f * kNegInf;
  const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t;
    if (row_a < T)
      *reinterpret_cast<unsigned*>(out + base + (long long)row_a * D + col) =
          dead_a ? 0u : pack16<E>(acc[n][0] / la, acc[n][1] / la);
    if (row_b < T)
      *reinterpret_cast<unsigned*>(out + base + (long long)row_b * D + col) =
          dead_b ? 0u : pack16<E>(acc[n][2] / lb, acc[n][3] / lb);
  }
  if (t == 0) {
    if (row_a < T) lse[bh * T + row_a] = dead_a ? 0.f : m_a + logf(la);
    if (row_b < T) lse[bh * T + row_b] = dead_b ? 0.f : m_b + logf(lb);
  }
}

template <typename E, int D>
int launch_b16(const E* q, const E* k, const E* v, const float* bias, E* out,
               float* lse, int bh, int T, float scale, int causal,
               int device, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e = allow_smem(flash_fwd_b16_kernel<E, D>, device, done);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = FwdTileB<D>::kBytes +
                       sizeof(int) * ((T + kFwdKeysB - 1) / kFwdKeysB + 1);
  const dim3 grid((unsigned)((T + kBlock - 1) / kBlock), (unsigned)bh);
  flash_fwd_b16_kernel<E, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, bias, out, lse, T, scale, causal);
  return (int)cudaGetLastError();
}

// The 16-bit entries' body: q, k, v, out (bh, T, D) contiguous E, 16-byte
// aligned; D is 32, 64 or 128.
template <typename E>
int fwd16(const void* q, const void* k, const void* v, const float* bias,
          void* out, float* lse, int bh, int T, int D, float scale,
          int causal, int device, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bh <= 0 || bh > 65535 || T <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const E* qe = static_cast<const E*>(q);
  const E* ke = static_cast<const E*>(k);
  const E* ve = static_cast<const E*>(v);
  E* oe = static_cast<E*>(out);
  switch (D) {
    case 32:
      return launch_b16<E, 32>(qe, ke, ve, bias, oe, lse, bh, T, scale,
                               causal, device, stream);
    case 64:
      return launch_b16<E, 64>(qe, ke, ve, bias, oe, lse, bh, T, scale,
                               causal, device, stream);
    case 128:
      return launch_b16<E, 128>(qe, ke, ve, bias, oe, lse, bh, T, scale,
                                causal, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// The 16-bit flavours: q, k, v, out (bh, T, D) contiguous bf16 (or fp16),
// 16-byte aligned; bias and lse as above (fp32). D is 32, 64 or 128.
extern "C" int mxtpu_flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const float* bias,
    void* out, float* lse, int bh, int T, int D, float scale, int causal,
    int device, void* stream_ptr) {
  return fwd16<bf16>(q, k, v, bias, out, lse, bh, T, D, scale, causal,
                     device, stream_ptr);
}

extern "C" int mxtpu_flash_attention_fwd_f16(
    const void* q, const void* k, const void* v, const float* bias,
    void* out, float* lse, int bh, int T, int D, float scale, int causal,
    int device, void* stream_ptr) {
  return fwd16<f16>(q, k, v, bias, out, lse, bh, T, D, scale, causal,
                    device, stream_ptr);
}
