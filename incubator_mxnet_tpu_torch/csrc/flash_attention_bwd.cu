// Attention backward from the saved log-sum-exp (flash attention), fp32,
// bf16 and fp16, for Hopper (sm_90a): one kernel for dQ and one for dK and
// dV in each. The fp32 route is described first; the 16-bit route's notes
// (bf16 and fp16, one body over the element type, on wgmma fed by TMA)
// stand above its kernels, further down.
//
// Replaces incubator_mxnet_tpu/ops/pallas/flash_attention.py: _dq_kernel and
// _dkv_kernel, the latter with and without has_dbias (reached through
// _bwd_call and the custom VJP _flash_bwd of _flash_core). delta =
// rowsum(dO * O), one jnp reduction in _bwd_call, is one PyTorch reduction
// in the fp32 route's wrapper and the 16-bit dQ kernel's own work.
//
// What bounds it on the H100: operations. The gradient needs five T x T x D
// products per (batch, head): S = Q K^T, dP = dO V^T, dQ = dS K, dK = dS^T Q
// and dV = P^T dO, 10 * T * T * D operations, against some 7 * T * D * 4 bytes
// of q, k, v, out, dO, dq, dk, dv. At (B*H, T, D) = (96, 512, 64) that is
// 16.1 GFLOP: 0.24 ms at the 67 TFLOP/s of fp32 on the CUDA cores, 0.098 ms
// as three TF32 tensor-core products each (494.7 TFLOP/s), while the bytes
// would take 0.03 ms.
//
// What the design does about it (the building blocks, shared with the
// forward, are in flash_tf32.cuh):
// - Every product runs on the tensor cores (mma.sync m16n8k8, tf32) and stays
//   fp32-accurate by the 3xTF32 split: x = hi + lo with hi = tf32(x) and
//   lo = tf32(x - hi), rounded as cvt.rna.tf32 rounds (nearest, ties away),
//   and a * b = hi*lo + lo*hi + hi*hi (the lo*lo term dropped, as CUTLASS's
//   OpMultiplyAddFastF32).
// - Sums that round to nearest. The H100's tensor cores align an mma's
//   products and its C input to the largest and cut the rest toward zero
//   (chip_smoke.py's tc_rounding line: 1 - 0.125 ulp comes back as 1), so a
//   sum carried through C for 512 keys would drift. Each k-step's three
//   products go into a fresh accumulator, which is added to the running fp32
//   sum on the CUDA cores. dK and dV sum over every query of the sequence
//   and can reach |60| where few keys are live; there the partial sums of
//   every 64 queries are folded into running sums (dk's in registers, dv's
//   in shared memory) with an exact 2Sum, and the rounding error starts the
//   next partial (compensated summation), so a sum over any T rounds about
//   as if once.
// - The JAX split of the work: the dQ kernel gives one block to each (64-row
//   Q tile, b*h), keeps the Q and dO tiles in shared memory and walks the
//   keys 32 at a time; the dK/dV kernel gives one block to each (64-key
//   tile, b*h), keeps K and V and walks the queries 32 at a time. Both recompute S
//   and dP, so together they do seven products where five would do; in
//   exchange neither needs atomics, and each output element is written by
//   one block: two calls on the same inputs are bitwise equal.
// - Four warps a block, each owning 16 rows (dQ) or 16 keys (dK/dV). In the
//   second product of each kernel the contraction index inside each group
//   of 8 is permuted (mma k-slot t holds element 2t, slot t + 4 element
//   2t + 1), so that the accumulator fragments of the S-shaped products are
//   its A fragments: dS feeds dQ += dS K, P^T and dS^T feed dV += P^T dO and
//   dK += dS^T Q, straight from registers.
// - Tiles sit in shared memory with rows of D + 4 floats: the fragment reads
//   (rows g, columns t; rows 2t + e, columns g) hit 32 distinct banks, and
//   each is a base register per thread plus a constant offset.
// - The streamed tiles (K, V and the key bias for dQ; Q, dO, lse and delta
//   for dK/dV) come through a two-stage cp.async ring: tile i + 1 lands while
//   tile i's products run. Once a stage has landed, the block splits its two
//   matrices into tf32 halves in shared memory (hi in place, lo beside), so
//   each value is split once rather than by every warp at every use; the
//   resident A operands (Q and dO, or K and V) are split as they are read.
//   At D = 64 a block holds 87-104 KB (dQ: Q, dO, two 32-key K/V stages and
//   the remainders; dK/dV: K, V, two 32-query stages, the remainders and
//   dv's running sums), so two blocks of 128 threads share an SM.
// - Key tiles with no live key are skipped. A key whose bias is at or below
//   -0.5e30 (the mask's -1e30, plus any learned bias) has p = exp(s - lse) =
//   0 exactly in fp32, so its dS is 0 and it adds exact zeros: the dQ kernel
//   votes on each key tile's biases first and walks only tiles with a live
//   key, and a dK/dV block whose 64 keys are all dead writes zeros to dk and
//   dv (and dbias) and returns. A tile with any live key is computed whole.
//   The causal walk still ends at the diagonal.
//
// The cotangent of a learned per-key bias (has_dbias): dbias[key] = sum over
// query rows of P * (dP - delta), the unscaled dS. The dK/dV kernel forms it
// beside dS: each thread sums its query columns for its two keys, and the
// four threads of a quad add theirs at the end with shuffles. It writes (B*H,
// T) floats, where the TPU kernel writes (B*H, 8, T) with only sublane 0
// live. A null dbias pointer launches the instantiation without it; dk and dv
// come out bitwise the same in both.
//
// Semantics follow the TPU kernels: s = q.k * scale + bias[key], causal
// scores above the diagonal are -1e30, and p = exp(s - lse). A query row
// whose keys are all masked has lse = 0 and out = 0 from the forward; its
// scores keep the -1e30 bias, so p = 0, its dq is exactly 0 and it adds
// nothing to dk and dv. Any T: rows and keys past T are zero-filled in the
// tiles and get p = 0.

#include <cuda.h>    // CUtensorMap and its enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

#include "flash_tf32.cuh"
#include "flash_b16.cuh"
#include "hopper.cuh"
#include "flash_wg.cuh"

constexpr int kDkvRows = 32;      // queries of a dK/dV stage
constexpr int kDqKeys = 32;       // keys of a dQ stage

template <int D>
struct BwdTile {
  static constexpr int kLd = D + 4;           // padded row of a tile
  static constexpr int kTile = kBlock * kLd;  // floats of a 64 x D tile
  static constexpr int kNT = D / 8;           // mma n-tiles across D
  // keys of one dQ pass over S and dP: the whole 32-key stage, or half of it
  // at D = 128, where dQ's accumulators take 64 registers
  static constexpr int kChunkDq = D == 128 ? 16 : 32;
  // dQ: Q and dO, two stages of kDqKeys keys' K, V and key bias, and the
  // tf32 remainders of a stage's K and V; the count and the list of live
  // key tiles follow (an int each, sized at launch)
  static constexpr int kDqStage = 2 * kDqKeys * kLd + kDqKeys;
  static constexpr size_t kDqBytes =
      sizeof(float) * (2 * kTile + 2 * kDqStage + 2 * kDqKeys * kLd);
  // dK/dV: K and V, two stages of kDkvRows queries' Q, dO, lse and delta,
  // the tf32 remainders of a stage's Q and dO, then each thread's running dv
  // sums (D / 2 floats)
  static constexpr int kDkvStage = 2 * kDkvRows * kLd + 2 * kDkvRows;
  static constexpr size_t kDkvBytes =
      sizeof(float) * (2 * kTile + 2 * kDkvStage + 2 * kDkvRows * kLd +
                       kThreads * D / 2);
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, float* __restrict__ dq,
                    int T, float scale, int causal) {
  using Tile = BwdTile<D>;
  constexpr int NT = Tile::kNT, CH = Tile::kChunkDq, NJ = CH / 8;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + Tile::kTile;
  float* stages = dOs + Tile::kTile;   // K, V, key bias; two of them
  float* lo_k = stages + 2 * Tile::kDqStage;    // the tf32 remainders
  float* lo_v = lo_k + kDqKeys * Tile::kLd;
  int* n_live = reinterpret_cast<int*>(lo_v + kDqKeys * Tile::kLd);
  int* tiles = n_live + 1;
  constexpr int KT = kDqKeys;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBlock;
  const long long bh = blockIdx.y;
  const long long base = bh * T * D;
  const float* brow = bias == nullptr ? nullptr : bias + bh * T;

  // the 32-key tiles to walk: up to the causal diagonal, and only those with
  // a live key (a dead tile adds exact zeros)
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

  // this thread's accumulator rows; columns 8n + 2t and + 1
  const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (nl > 0) {
    auto issue = [&](int i) {
      float* st = stages + (i & 1) * Tile::kDqStage;
      const int k0 = tiles[i] * KT;
      load_tile<D, KT>(st, k + base, k0, T);
      load_tile<D, KT>(st + KT * Tile::kLd, v + base, k0, T);
      if (brow != nullptr) load_row<KT>(st + 2 * KT * Tile::kLd, brow, k0, T);
    };
    load_tile<D>(Qs, q + base, q0, T);
    load_tile<D>(dOs, dout + base, q0, T);
    issue(0);
    cp_async_commit();
    const float lse_a = row_a < T ? lse[bh * T + row_a] : 0.f;
    const float lse_b = row_b < T ? lse[bh * T + row_b] : 0.f;
    const float delta_a = row_a < T ? delta[bh * T + row_a] : 0.f;
    const float delta_b = row_b < T ? delta[bh * T + row_b] : 0.f;

    for (int i = 0; i < nl; ++i) {
      if (i + 1 < nl) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();                // tile i (and Q, dO) have landed
      __syncthreads();
      float* Kw = stages + (i & 1) * Tile::kDqStage;
      split_tile<D, KT>(Kw, lo_k);
      split_tile<D, KT>(Kw + KT * Tile::kLd, lo_v);
      __syncthreads();
      const float* Ks = Kw;
      const float* Vs = Ks + KT * Tile::kLd;
      const float* Bs = Vs + KT * Tile::kLd;
      const int k0 = tiles[i] * KT;

#pragma unroll
      for (int c0 = 0; c0 < KT; c0 += CH) {
        // S = Q K^T and dP = dO V^T over the chunk's keys
        float s[NJ][4], dp[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          unsigned qh[4], ql[4], oh[4], ol[4];
          frag_a<D>(Qs, 16 * warp + g, 8 * kk + t, qh, ql);
          frag_a<D>(dOs, 16 * warp + g, 8 * kk + t, oh, ol);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            unsigned kh[2], kl[2], vh[2], vl[2];
            pre_b_nk<D>(Ks, lo_k, c0 + 8 * j + g, 8 * kk + t, kh, kl);
            pre_b_nk<D>(Vs, lo_v, c0 + 8 * j + g, 8 * kk + t, vh, vl);
            mma3(s[j], qh, ql, kh, kl);
            mma3(dp[j], oh, ol, vh, vl);
          }
        }
        // dS = P * (dP - delta) * scale, P = exp(S * scale + bias - lse)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + 2 * t + (e & 1);
            const int key = k0 + col;
            const bool lo_row = e < 2;
            float x = s[j][e] * scale + (brow != nullptr ? Bs[col] : 0.f);
            if (causal && key > (lo_row ? row_a : row_b)) x = kNegInf;
            const float p = key < T ? expf(x - (lo_row ? lse_a : lse_b)) : 0.f;
            s[j][e] = p * (dp[j][e] - (lo_row ? delta_a : delta_b)) * scale;
          }
        // dQ += dS K over the chunk's keys
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          unsigned ah[4], al[4];
          frag_acc(s[j], ah, al);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            unsigned kh[2], kl[2];
            pre_b_kn<D>(Ks, lo_k, c0 + 8 * j + 2 * t, 8 * n + g, kh, kl);
            mma3(acc[n], ah, al, kh, kl);
          }
        }
      }
      __syncthreads();                   // the stage is refilled next
    }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t;
    if (row_a < T)
      *reinterpret_cast<float2*>(dq + base + (long long)row_a * D + col) =
          make_float2(acc[n][0], acc[n][1]);
    if (row_b < T)
      *reinterpret_cast<float2*>(dq + base + (long long)row_b * D + col) =
          make_float2(acc[n][2], acc[n][3]);
  }
}

// a + b rounded to a float, and in err its rounding error exactly (2Sum:
// for any magnitudes of a and b)
__device__ __forceinline__ float two_sum(float a, float b, float& err) {
  const float s = a + b;
  const float bb = s - a;
  err = (a - (s - bb)) + (b - bb);
  return s;
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
  using Tile = BwdTile<D>;
  constexpr int NT = Tile::kNT, R = kDkvRows, NJ = R / 8;

  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + Tile::kTile;
  float* stages = Vs + Tile::kTile;    // Q, dO, lse, delta; two of them
  float* lo_q = stages + 2 * Tile::kDkvStage;   // the tf32 remainders
  float* lo_o = lo_q + kDkvRows * Tile::kLd;
  // this thread's running dv: float4 (n, thread) at [n][threadIdx.x]
  float4* sums = reinterpret_cast<float4*>(lo_o + kDkvRows * Tile::kLd);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kBlock;
  const long long bh = blockIdx.y;
  const long long base = bh * T * D;
  const float* brow = bias == nullptr ? nullptr : bias + bh * T;

  // this thread's accumulator rows are keys key_a and key_b; columns 8n + 2t
  // and + 1. The products go to dk_t and dv_t, which are added every 64
  // queries to the running sums (dk_s, and dv's in shared memory, where
  // registers ran out), with their rounding error carried into the next
  // partial (compensated summation: a sum over thousands of queries rounds
  // about as if once).
  const int key_a = k0 + 16 * warp + g, key_b = key_a + 8;
  float dk_t[NT][4], dv_t[NT][4], dk_s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_t[n][e] = dv_t[n][e] = dk_s[n][e] = 0.f;
    sums[n * kThreads + threadIdx.x] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float db_a = 0.f, db_b = 0.f;

  // a block whose keys are all dead writes zeros
  const bool any = threadIdx.x < kBlock && live_key(brow, k0 + threadIdx.x, T);
  if (__syncthreads_or(any)) {
    const float bias_a = (brow != nullptr && key_a < T) ? brow[key_a] : 0.f;
    const float bias_b = (brow != nullptr && key_b < T) ? brow[key_b] : 0.f;
    // causal: the query tiles before this key tile see none of its keys
    const int t0 = causal ? k0 / R : 0;
    const int n_q = (T + R - 1) / R;
    auto issue = [&](int i) {
      float* st = stages + ((i - t0) & 1) * Tile::kDkvStage;
      const int r0 = i * R;
      load_tile<D, R>(st, q + base, r0, T);
      load_tile<D, R>(st + R * Tile::kLd, dout + base, r0, T);
      load_row<R>(st + 2 * R * Tile::kLd, lse + bh * T, r0, T);
      load_row<R>(st + 2 * R * Tile::kLd + R, delta + bh * T, r0, T);
    };
    load_tile<D, kBlock>(Ks, k + base, k0, T);
    load_tile<D, kBlock>(Vs, v + base, k0, T);
    issue(t0);
    cp_async_commit();

    for (int i = t0; i < n_q; ++i) {
      if (i + 1 < n_q) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();                // tile i (and K, V) have landed
      __syncthreads();
      float* Qw = stages + ((i - t0) & 1) * Tile::kDkvStage;
      split_tile<D, R>(Qw, lo_q);
      split_tile<D, R>(Qw + R * Tile::kLd, lo_o);
      __syncthreads();
      const float* Qs = Qw;
      const float* dOs = Qs + R * Tile::kLd;
      const float* Ls = dOs + R * Tile::kLd;
      const float* Dl = Ls + R;
      const int r0 = i * R;

      // S^T = K Q^T and dP^T = V dO^T over the tile's queries
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        unsigned kh[4], kl[4], vh[4], vl[4];
        frag_a<D>(Ks, 16 * warp + g, 8 * kk + t, kh, kl);
        frag_a<D>(Vs, 16 * warp + g, 8 * kk + t, vh, vl);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          unsigned qh[2], ql[2], oh[2], ol[2];
          pre_b_nk<D>(Qs, lo_q, 8 * j + g, 8 * kk + t, qh, ql);
          pre_b_nk<D>(dOs, lo_o, 8 * j + g, 8 * kk + t, oh, ol);
          mma3(s[j], kh, kl, qh, ql);
          mma3(dp[j], vh, vl, oh, ol);
        }
      }
      // P^T, and dS^T = P^T * (dP^T - delta) * scale; dbias sums the
      // unscaled dS over the queries
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int query = r0 + col;
          const bool lo_row = e < 2;
          const int key = lo_row ? key_a : key_b;
          float x = s[j][e] * scale + (lo_row ? bias_a : bias_b);
          if (causal && key > query) x = kNegInf;
          const float p = (key < T && query < T) ? expf(x - Ls[col]) : 0.f;
          const float ds = p * (dp[j][e] - Dl[col]);
          if (kDbias) {
            if (lo_row) db_a += ds;
            else db_b += ds;
          }
          s[j][e] = p;
          dp[j][e] = ds * scale;
        }
      // dV += P^T dO and dK += dS^T Q over the tile's queries
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        unsigned ph[4], pl[4], dh[4], dl[4];
        frag_acc(s[j], ph, pl);
        frag_acc(dp[j], dh, dl);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          unsigned bh2[2], bl2[2];
          pre_b_kn<D>(dOs, lo_o, 8 * j + 2 * t, 8 * n + g, bh2, bl2);
          mma3(dv_t[n], ph, pl, bh2, bl2);
          pre_b_kn<D>(Qs, lo_q, 8 * j + 2 * t, 8 * n + g, bh2, bl2);
          mma3(dk_t[n], dh, dl, bh2, bl2);
        }
      }
      // every 64 queries and at the end, into the running sums; the rounding
      // error starts the next partial
      if (((i - t0) & 1) || i + 1 == n_q) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dk_s[n][e] = two_sum(dk_s[n][e], dk_t[n][e], dk_t[n][e]);
        float4 b = sums[n * kThreads + threadIdx.x];
        b.x = two_sum(b.x, dv_t[n][0], dv_t[n][0]);
        b.y = two_sum(b.y, dv_t[n][1], dv_t[n][1]);
        b.z = two_sum(b.z, dv_t[n][2], dv_t[n][2]);
        b.w = two_sum(b.w, dv_t[n][3], dv_t[n][3]);
        sums[n * kThreads + threadIdx.x] = b;
      }
      }
      __syncthreads();                   // the stage is refilled next
    }
  }

  if (kDbias) {
    // the four threads of a quad hold the same two keys
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      db_a += __shfl_xor_sync(0xffffffffu, db_a, off);
      db_b += __shfl_xor_sync(0xffffffffu, db_b, off);
    }
    if (t == 0) {
      if (key_a < T) dbias[bh * T + key_a] = db_a;
      if (key_b < T) dbias[bh * T + key_b] = db_b;
    }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float4 a = make_float4(dk_s[n][0], dk_s[n][1], dk_s[n][2], dk_s[n][3]);
    const float4 b = sums[n * kThreads + threadIdx.x];
    const int col = 8 * n + 2 * t;
    if (key_a < T) {
      const long long o = base + (long long)key_a * D + col;
      *reinterpret_cast<float2*>(dk + o) =
          make_float2(a.x + dk_t[n][0], a.y + dk_t[n][1]);
      *reinterpret_cast<float2*>(dv + o) =
          make_float2(b.x + dv_t[n][0], b.y + dv_t[n][1]);
    }
    if (key_b < T) {
      const long long o = base + (long long)key_b * D + col;
      *reinterpret_cast<float2*>(dk + o) =
          make_float2(a.z + dk_t[n][2], a.w + dk_t[n][3]);
      *reinterpret_cast<float2*>(dv + o) =
          make_float2(b.z + dv_t[n][2], b.w + dv_t[n][3]);
    }
  }
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              const float* bias, float* dq, int bh, int T, float scale,
              int causal, int device, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, device, done);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (T + kBlock - 1) / kBlock;
  const size_t bytes =
      BwdTile<D>::kDqBytes + sizeof(int) * ((T + kDqKeys - 1) / kDqKeys + 1);
  const dim3 grid((unsigned)n_tiles, (unsigned)bh);
  flash_bwd_dq_kernel<D><<<grid, kThreads, bytes, stream>>>(
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
  const cudaError_t e =
      allow_smem(flash_bwd_dkv_kernel<D, kDbias>, device, done);
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

// ------------------------------------------------------- bf16 and fp16
//
// The 16-bit flavours (the TPU kernels on bf16 or fp16 q, k, v and dO under
// the trainer's compute_dtype), one body over the element type E; the
// dK/dV kernel with and without has_dbias (a learned key bias trained in
// bf16 or fp16). What bounds them: operations (seven T x T x D products
// between the two kernels at the 16-bit rate, 989 TFLOP/s), with half the
// fp32 bytes. The design is Hopper's own (hopper.cuh; the wgmma machinery,
// shared with the 16-bit forward, in flash_wg.cuh):
// - The JAX split: a dQ block owns 128 Q rows and walks the keys, 64 a
//   stage; a dK/dV block owns 128 keys and walks the queries, 32 a stage
//   (16 at D = 128, where dk's and dv's accumulators take 128 registers).
//   No atomics: each output element is written by one block, and two calls
//   on the same inputs are bitwise equal.
// - A block is three warpgroups, one an SM: a producer, whose first warp
//   keeps a ring of stages (4 for dQ, 6 for dK/dV) filled with TMA loads,
//   and two consumers, each owning 64 of the block's rows (keys), that run
//   every product as wgmma on the stages they share as they land. Full and
//   empty mbarriers hand the stages over. setmaxnreg gives the producer 24
//   registers a thread and the consumers 240 at run time; ptxas 12.8 still
//   compiles every region to the launch bound's 168, so the tiles are
//   sized to fit 168 (no spills at D <= 64).
// - Products, all m64nNk16 with E operands and fp32 accumulators: S = Q K^T
//   and dP = dO V^T (dQ kernel), S^T = K Q^T and dP^T = V dO^T (dK/dV
//   kernel) take both operands K-major from shared memory, the resident
//   tile as A and the stage as B; dQ += dS K, dV += P^T dO and dK += dS^T Q
//   take A from registers (P and dS, taken from the first products'
//   accumulators into registers of their own and rounded to E by pack_a:
//   they never leave registers) and B from the same stage read MN-major
//   (the transposed-B descriptor; no transposed copy). B is read from
//   shared memory once a warpgroup, not once a warp. Only the products
//   write their accumulators (the first of a sum overwrites), so ptxas
//   keeps them asynchronous.
// - Overlap: S and dP are two commit groups; the exp of a stage runs while
//   its dP product does (wait_group 1), and a stage's second products run
//   while the next stage's S and dP are issued. A stage goes back to the
//   producer once the products of the stage after it have started, so the
//   ring runs up to three stages ahead. The two consumers take turns at
//   the tensor cores (named barriers 1 and 2), so that one's exp and
//   rounding run while the other's products do.
// - TMA reads 3-D tensor maps (D, T, B*H), one a tensor, in boxes of 64
//   (D >= 64, 128-byte swizzle) or 32 (D = 32, 64-byte swizzle) columns;
//   rows past T land as zeros and never reach the next head's rows (in fp16
//   an inf in dO then stays in its head). The maps are encoded on the host
//   for each call and passed as __grid_constant__ parameters.
// - delta = rowsum(dO * O) is the dQ kernel's: each consumer takes it in
//   fp32 for its 64 rows from dO and O while its first stage's products run
//   (the products of two 16-bit values are exact in fp32), uses it, and
//   writes it out (B*H, T) for the dK/dV kernel, which runs after it on the
//   same stream.
// - p = 2^(s * scale * log2(e) + (bias - lse) * log2(e)) by ex2.approx
//   without .ftz, with no branch: a stage that reaches past T or across the
//   causal diagonal sets its dead scores' argument to -1e30 (p = 0), and
//   one that does not skips the test. dS = p * (dP - delta) * scale, in
//   fp32; p and dS round to E (cvt.rn) as they are packed into the second
//   products' A fragments, where the TPU kernel rounds them to v's dtype
//   (_recompute_p_ds). The sums stay fp32, and dq, dk and dv round to E
//   once, at the end. In fp16 a dS past 65504 (a loss scale that overflows)
//   rounds to inf and so does every gradient it feeds: the rounding never
//   saturates, so the guard's finite check sees the overflow.
// - The dead-tile rules are the fp32 route's: the dQ kernel walks only key
//   tiles with a live key (a vote of the whole block before the roles
//   split), a dK/dV block whose 128 keys are all dead writes zeros, and the
//   causal walks end (dQ) or start (dK/dV) at the diagonal.
// - dbias (kDbias): each thread sums, in fp32 registers, the unscaled and
//   unrounded dS = p * (dP - delta) of its two keys over the queries it
//   holds, as _dkv_kernel sums ds_bias; the quad's four partial sums meet
//   by two shuffles at the end. A masked key's p is 0 for every query, so
//   its dbias is exactly 0.

constexpr int kKeysDq = 64;         // keys of a dQ stage

// the sum over n elements (a multiple of 8, 16-byte aligned) of x * y in
// fp32, in order; a product of two 16-bit values is exact in fp32
template <typename E, int n>
__device__ __forceinline__ float dot16(const E* x, const E* y) {
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < n; c += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(x + c);
    const uint4 b = *reinterpret_cast<const uint4*>(y + c);
    const unsigned ua[4] = {a.x, a.y, a.z, a.w}, ub[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = widen2<E>(ua[i]), fb = widen2<E>(ub[i]);
      sum = fmaf(fa.x, fb.x, sum);
      sum = fmaf(fa.y, fb.y, sum);
    }
  }
  return sum;
}

// byte offsets from the 1024-aligned base of the dQ kernel's shared memory:
// each consumer's Q, then each one's dO, the ring of K and V stages, each
// stage's key biases * log2(e), the mbarriers (Q/dO, full[kStages],
// empty[kStages]); the count and list of live key tiles follow (sized at
// launch)
template <int D>
struct DqTile {
  static constexpr int kStages = 4;
  static constexpr int kTile = kBlock * D * kB16Bytes;      // Q or dO
  static constexpr int kKv = kKeysDq * D * kB16Bytes;       // K or V
  static constexpr int kStage = 2 * kKv;
  static constexpr int kRing = 2 * kConsumers * kTile;
  static constexpr int kBias = kRing + kStages * kStage;
  static constexpr int kBars = kBias + kStages * kKeysDq * 4;
  static constexpr int kList = kBars + (1 + 2 * kStages) * 8;
  static constexpr size_t kBytes = kList + 1024;            // + alignment
};

// byte offsets of the dK/dV kernel's: each consumer's K, then each one's
// V, the ring of Q and dO stages of kRows queries, each stage's lse *
// log2(e) and delta, the mbarriers (K/V, full[kStages], empty[kStages]).
// kRows keeps a consumer's accumulators (dk, dv: D each; S^T, dP^T: kRows
// each, over 128 threads) inside the 168 registers a thread of a 384-thread
// block has
template <int D>
struct DkvTile {
  static constexpr int kRows = D == 128 ? 16 : 32;
  static constexpr int kStages = 6;
  static constexpr int kTile = kBlock * D * kB16Bytes;      // K or V
  static constexpr int kQo = kRows * D * kB16Bytes;         // Q or dO
  static constexpr int kStage = 2 * kQo;
  static constexpr int kRing = 2 * kConsumers * kTile;
  static constexpr int kStats = kRing + kStages * kStage;
  static constexpr int kBars = kStats + kStages * 2 * kRows * 4;
  static constexpr size_t kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

template <typename E, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const E* __restrict__ dout, const E* __restrict__ out,
                       const float* __restrict__ lse,
                       const float* __restrict__ bias, E* __restrict__ dq,
                       float* __restrict__ delta, int T, float scale,
                       int causal) {
  using Tile = DqTile<D>;
  using P = Pan<D>;
  constexpr int KT = kKeysDq, S = Tile::kStages, NS = KT / 2, NQ = D / 2;

  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  float* biases = reinterpret_cast<float*>(gbase + Tile::kBias);
  const unsigned qbar = base + Tile::kBars, full = qbar + 8,
                 empty = full + 8 * S;
  int* n_live = reinterpret_cast<int*>(gbase + Tile::kList);
  int* tiles = n_live + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kRowsBlock;
  const int bh = blockIdx.y;
  const long long rbase = (long long)bh * T;
  const float* brow = bias == nullptr ? nullptr : bias + rbase;

  // the key tiles to walk: up to the causal diagonal of the block's last
  // row, and only those with a live key (a dead tile adds exact zeros)
  int n_tiles = (T + KT - 1) / KT;
  if (causal)
    n_tiles = min(n_tiles, (min(q0 + kRowsBlock, T) - 1) / KT + 1);
  for (int i = warp; i < n_tiles; i += kWgThreads / 32) {
    const bool live = any_live<KT>(brow, i * KT, T);
    if (lane == 0) tiles[i] = live;
  }
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 32);        // each lane of the producer warp
      mbar_init(empty + 8 * s, 4 * kConsumers);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

  // the warpgroup, as the compiler can see it is uniform across it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // producer: its first warp loads Q and dO once, then the live key
    // tiles' K, V (TMA, lane 0) and key biases (every lane; zeros without
    // a bias) into the ring
    setmaxnreg_dec24();
    if (warp == 4 * kConsumers && nl > 0) {
      if (lane == 0) {
        mbar_expect_tx(qbar, 2 * kConsumers * Tile::kTile);
        for (int c = 0; c < kConsumers; ++c) {
          P::template load<kBlock>(base + c * Tile::kTile, &map_q, qbar,
                                   q0 + c * kBlock, bh);
          P::template load<kBlock>(base + (kConsumers + c) * Tile::kTile,
                                   &map_do, qbar, q0 + c * kBlock, bh);
        }
      }
      for (int i = 0; i < nl; ++i) {
        const int s = i % S, k0 = tiles[i] * KT;
        mbar_wait(empty + 8 * s, ((i / S) & 1) ^ 1);
        for (int j = lane; j < KT; j += 32)
          biases[s * KT + j] = (brow != nullptr && k0 + j < T)
                                   ? brow[k0 + j] * kLog2e
                                   : 0.f;
        if (lane == 0) {
          const unsigned st = base + Tile::kRing + s * Tile::kStage;
          mbar_expect_tx(full + 8 * s, Tile::kStage);
          P::template load<KT>(st, &map_k, full + 8 * s, k0, bh);
          P::template load<KT>(st + Tile::kKv, &map_v, full + 8 * s, k0,
                               bh);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // consumer warpgroup wg: its warp w owns rows q0 + 64 wg + 16 w .. +
    // 15; its thread's accumulator rows are row_a and row_b, columns 8 n +
    // 2 t and + 1
    setmaxnreg_inc240();
    const int w = warp % 4, g = lane / 4, t = lane % 4;
    const int row_lo = q0 + kBlock * wg;  // the warpgroup's first row
    const int row_a = row_lo + 16 * w + g, row_b = row_a + 8;

    // delta of rows row_a and row_b: each thread of a quad sums a quarter
    // of the row, the quad adds the four sums
    float dl[2];
    auto take_delta = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = h ? row_b : row_a;
        float sum = 0.f;
        if (row < T) {
          const long long o = (rbase + row) * D + t * (D / 4);
          sum = dot16<E, D / 4>(dout + o, out + o);
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        dl[h] = sum;
      }
      if (t == 0) {
        if (row_a < T) delta[rbase + row_a] = dl[0];
        if (row_b < T) delta[rbase + row_b] = dl[1];
      }
    };

    // dq's sums: written by the products only (the first overwrites), or
    // zeros where no key tile is live
    float acc[NQ];
    if (nl == 0) {
      take_delta();
#pragma unroll
      for (int i = 0; i < NQ; ++i) acc[i] = 0.f;
    } else {
      const float sl2 = scale * kLog2e;
      const float lse_a = row_a < T ? lse[rbase + row_a] * kLog2e : 0.f;
      const float lse_b = row_b < T ? lse[rbase + row_b] * kLog2e : 0.f;
      const unsigned qs = base + wg * Tile::kTile,
                     dos = base + (kConsumers + wg) * Tile::kTile;
      // S and dP are the products' alone; P, then dS, are taken into p
      float s[NS], dp[NS], p[NS];
      unsigned a[KT / 16][4];
      // S = Q K^T and dP = dO V^T of stage i, two commit groups
      auto issue = [&](int i) {
        const int slot = i % S;
        const unsigned st = base + Tile::kRing + slot * Tile::kStage;
        mbar_wait(full + 8 * slot, (i / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wg_ss<E, KT>(s, P::template k<kBlock>(qs, kk),
                       P::template k<KT>(st, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wg_ss<E, KT>(dp, P::template k<kBlock>(dos, kk),
                       P::template k<KT>(st + Tile::kKv, kk), kk > 0);
        wgmma_commit();
      };
      mbar_wait(qbar, 0);
      if (wg == 1) turn_pass(1);        // warpgroup 0 issues first
      turn_wait(wg);
      issue(0);
      turn_pass(wg);
      take_delta();                     // while stage 0's products run
      for (int i = 0; i < nl; ++i) {
        const int slot = i % S, k0 = tiles[i] * KT;
        const unsigned st = base + Tile::kRing + slot * Tile::kStage;
        const float* bs = biases + slot * KT;
        // S of stage i has landed, and stage i - 1's dQ product is done:
        // its K and V go back to the producer
        wgmma_wait<1>();
        fence_all<NS>(s);
        fence_all<KT / 16>(a);
        if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % S));
        // P = exp(S * scale + bias - lse), while dP runs; a stage that
        // reaches past T or across this warpgroup's causal diagonal masks
        // its scores one by one (to -1e30: p = 0), without a branch
        if (k0 + KT <= T && (!causal || k0 + KT - 1 <= row_lo)) {
#pragma unroll
          for (int j = 0; j < NS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float b = bs[8 * j + 2 * t + e];
              p[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, b - lse_a));
              p[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], sl2, b - lse_b));
            }
        } else {
#pragma unroll
          for (int j = 0; j < NS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1), key = k0 + col;
              const bool lo = e < 2;
              const bool dead =
                  key >= T || (causal && key > (lo ? row_a : row_b));
              const float x =
                  fmaf(s[4 * j + e], sl2, bs[col] - (lo ? lse_a : lse_b));
              p[4 * j + e] = ex2(dead ? kNegInf : x);
            }
        }
        wgmma_wait<0>();
        fence_all<NS>(dp);
        // dS = P * (dP - delta) * scale, rounded to E into dQ's A
        // fragments
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[4 * j + e] =
                p[4 * j + e] * (dp[4 * j + e] - dl[e >> 1]) * scale;
#pragma unroll
        for (int kp = 0; kp < KT / 16; ++kp)
          pack_a<E>(a[kp], p + 8 * kp, p + 8 * kp + 4);
        // dQ += dS K over the stage's keys, K read MN-major, then the next
        // stage's S and dP, in this warpgroup's turn
        turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int kp = 0; kp < KT / 16; ++kp)
          wg_rs<E, D>(acc, a[kp], P::template mn<KT>(st, kp), i + kp > 0);
        wgmma_commit();
        if (i + 1 < nl) issue(i + 1);
        if (wg == 0 || i + 1 < nl) turn_pass(wg);
      }
      wgmma_wait<0>();
      fence_all<NQ>(acc);
      fence_all<KT / 16>(a);
    }

    E* dq_a = dq + (rbase + row_a) * D;
    E* dq_b = dq + (rbase + row_b) * D;
#pragma unroll
    for (int n = 0; n < NQ / 4; ++n) {
      const int col = 8 * n + 2 * t;
      if (row_a < T)
        *reinterpret_cast<unsigned*>(dq_a + col) =
            pack16<E>(acc[4 * n], acc[4 * n + 1]);
      if (row_b < T)
        *reinterpret_cast<unsigned*>(dq_b + col) =
            pack16<E>(acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
}

template <typename E, int D, bool kDbias>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias, E* __restrict__ dk,
                        E* __restrict__ dv, float* __restrict__ dbias, int T,
                        float scale, int causal) {
  using Tile = DkvTile<D>;
  using P = Pan<D>;
  constexpr int R = Tile::kRows, S = Tile::kStages, NS = R / 2, NQ = D / 2;

  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  float* stats = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                          Tile::kStats);
  const unsigned kvbar = base + Tile::kBars, full = kvbar + 8,
                 empty = full + 8 * S;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kRowsBlock;
  const int bh = blockIdx.y;
  const long long rbase = (long long)bh * T;
  const float* brow = bias == nullptr ? nullptr : bias + rbase;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 32);        // each lane of the producer warp
      mbar_init(empty + 8 * s, 4 * kConsumers);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a block whose keys are all dead writes zeros
  const bool any =
      threadIdx.x < kRowsBlock && live_key(brow, k0 + threadIdx.x, T);
  const bool live = __syncthreads_or(any);
  // causal: the query stages before this key tile see none of its keys
  const int t0 = causal ? k0 / R : 0;
  const int n_q = (T + R - 1) / R;

  // the warpgroup, as the compiler can see it is uniform across it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // producer: its first warp loads K and V once, then each query stage's
    // Q, dO (TMA, lane 0), lse * log2(e) and delta (every lane) into the
    // ring
    setmaxnreg_dec24();
    if (warp == 4 * kConsumers && live) {
      if (lane == 0) {
        mbar_expect_tx(kvbar, 2 * kConsumers * Tile::kTile);
        for (int c = 0; c < kConsumers; ++c) {
          P::template load<kBlock>(base + c * Tile::kTile, &map_k, kvbar,
                                   k0 + c * kBlock, bh);
          P::template load<kBlock>(base + (kConsumers + c) * Tile::kTile,
                                   &map_v, kvbar, k0 + c * kBlock, bh);
        }
      }
      for (int i = t0; i < n_q; ++i) {
        const int it = i - t0, s = it % S, r0 = i * R;
        mbar_wait(empty + 8 * s, ((it / S) & 1) ^ 1);
        float* st = stats + s * 2 * R;
        for (int j = lane; j < R; j += 32) {
          const bool ok = r0 + j < T;
          st[j] = ok ? lse[rbase + r0 + j] * kLog2e : 0.f;
          st[R + j] = ok ? delta[rbase + r0 + j] : 0.f;
        }
        if (lane == 0) {
          const unsigned qs = base + Tile::kRing + s * Tile::kStage;
          mbar_expect_tx(full + 8 * s, Tile::kStage);
          P::template load<R>(qs, &map_q, full + 8 * s, r0, bh);
          P::template load<R>(qs + Tile::kQo, &map_do, full + 8 * s, r0,
                              bh);
        } else {
          mbar_arrive(full + 8 * s);
        }
      }
    }
  } else {
    // consumer warpgroup wg: its warp w owns keys k0 + 64 wg + 16 w .. +
    // 15; its thread's accumulator rows are keys key_a and key_b, columns
    // 8 n + 2 t and + 1
    setmaxnreg_inc240();
    const int w = warp % 4, g = lane / 4, t = lane % 4;
    const int key_a = k0 + kBlock * wg + 16 * w + g, key_b = key_a + 8;
    const int key_hi = k0 + kBlock * wg + kBlock - 1;   // its last key
    // dk's and dv's sums: written by the products only (the first
    // overwrites), or zeros where every key is dead
    float dk_acc[NQ], dv_acc[NQ];
    float db_a = 0.f, db_b = 0.f;          // dbias of keys key_a, key_b
    if (!live) {
#pragma unroll
      for (int i = 0; i < NQ; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    } else {
      const float sl2 = scale * kLog2e;
      const float bias_a =
          (brow != nullptr && key_a < T) ? brow[key_a] * kLog2e : 0.f;
      const float bias_b =
          (brow != nullptr && key_b < T) ? brow[key_b] * kLog2e : 0.f;
      const unsigned ks = base + wg * Tile::kTile,
                     vs = base + (kConsumers + wg) * Tile::kTile;
      // S^T and dP^T are the products' alone; P^T, then dS^T, are taken
      // into p
      float s[NS], dp[NS], p[NS];
      unsigned pa[R / 16][4], da[R / 16][4];
      // S^T = K Q^T and dP^T = V dO^T of query stage i, two commit groups
      auto issue = [&](int i) {
        const int it = i - t0, slot = it % S;
        const unsigned qs = base + Tile::kRing + slot * Tile::kStage;
        mbar_wait(full + 8 * slot, (it / S) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wg_ss<E, R>(s, P::template k<kBlock>(ks, kk),
                      P::template k<R>(qs, kk), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wg_ss<E, R>(dp, P::template k<kBlock>(vs, kk),
                      P::template k<R>(qs + Tile::kQo, kk), kk > 0);
        wgmma_commit();
      };
      mbar_wait(kvbar, 0);
      if (wg == 1) turn_pass(1);        // warpgroup 0 issues first
      turn_wait(wg);
      issue(t0);
      turn_pass(wg);
      for (int i = t0; i < n_q; ++i) {
        const int it = i - t0, slot = it % S, r0 = i * R;
        const unsigned qs = base + Tile::kRing + slot * Tile::kStage;
        const float* Ls = stats + slot * 2 * R;
        const float* Dl = Ls + R;
        // S^T of stage i has landed, and stage i - 1's dV and dK products
        // are done: its Q and dO go back to the producer
        wgmma_wait<1>();
        fence_all<NS>(s);
        fence_all<R / 16>(pa);
        fence_all<R / 16>(da);
        if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % S));
        // P^T = exp(S^T * scale + bias - lse), while dP^T runs; a stage
        // that reaches past T, or a warpgroup whose keys do, or one that
        // crosses the causal diagonal, masks its scores one by one (to
        // -1e30: p = 0), without a branch
        if (r0 + R <= T && key_hi < T && (!causal || r0 >= key_hi)) {
#pragma unroll
          for (int j = 0; j < NS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float l = Ls[8 * j + 2 * t + e];
              p[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, bias_a - l));
              p[4 * j + 2 + e] = ex2(fmaf(s[4 * j + 2 + e], sl2, bias_b - l));
            }
        } else {
#pragma unroll
          for (int j = 0; j < NS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1), query = r0 + col;
              const bool lo = e < 2;
              const int key = lo ? key_a : key_b;
              const bool dead =
                  key >= T || query >= T || (causal && key > query);
              const float x =
                  fmaf(s[4 * j + e], sl2, (lo ? bias_a : bias_b) - Ls[col]);
              p[4 * j + e] = ex2(dead ? kNegInf : x);
            }
        }
        wgmma_wait<0>();
        fence_all<NS>(dp);
        // P^T rounded to E into the A fragments of dV += P^T dO; then dS^T
        // = P^T * (dP^T - delta) * scale into those of dK += dS^T Q (dO and
        // Q read MN-major); dbias sums the unscaled, unrounded dS over the
        // queries in fp32
#pragma unroll
        for (int kp = 0; kp < R / 16; ++kp)
          pack_a<E>(pa[kp], p + 8 * kp, p + 8 * kp + 4);
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * t + (e & 1);
            const float ds = p[4 * j + e] * (dp[4 * j + e] - Dl[col]);
            if (kDbias) {
              if (e < 2) db_a += ds;
              else db_b += ds;
            }
            p[4 * j + e] = ds * scale;
          }
#pragma unroll
        for (int kp = 0; kp < R / 16; ++kp)
          pack_a<E>(da[kp], p + 8 * kp, p + 8 * kp + 4);
        turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int kp = 0; kp < R / 16; ++kp)
          wg_rs<E, D>(dv_acc, pa[kp], P::template mn<R>(qs + Tile::kQo, kp),
                      it + kp > 0);
#pragma unroll
        for (int kp = 0; kp < R / 16; ++kp)
          wg_rs<E, D>(dk_acc, da[kp], P::template mn<R>(qs, kp),
                      it + kp > 0);
        wgmma_commit();
        if (i + 1 < n_q) issue(i + 1);
        if (wg == 0 || i + 1 < n_q) turn_pass(wg);
      }
      wgmma_wait<0>();
      fence_all<NQ>(dk_acc);
      fence_all<NQ>(dv_acc);
      fence_all<R / 16>(pa);
      fence_all<R / 16>(da);
    }

    if (kDbias) {
      // the four threads of a quad hold the same two keys; a masked key's
      // p is 0 for every query, so its dbias is exactly 0
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        db_a += __shfl_xor_sync(0xffffffffu, db_a, off);
        db_b += __shfl_xor_sync(0xffffffffu, db_b, off);
      }
      if (t == 0) {
        if (key_a < T) dbias[rbase + key_a] = db_a;
        if (key_b < T) dbias[rbase + key_b] = db_b;
      }
    }

#pragma unroll
    for (int n = 0; n < NQ / 4; ++n) {
      const int col = 8 * n + 2 * t;
      if (key_a < T) {
        const long long o = (rbase + key_a) * D + col;
        *reinterpret_cast<unsigned*>(dk + o) =
            pack16<E>(dk_acc[4 * n], dk_acc[4 * n + 1]);
        *reinterpret_cast<unsigned*>(dv + o) =
            pack16<E>(dv_acc[4 * n], dv_acc[4 * n + 1]);
      }
      if (key_b < T) {
        const long long o = (rbase + key_b) * D + col;
        *reinterpret_cast<unsigned*>(dk + o) =
            pack16<E>(dk_acc[4 * n + 2], dk_acc[4 * n + 3]);
        *reinterpret_cast<unsigned*>(dv + o) =
            pack16<E>(dv_acc[4 * n + 2], dv_acc[4 * n + 3]);
      }
    }
  }
}

// The descriptors' own check: one 64 x D tile of q and of k (E) through
// the kernels' maps, panels and products: s = q k^T (64 x 64, both K-major
// from shared memory, as S = Q K^T) and o = p k (64 x D, p rounded to E
// from registers and k read MN-major, as dQ += dS K), fp32 row-major out.
template <typename E, int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_probe_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const float* __restrict__ p,
                             float* __restrict__ s_out,
                             float* __restrict__ o_out) {
  using P = Pan<D>;
  constexpr int kTile = kBlock * D * kB16Bytes;
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned bar = base + 2 * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = 16 * warp + g, row_b = row_a + 8;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 2 * kTile);
    P::template load<kBlock>(base, &map_q, bar, 0, 0);
    P::template load<kBlock>(base + kTile, &map_k, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wg_ss<E, 64>(s, P::template k<kBlock>(base, kk),
                 P::template k<kBlock>(base + kTile, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all<32>(s);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(e < 2 ? row_a : row_b) * 64 + 8 * j + 2 * t + (e & 1)] =
          s[4 * j + e];
  // the accumulator layout of p, packed as dS is
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[4 * j + e] = p[(e < 2 ? row_a : row_b) * 64 + 8 * j + 2 * t + (e & 1)];
  unsigned a[4][4];
#pragma unroll
  for (int kp = 0; kp < 4; ++kp) pack_a<E>(a[kp], s + 8 * kp, s + 8 * kp + 4);
  float o[D / 2];
  wgmma_fence();
#pragma unroll
  for (int kp = 0; kp < 4; ++kp)
    wg_rs<E, D>(o, a[kp], P::template mn<kBlock>(base + kTile, kp), kp > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all<D / 2>(o);
  fence_all<4>(a);
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(e < 2 ? row_a : row_b) * D + 8 * n + 2 * t + (e & 1)] =
          o[4 * n + e];
}

template <typename E, int D>
int launch_dq_wg(const E* q, const E* k, const E* v, const E* dout,
                 const E* out, const float* lse, const float* bias, E* dq,
                 float* delta, int bh, int T, float scale, int causal,
                 int device, cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e =
      allow_smem(flash_bwd_dq_wg_kernel<E, D>, device, done);
  if (e != cudaSuccess) return (int)e;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo;
  if (!map16<E, D>(encode, &mq, q, T, bh, kBlock) ||
      !map16<E, D>(encode, &mk, k, T, bh, kKeysDq) ||
      !map16<E, D>(encode, &mv, v, T, bh, kKeysDq) ||
      !map16<E, D>(encode, &mdo, dout, T, bh, kBlock))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = DqTile<D>::kBytes +
                       sizeof(int) * ((T + kKeysDq - 1) / kKeysDq + 1);
  const dim3 grid((unsigned)((T + kRowsBlock - 1) / kRowsBlock),
                  (unsigned)bh);
  flash_bwd_dq_wg_kernel<E, D><<<grid, kWgThreads, bytes, stream>>>(
      mq, mk, mv, mdo, dout, out, lse, bias, dq, delta, T, scale, causal);
  return (int)cudaGetLastError();
}

template <typename E, int D, bool kDbias>
int launch_dkv_wg_kernel(const E* q, const E* k, const E* v, const E* dout,
                         const float* lse, const float* delta,
                         const float* bias, E* dk, E* dv, float* dbias,
                         int bh, int T, float scale, int causal, int device,
                         cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e =
      allow_smem(flash_bwd_dkv_wg_kernel<E, D, kDbias>, device, done);
  if (e != cudaSuccess) return (int)e;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  constexpr int R = DkvTile<D>::kRows;
  CUtensorMap mq, mk, mv, mdo;
  if (!map16<E, D>(encode, &mq, q, T, bh, R) ||
      !map16<E, D>(encode, &mk, k, T, bh, kBlock) ||
      !map16<E, D>(encode, &mv, v, T, bh, kBlock) ||
      !map16<E, D>(encode, &mdo, dout, T, bh, R))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((T + kRowsBlock - 1) / kRowsBlock),
                  (unsigned)bh);
  flash_bwd_dkv_wg_kernel<E, D, kDbias>
      <<<grid, kWgThreads, DkvTile<D>::kBytes, stream>>>(
          mq, mk, mv, mdo, lse, delta, bias, dk, dv, dbias, T, scale,
          causal);
  return (int)cudaGetLastError();
}

// The dK/dV launch, with the has_dbias instantiation for a dbias output
template <typename E, int D>
int launch_dkv_wg(const E* q, const E* k, const E* v, const E* dout,
                  const float* lse, const float* delta, const float* bias,
                  E* dk, E* dv, float* dbias, int bh, int T, float scale,
                  int causal, int device, cudaStream_t stream) {
  if (dbias != nullptr)
    return launch_dkv_wg_kernel<E, D, true>(q, k, v, dout, lse, delta, bias,
                                            dk, dv, dbias, bh, T, scale,
                                            causal, device, stream);
  return launch_dkv_wg_kernel<E, D, false>(q, k, v, dout, lse, delta, bias,
                                           dk, dv, nullptr, bh, T, scale,
                                           causal, device, stream);
}

template <typename E, int D>
int launch_probe(const void* q, const void* k, const float* p, float* s,
                 float* o, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk;
  if (!map16<E, D>(encode, &mq, q, kBlock, 1, kBlock) ||
      !map16<E, D>(encode, &mk, k, kBlock, 1, kBlock))
    return (int)cudaErrorInvalidValue;
  const int bytes = 2 * kBlock * D * kB16Bytes + 8 + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_probe_kernel<E, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dq_probe_kernel<E, D><<<1, 128, bytes, stream>>>(mq, mk, p, s,
                                                                o);
  return (int)cudaGetLastError();
}

// The 16-bit entries' bodies: q, k, v, dout, out, dq, dk, dv (bh, T, D)
// contiguous E, 16-byte aligned; D is 32, 64 or 128.
template <typename E>
int dq16(const void* q, const void* k, const void* v, const void* dout,
         const void* out, const float* lse, const float* bias, void* dq,
         float* delta, int bh, int T, int D, float scale, int causal,
         int device, void* stream_ptr) {
  const int rc = check_args(bh, T, device);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const E *qe = static_cast<const E*>(q), *ke = static_cast<const E*>(k),
          *ve = static_cast<const E*>(v), *de = static_cast<const E*>(dout),
          *oe = static_cast<const E*>(out);
  E* dqe = static_cast<E*>(dq);
  switch (D) {
    case 32:
      return launch_dq_wg<E, 32>(qe, ke, ve, de, oe, lse, bias, dqe, delta,
                                 bh, T, scale, causal, device, stream);
    case 64:
      return launch_dq_wg<E, 64>(qe, ke, ve, de, oe, lse, bias, dqe, delta,
                                 bh, T, scale, causal, device, stream);
    case 128:
      return launch_dq_wg<E, 128>(qe, ke, ve, de, oe, lse, bias, dqe, delta,
                                  bh, T, scale, causal, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename E>
int dkv16(const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* delta, const float* bias, void* dk,
          void* dv, float* dbias, int bh, int T, int D, float scale,
          int causal, int device, void* stream_ptr) {
  const int rc = check_args(bh, T, device);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const E *qe = static_cast<const E*>(q), *ke = static_cast<const E*>(k),
          *ve = static_cast<const E*>(v), *oe = static_cast<const E*>(dout);
  E *dke = static_cast<E*>(dk), *dve = static_cast<E*>(dv);
  switch (D) {
    case 32:
      return launch_dkv_wg<E, 32>(qe, ke, ve, oe, lse, delta, bias, dke, dve,
                                  dbias, bh, T, scale, causal, device,
                                  stream);
    case 64:
      return launch_dkv_wg<E, 64>(qe, ke, ve, oe, lse, delta, bias, dke, dve,
                                  dbias, bh, T, scale, causal, device,
                                  stream);
    case 128:
      return launch_dkv_wg<E, 128>(qe, ke, ve, oe, lse, delta, bias, dke,
                                   dve, dbias, bh, T, scale, causal, device,
                                   stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename E>
int probe16(const void* q, const void* k, const float* p, float* s, float* o,
            int D, int device, void* stream_ptr) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (D) {
    case 32:
      return launch_probe<E, 32>(q, k, p, s, o, stream);
    case 64:
      return launch_probe<E, 64>(q, k, p, s, o, stream);
    case 128:
      return launch_probe<E, 128>(q, k, p, s, o, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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

// The 16-bit flavours: q, k, v, dout, out, dq, dk, dv (bh, T, D) contiguous
// bf16 (or fp16), 16-byte aligned; lse, bias and dbias as above (fp32; dbias
// null for none). The dQ entries read out (the forward's output) in place
// of delta and write delta = rowsum(dO * O), (bh, T) fp32, beside dq; the
// dK/dV entries read that delta. D is 32, 64 or 128.
extern "C" int mxtpu_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const float* lse, const float* bias, void* dq,
    float* delta, int bh, int T, int D, float scale, int causal, int device,
    void* stream_ptr) {
  return dq16<bf16>(q, k, v, dout, out, lse, bias, dq, delta, bh, T, D,
                    scale, causal, device, stream_ptr);
}

extern "C" int mxtpu_flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* bias, void* dk,
    void* dv, float* dbias, int bh, int T, int D, float scale, int causal,
    int device, void* stream_ptr) {
  return dkv16<bf16>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, bh, T,
                     D, scale, causal, device, stream_ptr);
}

extern "C" int mxtpu_flash_attention_bwd_dq_f16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* out, const float* lse, const float* bias, void* dq,
    float* delta, int bh, int T, int D, float scale, int causal, int device,
    void* stream_ptr) {
  return dq16<f16>(q, k, v, dout, out, lse, bias, dq, delta, bh, T, D, scale,
                   causal, device, stream_ptr);
}

extern "C" int mxtpu_flash_attention_bwd_dkv_f16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* bias, void* dk,
    void* dv, float* dbias, int bh, int T, int D, float scale, int causal,
    int device, void* stream_ptr) {
  return dkv16<f16>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, bh, T,
                    D, scale, causal, device, stream_ptr);
}

// The descriptors' check (flash_bwd_dq_probe_kernel): q, k (64, D)
// contiguous bf16 (dtype 0) or fp16 (dtype 1), 16-byte aligned; p (64, 64)
// fp32; s (64, 64) = q k^T and o (64, D) = p k, fp32 outputs.
extern "C" int mxtpu_flash_bwd_wgmma_probe(const void* q, const void* k,
                                           const float* p, float* s,
                                           float* o, int D, int dtype,
                                           int device, void* stream_ptr) {
  if (dtype == 0)
    return probe16<bf16>(q, k, p, s, o, D, device, stream_ptr);
  if (dtype == 1)
    return probe16<f16>(q, k, p, s, o, D, device, stream_ptr);
  return (int)cudaErrorInvalidValue;
}
