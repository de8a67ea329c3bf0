// Attention backward from the saved log-sum-exp (flash attention), fp32,
// bf16 and fp16, for Hopper (sm_90a): one kernel for dQ and one for dK and
// dV in each. The fp32 route is described first; the 16-bit route's notes
// (bf16 and fp16, one body over the element type) stand above its kernels,
// further down.
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

#include "flash_tf32.cuh"
#include "flash_b16.cuh"

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
// bf16 or fp16): every product on the tensor cores as mma.sync m16n8k16 with E
// operands and fp32 accumulators, one product where the fp32 route takes
// three. What bounds it: operations, as in fp32 (seven T x T x D products
// between the two kernels at the 16-bit rate, 989 TFLOP/s), with half the
// fp32 bytes. Design, a simple one first
// (wgmma and TMA are later work):
// - The fp32 route's split: the dQ kernel owns a 64-row Q tile and walks the
//   keys (64 a stage at D <= 64, 32 at D = 128), the dK/dV kernel owns a
//   64-key tile and walks the queries (64 a stage at D <= 64, 16 at D =
//   128), each through a two-stage cp.async ring; no atomics, and two calls
//   on the same inputs are bitwise equal.
// - The resident operands (Q and dO, or K and V) are read once with ldmatrix
//   into A fragments held in registers; the streamed ones come by ldmatrix
//   (S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T) or ldmatrix.trans
//   (dQ += dS K, dV += P^T dO, dK += dS^T Q).
// - S and dP stay in registers: p = exp(s - lse) and dS = p * (dP - delta)
//   * scale in fp32, then p and dS are rounded to E as they are packed
//   into the second products' A fragments, where the TPU kernel rounds them
//   to v's dtype (_recompute_p_ds). The sums stay fp32 in the accumulators,
//   and dq, dk and dv round to E once, at the end. In fp16 a dS past 65504
//   (a loss scale that overflows) rounds to inf and so does every gradient
//   it feeds: the rounding never saturates, so the guard's finite check
//   sees the overflow.
// - The dead-tile rules are the fp32 route's: the dQ kernel walks only key
//   tiles with a live key, and a dK/dV block whose 64 keys are all dead
//   writes zeros.
// - dbias (kDbias): each thread sums, in fp32 registers, the unscaled and
//   unrounded dS = p * (dP - delta) of its two keys over the queries it
//   holds, as _dkv_kernel sums ds_bias; the quad's four partial sums meet
//   by two shuffles at the end. dK takes the same dS times scale, rounded to
//   E as it is packed. A masked key's p is 0 for every query, so its
//   dbias is exactly 0. The extra work is one add a score.

template <int D>
struct BwdTileB {
  static constexpr int kLd = D + 8;           // elements a padded row
  static constexpr int kTile = kBlock * kLd;  // elements of a 64-row tile
  static constexpr int kKeys = D <= 64 ? 64 : 32;   // keys of a dQ stage
  static constexpr int kRows = D <= 64 ? 64 : 16;   // queries of a dK/dV stage
  // dQ: Q and dO, two stages of K and V, two stages of the keys' bias; the
  // count and the list of live key tiles follow (sized at launch)
  static constexpr int kDqStage = 2 * kKeys * kLd;
  static constexpr size_t kDqBytes = kB16Bytes * (2 * kTile + 2 * kDqStage) +
                                     sizeof(float) * 2 * kKeys;
  // dK/dV: K and V, two stages of Q and dO, two stages of lse and delta
  static constexpr int kDkvStage = 2 * kRows * kLd;
  static constexpr size_t kDkvBytes =
      kB16Bytes * (2 * kTile + 2 * kDkvStage) + sizeof(float) * 4 * kRows;
};

template <typename E, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_b16_kernel(const E* __restrict__ q, const E* __restrict__ k,
                        const E* __restrict__ v, const E* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ bias, E* __restrict__ dq,
                        int T, float scale, int causal) {
  using Tile = BwdTileB<D>;
  constexpr int KT = Tile::kKeys, NJ = KT / 8, KK = D / 16, NT = D / 8;

  extern __shared__ float4 smem4[];
  E* Qs = reinterpret_cast<E*>(smem4);
  E* dOs = Qs + Tile::kTile;
  E* stages = dOs + Tile::kTile;               // K, V; two of them
  float* biases = reinterpret_cast<float*>(stages + 2 * Tile::kDqStage);
  int* n_live = reinterpret_cast<int*>(biases + 2 * KT);
  int* tiles = n_live + 1;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kBlock;
  const long long bh = blockIdx.y;
  const long long base = bh * T * D;
  const float* brow = bias == nullptr ? nullptr : bias + bh * T;

  // the key tiles to walk: up to the causal diagonal, and only those with a
  // live key (a dead tile adds exact zeros)
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

  // this thread's accumulator rows; columns 8n + 2t and + 1
  const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  if (nl > 0) {
    auto issue = [&](int i) {
      E* st = stages + (i & 1) * Tile::kDqStage;
      const int k0 = tiles[i] * KT;
      load_tile16<D, KT>(st, k + base, k0, T);
      load_tile16<D, KT>(st + KT * Tile::kLd, v + base, k0, T);
      if (brow != nullptr) load_row<KT>(biases + (i & 1) * KT, brow, k0, T);
    };
    load_tile16<D, kBlock>(Qs, q + base, q0, T);
    load_tile16<D, kBlock>(dOs, dout + base, q0, T);
    cp_async_commit();
    issue(0);
    cp_async_commit();
    const float lse_a = row_a < T ? lse[bh * T + row_a] : 0.f;
    const float lse_b = row_b < T ? lse[bh * T + row_b] : 0.f;
    const float delta_a = row_a < T ? delta[bh * T + row_a] : 0.f;
    const float delta_b = row_b < T ? delta[bh * T + row_b] : 0.f;
    cp_async_wait<1>();                  // Q and dO have landed
    __syncthreads();
    unsigned qf[KK][4], of[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      frag_a16<D>(qf[kk], Qs, 16 * warp, 16 * kk);
      frag_a16<D>(of[kk], dOs, 16 * warp, 16 * kk);
    }

    for (int i = 0; i < nl; ++i) {
      if (i + 1 < nl) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();                // stage i has landed
      __syncthreads();
      const E* Ks = stages + (i & 1) * Tile::kDqStage;
      const E* Vs = Ks + KT * Tile::kLd;
      const float* Bs = biases + (i & 1) * KT;
      const int k0 = tiles[i] * KT;

      // S = Q K^T and dP = dO V^T over the stage's keys
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int j2 = 0; j2 < NJ / 2; ++j2) {
          unsigned b[4];
          frag_b_nk<D>(b, Ks, 16 * j2, 16 * kk);
          mma16<E>(s[2 * j2], qf[kk], b);
          mma16<E>(s[2 * j2 + 1], qf[kk], b + 2);
          frag_b_nk<D>(b, Vs, 16 * j2, 16 * kk);
          mma16<E>(dp[2 * j2], of[kk], b);
          mma16<E>(dp[2 * j2 + 1], of[kk], b + 2);
        }
      // dS = P * (dP - delta) * scale, P = exp(S * scale + bias - lse)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const int key = k0 + col;
          const bool lo_row = e < 2;
          float x = s[j][e] * scale + (brow != nullptr ? Bs[col] : 0.f);
          if (causal && key > (lo_row ? row_a : row_b)) x = kNegInf;
          const float p = key < T ? expf(x - (lo_row ? lse_a : lse_b)) : 0.f;
          s[j][e] = p * (dp[j][e] - (lo_row ? delta_a : delta_b)) * scale;
        }
      // dQ += dS K over the stage's keys, dS rounded to E
#pragma unroll
      for (int kp = 0; kp < KT / 16; ++kp) {
        unsigned a[4];
        pack_a<E>(a, s[2 * kp], s[2 * kp + 1]);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          unsigned b[4];
          frag_b_kn<D>(b, Ks, 16 * kp, 16 * n2);
          mma16<E>(acc[2 * n2], a, b);
          mma16<E>(acc[2 * n2 + 1], a, b + 2);
        }
      }
      __syncthreads();                   // the stage is refilled next
    }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t;
    if (row_a < T)
      *reinterpret_cast<unsigned*>(dq + base + (long long)row_a * D + col) =
          pack16<E>(acc[n][0], acc[n][1]);
    if (row_b < T)
      *reinterpret_cast<unsigned*>(dq + base + (long long)row_b * D + col) =
          pack16<E>(acc[n][2], acc[n][3]);
  }
}

template <typename E, int D, bool kDbias>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_b16_kernel(const E* __restrict__ q, const E* __restrict__ k,
                         const E* __restrict__ v, const E* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ bias, E* __restrict__ dk,
                         E* __restrict__ dv, float* __restrict__ dbias, int T,
                         float scale, int causal) {
  using Tile = BwdTileB<D>;
  constexpr int R = Tile::kRows, NJ = R / 8, KK = D / 16, NT = D / 8;

  extern __shared__ float4 smem4[];
  E* Ks = reinterpret_cast<E*>(smem4);
  E* Vs = Ks + Tile::kTile;
  E* stages = Vs + Tile::kTile;                // Q, dO; two of them
  float* stats = reinterpret_cast<float*>(stages + 2 * Tile::kDkvStage);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kBlock;
  const long long bh = blockIdx.y;
  const long long base = bh * T * D;
  const float* brow = bias == nullptr ? nullptr : bias + bh * T;

  // this thread's accumulator rows are keys key_a and key_b; columns 8n + 2t
  // and + 1
  const int key_a = k0 + 16 * warp + g, key_b = key_a + 8;
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  float db_a = 0.f, db_b = 0.f;            // dbias of keys key_a, key_b

  // a block whose keys are all dead writes zeros
  const bool any = threadIdx.x < kBlock && live_key(brow, k0 + threadIdx.x, T);
  if (__syncthreads_or(any)) {
    const float bias_a = (brow != nullptr && key_a < T) ? brow[key_a] : 0.f;
    const float bias_b = (brow != nullptr && key_b < T) ? brow[key_b] : 0.f;
    // causal: the query tiles before this key tile see none of its keys
    const int t0 = causal ? k0 / R : 0;
    const int n_q = (T + R - 1) / R;
    auto issue = [&](int i) {
      const int slot = (i - t0) & 1;
      E* st = stages + slot * Tile::kDkvStage;
      const int r0 = i * R;
      load_tile16<D, R>(st, q + base, r0, T);
      load_tile16<D, R>(st + R * Tile::kLd, dout + base, r0, T);
      load_row<R>(stats + slot * 2 * R, lse + bh * T, r0, T);
      load_row<R>(stats + slot * 2 * R + R, delta + bh * T, r0, T);
    };
    load_tile16<D, kBlock>(Ks, k + base, k0, T);
    load_tile16<D, kBlock>(Vs, v + base, k0, T);
    cp_async_commit();
    issue(t0);
    cp_async_commit();
    cp_async_wait<1>();                  // K and V have landed
    __syncthreads();
    unsigned kf[KK][4], vf[KK][4];
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      frag_a16<D>(kf[kk], Ks, 16 * warp, 16 * kk);
      frag_a16<D>(vf[kk], Vs, 16 * warp, 16 * kk);
    }

    for (int i = t0; i < n_q; ++i) {
      if (i + 1 < n_q) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();                // stage i has landed
      __syncthreads();
      const int slot = (i - t0) & 1;
      const E* Qs = stages + slot * Tile::kDkvStage;
      const E* dOs = Qs + R * Tile::kLd;
      const float* Ls = stats + slot * 2 * R;
      const float* Dl = Ls + R;
      const int r0 = i * R;

      // S^T = K Q^T and dP^T = V dO^T over the stage's queries
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int j2 = 0; j2 < NJ / 2; ++j2) {
          unsigned b[4];
          frag_b_nk<D>(b, Qs, 16 * j2, 16 * kk);
          mma16<E>(s[2 * j2], kf[kk], b);
          mma16<E>(s[2 * j2 + 1], kf[kk], b + 2);
          frag_b_nk<D>(b, dOs, 16 * j2, 16 * kk);
          mma16<E>(dp[2 * j2], vf[kk], b);
          mma16<E>(dp[2 * j2 + 1], vf[kk], b + 2);
        }
      // P^T, and dS^T = P^T * (dP^T - delta) * scale; dbias sums the
      // unscaled, unrounded dS over the queries in fp32
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
          dp[j][e] = ds * scale;
          s[j][e] = p;
        }
      // dV += P^T dO and dK += dS^T Q over the stage's queries, P and dS
      // rounded to E
#pragma unroll
      for (int kp = 0; kp < R / 16; ++kp) {
        unsigned pa[4], da[4];
        pack_a<E>(pa, s[2 * kp], s[2 * kp + 1]);
        pack_a<E>(da, dp[2 * kp], dp[2 * kp + 1]);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          unsigned b[4];
          frag_b_kn<D>(b, dOs, 16 * kp, 16 * n2);
          mma16<E>(dv_acc[2 * n2], pa, b);
          mma16<E>(dv_acc[2 * n2 + 1], pa, b + 2);
          frag_b_kn<D>(b, Qs, 16 * kp, 16 * n2);
          mma16<E>(dk_acc[2 * n2], da, b);
          mma16<E>(dk_acc[2 * n2 + 1], da, b + 2);
        }
      }
      __syncthreads();                   // the stage is refilled next
    }
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
      if (key_a < T) dbias[bh * T + key_a] = db_a;
      if (key_b < T) dbias[bh * T + key_b] = db_b;
    }
  }

#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = 8 * n + 2 * t;
    if (key_a < T) {
      const long long o = base + (long long)key_a * D + col;
      *reinterpret_cast<unsigned*>(dk + o) =
          pack16<E>(dk_acc[n][0], dk_acc[n][1]);
      *reinterpret_cast<unsigned*>(dv + o) =
          pack16<E>(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key_b < T) {
      const long long o = base + (long long)key_b * D + col;
      *reinterpret_cast<unsigned*>(dk + o) =
          pack16<E>(dk_acc[n][2], dk_acc[n][3]);
      *reinterpret_cast<unsigned*>(dv + o) =
          pack16<E>(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

template <typename E, int D>
int launch_dq_b16(const E* q, const E* k, const E* v, const E* dout,
                  const float* lse, const float* delta, const float* bias,
                  E* dq, int bh, int T, float scale, int causal, int device,
                  cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e =
      allow_smem(flash_bwd_dq_b16_kernel<E, D>, device, done);
  if (e != cudaSuccess) return (int)e;
  constexpr int KT = BwdTileB<D>::kKeys;
  const size_t bytes =
      BwdTileB<D>::kDqBytes + sizeof(int) * ((T + KT - 1) / KT + 1);
  const dim3 grid((unsigned)((T + kBlock - 1) / kBlock), (unsigned)bh);
  flash_bwd_dq_b16_kernel<E, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, dout, lse, delta, bias, dq, T, scale, causal);
  return (int)cudaGetLastError();
}

template <typename E, int D, bool kDbias>
int launch_dkv_b16_kernel(const E* q, const E* k, const E* v, const E* dout,
                          const float* lse, const float* delta,
                          const float* bias, E* dk, E* dv, float* dbias,
                          int bh, int T, float scale, int causal, int device,
                          cudaStream_t stream) {
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e =
      allow_smem(flash_bwd_dkv_b16_kernel<E, D, kDbias>, device, done);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((T + kBlock - 1) / kBlock), (unsigned)bh);
  flash_bwd_dkv_b16_kernel<E, D, kDbias>
      <<<grid, kThreads, BwdTileB<D>::kDkvBytes, stream>>>(
          q, k, v, dout, lse, delta, bias, dk, dv, dbias, T, scale, causal);
  return (int)cudaGetLastError();
}

// The dK/dV launch, with the has_dbias instantiation for a dbias output
template <typename E, int D>
int launch_dkv_b16(const E* q, const E* k, const E* v, const E* dout,
                   const float* lse, const float* delta, const float* bias,
                   E* dk, E* dv, float* dbias, int bh, int T, float scale,
                   int causal, int device, cudaStream_t stream) {
  if (dbias != nullptr)
    return launch_dkv_b16_kernel<E, D, true>(q, k, v, dout, lse, delta, bias,
                                             dk, dv, dbias, bh, T, scale,
                                             causal, device, stream);
  return launch_dkv_b16_kernel<E, D, false>(q, k, v, dout, lse, delta, bias,
                                            dk, dv, nullptr, bh, T, scale,
                                            causal, device, stream);
}

// The 16-bit entries' bodies: q, k, v, dout, dq, dk, dv (bh, T, D)
// contiguous E, 16-byte aligned; D is 32, 64 or 128.
template <typename E>
int dq16(const void* q, const void* k, const void* v, const void* dout,
         const float* lse, const float* delta, const float* bias, void* dq,
         int bh, int T, int D, float scale, int causal, int device,
         void* stream_ptr) {
  const int rc = check_args(bh, T, device);
  if (rc != 0) return rc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const E *qe = static_cast<const E*>(q), *ke = static_cast<const E*>(k),
          *ve = static_cast<const E*>(v), *oe = static_cast<const E*>(dout);
  E* dqe = static_cast<E*>(dq);
  switch (D) {
    case 32:
      return launch_dq_b16<E, 32>(qe, ke, ve, oe, lse, delta, bias, dqe, bh,
                                  T, scale, causal, device, stream);
    case 64:
      return launch_dq_b16<E, 64>(qe, ke, ve, oe, lse, delta, bias, dqe, bh,
                                  T, scale, causal, device, stream);
    case 128:
      return launch_dq_b16<E, 128>(qe, ke, ve, oe, lse, delta, bias, dqe,
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
      return launch_dkv_b16<E, 32>(qe, ke, ve, oe, lse, delta, bias, dke,
                                   dve, dbias, bh, T, scale, causal, device,
                                   stream);
    case 64:
      return launch_dkv_b16<E, 64>(qe, ke, ve, oe, lse, delta, bias, dke,
                                   dve, dbias, bh, T, scale, causal, device,
                                   stream);
    case 128:
      return launch_dkv_b16<E, 128>(qe, ke, ve, oe, lse, delta, bias, dke,
                                    dve, dbias, bh, T, scale, causal, device,
                                    stream);
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

// The 16-bit flavours: q, k, v, dout, dq, dk, dv (bh, T, D) contiguous bf16
// (or fp16), 16-byte aligned; lse, delta, bias and dbias as above (fp32;
// dbias null for none). D is 32, 64 or 128.
extern "C" int mxtpu_flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const float* bias, void* dq,
    int bh, int T, int D, float scale, int causal, int device,
    void* stream_ptr) {
  return dq16<bf16>(q, k, v, dout, lse, delta, bias, dq, bh, T, D, scale,
                    causal, device, stream_ptr);
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
    const float* lse, const float* delta, const float* bias, void* dq,
    int bh, int T, int D, float scale, int causal, int device,
    void* stream_ptr) {
  return dq16<f16>(q, k, v, dout, lse, delta, bias, dq, bh, T, D, scale,
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
