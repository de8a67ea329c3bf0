// Attention forward with an online softmax (flash attention), fp32, bf16 and
// fp16, for Hopper (sm_90a).
//
// Replaces incubator_mxnet_tpu/ops/pallas/flash_attention.py: _fwd_kernel
// (reached through _fwd_call, _flash_core and flash_attention), in the three
// input dtypes the JAX package gives it. The fp32 route is described first;
// the 16-bit route's notes (bf16 and fp16, one kernel over the element type,
// on wgmma fed by TMA) stand above its kernel, further down.
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

#include <cuda.h>    // CUtensorMap and its enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

#include "flash_tf32.cuh"
#include "flash_b16.cuh"
#include "hopper.cuh"
#include "flash_wg.cuh"

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
// trainer's compute_dtype), one kernel over the element type E on wgmma fed
// by TMA: the 16-bit backward's skeleton (flash_wg.cuh, hopper.cuh). What
// bounds it on the H100, at the dense (96, 512, 64): the bytes of 16-bit q,
// k, v and out, 25 MB (7.5 us at 3.35 TB/s); the products, 4 * BH * T * T *
// D = 6.4 GFLOP (6.5 us at 989 TFLOP/s); and the exps, one a score, 25.2 M,
// which an SM's MUFU units issue at 16 a clock (6.0 us on 132 SMs at 1980
// MHz): three floors of one size, so the exps have to run while the
// products and the loads do.
// Design:
// - A block is three warpgroups: a producer, whose first warp loads each
//   tile's Q by TMA and keeps a ring of four K/V stages filled by TMA over
//   3-D maps (D, T, B*H) (rows past T land as zeros and never reach the
//   next head's rows), and two consumers, each owning 64 of a tile's 128 Q
//   rows. Full and empty mbarriers hand the stages over; Q has two slots,
//   so that a tile's Q lands while the tile before it runs.
// - The grid: tiles of equal work (no bias and no causal mask: the dense
//   training shape) go to a persistent grid of one block an SM, which walks
//   tiles b, b + grid, ...: the next tile's Q and first stages load during
//   this one's last stages, and a block's start is paid once an SM instead
//   of once a tile. Otherwise (a bias or a causal mask: tiles of unequal
//   work) a block takes one tile and the card schedules blocks as SMs free
//   up: a static walk over such tiles left SMs idle and timed slower.
// - S = Q K^T is wgmma ss over 128-key stages (64 at D = 128); O += P V is
//   wgmma rs, P from registers and V read MN-major from the same stage
//   image (Pan::mn), as the backward's dQ += dS K: no transposed copy.
// - Overlap: the consumers take turns at the tensor cores (turn_wait,
//   turn_pass). In its turn a consumer issues the S product of stage i and
//   the P V product of stage i - 1, two commit groups; stage i's softmax
//   waits for its S only and runs while P V of stage i - 1 and the other
//   consumer's products do. (Issuing S of stage i + 1 before stage i's
//   softmax, as the backward's dQ kernel orders them, needs S twice in
//   registers: built first on 64-key stages, it timed slower on the card
//   than this order on 128-key stages, whose per-stage costs it halves,
//   and at 128 keys two S buffers spill.)
// - p = 2^(s * scale * log2(e) + (bias - m) * log2(e)) by ex2.approx.ftz,
//   in place in S's registers: m is the row's running max in the log2
//   domain, taken as a tree, and each stage's key biases land
//   pre-multiplied by log2(e); without a bias the max is taken over the raw
//   scores and a p is one FFMA and one MUFU.EX2. .ftz flushes a p below
//   2**-126 to 0, which no fp16 value and no bf16 value that moves O by a
//   step can tell apart. Dead scores (past T, above the causal diagonal)
//   take -1e30 without a branch, and only on stages that reach past T or
//   cross the diagonal. m and l stay fp32 and l sums the unrounded p, as
//   _fwd_kernel sums it; p rounds to E (cvt.rn) as it is packed into P V's
//   A fragments, where the TPU kernel writes p.astype(v.dtype) (in fp16 a p
//   below 2**-14 stays subnormal). O is rescaled in registers between its
//   products and scaled by 1 / l once, at the end.
// - O leaves through shared memory: each thread's rows, rounded to E, into
//   its warpgroup's Q tile (free once the tile's last S product is done),
//   laid out as TMA reads it, then one TMA store a panel, which leaves rows
//   past T unwritten.
// - Registers: ptxas compiles every region to the launch bound's 168 a
//   thread whatever setmaxnreg asks. A consumer holds S (KT / 2), P (KT /
//   4) and O (D / 2): 128 at D = 64 with 128-key stages (a few values of the
//   walk's state spill there), 112 at D = 32 and, with 64-key stages, at D
//   = 128 (128 keys would take 160 there).
// - Kept rules: only key tiles with a live key are walked (with a bias the
//   whole block votes, a warp a key tile; without one every tile is live),
//   both consumers the same list; the causal walk ends at the diagonal of
//   the tile's last row; a row with no live key gives exact zeros and lse = 0
//   (m <= -0.5e30); lse is fp32, in natural log; any T >= 1 and D in {32,
//   64, 128}; no atomics and a fixed walk, so two calls give the same bits.

// byte offsets from the 1024-aligned base of the forward's shared memory:
// two Q slots (each consumer's Q, a tile's; the next tile's lands in the
// other), the ring of K and V stages, each stage's key biases * log2(e),
// the mbarriers (qfull[2], qempty[2], full[kStages], empty[kStages]), each
// slot's count of key tiles to walk; with a bias the list of them follows
// (sized at launch)
template <int D>
struct FwdWgTile {
  static constexpr int kKeys = D == 128 ? 64 : 128;     // keys of a stage
  static constexpr int kStages = 4;
  static constexpr int kTile = kBlock * D * kB16Bytes;   // a consumer's Q
  static constexpr int kQSlot = kConsumers * kTile;
  static constexpr int kKv = kKeys * D * kB16Bytes;      // K or V
  static constexpr int kStage = 2 * kKv;
  static constexpr int kRing = 2 * kQSlot;
  static constexpr int kBias = kRing + kStages * kStage;
  static constexpr int kBars = kBias + kStages * kKeys * 4;
  static constexpr int kList = kBars + (4 + 2 * kStages) * 8;
  static constexpr size_t kBytes = kList + 8 + 1024;     // + alignment
};

constexpr float kLn2 = 0.6931471805599453f;
// a row's max at or below it (log2 domain): no live key, -0.5e30 in nats
constexpr float kDeadMax = 0.5f * kNegInf * kLog2e;

__device__ __forceinline__ void st_shared(unsigned addr, unsigned v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// the largest of f(O), f(O + 1), ..., f(O + N - 1), as a tree: depth
// log2(N) instead of a chain of N, each leaf taken when its pair needs it
template <int N, int O = 0, typename F>
__device__ __forceinline__ float tree_max(F f) {
  if constexpr (N == 1)
    return f(O);
  else
    return fmaxf(tree_max<N / 2, O>(f), tree_max<N / 2, O + N / 2>(f));
}

// block b takes tiles b, b + gridDim.x, ... of the n_qblk * bh tiles of
// 128 Q rows (tile t: rows 128 (t % n_qblk) .. of head t / n_qblk): one
// tile with a block a tile, several on the persistent grid
template <typename E, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o,
                    const float* __restrict__ bias, float* __restrict__ lse,
                    int T, int n_tiles_all, float scale, int causal) {
  using Tile = FwdWgTile<D>;
  using P = Pan<D>;
  constexpr int KT = Tile::kKeys, S = Tile::kStages, NS = KT / 2,
                KP = KT / 16, NQ = D / 2;

  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_u32(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  float* biases = reinterpret_cast<float*>(gbase + Tile::kBias);
  const unsigned qfull = base + Tile::kBars, qempty = qfull + 16,
                 full = qempty + 16, empty = full + 8 * S;
  int* n_live = reinterpret_cast<int*>(gbase + Tile::kList);   // [2]
  int* list = n_live + 2;   // with a bias: the block's one tile's key tiles
  const int n_qblk = (T + kRowsBlock - 1) / kRowsBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 128 * kConsumers) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(qfull + 8 * s, 2);      // Q's bytes, then the count
      mbar_init(qempty + 8 * s, kConsumers);   // each consumer's store
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 32);        // each lane of the producer warp
      mbar_init(empty + 8 * s, 4 * kConsumers);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_map(&map_k);
    prefetch_map(&map_v);
    prefetch_map(&map_o);
    // the first tile's Q, in flight during the vote
    mbar_expect_tx(qfull, Tile::kQSlot);
    for (int c = 0; c < kConsumers; ++c)
      P::template load<kBlock>(base + c * Tile::kTile, &map_q, qfull,
                               (blockIdx.x % n_qblk) * kRowsBlock +
                                   c * kBlock,
                               blockIdx.x / n_qblk);
  }

  // the key tiles tile t walks: up to the causal diagonal of its last row
  auto tile_keys = [&](int q0) {
    const int n = (T + KT - 1) / KT;
    return causal ? min(n, (min(q0 + kRowsBlock, T) - 1) / KT + 1) : n;
  };
  // With a bias the block has one tile (the persistent grid is for tiles
  // without one): the whole block votes on its key tiles, a warp a tile,
  // and the list of those with a live key goes into `list`
  if (bias != nullptr) {
    const float* brow = bias + (long long)(blockIdx.x / n_qblk) * T;
    const int n_tiles = tile_keys((blockIdx.x % n_qblk) * kRowsBlock);
    for (int i = warp; i < n_tiles; i += kWgThreads / 32) {
      const bool live = any_live<KT>(brow, i * KT, T);
      if (lane == 0) list[i] = live;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int n = 0;
      for (int i = 0; i < n_tiles; ++i)
        if (list[i]) list[n++] = i;
      n_live[0] = n;
    }
  }
  __syncthreads();

  // the warpgroup, as the compiler can see it is uniform across it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // producer: its first warp, for each tile, puts its Q into the free
    // slot (the first tile's is in flight) and publishes its count of key
    // tiles (with a bias, the vote's), then fills the ring with the live
    // key tiles' K, V (TMA, lane 0) and key biases * log2(e) (every lane;
    // zeros without a bias)
    setmaxnreg_dec40();
    if (warp == 4 * kConsumers) {
      int g = 0;                        // stages filled so far
      for (int t = blockIdx.x, it = 0; t < n_tiles_all;
           t += gridDim.x, ++it) {
        const int slot = it & 1;
        const int q0 = (t % n_qblk) * kRowsBlock, bh = t / n_qblk;
        const float* brow =
            bias == nullptr ? nullptr : bias + (long long)bh * T;
        if (it > 0) {
          mbar_wait(qempty + 8 * slot, ((it >> 1) & 1) ^ 1);
          if (lane == 0) {
            mbar_expect_tx(qfull + 8 * slot, Tile::kQSlot);
            for (int c = 0; c < kConsumers; ++c)
              P::template load<kBlock>(base + slot * Tile::kQSlot +
                                           c * Tile::kTile,
                                       &map_q, qfull + 8 * slot,
                                       q0 + c * kBlock, bh);
          }
        }
        const int nl = brow != nullptr ? n_live[0] : tile_keys(q0);
        if (lane == 0) {
          n_live[slot] = nl;
          mbar_arrive(qfull + 8 * slot);   // the count is in place
        }
        for (int i = 0; i < nl; ++i, ++g) {
          const int s = g % S;
          const int k0 = (brow != nullptr ? list[i] : i) * KT;
          mbar_wait(empty + 8 * s, ((g / S) & 1) ^ 1);
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
    }
  } else {
    // consumer warpgroup wg: of each tile, its warp w owns rows q0 + 64 wg
    // + 16 w .. + 15; its thread's accumulator rows are row_a and row_b,
    // columns 8 n + 2 t and + 1. m is the rows' running max (log2 domain,
    // the quad's), l this thread's share of their sums.
    setmaxnreg_inc232();
    const int w = warp % 4, g = lane / 4, t = lane % 4;
    const float sl2 = scale * kLog2e;
    // S of a stage, then its p in place; P, rounded to E, of the stage
    // whose P V product is next; O's sums: written by the products only
    // while they run (the first of a tile's sum overwrites), rescaled
    // between them
    float s[NS];
    unsigned pa[KP][4];
    float acc[NQ];
    int gs = 0;                         // stages taken so far
    if (wg == 1) turn_pass(1);          // warpgroup 0 issues first
    for (int tile = blockIdx.x, it = 0; tile < n_tiles_all;
         tile += gridDim.x, ++it) {
      const int slot = it & 1;
      const int q0 = (tile % n_qblk) * kRowsBlock, bh = tile / n_qblk;
      const bool has_bias = bias != nullptr;
      const int row_lo = q0 + kBlock * wg;  // the warpgroup's first row
      const int row_a = row_lo + 16 * w + g, row_b = row_a + 8;
      const unsigned qs = base + slot * Tile::kQSlot + wg * Tile::kTile;
      mbar_wait(qfull + 8 * slot, (it >> 1) & 1);
      const int nl = n_live[slot];
      // the first key of the i-th tile walked
      auto key0 = [&](int i) { return (has_bias ? list[i] : i) * KT; };
      auto stage = [&](int i) {
        return base + Tile::kRing + ((gs + i) % S) * Tile::kStage;
      };
      float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
      // stage i's softmax on s: the rows' new max, then s = p in place and
      // the rows' sums; alpha is the factor O moves by
      auto softmax = [&](int i, float& alpha_a, float& alpha_b) {
        const int k0 = key0(i);
        const float* bs = biases + ((gs + i) % S) * KT;
        // a stage that reaches past T or across this warpgroup's causal
        // diagonal masks its scores one by one (to -1e30: p = 0)
        const bool masked =
            k0 + KT > T || (causal && k0 + KT - 1 > row_lo);
        auto dead = [&](int col, bool lo) {
          const int key = k0 + col;
          return key >= T || (causal && key > (lo ? row_a : row_b));
        };
        // each score's exponent, scaled to the log2 domain (kMode 0:
        // masked, 1: a bias, 2: neither, left unscaled)
        auto x_of = [&](auto mode, int j, int e) {
          constexpr int kMode = decltype(mode)::value;
          const int col = 8 * j + 2 * t + (e & 1);
          if constexpr (kMode == 0)
            return dead(col, e < 2) ? kNegInf
                                    : fmaf(s[4 * j + e], sl2, bs[col]);
          else if constexpr (kMode == 1)
            return fmaf(s[4 * j + e], sl2, bs[col]);
          else
            return s[4 * j + e];
        };
        // the max, then the exps and sums, one loop for each kind of
        // stage so that no test or branch sits beside an ex2
        float sum_a = 0.f, sum_b = 0.f;
        auto run = [&](auto mode) {
          constexpr int kMode = decltype(mode)::value;
          // element k of a row is column pair k / 2's (k % 2)-th
          float mx_a = tree_max<NS / 2>(
              [&](int k) { return x_of(mode, k / 2, k % 2); });
          float mx_b = tree_max<NS / 2>(
              [&](int k) { return x_of(mode, k / 2, 2 + k % 2); });
          if constexpr (kMode == 2) {
            // scale > 0: the max of the scaled scores is the scaled max
            mx_a *= sl2;
            mx_b *= sl2;
          }
#pragma unroll
          for (int off = 1; off < 4; off <<= 1) {
            mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
          }
          mx_a = fmaxf(mx_a, m_a);
          mx_b = fmaxf(mx_b, m_b);
          alpha_a = ex2_ftz(m_a - mx_a);
          alpha_b = ex2_ftz(m_b - mx_b);
          m_a = mx_a;
          m_b = mx_b;
#pragma unroll
          for (int j = 0; j < NS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 8 * j + 2 * t + (e & 1);
              const float m = e < 2 ? m_a : m_b;
              float x;
              if constexpr (kMode == 0)
                x = dead(col, e < 2) ? kNegInf
                                     : fmaf(s[4 * j + e], sl2, bs[col] - m);
              else if constexpr (kMode == 1)
                x = fmaf(s[4 * j + e], sl2, bs[col] - m);
              else
                x = fmaf(s[4 * j + e], sl2, -m);
              const float p = ex2_ftz(x);
              s[4 * j + e] = p;
              if (e < 2) sum_a += p;
              else sum_b += p;
            }
        };
        if (masked) run(std::integral_constant<int, 0>());
        else if (has_bias) run(std::integral_constant<int, 1>());
        else run(std::integral_constant<int, 2>());
        l_a = fmaf(l_a, alpha_a, sum_a);
        l_b = fmaf(l_b, alpha_b, sum_b);
      };
      // P V of stage i from pa
      auto pv_product = [&](int i) {
#pragma unroll
        for (int kp = 0; kp < KP; ++kp)
          wg_rs<E, D>(acc, pa[kp], P::template mn<KT>(stage(i) + Tile::kKv,
                                                      kp),
                      i + kp > 0);
      };

      if (nl > 0) mbar_wait(full + 8 * (gs % S), (gs / S) & 1);
      for (int i = 0; i < nl; ++i) {
        // in this warpgroup's turn (stage i has landed): the S product of
        // stage i, then the P V product of stage i - 1 (two commit groups)
        turn_wait(wg);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wg_ss<E, KT>(s, P::template k<kBlock>(qs, kk),
                       P::template k<KT>(stage(i), kk), kk > 0);
        wgmma_commit();
        if (i > 0) pv_product(i - 1);
        wgmma_commit();
        turn_pass(wg);
        // stage i + 1's landing, then stage i's softmax once its S has
        // landed, while P V of stage i - 1 runs
        if (i + 1 < nl)
          mbar_wait(full + 8 * ((gs + i + 1) % S), ((gs + i + 1) / S) & 1);
        wgmma_wait<1>();
        fence_all<NS>(s);
        float alpha_a, alpha_b;
        softmax(i, alpha_a, alpha_b);
        // P V of stage i - 1 is done: its stage goes back to the producer,
        // O moves to the new max, and stage i's p rounds to E into pa
        wgmma_wait<0>();
        fence_all<NQ>(acc);
        fence_all<KP>(pa);
        if (i > 0) {
          if (lane == 0) mbar_arrive(empty + 8 * ((gs + i - 1) % S));
#pragma unroll
          for (int n = 0; n < NQ / 4; ++n) {
            acc[4 * n] *= alpha_a;
            acc[4 * n + 1] *= alpha_a;
            acc[4 * n + 2] *= alpha_b;
            acc[4 * n + 3] *= alpha_b;
          }
        }
#pragma unroll
        for (int kp = 0; kp < KP; ++kp)
          pack_a<E>(pa[kp], s + 8 * kp, s + 8 * kp + 4);
      }
      if (nl > 0) {
        // O += P V of the last stage, whose stage then goes back
        turn_wait(wg);
        wgmma_fence();
        pv_product(nl - 1);
        wgmma_commit();
        turn_pass(wg);
        wgmma_wait<0>();
        fence_all<NQ>(acc);
        fence_all<KP>(pa);
        if (lane == 0) mbar_arrive(empty + 8 * ((gs + nl - 1) % S));
      }
      gs += nl;

      // the quad's four shares of each row's sum
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      const bool dead_a = m_a <= kDeadMax, dead_b = m_b <= kDeadMax;
      const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
      const float ia = 1.f / la, ib = 1.f / lb;
      // O, rounded to E, through this warpgroup's Q tile (its last S
      // product is done), laid out as TMA reads it; then one TMA store a
      // panel, which leaves rows past T unwritten; the slot goes back to
      // the producer once the store has read it
      const int ra = 16 * w + g, rb = ra + 8;
#pragma unroll
      for (int n = 0; n < NQ / 4; ++n) {
        const int col = 8 * n + 2 * t;
        st_shared(qs + P::template offset<kBlock>(ra, col),
                  dead_a ? 0u
                         : pack16<E>(acc[4 * n] * ia, acc[4 * n + 1] * ia));
        st_shared(qs + P::template offset<kBlock>(rb, col),
                  dead_b ? 0u
                         : pack16<E>(acc[4 * n + 2] * ib,
                                     acc[4 * n + 3] * ib));
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
      if (threadIdx.x % 128 == 0) {
        P::template store<kBlock>(qs, &map_o, row_lo, bh);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(qempty + 8 * slot);
      }
      __syncwarp();
      if (t == 0) {
        float* lrow = lse + (long long)bh * T;
        if (row_a < T) lrow[row_a] = dead_a ? 0.f : (m_a + log2f(la)) * kLn2;
        if (row_b < T) lrow[row_b] = dead_b ? 0.f : (m_b + log2f(lb)) * kLn2;
      }
    }
    // warpgroup 1 passed once more than warpgroup 0 waited
    if (wg == 0) turn_wait(0);
  }
}

template <typename E, int D>
int launch_wg(const E* q, const E* k, const E* v, const float* bias, E* out,
              float* lse, int bh, int T, float scale, int causal, int device,
              cudaStream_t stream) {
  using Tile = FwdWgTile<D>;
  static std::atomic<bool> done[kMaxDevices];
  static std::atomic<int> sms[kMaxDevices];
  const cudaError_t e = allow_smem(flash_fwd_wg_kernel<E, D>, device, done);
  if (e != cudaSuccess) return (int)e;
  const bool known = device >= 0 && device < kMaxDevices;
  int n_sm = known ? sms[device].load(std::memory_order_relaxed) : 0;
  if (n_sm == 0) {
    const cudaError_t a = cudaDeviceGetAttribute(
        &n_sm, cudaDevAttrMultiProcessorCount, device);
    if (a != cudaSuccess) return (int)a;
    if (known) sms[device].store(n_sm, std::memory_order_relaxed);
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mo;
  if (!map16<E, D>(encode, &mq, q, T, bh, kBlock) ||
      !map16<E, D>(encode, &mk, k, T, bh, Tile::kKeys) ||
      !map16<E, D>(encode, &mv, v, T, bh, Tile::kKeys) ||
      !map16<E, D>(encode, &mo, out, T, bh, kBlock))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((T + kRowsBlock - 1) / kRowsBlock) * bh;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes =
      Tile::kBytes + sizeof(int) * ((T + Tile::kKeys - 1) / Tile::kKeys);
  // tiles of equal work (no bias, no causal mask) over one block an SM;
  // otherwise a block a tile, which the card schedules as SMs free up
  const unsigned grid = (unsigned)(bias == nullptr && !causal
                                       ? std::min<long long>(tiles, n_sm)
                                       : tiles);
  flash_fwd_wg_kernel<E, D><<<grid, kWgThreads, bytes, stream>>>(
      mq, mk, mv, mo, bias, lse, T, (int)tiles, scale, causal);
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
      return launch_wg<E, 32>(qe, ke, ve, bias, oe, lse, bh, T, scale,
                              causal, device, stream);
    case 64:
      return launch_wg<E, 64>(qe, ke, ve, bias, oe, lse, bh, T, scale,
                              causal, device, stream);
    case 128:
      return launch_wg<E, 128>(qe, ke, ve, bias, oe, lse, bh, T, scale,
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
