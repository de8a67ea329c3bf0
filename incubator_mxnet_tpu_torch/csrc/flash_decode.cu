// Paged attention of C query rows per sequence over its past (flash decode),
// for Hopper (sm_90a): fp32, bf16 q over bf16 or fp32 pools, and fp16 q over
// fp16 or fp32 pools.
//
// Replaces incubator_mxnet_tpu/ops/pallas/flash_decode.py: _decode_kernel
// (reached through _kernel_call and paged_flash_decode). The TPU kernel takes
// one query row per sequence (C == 1) and leaves C > 1 to lax; this one takes
// any C >= 1, so prefill chunks and speculative verification run here too. It
// computes the same function as the lax oracle _lax_paged_mhl: for sequence s
// the keys are the first lengths[s] positions of the pool rows its block
// table names, and it returns the normalised output o with the online-softmax
// row max m and denominator l.
//
// What bounds it on the H100: bytes. A decode step reads every live K and V
// row once, sum_s len_s * H * D * 4 * 2 bytes (8 sequences of ~350 positions
// at H * D = 768: ~17 MB, ~5 us at 3.35 TB/s), and does 4 * C * D operations
// per live key and head, 2 per byte at C = 1. Only at C ~ 64 and more would
// the fp32 CUDA cores (67 TFLOP/s) bound it instead. At these sizes the
// latency of a pass over the past weighs as much as its bytes: a 1024-
// position past walked by one block is a chain of dependent tile loads.
//
// What the design does about it:
// - Split-KV over a thread-block cluster. The (head, sequence, tile of up to
//   QT query rows) work of one cluster of nsplit <= 8 blocks. The host picks
//   nsplit from the table's capacity (max_blocks * block_size) and C alone,
//   so that a full table gives a block at most eight tiles for one query
//   row and four for a chunk; it never reads lengths. On the device, the
//   past of lengths[s] positions is cut into nact <= nsplit contiguous runs
//   of whole 32-key tiles, as many as there are tiles, and block r walks
//   run r; the blocks past nact leave at once. The walking blocks merge
//   their partials (m, l, acc) in the same launch: each stores its partial
//   of row r into the shared memory of the block of rank r % nact
//   (distributed shared memory: the stores do not wait), one cluster
//   barrier, and each block merges its rows in rank order. A past of one
//   tile takes one block and no barrier; a sequence with no past writes
//   o = 0, m = -1e30, l = 0 at once. No second kernel, no scratch in device
//   memory.
// - A block's run streams through a ring of two to four cp.async stages of
//   32 K and V rows (16 bytes a copy, each head row read as one coalesced
//   run): the loads of later tiles are in flight while a tile is scored.
//   Each thread reads its key's table entry a tile ahead, and the query
//   rows come by cp.async too, so no load stalls a thread before the first
//   wait. Padded table entries and positions past lengths[s] are never
//   read.
// - The four warps share each tile, warp w taking keys 8w..8w+7, and each
//   keeps its own online softmax over every query row (a running max m, a
//   sum l and the D-wide accumulator), merged with the others' at the end.
//   Up to 8 rows (decode, short chunks) the CUDA cores score: a quad of
//   lanes a key, each lane a quarter of its D products (float4 reads of K
//   rows padded to D + 16 floats, conflict-free), summed with two shuffles;
//   the probabilities go through shared memory to P V, D / 32 columns a
//   lane. From 16 rows on (prefill chunks) a row-serial loop would be the
//   kernel's time, so both products run on the tensor cores as the flash
//   forward's do (flash_tf32.cuh: 3xTF32 mma.sync m16n8k8, each k-step into
//   a fresh accumulator, K, V and Q split into tf32 halves once, P from the
//   S accumulator straight into P V's A fragment).
// - All C rows of a prefill chunk (up to 32; 16 at D = 128, where the
//   accumulators would spill) share one cluster, so each K and V row is read
//   once per head, whatever C.
// - Deterministic: the runs depend on the host's shapes and lengths[s]
//   only, and every merge adds in a fixed order, so two calls are bitwise
//   equal.
//
// A sequence with no past gives o = 0, m = -1e30 and l = 0 exactly, as in
// the TPU kernel. The (1, 8, H) sublane-replicated m and l outputs were
// Mosaic's layout and are gone: m and l are (S, C, H).
//
// The bf16 flavour (the TPU kernel on a bf16 GPT's q, over a bf16 spec's
// pools or the default fp32 ones). It computes what _decode_kernel computes
// there: scores as fp32 sums of q . k with both widened from their stored
// dtype, p and its sums in fp32, o normalised and written once in q's dtype,
// m and l fp32. What bounds it: bytes, as in fp32, with a bf16 pool's K and
// V rows half as many (8 sequences of ~350 positions at H * D = 768: ~8.6
// MB, ~2.6 us at 3.35 TB/s). The kernel is the fp32 one, templated on the
// element types of q (TQ) and of the pools (TK):
// - A 16-bit pool's K and V rows come through the same cp.async ring at
//   half the bytes: a 16-byte copy is 8 values, a D-wide head row is D / 8
//   copies (D = 32, 64, 128: whole copies, whatever the block size, since
//   each position's row is copied on its own after its table lookup). The
//   products read the stage as it landed and widen each value in
//   registers: no fp32 copy of a stage, no pass or barrier to make one, no
//   converted copy of a pool in device memory. The rows' pitches (Smem)
//   keep each route's reads conflict-free.
// - On the CUDA cores (up to 8 rows) a quad-lane reads its quarter of a K
//   row as 16-byte vectors of 8 values, and P V reads V's 16-bit columns.
// - On the tensor cores (chunks of 16 rows and more; q and the pools of one
//   type there) a 16-bit value is exact in TF32 (its remainder is 0), and
//   so is q: Q K^T is one TF32 product a k-step, where the fp32 pools' route
//   takes three, and no tile is split. P, an fp32 value, is split into TF32
//   hi and lo as in fp32, and P V is two TF32 products against V taken
//   exactly: P keeps about 22 bits, where the TPU kernel keeps p in fp32
//   (rounding P to bf16 for an m16n8k16 product would keep 8, and P in two
//   bf16 terms 16, against the 1e-5 floor of its limit).
// - bf16 q over fp32 pools is widened as it is loaded into the block's fp32
//   query rows, and the fp32 kernel's code runs unchanged.
// - o rounds once to bf16 (round to nearest even), at the end; m and l
//   are the fp32 kernel's.
//
// The fp16 flavour (the TPU kernel on an fp16 GPT's q, over an fp16 spec's
// pools or the default fp32 ones) is the same body instantiated on __half
// (flash_decode_kernel<D, QT, __half, TK>, TK __half or float), with what
// _decode_kernel computes there: fp32 scores of q and k widened from their
// stored dtype, p and its sums fp32, o rounded once to fp16, m and l fp32.
// Bytes bound it as they bound bf16 (2-byte pool rows). Only two things
// differ from bf16, and both sit in helpers over the element type:
// - Widening. A bf16 value widens by a 16-bit shift; an fp16 one needs a
//   real conversion (__half22float2 on each pair, subnormals included), so
//   widen8<T> and widen1<T> take the element type and the bf16 and fp32
//   instantiations keep their instructions.
// - Rounding o: __float2half_rn (round to nearest even, cvt.rn without
//   .satfinite, so a value past 65504 is inf as .to(torch.float16) gives it).
// On the tensor cores the 16-bit route stays exact for fp16 too: an fp16
// value has 11 significant bits, which TF32 holds, and its subnormals are
// normal numbers in TF32's 8-bit exponent. m and the -1e30 mask stay fp32
// in and out: in fp16 -1e30 would be -inf, and exp(m_p - m) NaN for a row
// with no past.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

#include "flash_tf32.cuh"

constexpr int kTileK = 32;        // keys of a stage: 8 a warp
constexpr int kMaxSplit = 8;      // blocks of a cluster (the portable limit)
constexpr int kMaxStages = 4;
constexpr size_t kSmemOptin = 232448;   // a block's shared memory, sm_90

using bf16 = __nv_bfloat16;
using f16 = __half;

// Query rows a block carries: 1 for decode, 8 for short chunks, else 32 (16
// at D = 128). From 16 rows on, the products run on the tensor cores (over
// fp32 pools 3xTF32, as the flash forward's; over 16-bit pools one TF32
// product for Q K^T and two for P V); below, on the CUDA cores. kKv16: the
// pools hold a 16-bit type (bf16 or fp16), whose ring stages are raw 16-bit
// rows that the products read as they landed.
template <int D, int QT, bool kKv16 = false>
struct Smem {
  static constexpr bool kTC = QT >= 16;
  // fp32 pools' K and V rows (floats): on the tensor cores D + 4, the
  // fragment reads' conflict-free pitch; on the CUDA cores K rows D + 16, so
  // that the two keys of a quarter-warp's float4 reads fall on distinct
  // banks
  static constexpr int kKStride = kTC ? D + 4 : D + 16;
  static constexpr int kVStride = kTC ? D + 4 : D;
  static constexpr int kStage = kTileK * (kKStride + kVStride);   // K, V
  // 16-bit pools' K and V rows (elements; 16-byte row starts for cp.async):
  // on the tensor cores D + 8, so that a fragment read's eight K rows (g)
  // and four V row pairs (t) start on distinct banks; on the CUDA cores K
  // rows 64 bytes on from a multiple of 128 (D + 32; D at D = 32), so that
  // the two keys of a quarter-warp's 16-byte reads fall on distinct banks,
  // and V rows D, which the warp reads along a row
  static constexpr int kKPitch16 = kTC ? D + 8 : (D == 32 ? D : D + 32);
  static constexpr int kVPitch16 = kTC ? D + 8 : D;
  static constexpr int kQStride = kTC ? D + 4 : D;
  static constexpr int kQ = QT * kQStride;          // the block's query rows
  // the tf32 remainders of the query rows and of a stage: on the tensor
  // cores over fp32 pools (a 16-bit value, and q of the pools' type, has
  // none)
  static constexpr bool kSplit = kTC && !kKv16;
  static constexpr int kQLo = kSplit ? kQ : 0;
  static constexpr int kLo = kSplit ? kStage : 0;
  static constexpr int kP = kTC ? 0 : kWarps * QT * 8;   // each warp's p
  static constexpr int kPart = QT * D + 2 * QT;     // acc, then m, then l
  static constexpr int kStat = QT * (kMaxSplit + 2);  // rows' merge weights
  // a ring stage (floats): K and V rows as the pools hold them
  static constexpr int kRaw =
      kKv16 ? kTileK * (kKPitch16 + kVPitch16) / 2 : kStage;
  // the ring, which the warps' partials reuse once the walk is done
  __host__ __device__ static constexpr int ring(int stages) {
    return stages * kRaw > kWarps * kPart ? stages * kRaw : kWarps * kPart;
  }
  // query rows (and remainders), p, a stage's remainders, the ring, the
  // cluster's partials of the rows this block merges, the rows' weights
  __host__ __device__ static constexpr size_t bytes(int stages,
                                                    int nsplit) {
    return sizeof(float) * (kQ + kQLo + kP + kLo + ring(stages) +
                            nsplit * kPart + kStat);
  }
};

// eight values of the 16-bit type T (16 bytes) widened to fp32 at dst
// (16-byte aligned): bf16 by a 16-bit shift, fp16 by a conversion of each
// pair (subnormals included)
template <typename T>
__device__ __forceinline__ void widen8(uint4 raw, float* dst) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (std::is_same<T, bf16>::value) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dst[2 * i] = __uint_as_float(w[i] << 16);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  } else {
    static_assert(std::is_same<T, f16>::value, "a 16-bit element type");
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
}

// one value of the 16-bit type T widened to fp32 (exact, subnormals
// included), and its bits as a TF32 operand: a 16-bit value fits TF32's 10
// mantissa bits and 8-bit exponent, so it needs no split
template <typename T>
__device__ __forceinline__ float widen1(T x) {
  if constexpr (std::is_same<T, bf16>::value)
    return __bfloat162float(x);
  else
    return __half2float(x);
}

template <typename T>
__device__ __forceinline__ unsigned tf32_of(T x) {
  return __float_as_uint(widen1<T>(x));
}

// acc += (ahi + alo) * b where b is exact in TF32: the two products into a
// fresh accumulator, which is added to acc rounding to nearest (mma3's
// rule, without the products of b's remainder, which is 0)
__device__ __forceinline__ void mma2(float* acc, const unsigned* ahi,
                                     const unsigned* alo,
                                     const unsigned* b) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float t[4];
  mma_tf32(t, ahi, b, zero);
  mma_tf32(t, alo, b, t);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// o in q's dtype: fp32 as it is, bf16 and fp16 rounded to nearest even
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_out(f16* p, float v) {
  *p = __float2half_rn(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// wait until at most n of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// grid (nsplit * ceil(C / QT), H, S), clusters of (nsplit, 1, 1): the
// blocks of a cluster share one (head, sequence, query tile)
template <int D, int QT, typename TQ, typename TK>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q,
                    const TK* __restrict__ k_pool,
                    const TK* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    TQ* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int C, int H, int num_blocks,
                    int block_size, int max_blocks, float scale, int nsplit,
                    int stages) {
  constexpr bool kKv16 = sizeof(TK) == 2;    // bf16 or fp16 pools
  constexpr bool kQ16 = sizeof(TQ) == 2;
  using Sm = Smem<D, QT, kKv16>;
  constexpr bool kTC = Sm::kTC;
  constexpr int KS = Sm::kKStride, VS = Sm::kVStride, QS = Sm::kQStride;
  constexpr int KP = Sm::kKPitch16, VP = Sm::kVPitch16;
  constexpr int D4 = D / 4;
  constexpr int DS = D / 16;      // float4 a lane reads of a K row
  constexpr int DV = D / 32;      // output columns a lane (CUDA cores)
  constexpr int MT = kTC ? QT / 16 : 1;   // mma m-tiles (tensor cores)
  constexpr int NT = D / 8;               // mma n-tiles across D
  constexpr int D8 = D / 8;               // 16-byte copies of a 16-bit row

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* q_lo = Qs + Sm::kQ;
  float* Ps = q_lo + Sm::kQLo;
  float* lo_k = Ps + Sm::kP;
  float* lo_v = lo_k + kTileK * KS;
  float* ring = lo_k + Sm::kLo;
  float* parts = ring + Sm::ring(stages);   // by rank, of the rows it owns
  // per row: the partials' weights exp(m - M) (kMaxSplit), then M and L
  float* stat = parts + nsplit * Sm::kPart;
  constexpr int SW = kMaxSplit + 2;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int c0 = (blockIdx.x / nsplit) * QT;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int nq = min(QT, C - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const long long pos_stride = (long long)H * D;   // elements a position

  // positions past the table's reach do not exist (as in the lax oracle)
  const int len = max(0, min(lengths[s], max_blocks * block_size));
  // the ranks that walk: one a tile at most, so that a short past takes
  // few blocks, and one block no cluster barrier at all; the others leave
  // at once (through the barrier, when there is one: it counts every block
  // of the cluster)
  const int nact = max(1, min(nsplit, (len + kTileK - 1) / kTileK));
  if (rank >= nact) {
    if (nact > 1) cluster.sync();
    return;
  }
  if (len == 0) {                        // no past: o = 0, m = -1e30, l = 0
    for (int i = threadIdx.x; i < nq * D; i += kThreads) {
      const long long orow = ((long long)s * C + c0 + i / D) * H + h;
      store_out(out + orow * D + i % D, 0.f);
      if (i % D == 0) {
        m_out[orow] = kNegInf;
        l_out[orow] = 0.f;
      }
    }
    return;
  }
  // the block's query rows, zero past C, land with the first tile; 16-bit
  // rows are widened as they are read (the first tile's barrier publishes
  // them)
  if constexpr (kQ16) {
    for (int i = threadIdx.x; i < QT * D8; i += kThreads) {
      const int r = i / D8, c8 = i % D8;
      const uint4 raw =
          r < nq ? *reinterpret_cast<const uint4*>(
                       q + (((long long)s * C + c0 + r) * H + h) * D + 8 * c8)
                 : make_uint4(0u, 0u, 0u, 0u);
      widen8<TQ>(raw, Qs + r * QS + 8 * c8);
    }
  } else {
    for (int i = threadIdx.x; i < QT * D4; i += kThreads) {
      const int r = i / D4, c4 = i % D4;
      const bool ok = r < nq;
      cp_async16(Qs + r * QS + 4 * c4,
                 ok ? reinterpret_cast<const float*>(q) +
                          (((long long)s * C + c0 + r) * H + h) * D + 4 * c4
                    : reinterpret_cast<const float*>(q),
                 ok);
    }
  }
  // this block's run: the rank-th of nact runs of whole tiles
  const int* tab = tables + (long long)s * max_blocks;
  const int per = ((len + nact - 1) / nact + kTileK - 1) / kTileK * kTileK;
  const int p_begin = min(len, rank * per);
  const int p_end = min(len, p_begin + per);
  const int n_t = (p_end - p_begin + kTileK - 1) / kTileK;

  // tile i of the run into its stage: thread (key, sub) copies every 4th
  // 16-byte piece of its key's K and V rows. The key's table entry is read
  // a tile ahead (entry), so that its latency hides behind a tile's work;
  // a pool row is clamped into the pool, so a bad entry cannot read
  // outside it.
  const int key = threadIdx.x / 4, sub = threadIdx.x % 4;
  auto entry = [&](int i) {
    const int pos = p_begin + i * kTileK + key;
    return pos < p_end ? tab[pos / block_size] : 0;
  };
  auto issue = [&](int i, int blk) {
    float* stage = ring + (i % stages) * Sm::kRaw;
    const int pos = p_begin + i * kTileK + key;
    const bool ok = pos < p_end;
    blk = min(max(blk, 0), num_blocks - 1);
    const long long row =
        ok ? ((long long)blk * block_size + pos % block_size) * pos_stride +
                 (long long)h * D
           : 0;
    if constexpr (kKv16) {
      // raw 16-bit rows, D a key at the pitches KP and VP: 8 values a copy
      TK* Kr = reinterpret_cast<TK*>(stage);
      TK* Vr = Kr + kTileK * KP;
#pragma unroll
      for (int c = sub; c < D8; c += 4) {
        cp_async16(reinterpret_cast<float*>(Kr + key * KP + 8 * c),
                   reinterpret_cast<const float*>(k_pool + row + 8 * c), ok);
        cp_async16(reinterpret_cast<float*>(Vr + key * VP + 8 * c),
                   reinterpret_cast<const float*>(v_pool + row + 8 * c), ok);
      }
    } else {
      float* Ks = stage;
      float* Vs = Ks + kTileK * KS;
#pragma unroll
      for (int c = sub; c < D4; c += 4) {
        cp_async16(Ks + key * KS + 4 * c,
                   reinterpret_cast<const float*>(k_pool) + row + 4 * c, ok);
        cp_async16(Vs + key * VS + 4 * c,
                   reinterpret_cast<const float*>(v_pool) + row + 4 * c, ok);
      }
    }
  };

  // CUDA cores: each warp's running max m and the D-wide accumulator of
  // every row (D / 32 columns a lane), each lane its key's share of l.
  // Tensor cores: the same per fragment row (rows g and g + 8 of each
  // m-tile), l the thread's two columns' share.
  float m[kTC ? 1 : QT], l[kTC ? 1 : QT], acc[kTC ? 1 : QT][DV];
  float mf[MT][2], lf[MT][2], of[kTC ? MT : 1][kTC ? NT : 1][4];
#pragma unroll
  for (int r = 0; r < (kTC ? 1 : QT); ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[r][c] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    mf[mt][0] = mf[mt][1] = kNegInf;
    lf[mt][0] = lf[mt][1] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < (kTC ? MT : 1); ++mt)
#pragma unroll
    for (int n = 0; n < (kTC ? NT : 1); ++n)
      of[mt][n][0] = of[mt][n][1] = of[mt][n][2] = of[mt][n][3] = 0.f;

  // the first stages - 1 tiles, their entries read together
  int first[kMaxStages - 1];
#pragma unroll
  for (int i = 0; i < kMaxStages - 1; ++i)
    first[i] = i < stages - 1 && i < n_t ? entry(i) : 0;
#pragma unroll
  for (int i = 0; i < kMaxStages - 1; ++i) {
    if (i < stages - 1) {
      if (i < n_t) issue(i, first[i]);
      cp_async_commit();
    }
  }
  int ahead = stages - 1 < n_t ? entry(stages - 1) : 0;
  float* Pw = Ps + warp * QT * 8;
  for (int i = 0; i < n_t; ++i) {
    const int j = i + stages - 1;        // the tile that goes in flight
    if (j < n_t) issue(j, ahead);
    cp_async_commit();
    ahead = j + 1 < n_t ? entry(j + 1) : 0;
    cp_async_wait_upto(stages - 1);      // tile i (and Q) have landed
    __syncthreads();
    // the stage as it landed: fp32 rows (Ks, Vs), or 16-bit rows (Kr, Vr)
    // that the products widen as they read them
    float* Ks = ring + (i % stages) * Sm::kRaw;
    float* Vs = Ks + kTileK * KS;
    const TK* Kr = reinterpret_cast<const TK*>(Ks);
    const TK* Vr = Kr + kTileK * KP;
    const int p0 = p_begin + i * kTileK;

    if constexpr (kTC) {
      // S = Q K^T over this warp's eight keys, every row
      float sc[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) sc[mt][0] = sc[mt][1] = sc[mt][2] = sc[mt][3] = 0.f;
      if constexpr (kKv16) {
        // one TF32 product a k-step: the 16-bit K values and q (of the
        // pools' type) are exact in TF32
        const float zero[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          const TK* kr = Kr + (8 * warp + g) * KP + 8 * kk + t;
          const unsigned b[2] = {tf32_of<TK>(kr[0]), tf32_of<TK>(kr[4])};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const float* qr = Qs + (16 * mt + g) * QS + 8 * kk + t;
            const unsigned a[4] = {
                __float_as_uint(qr[0]), __float_as_uint(qr[8 * QS]),
                __float_as_uint(qr[4]), __float_as_uint(qr[8 * QS + 4])};
            float tt[4];
            mma_tf32(tt, a, b, zero);
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[mt][e] += tt[e];
          }
        }
      } else {
        // the stage (and, once, Q) into tf32 halves
        split_tile<D, kTileK>(Ks, lo_k);
        split_tile<D, kTileK>(Vs, lo_v);
        if (i == 0) split_tile<D, QT>(Qs, q_lo);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < D / 8; ++kk) {
          unsigned bh[2], bl[2];
          pre_b_nk<D>(Ks, lo_k, 8 * warp + g, 8 * kk + t, bh, bl);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            unsigned ah[4], al[4];
            pre_a<D>(Qs, q_lo, 16 * mt + g, 8 * kk + t, ah, al);
            mma3(sc[mt], ah, al, bh, bl);
          }
        }
      }
      // the online softmax over the warp's keys: this thread's two
      // columns, then the quad
      const bool v0 = p0 + 8 * warp + 2 * t < p_end;
      const bool v1 = p0 + 8 * warp + 2 * t + 1 < p_end;
      unsigned ph[MT][4], pl[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float x0 = v0 ? sc[mt][2 * hf] * scale : -INFINITY;
          float x1 = v1 ? sc[mt][2 * hf + 1] * scale : -INFINITY;
          float mx = fmaxf(x0, x1);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(mf[mt][hf], mx);
          const float alpha = expf(mf[mt][hf] - m_new);
          mf[mt][hf] = m_new;
          x0 = expf(x0 - m_new);
          x1 = expf(x1 - m_new);
          lf[mt][hf] = lf[mt][hf] * alpha + x0 + x1;
          sc[mt][2 * hf] = x0;
          sc[mt][2 * hf + 1] = x1;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            of[mt][n][2 * hf] *= alpha;
            of[mt][n][2 * hf + 1] *= alpha;
          }
        }
        frag_acc(sc[mt], ph[mt], pl[mt]);
      }
      // O += P V over the warp's keys, P straight from the registers (tf32
      // hi and lo: about 22 bits, where the TPU kernel keeps p in fp32)
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        if constexpr (kKv16) {
          // V exact in TF32: two products, P's hi and lo
          const TK* vr = Vr + (8 * warp + 2 * t) * VP + 8 * n + g;
          const unsigned b[2] = {tf32_of<TK>(vr[0]), tf32_of<TK>(vr[VP])};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma2(of[mt][n], ph[mt], pl[mt], b);
        } else {
          unsigned vh[2], vl[2];
          pre_b_kn<D>(Vs, lo_v, 8 * warp + 2 * t, 8 * n + g, vh, vl);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma3(of[mt][n], ph[mt], pl[mt], vh, vl);
        }
      }
    } else {
      // score this warp's key 8w + g against every query row: lane t takes
      // columns 4t + 16j of an fp32 row, or 8t + 32j of a 16-bit one (16
      // bytes a read either way, widened in registers)
      const int kl = 8 * warp + g;
      const bool valid = p0 + kl < p_end;
      float4 kr[DS];
      if constexpr (kKv16) {
#pragma unroll
        for (int j = 0; j < D / 32; ++j)
          widen8<TK>(*reinterpret_cast<const uint4*>(Kr + kl * KP + 8 * t +
                                                     32 * j),
                     reinterpret_cast<float*>(kr + 2 * j));
      } else {
#pragma unroll
        for (int j = 0; j < DS; ++j)
          kr[j] = *reinterpret_cast<const float4*>(Ks + kl * KS + 4 * t + 16 * j);
      }
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < DS; ++j) {
          // the query columns of kr[j]
          const int col = kKv16 ? 8 * t + 32 * (j / 2) + 4 * (j % 2)
                                : 4 * t + 16 * j;
          d = dot4(*reinterpret_cast<const float4*>(Qs + r * QS + col),
                   kr[j], d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        const float sv = valid ? d * scale : -INFINITY;
        float mt = sv;
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m[r], mt);
        const float p = valid ? expf(sv - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        m[r] = m_new;
        l[r] = l[r] * alpha + p;
#pragma unroll
        for (int c = 0; c < DV; ++c) acc[r][c] *= alpha;
        if (t == 0) Pw[r * 8 + g] = p;
      }
      __syncwarp();

      // acc += P V over the warp's eight keys
      float vv[8][DV];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < DV; ++c) {
          if constexpr (kKv16)
            vv[j][c] = widen1<TK>(Vr[(8 * warp + j) * VP + lane + 32 * c]);
          else
            vv[j][c] = Vs[(8 * warp + j) * VS + lane + 32 * c];
        }
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        const float4 pa = *reinterpret_cast<const float4*>(Pw + r * 8);
        const float4 pb = *reinterpret_cast<const float4*>(Pw + r * 8 + 4);
        const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < DV; ++c)
            acc[r][c] = fmaf(pr[j], vv[j][c], acc[r][c]);
      }
    }
    __syncthreads();                     // the stage is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' partials over the ring: acc (QT x D), then m, then l
  float* wp = ring + warp * Sm::kPart;
  if constexpr (kTC) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * mt + g + 8 * hf;
        float lr = lf[mt][hf];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(wp + r * D + 8 * n + 2 * t) =
              make_float2(of[mt][n][2 * hf], of[mt][n][2 * hf + 1]);
        if (t == 0) {
          wp[QT * D + r] = mf[mt][hf];
          wp[QT * D + QT + r] = lr;
        }
      }
  } else {
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      float lr = l[r];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        lr += __shfl_xor_sync(0xffffffffu, lr, off);
#pragma unroll
      for (int c = 0; c < DV; ++c) wp[r * D + lane + 32 * c] = acc[r][c];
      if (lane == 0) {
        wp[QT * D + r] = m[r];
        wp[QT * D + QT + r] = lr;
      }
    }
  }
  __syncthreads();
  // each row's weights over the four warps: M, exp(m_w - M) and L
  if ((int)threadIdx.x < nq) {
    const int r = threadIdx.x;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, ring[w * Sm::kPart + QT * D + r]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(ring[w * Sm::kPart + QT * D + r] - M);
      stat[r * SW + w] = e;
      L = fmaf(ring[w * Sm::kPart + QT * D + QT + r], e, L);
    }
    stat[r * SW + kMaxSplit] = M;
    stat[r * SW + kMaxSplit + 1] = L;
  }
  __syncthreads();
  // o = acc / l, dead rows 0, for the row at orow
  auto emit = [&](int r, int d, float O) {
    const float M = stat[r * SW + kMaxSplit];
    const float L = stat[r * SW + kMaxSplit + 1];
    const bool dead = M <= 0.5f * kNegInf;
    const long long orow = ((long long)s * C + c0 + r) * H + h;
    store_out(out + orow * D + d, dead ? 0.f : O / fmaxf(L, 1e-30f));
    if (d == 0) {
      m_out[orow] = M;
      l_out[orow] = dead ? 0.f : L;
    }
  };
  if (nact == 1) {                       // the block's partial is the result
    for (int i = threadIdx.x; i < nq * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float O = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        O = fmaf(ring[w * Sm::kPart + r * D + d], stat[r * SW + w], O);
      emit(r, d, O);
    }
    return;
  }
  // the block's partial; row r goes to the block of rank r % nact, which
  // merges it (distributed shared memory: the stores do not wait)
  for (int i = threadIdx.x; i < nq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      O = fmaf(ring[w * Sm::kPart + r * D + d], stat[r * SW + w], O);
    float* dst = cluster.map_shared_rank(parts, r % nact) + rank * Sm::kPart;
    dst[r * D + d] = O;
    if (d == 0) {
      dst[QT * D + r] = stat[r * SW + kMaxSplit];
      dst[QT * D + QT + r] = stat[r * SW + kMaxSplit + 1];
    }
  }
  cluster.sync();                        // every partial is with its owner

  // this block's rows: the weights of the cluster's partials, then the
  // partials merged in rank order
  const int mine = nq > rank ? (nq - rank + nact - 1) / nact : 0;
  if ((int)threadIdx.x < mine) {
    const int r = rank + threadIdx.x * nact;
    float M = kNegInf;
    for (int b = 0; b < nact; ++b)
      M = fmaxf(M, parts[b * Sm::kPart + QT * D + r]);
    float L = 0.f;
    for (int b = 0; b < nact; ++b) {
      const float e = expf(parts[b * Sm::kPart + QT * D + r] - M);
      stat[r * SW + b] = e;
      L = fmaf(parts[b * Sm::kPart + QT * D + QT + r], e, L);
    }
    stat[r * SW + kMaxSplit] = M;
    stat[r * SW + kMaxSplit + 1] = L;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < mine * D; i += kThreads) {
    const int r = rank + (i / D) * nact, d = i % D;
    float O = 0.f;
    for (int b = 0; b < nact; ++b)
      O = fmaf(parts[b * Sm::kPart + r * D + d], stat[r * SW + b], O);
    emit(r, d, O);
  }
}

template <int D, int QT, typename TQ, typename TK>
int launch(const TQ* q, const TK* k_pool, const TK* v_pool,
           const int* tables, const int* lengths, TQ* out, float* m,
           float* l, int S, int C, int H, int num_blocks, int block_size,
           int max_blocks, float scale, int nsplit, int stages, int device,
           cudaStream_t stream) {
  using Sm = Smem<D, QT, sizeof(TK) == 2>;
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e =
      allow_smem(flash_decode_kernel<D, QT, TQ, TK>, device, done);
  if (e != cudaSuccess) return (int)e;
  // a deep ring of wide stages may not fit beside the cluster's partials
  while (stages > 2 && Sm::bytes(stages, nsplit) > kSmemOptin) --stages;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nsplit * ((C + QT - 1) / QT)), (unsigned)H,
                     (unsigned)S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Sm::bytes(stages, nsplit);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<D, QT, TQ, TK>, q, k_pool, v_pool, tables,
      lengths, out, m, l, C, H, num_blocks, block_size, max_blocks, scale,
      nsplit, stages);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

template <int D, typename TQ, typename TK>
int launch_d(const TQ* q, const TK* k_pool, const TK* v_pool,
             const int* tables, const int* lengths, TQ* out, float* m,
             float* l, int S, int C, int H, int num_blocks, int block_size,
             int max_blocks, float scale, int nsplit, int stages, int device,
             cudaStream_t stream) {
  constexpr int kWide = D == 128 ? 16 : 32;
  if (C == 1)
    return launch<D, 1>(q, k_pool, v_pool, tables, lengths, out, m, l, S, C,
                        H, num_blocks, block_size, max_blocks, scale, nsplit,
                        stages, device, stream);
  if (C <= 8)
    return launch<D, 8>(q, k_pool, v_pool, tables, lengths, out, m, l, S, C,
                        H, num_blocks, block_size, max_blocks, scale, nsplit,
                        stages, device, stream);
  return launch<D, kWide>(q, k_pool, v_pool, tables, lengths, out, m, l, S,
                          C, H, num_blocks, block_size, max_blocks, scale,
                          nsplit, stages, device, stream);
}

// Picks the split from the table's capacity and C: enough blocks a cluster
// (at most 8) that a full table gives each at most eight 32-key tiles for
// one query row, four for more, and ring stages for a full run: two (fewer
// if the run is shorter), up to four for runs of 16 tiles and more, since a
// deeper ring costs shared memory and so blocks resident an SM (and no
// deeper than fits beside the cluster's partials). Makes `device` current
// for this library's runtime, launches on `stream`, allocates nothing, and
// returns cudaGetLastError().
template <typename TQ, typename TK>
int decode(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* lengths, void* out, float* m,
           float* l, int S, int C, int H, int D, int num_blocks,
           int block_size, int max_blocks, float scale, int device,
           void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (S <= 0 || S > 65535 || C <= 0 || (C + 7) / 8 > 65535 || H <= 0 ||
      H > 65535 || num_blocks <= 0 || block_size <= 0 || max_blocks <= 0 ||
      (long long)max_blocks * block_size > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      ((long long)max_blocks * block_size + kTileK - 1) / kTileK;
  // a full table's tiles a block: a decode row's tile is a few
  // instructions, so eight a block and fewer blocks to schedule; a chunk's
  // rows make a tile worth splitting further, four a block
  const int run_tiles = C == 1 ? 8 : 4;
  const int nsplit = (int)std::min<long long>(
      kMaxSplit, std::max<long long>(1, (tiles + run_tiles - 1) / run_tiles));
  const long long run = (tiles + nsplit - 1) / nsplit;   // tiles a block
  const int stages =
      run <= 2 ? (int)run
               : (int)std::min<long long>(kMaxStages,
                                          std::max<long long>(2, run / 4));
  const TQ* qt = static_cast<const TQ*>(q);
  const TK* kt = static_cast<const TK*>(k_pool);
  const TK* vt = static_cast<const TK*>(v_pool);
  TQ* ot = static_cast<TQ*>(out);
  switch (D) {
    case 32:
      return launch_d<32>(qt, kt, vt, tables, lengths, ot, m, l, S, C, H,
                          num_blocks, block_size, max_blocks, scale, nsplit,
                          stages, device, stream);
    case 64:
      return launch_d<64>(qt, kt, vt, tables, lengths, ot, m, l, S, C, H,
                          num_blocks, block_size, max_blocks, scale, nsplit,
                          stages, device, stream);
    case 128:
      return launch_d<128>(qt, kt, vt, tables, lengths, ot, m, l, S, C, H,
                           num_blocks, block_size, max_blocks, scale, nsplit,
                           stages, device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points, bound with ctypes. q, out: (S, C, H, D); k_pool, v_pool:
// (num_blocks, block_size, H, D); m, l: (S, C, H) fp32; all contiguous,
// 16-byte aligned. tables: (S, max_blocks) int32; lengths: (S,) int32. D is
// 32, 64 or 128.
//
// fp32 q, pools and o.
extern "C" int mxtpu_flash_decode_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int* tables, const int* lengths, float* out, float* m, float* l,
    int S, int C, int H, int D, int num_blocks, int block_size,
    int max_blocks, float scale, int device, void* stream_ptr) {
  return decode<float, float>(q, k_pool, v_pool, tables, lengths, out, m, l,
                              S, C, H, D, num_blocks, block_size, max_blocks,
                              scale, device, stream_ptr);
}

// bf16 q and o over pools of kv_dtype: 0 bf16, 1 fp32. Any other code (a
// pair this library was not built for) returns cudaErrorInvalidValue and
// launches nothing.
extern "C" int mxtpu_flash_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const int* tables, const int* lengths, void* out, float* m, float* l,
    int S, int C, int H, int D, int num_blocks, int block_size,
    int max_blocks, float scale, int kv_dtype, int device,
    void* stream_ptr) {
  if (kv_dtype == 0)
    return decode<bf16, bf16>(q, k_pool, v_pool, tables, lengths, out, m, l,
                              S, C, H, D, num_blocks, block_size, max_blocks,
                              scale, device, stream_ptr);
  if (kv_dtype == 1)
    return decode<bf16, float>(q, k_pool, v_pool, tables, lengths, out, m,
                               l, S, C, H, D, num_blocks, block_size,
                               max_blocks, scale, device, stream_ptr);
  return (int)cudaErrorInvalidValue;
}

// fp16 q and o over pools of kv_dtype: 0 fp16, 1 fp32; any other code
// returns cudaErrorInvalidValue and launches nothing.
extern "C" int mxtpu_flash_decode_f16(
    const void* q, const void* k_pool, const void* v_pool,
    const int* tables, const int* lengths, void* out, float* m, float* l,
    int S, int C, int H, int D, int num_blocks, int block_size,
    int max_blocks, float scale, int kv_dtype, int device,
    void* stream_ptr) {
  if (kv_dtype == 0)
    return decode<f16, f16>(q, k_pool, v_pool, tables, lengths, out, m, l, S,
                            C, H, D, num_blocks, block_size, max_blocks,
                            scale, device, stream_ptr);
  if (kv_dtype == 1)
    return decode<f16, float>(q, k_pool, v_pool, tables, lengths, out, m, l,
                              S, C, H, D, num_blocks, block_size, max_blocks,
                              scale, device, stream_ptr);
  return (int)cudaErrorInvalidValue;
}
