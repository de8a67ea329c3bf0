// Exact int8 x int8 -> int32 matrix product for Hopper (sm_90a).
//
// Replaces incubator_mxnet_tpu/ops/pallas/int8_matmul.py: _kernel (reached
// through int8_matmul), the (M, K) x (K, N) product with an int32
// accumulator that serving/quant.py's Int8Dense runs for the vocab head of
// int8 decode.
//
// Layout: A is (M, K) and W is (N, K), both row-major, so both operands are
// K-contiguous; C = A W^T is (M, N) int32, row-major. W (N, K) is the
// (out, in) layout of a Dense weight, and the K-major B operand that the
// tensor cores' integer products (mma.sync "col", wgmma) require.
//
// What bounds it on the H100: at the decode shape (M = 8 slots, K = 656,
// N = 10000) bytes: the 6.5 MB weight is read once, 2 us at 3.35 TB/s,
// against 0.1 GOP. At 4096^3 operations: 137 GOP at the dense int8
// tensor-core rate (1979 TOP/s) is 69 us, and only wgmma reaches that rate;
// the int32 output (67 of the 100 MB it moves) costs 20 us of bytes.
//
// Three routes, picked by the Python wrapper (ops/kernels/int8_matmul.py
// _route) and checked here:
//   small (M <= 16, decode): one block of 4 warps owns a 16 x 32 tile of C
//     and requests all of its K share before it multiplies, in stages of
//     256 bytes copied with 16-byte cp.async (at the decode shape, K = 656,
//     three stages: all of the tile's bytes in flight at once). The warps
//     split each stage's k-steps of 32 among them, so no warp walks a chain
//     of dependent stages, and multiply with mma.sync.m16n8k32 (s8 x s8 ->
//     s32) from rows padded to 272 bytes (conflict-free fragment reads);
//     their int32 partials meet in shared memory once the last stage is
//     consumed, with no atomics and no scratch in device memory. Longer K
//     streams through the three stages. Misaligned operands take the same
//     kernel with byte-wide loads.
//   tma (M > 16, both bases 16-byte aligned, K % 16 == 0): one persistent
//     block an SM walks 128 x 256 tiles of C. One producer thread keeps a
//     ring of 4 stages of 128 bytes of K (A 16 KB + W 32 KB a stage, 192 KB
//     of dynamic shared memory) filled with TMA loads (cp.async.bulk.tensor,
//     128-byte swizzle), each stage's arrival counted by an mbarrier; two
//     consumer warpgroups of 64 x 256 each run wgmma.m64n256k32 (s8 x s8 ->
//     s32) on the swizzled tiles straight from shared memory and hand a
//     stage back through a second mbarrier once its products have
//     completed, so loads run 3 stages ahead of the tensor cores, into the
//     next tile while the consumers store this one. TMA zero-fills rows
//     past M or N and bytes past K, which adds nothing to an integer sum.
//     The epilogue stores 8 bytes a thread (a quad of threads writes 32
//     contiguous bytes of a row). At full rate a stage's 48 KB feeds 1024
//     tensor-core clocks of an SM, ~11.6 TB/s from L2 across the card, so
//     L2 is the expected limit; a cluster of two blocks sharing W through
//     TMA multicast would halve W's share of that traffic.
//   bytes (anything else: a view at an odd offset, a K such as 650): a
//     128 x 128 tile of mma.sync with byte-wide loads, correct and slow;
//     Int8Dense keeps its weight zero-padded in K to a multiple of 16 so
//     that the serving path never takes it.
//
// Integer sums are exact in any order: every route equals the plain
// version bit for bit. The wrapper refuses K >= 2^31 / 128^2, from which
// on an int32 sum of int8 products could leave the int32 range.

#include <cuda.h>    // CUtensorMap and its enums (no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;           // K bytes per stage: two mma k-steps of 32
constexpr int kRow = kBK + 16;    // padded shared-memory row (80 bytes)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

#include "hopper.cuh"

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes instead.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 inputs, s32 accumulator.
__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, bool VEC>
__global__ void __launch_bounds__(WARPS_M* WARPS_N * 32)
    int8_mm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
                   int32_t* __restrict__ c, int M, int N, int K) {
  constexpr int kThreads = WARPS_M * WARPS_N * 32;
  constexpr int WTM = BM / WARPS_M;    // warp tile
  constexpr int WTN = BN / WARPS_N;
  constexpr int MT = WTM / 16;         // mma tiles per warp
  constexpr int NT = WTN / 8;
  static_assert(WTM % 16 == 0 && WTN % 8 == 0, "warp tile");
  __shared__ __align__(16) int8_t smem[STAGES][(BM + BN) * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;    // mma fragment coordinates
  const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
  const long long m0 = (long long)blockIdx.y * BM;
  const long long n0 = (long long)blockIdx.x * BN;
  const int ktiles = (K + kBK - 1) / kBK;

  // Stage `s` <- rows m0.. of A and n0.. of W, columns k0 .. k0 + 63.
  auto load = [&](int s, int k0) {
    int8_t* dst = smem[s];
    if constexpr (VEC) {
      for (int ch = tid; ch < (BM + BN) * (kBK / 16); ch += kThreads) {
        const int r = ch / (kBK / 16), j = ch % (kBK / 16);
        const int k = k0 + j * 16;
        const bool is_a = r < BM;
        const long long row = is_a ? m0 + r : n0 + (r - BM);
        const int8_t* base = is_a ? a : w;
        const bool ok = row < (is_a ? M : N) && k < K;
        cp_async16(dst + r * kRow + j * 16, ok ? base + row * K + k : base,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < (BM + BN) * kBK; e += kThreads) {
        const int r = e / kBK, kk = e % kBK;
        const int k = k0 + kk;
        const bool is_a = r < BM;
        const long long row = is_a ? m0 + r : n0 + (r - BM);
        const int8_t* base = is_a ? a : w;
        const bool ok = row < (is_a ? M : N) && k < K;
        dst[r * kRow + kk] = ok ? base[row * K + k] : (int8_t)0;
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles) load(s, s * kBK);
    cp_async_commit();    // always: the wait below counts groups
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();    // stage kt has landed ...
    __syncthreads();                // ... for every thread, and stage kt - 1
                                    // is no longer read by anyone
    const int next = kt + STAGES - 1;
    if (next < ktiles) load(next % STAGES, next * kBK);
    cp_async_commit();

    const int8_t* As = smem[kt % STAGES];
    const int8_t* Ws = As + BM * kRow;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      unsigned af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = As + (wm + i * 16 + g) * kRow + ks + t * 4;
        af[i][0] = *reinterpret_cast<const unsigned*>(p);
        af[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * kRow);
        af[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        af[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = Ws + (wn + j * 8 + g) * kRow + ks + t * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
  }

  // accumulator fragment: rows g and g + 8, columns 2t and 2t + 1
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = m0 + wm + i * 16 + g + h * 8;
        const long long col = n0 + wn + j * 8 + t * 2;
        if (row >= M) continue;
        if (col < N) c[row * N + col] = acc[i][j][2 * h];
        if (col + 1 < N) c[row * N + col + 1] = acc[i][j][2 * h + 1];
      }
}

// --------------------------------------------- small: split K over warps
namespace small {

constexpr int kBM = 16, kBN = 32;    // the tile of C a block owns
constexpr int kWarps = 4;            // each takes every 4th k-step of 32
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 256;          // K bytes a stage
constexpr int kRowC = kChunk + 16;   // padded row (272 bytes: conflict-free
                                     // fragment reads, 4 banks a row on)
constexpr int kStages = 3;           // all requested before the first wait
constexpr int kStageBytes = (kBM + kBN) * kRowC;
constexpr int kNT = kBN / 8;         // n8 tiles of a warp's 16 x 32 partial
constexpr int kRedRow = kBN + 4;     // a partial's row in the reduction
static_assert(kWarps * kBM * kRedRow * 4 <= kStages * kStageBytes,
              "reduction space");

// One block owns a 16 x 32 tile of C and requests its whole share of A and
// W, in stages of 256 bytes of K, before it multiplies: at the decode shape
// (K = 656) three stages, all of the tile's bytes in flight at once, over
// 313 blocks. Its 4 warps split each stage's k-steps (warp w takes steps
// w, w + 4, ...), so no warp walks a chain of dependent stages; each keeps
// a 16 x 32 int32 partial in registers. The partials meet in shared memory
// once the last stage is consumed, and each thread adds the 4 partials of
// 4 outputs in warp order and stores them. Integer sums are exact in any order; nothing
// is atomic and nothing but A, W and C goes through device memory.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    int8_mm_small_kernel(const int8_t* __restrict__ a,
                         const int8_t* __restrict__ w,
                         int32_t* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) int8_t smem[kStages * kStageBytes];   // 39 KB
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;    // mma fragment coordinates
  const long long n0 = (long long)blockIdx.x * kBN;
  const int nchunks = (K + kChunk - 1) / kChunk;

  // stage `s` <- A's rows 0..15 and W's rows n0.., K columns k0 .. + 255
  auto load = [&](int s, int k0) {
    int8_t* dst = smem + s * kStageBytes;
    if constexpr (VEC) {
      for (int ch = tid; ch < (kBM + kBN) * (kChunk / 16); ch += kThreads) {
        const int r = ch / (kChunk / 16), j = ch % (kChunk / 16);
        const int k = k0 + j * 16;
        const bool is_a = r < kBM;
        const long long row = is_a ? r : n0 + (r - kBM);
        const int8_t* base = is_a ? a : w;
        const bool ok = row < (is_a ? M : N) && k < K;
        cp_async16(dst + r * kRowC + j * 16, ok ? base + row * K + k : base,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < (kBM + kBN) * kChunk; e += kThreads) {
        const int r = e / kChunk, kk = e % kChunk;
        const int k = k0 + kk;
        const bool is_a = r < kBM;
        const long long row = is_a ? r : n0 + (r - kBM);
        const int8_t* base = is_a ? a : w;
        const bool ok = row < (is_a ? M : N) && k < K;
        dst[r * kRowC + kk] = ok ? base[row * K + k] : (int8_t)0;
      }
    }
  };

  int acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0;

#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < nchunks) load(s, s * kChunk);
    cp_async_commit();    // always: the wait below counts groups
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kStages - 1>();   // stage ch has landed ...
    __syncthreads();                // ... for every thread
    const int8_t* As = smem + (ch % kStages) * kStageBytes;
    const int8_t* Ws = As + kBM * kRowC;
    const int steps = (min(kChunk, K - ch * kChunk) + 31) / 32;
    for (int st = warp; st < steps; st += kWarps) {
      const int ks = st * 32;
      unsigned af[4], bf[kNT][2];
      const int8_t* p = As + g * kRowC + ks + t * 4;
      af[0] = *reinterpret_cast<const unsigned*>(p);
      af[1] = *reinterpret_cast<const unsigned*>(p + 8 * kRowC);
      af[2] = *reinterpret_cast<const unsigned*>(p + 16);
      af[3] = *reinterpret_cast<const unsigned*>(p + 8 * kRowC + 16);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int8_t* q = Ws + (j * 8 + g) * kRowC + ks + t * 4;
        bf[j][0] = *reinterpret_cast<const unsigned*>(q);
        bf[j][1] = *reinterpret_cast<const unsigned*>(q + 16);
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_s8(acc[j], af, bf[j]);
    }
    __syncthreads();                // stage ch is no longer read by anyone
    if (ch + kStages < nchunks)
      load(ch % kStages, (ch + kStages) * kChunk);
    cp_async_commit();
  }

  // the warps' partials (accumulator fragment: rows g and g + 8, columns
  // 8 j + 2 t and + 1) into the stages' space, then each output's partials
  // added in warp order
  cp_async_wait<0>();
  int* red = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int* dst = red + (warp * kBM + g + 8 * h) * kRedRow + j * 8 + 2 * t;
      dst[0] = acc[j][2 * h];
      dst[1] = acc[j][2 * h + 1];
    }
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int row = i / kBN, col = i % kBN;
    if (row >= M || n0 + col >= N) continue;
    int sum = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      sum += red[(v * kBM + row) * kRedRow + col];
    c[(long long)row * N + n0 + col] = sum;
  }
}

template <bool VEC>
cudaError_t launch(const int8_t* a, const int8_t* w, int32_t* c, int M,
                   int N, int K, cudaStream_t stream) {
  int8_mm_small_kernel<VEC><<<(unsigned)((N + kBN - 1) / kBN), kThreads, 0,
                              stream>>>(a, w, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace small

// Byte-load tile: 128 x 128, 8 warps as 2 x 4 (warp tile 64 x 32), 2
// stages (40 KB of static shared memory).
constexpr int kBytesBM = 128, kBytesBN = 128;

cudaError_t launch_bytes(const int8_t* a, const int8_t* w, int32_t* c, int M,
                         int N, int K, cudaStream_t stream) {
  const dim3 grid((N + kBytesBN - 1) / kBytesBN,
                  (M + kBytesBM - 1) / kBytesBM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int8_mm_kernel<kBytesBM, kBytesBN, 2, 4, 2, false>
      <<<grid, 256, 0, stream>>>(a, w, c, M, N, K);
  return cudaGetLastError();
}

// ------------------------------------------------------- tma: wgmma + TMA
namespace tma {

constexpr int kBM = 128, kBN = 256;      // block tile of C
constexpr int kBK = 128;                 // K bytes a stage: 4 wgmma k-steps
constexpr int kStages = 4;
constexpr int kConsumers = 2;            // warpgroups, 64 rows of C each
constexpr int kThreads = kConsumers * 128 + 32;   // + the producer warp
constexpr int kABytes = kBM * kBK;       // 16 KB
constexpr int kStageBytes = kABytes + kBN * kBK;  // + 32 KB of W
// stages, then full[kStages] and empty[kStages] mbarriers, and room to
// align the base to the 1024 bytes of a 128-byte swizzle atom
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kStages * 8 + 1024;

// d (64 x 256 s32, the wgmma accumulator fragment) += A (64 x 32 s8, from
// desc_a) x B (256 x 32 s8, from desc_b)^T: both operands K-major.
__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t desc_a,
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Persistent: block b owns output tiles b, b + gridDim.x, ... (N fastest),
// so that the producer loads the next tile's first stages while the
// consumers store this one's accumulators. `it` counts stages over all of
// a block's tiles: stage it uses slot it % kStages in round it / kStages.
__global__ void __launch_bounds__(kThreads, 1)
    int8_mm_tma_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_w,
                       int32_t* __restrict__ c, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const unsigned full = base + kStages * kStageBytes;   // mbarriers
  const unsigned empty = full + kStages * 8;
  const int ktiles = (K + kBK - 1) / kBK;
  const long long tiles_n = (N + kBN - 1) / kBN;
  const long long tiles = tiles_n * ((M + kBM - 1) / kBM);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's arrive
      mbar_init(empty + 8 * s, kConsumers * 4);    // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // producer: one thread keeps the ring full, kStages stages ahead
    if (threadIdx.x != kConsumers * 128) return;
    unsigned it = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (int)(t / tiles_n) * kBM, n0 = (int)(t % tiles_n) * kBN;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const unsigned s = it % kStages;
        // round r of a slot waits for the consumers' release of round r - 1
        // (round 0 passes: the phase "before" the first counts as complete)
        mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const unsigned dst = base + s * kStageBytes;
        mbar_expect_tx(full + 8 * s, kStageBytes);
        tma_load(dst, &map_a, full + 8 * s, kt * kBK, m0);
        tma_load(dst + kABytes, &map_w, full + 8 * s, kt * kBK, n0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of a tile
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const bool pairs = (N % 2) == 0;
  unsigned it = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (int)(t / tiles_n) * kBM, n0 = (int)(t % tiles_n) * kBN;
    int d[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_operand(d[i]);

    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const unsigned s = it % kStages;
      mbar_wait(full + 8 * s, (it / kStages) & 1);
      const unsigned a_tile = base + s * kStageBytes + wg * 64 * kBK;
      const unsigned w_tile = base + s * kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma_s8_n256(d, sw128_desc(a_tile + kk * 32),
                      sw128_desc(w_tile + kk * 32));
      wgmma_commit();
      // the products of the stage before have completed: hand its slot
      // back
      wgmma_wait<1>();
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % kStages));
#pragma unroll
    for (int i = 0; i < 128; ++i) fence_operand(d[i]);

    // accumulator fragment: d[4j + 2h + e] is row 16 warp + lane / 4 + 8 h,
    // column 8 j + 2 (lane % 4) + e of the warpgroup's 64 x 256
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
    const int col0 = n0 + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      int32_t* out = c + (long long)row * N;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = col0 + 8 * j;
        const int v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
        if (pairs && col + 1 < N) {
          *reinterpret_cast<int2*>(out + col) = make_int2(v0, v1);
        } else {
          if (col < N) out[col] = v0;
          if (col + 1 < N) out[col + 1] = v1;
        }
      }
    }
  }
}

// (rows, K) int8 row-major at `ptr`, read in boxes of 128 bytes x box_rows
// with the 128-byte swizzle; reads past the edges fill zeros.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
              int rows, int K, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};    // bytes between rows
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const int8_t* a, const int8_t* w, int32_t* c, int M,
                   int N, int K, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const long long tiles = (long long)((N + kBN - 1) / kBN) *
                          ((M + kBM - 1) / kBM);
  const dim3 grid((unsigned)(tiles < sms ? tiles : sms));
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map_a, map_w;
  if (!make_map(encode, &map_a, a, M, K, kBM) ||
      !make_map(encode, &map_w, w, N, K, kBN))
    return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(int8_mm_tma_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemBytes);
  if (e != cudaSuccess) return e;
  int8_mm_tma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_w, c,
                                                             M, N, K);
  return cudaGetLastError();
}

}  // namespace tma

}  // namespace

// C (M, N) int32 = A (M, K) int8 x W (N, K) int8 transposed; contiguous
// operands, any M, N >= 1 and K >= 1. `route` is the wrapper's choice:
// 0 small (M <= 16), 1 tma (both bases 16-byte aligned and K % 16 == 0),
// 2 bytes (any operands); a route whose condition fails is refused with
// cudaErrorInvalidValue, so the wrapper and this file cannot disagree.
extern "C" int mxtpu_int8_matmul_nk(const void* a, const void* w, void* c,
                                    int M, int N, int K, int route,
                                    int device, void* stream_ptr) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       K % 16 == 0;
  if ((route == 0 && M > small::kBM) || (route == 1 && !aligned) ||
      route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* w8 = static_cast<const int8_t*>(w);
  auto* c32 = static_cast<int32_t*>(c);
  if (route == 0)
    return (int)(aligned ? small::launch<true>(a8, w8, c32, M, N, K, stream)
                         : small::launch<false>(a8, w8, c32, M, N, K, stream));
  if (route == 1)
    return (int)tma::launch(a8, w8, c32, M, N, K, device, stream);
  return (int)launch_bytes(a8, w8, c32, M, N, K, stream);
}
