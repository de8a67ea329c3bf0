// Exact int8 x int8 -> int32 matrix product for Hopper (sm_90a).
//
// Replaces incubator_mxnet_tpu/ops/pallas/int8_matmul.py: _kernel (reached
// through int8_matmul), the (M, K) x (K, N) product with an int32
// accumulator that serving/quant.py's Int8Dense runs for the vocab head of
// int8 decode.
//
// Layout: A is (M, K) and W is (N, K), both row-major, so both operands are
// K-contiguous; C = A W^T is (M, N) int32, row-major. W (N, K) is the
// (out, in) layout of a Dense weight, and the natural B operand ("col") of
// the tensor cores' integer MMA.
//
// What bounds it on the H100: at the decode shape (M = 8 slots, K = 650,
// N = 10000) bytes: the 6.5 MB weight is read once, 1.9 us at 3.35 TB/s,
// against 0.1 GOP. At 4096^3 operations: 137 GOP at the dense int8
// tensor-core rate (1979 TOP/s) is 69 us.
//
// What the design does about it: one block owns a BM x BN tile of C and
// walks K in stages of 64 bytes; each stage of A and W rows is copied into
// shared memory with 16-byte cp.async, STAGES - 1 stages in flight ahead of
// the one being multiplied, so a block keeps several KB of the weight in
// flight. Warps multiply with mma.sync.m16n8k32 (s8 x s8 -> s32) from
// fragments read out of shared memory rows padded to 80 bytes, which makes
// the fragment reads free of bank conflicts. Rows of C at or past M and
// columns at or past N are masked; rows of A and W past the edge, and K past
// its end, are zero-filled, which adds nothing to an integer sum. For M up
// to 16 (decode) the tile is 16 x 64 with 4 stages, so that the grid has
// more blocks than the card has SMs; above it the tile is 128 x 128.
//
// 16-byte copies need 16-byte aligned rows: both base pointers aligned and
// K a multiple of 16. Anything else (a view with an odd offset, a K such as
// 650) takes the same kernel with byte-wide loads, which are correct and
// slow; Int8Dense keeps its weight zero-padded in K to a multiple of 16 so
// that the serving path takes the 16-byte copies.
//
// Integer sums are exact in any order: the result equals the plain
// version's bit for bit. The wrapper refuses K >= 2^31 / 128^2, from which
// on an int32 sum of int8 products could leave the int32 range.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;           // K bytes per stage: two mma k-steps of 32
constexpr int kRow = kBK + 16;    // padded shared-memory row (80 bytes)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

// Decode tile: 16 x 64, 4 warps side by side in N, 4 stages (25.6 KB).
constexpr int kSmallBM = 16, kSmallBN = 64;
// Large tile: 128 x 128, 8 warps as 2 x 4 (warp tile 64 x 32), 2 stages
// (40 KB of static shared memory).
constexpr int kLargeBM = 128, kLargeBN = 128;

template <bool VEC>
cudaError_t launch(const int8_t* a, const int8_t* w, int32_t* c, int M,
                   int N, int K, cudaStream_t stream) {
  if (M <= kSmallBM) {
    const dim3 grid((N + kSmallBN - 1) / kSmallBN, 1);
    int8_mm_kernel<kSmallBM, kSmallBN, 1, 4, 4, VEC>
        <<<grid, 128, 0, stream>>>(a, w, c, M, N, K);
  } else {
    const dim3 grid((N + kLargeBN - 1) / kLargeBN,
                    (M + kLargeBM - 1) / kLargeBM);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    int8_mm_kernel<kLargeBM, kLargeBN, 2, 4, 2, VEC>
        <<<grid, 256, 0, stream>>>(a, w, c, M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace

// C (M, N) int32 = A (M, K) int8 x W (N, K) int8 transposed; contiguous
// operands, any M, N >= 1 and K >= 1, any alignment.
extern "C" int mxtpu_int8_matmul_nk(const void* a, const void* w, void* c,
                                    int M, int N, int K, int device,
                                    void* stream_ptr) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* w8 = static_cast<const int8_t*>(w);
  auto* c32 = static_cast<int32_t*>(c);
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && K % 16 == 0;
  return (int)(vec ? launch<true>(a8, w8, c32, M, N, K, stream)
                   : launch<false>(a8, w8, c32, M, N, K, stream));
}
