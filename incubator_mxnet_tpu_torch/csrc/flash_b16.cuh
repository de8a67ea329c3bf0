// Building blocks of the 16-bit flash-attention kernels (flash_attention_fwd.cu
// and flash_attention_bwd.cu), over one element type E: __nv_bfloat16 (bf16)
// or __half (fp16). E tiles staged through cp.async, fragments read with
// ldmatrix, and mma.sync m16n8k16 with E operands and fp32 accumulators.
// Included after flash_tf32.cuh, inside each source's anonymous namespace:
// it takes the block shape (kBlock, kWarps, kThreads), the mask constants,
// the cp.async commit/wait and row helpers, live_key and allow_smem from
// there. The source includes <cuda_bf16.h> and <cuda_fp16.h> first, outside
// the namespace.
//
// - A tile of R rows of D elements sits in shared memory with rows of D + 8
//   elements (D * 2 + 16 bytes): the eight 16-byte rows an ldmatrix phase
//   reads start 4 banks apart, so they hit 32 distinct banks, and every
//   row start stays 16-byte aligned for cp.async.
// - Fragment maps of m16n8k16 (g = lane / 4, t = lane % 4): A (16 x 16, row)
//   a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8,
//   2t + 8..); B (16 x 8, col) b0 = (k 2t..2t+1, n g), b1 = (k 2t + 8.., n
//   g); C c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..). The accumulators of
//   two neighbouring n-tiles of an S-shaped product are therefore, packed in
//   pairs, the A fragment of one k-step of the next product (pack_a): P and
//   dS never leave registers, rounded to E where the TPU kernel rounds
//   them. The maps, ldmatrix and cp.async are the same for both types; only
//   the mma's operand type and the rounding differ (B16<E>).
// - fp16 rounds to nearest even with cvt.rn (__floats2half2_rn), never with
//   .satfinite: a scaled dS past 65504 becomes inf, so that an overflow under
//   dynamic loss scaling reaches dQ, dK and dV and the guard's finite check
//   sees it, as jnp's astype gives it. A p below 2**-14 stays an fp16
//   subnormal (the build has no --use_fast_math or -ftz).

#ifndef MXTPU_FLASH_B16_CUH_
#define MXTPU_FLASH_B16_CUH_

using bf16 = __nv_bfloat16;
using f16 = __half;
constexpr int kB16Bytes = 2;      // bytes of an element of either type

// the mma and the rounding of element type E
template <typename E>
struct B16;

template <>
struct B16<bf16> {
  // d += a (16 x 16, row) * b (16 x 8, col), bf16 inputs, fp32 accumulator
  static __device__ __forceinline__ void mma(float* d, const unsigned* a,
                                             const unsigned* b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // two floats rounded to bf16 (nearest even), lo in the low half
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
};

template <>
struct B16<f16> {
  // d += a (16 x 16, row) * b (16 x 8, col), fp16 inputs, fp32 accumulator
  static __device__ __forceinline__ void mma(float* d, const unsigned* a,
                                             const unsigned* b) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  // two floats rounded to fp16 (nearest even, inf past 65504), lo in the
  // low half
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
};

template <typename E>
__device__ __forceinline__ void mma16(float* d, const unsigned* a,
                                      const unsigned* b) {
  B16<E>::mma(d, a, b);
}

template <typename E>
__device__ __forceinline__ unsigned pack16(float lo, float hi) {
  return B16<E>::pack(lo, hi);
}

template <int D>
__device__ __forceinline__ int atb(int r, int c) {
  return r * (D + 8) + c;
}

// 16 bytes global -> shared; valid false writes zeros instead.
__device__ __forceinline__ void cp_async16b(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// rows [r0, r0 + R) of a (T, D) matrix of E into a padded tile, zero past T
template <int D, int R, typename E>
__device__ __forceinline__ void load_tile16(E* dst, const E* src, int r0,
                                            int T) {
  constexpr int C8 = D / 8;
  for (int i = threadIdx.x; i < R * C8; i += kThreads) {
    const int r = i / C8, c = (i % C8) * 8;
    const bool ok = r0 + r < T;
    cp_async16b(dst + atb<D>(r, c),
                ok ? src + (long long)(r0 + r) * D + c : src, ok);
  }
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a tile
// whose columns are the contraction index.
template <int D, typename E>
__device__ __forceinline__ void frag_a16(unsigned* a, const E* tile, int r0,
                                         int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, tile + atb<D>(r0 + lane % 16, c0 + (lane / 16) * 8));
}

// B fragments of two n-tiles, rows [n0, n0 + 16) of a tile whose rows are
// the n index and whose columns the contraction index (c0, c0 + 16): b[0..1]
// for n-tile n0, b[2..3] for n0 + 8.
template <int D, typename E>
__device__ __forceinline__ void frag_b_nk(unsigned* b, const E* tile, int n0,
                                          int c0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(b, tile + atb<D>(n0 + lane % 8 + (lane / 16) * 8,
                           c0 + ((lane / 8) % 2) * 8));
}

// B fragments of two n-tiles from a tile whose rows are the contraction
// index (k0, k0 + 16) and whose columns the n index: b[0..1] for columns
// [n0, n0 + 8), b[2..3] for [n0 + 8, n0 + 16).
template <int D, typename E>
__device__ __forceinline__ void frag_b_kn(unsigned* b, const E* tile, int k0,
                                          int n0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4_t(b, tile + atb<D>(k0 + lane % 8 + ((lane / 8) % 2) * 8,
                             n0 + (lane / 16) * 8));
}

// The A fragment of one k-step (16 columns) from the accumulators of the
// two n-tiles (c0 = columns 16 kk .. + 7, c1 = + 8 .. + 15) that an S-shaped
// product left, rounded to E.
template <typename E>
__device__ __forceinline__ void pack_a(unsigned* a, const float* c0,
                                       const float* c1) {
  a[0] = pack16<E>(c0[0], c0[1]);
  a[1] = pack16<E>(c0[2], c0[3]);
  a[2] = pack16<E>(c1[0], c1[1]);
  a[3] = pack16<E>(c1[2], c1[3]);
}

// whether keys [k0, k0 + K) hold a live one: one vote of the warp
template <int K>
__device__ __forceinline__ bool any_live(const float* brow, int k0, int T) {
  const int lane = threadIdx.x % 32;
  bool live = false;
#pragma unroll
  for (int j = 0; j < K; j += 32)
    live = live || live_key(brow, k0 + j + lane, T);
  return __any_sync(0xffffffffu, live);
}

#endif  // MXTPU_FLASH_B16_CUH_
