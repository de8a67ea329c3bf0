// Building blocks of the 16-bit flash-attention kernels (flash_attention_fwd.cu
// and flash_attention_bwd.cu), over one element type E: __nv_bfloat16 (bf16)
// or __half (fp16). Included after flash_tf32.cuh, inside each source's
// anonymous namespace: it takes the mask constants and live_key from there.
// The source includes <cuda_bf16.h> and <cuda_fp16.h> first, outside the
// namespace.
//
// - The accumulators of an S-shaped product (wgmma's m64nN layout, the
//   m16n8 C fragment of each warp's 16 rows: g = lane / 4, t = lane % 4,
//   c0, c1 = (g, 2t..2t+1), c2, c3 = (g + 8, 2t..)) of two neighbouring
//   8-column groups are, packed in pairs, the A fragment of one k16 step
//   of the next product (pack_a): P and dS never leave registers, rounded
//   to E where the TPU kernel rounds them.
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

// two floats rounded to E (nearest even; fp16 inf past 65504), lo in the
// low half
template <typename E>
__device__ __forceinline__ unsigned pack16(float lo, float hi) {
  if constexpr (std::is_same<E, bf16>::value) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  } else {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&h);
  }
}

// The A fragment of one k-step (16 columns) from the accumulators of the
// two 8-column groups (c0 = columns 16 kk .. + 7, c1 = + 8 .. + 15) that an
// S-shaped product left, rounded to E.
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
