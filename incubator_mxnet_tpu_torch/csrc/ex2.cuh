// 2^x on the MUFU unit, shared by the 16-bit flash kernels (flash_wg.cuh)
// and the softmax's vec route (fused_norm.cu).
//
// Included inside each source's anonymous namespace.

#ifndef MXTPU_EX2_CUH_
#define MXTPU_EX2_CUH_

// 2^x (ex2.approx without .ftz: a subnormal result survives)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 2^x flushed to 0 below 2^-126 (ex2.approx.ftz: one MUFU.EX2, where
// ex2 takes three more instructions to keep a subnormal result)
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#endif  // MXTPU_EX2_CUH_
