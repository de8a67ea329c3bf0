// The wgmma machinery of the 16-bit flash kernels on Hopper
// (flash_attention_fwd.cu's flash_fwd_wg_kernel, flash_attention_bwd.cu's
// flash_bwd_dq_wg_kernel and flash_bwd_dkv_wg_kernel), over one element
// type E, bf16 or fp16: the wgmma m64nNk16 products with E operands and
// fp32 accumulators (A and B K-major from shared memory, or A from
// registers and B MN-major), the block of two consumer warpgroups and a
// producer with their register split and turns at the tensor cores, ex2
// (from ex2.cuh), the shared-memory image of a tile as TMA writes it (Pan)
// and its 3-D tensor map (map16). sm_90a only.
//
// Included inside each source's anonymous namespace after flash_tf32.cuh
// (kBlock, smem_u32), flash_b16.cuh (bf16, f16, kB16Bytes) and hopper.cuh
// (descriptors, TMA loads, make_map3); the source includes <cuda.h>,
// <cuda_bf16.h>, <cuda_fp16.h>, <stdint.h> and <type_traits> first,
// outside the namespace.

#ifndef MXTPU_FLASH_WG_CUH_
#define MXTPU_FLASH_WG_CUH_

// wgmma m64nNk16, fp32 accumulators d (N / 2 a thread; acc 0 overwrites
// them): ss reads A and B K-major from shared memory (descriptors); rs
// takes A from registers and reads B MN-major (tnspB).
__device__ __forceinline__ void wgmma_ss_n16_bf16(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n16_f16(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n32_bf16(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n32_f16(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64_bf16(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n64_f16(float* d, uint64_t desc_a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128_bf16(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128_f16(float* d, uint64_t desc_a,
                                              uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n32_bf16(float* d, const unsigned* a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n32_f16(float* d, const unsigned* a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64_bf16(float* d, const unsigned* a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64_f16(float* d, const unsigned* a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n128_bf16(float* d, const unsigned* a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n128_f16(float* d, const unsigned* a,
                                             uint64_t desc_b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(acc));
}

constexpr int kConsumers = 2;       // consumer warpgroups of a block
constexpr int kWgThreads = 128 * (kConsumers + 1);    // + a producer
constexpr int kRowsBlock = kBlock * kConsumers;       // rows (keys) a block
constexpr float kLog2e = 1.4426950408889634f;

// the shared-memory image of an R x D tile of E as TMA writes it: D / kCols
// panels of R rows of kCols elements (128-byte rows, 128-byte swizzle at D
// >= 64; 64-byte rows, 64-byte swizzle at D = 32), one after the other
template <int D>
struct Pan {
  static constexpr int kCols = D >= 64 ? 64 : 32;
  static constexpr int kRowBytes = kCols * kB16Bytes;
  static constexpr unsigned kMode = D >= 64 ? 1u : 2u;
  static constexpr unsigned kAtom = 8 * kRowBytes;
  static constexpr CUtensorMapSwizzle kSwizzle =
      D >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;

  // the K-major descriptor of k16 step kk (columns 16 kk ..) of an R-row
  // tile at `tile`
  template <int R>
  static __device__ __forceinline__ uint64_t k(unsigned tile, int kk) {
    const int col = 16 * kk;
    return kmajor_desc(tile + (col / kCols) * R * kRowBytes +
                           (col % kCols) * kB16Bytes,
                       kAtom, kMode);
  }
  // the MN-major descriptor of k16 step kp (rows 16 kp ..) of an R-row tile
  template <int R>
  static __device__ __forceinline__ uint64_t mn(unsigned tile, int kp) {
    return mn_desc(tile + 16 * kp * kRowBytes, R * kRowBytes, kAtom, kMode);
  }
  // rows [r0, r0 + R) of head bh into the tile, each panel one TMA box
  template <int R>
  static __device__ __forceinline__ void load(unsigned tile,
                                              const CUtensorMap* map,
                                              unsigned bar, int r0, int bh) {
#pragma unroll
    for (int p = 0; p < D / kCols; ++p)
      tma_load3(tile + p * R * kRowBytes, map, bar, p * kCols, r0, bh);
  }
  // the tile's rows to rows [r0, r0 + R) of head bh, each panel one TMA
  // box (rows past the tensor's edge are not written)
  template <int R>
  static __device__ __forceinline__ void store(unsigned tile,
                                               const CUtensorMap* map, int r0,
                                               int bh) {
#pragma unroll
    for (int p = 0; p < D / kCols; ++p)
      tma_store3(map, tile + p * R * kRowBytes, p * kCols, r0, bh);
  }
  // the byte offset of element (r, col) in an R-row tile's image: its
  // panel, its row, and its 16-byte chunk swizzled as TMA swizzles it (the
  // chunk XOR the row's bits 0-2 in 128-byte rows, bits 1-2 in 64-byte
  // rows)
  template <int R>
  static __device__ __forceinline__ unsigned offset(int r, int col) {
    const int byte = (col % kCols) * kB16Bytes;
    const int swz = kMode == 1u ? (r & 7) : ((r >> 1) & 3);
    return (col / kCols) * R * kRowBytes + r * kRowBytes +
           ((((byte >> 4) ^ swz)) << 4) + (byte & 15);
  }
};

// wgmma m64nNk16 of element type E, fp32 accumulators d (N / 2 a thread);
// acc 0 overwrites d. ss: A and B from shared memory, both K-major. rs: A
// from registers (four packed pairs, the m16n8k16 A fragment of the
// thread's warp's 16 rows), B MN-major.
template <typename E, int N>
__device__ __forceinline__ void wg_ss(float* d, uint64_t a, uint64_t b,
                                      int acc) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wg_ss: N");
  if constexpr (std::is_same<E, bf16>::value) {
    if constexpr (N == 16) wgmma_ss_n16_bf16(d, a, b, acc);
    else if constexpr (N == 32) wgmma_ss_n32_bf16(d, a, b, acc);
    else if constexpr (N == 64) wgmma_ss_n64_bf16(d, a, b, acc);
    else wgmma_ss_n128_bf16(d, a, b, acc);
  } else {
    if constexpr (N == 16) wgmma_ss_n16_f16(d, a, b, acc);
    else if constexpr (N == 32) wgmma_ss_n32_f16(d, a, b, acc);
    else if constexpr (N == 64) wgmma_ss_n64_f16(d, a, b, acc);
    else wgmma_ss_n128_f16(d, a, b, acc);
  }
}

template <typename E, int N>
__device__ __forceinline__ void wg_rs(float* d, const unsigned* a,
                                      uint64_t b, int acc) {
  static_assert(N == 32 || N == 64 || N == 128, "wg_rs: N");
  if constexpr (std::is_same<E, bf16>::value) {
    if constexpr (N == 32) wgmma_rs_n32_bf16(d, a, b, acc);
    else if constexpr (N == 64) wgmma_rs_n64_bf16(d, a, b, acc);
    else wgmma_rs_n128_bf16(d, a, b, acc);
  } else {
    if constexpr (N == 32) wgmma_rs_n32_f16(d, a, b, acc);
    else if constexpr (N == 64) wgmma_rs_n64_f16(d, a, b, acc);
    else wgmma_rs_n128_f16(d, a, b, acc);
  }
}

template <int N>
__device__ __forceinline__ void fence_all(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

template <int N>
__device__ __forceinline__ void fence_all(unsigned (*a)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      fence_operand(reinterpret_cast<int&>(a[i][j]));
}

#include "ex2.cuh"   // ex2, ex2_ftz

// the producer warpgroup gives back registers (24 a thread), the consumers
// take them (240): 128 * 24 + 256 * 240 = 384 * 168, the block's share of
// the register file at one block an SM
__device__ __forceinline__ void setmaxnreg_dec24() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void setmaxnreg_inc240() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}
// the same split with 40 for a producer whose loop needs more than 24
// (128 * 40 + 256 * 232 = 64512 of the 384 * 168)
__device__ __forceinline__ void setmaxnreg_dec40() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
}
__device__ __forceinline__ void setmaxnreg_inc232() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
}

// Named barriers 1 and 2 (0 is __syncthreads) order the two consumer
// warpgroups' turns at the tensor cores: a warpgroup waits for its own
// barrier (its 128 threads sync, the other's 128 arrive) before it issues a
// stage's products, and arrives on the other's once they are issued, so that
// one warpgroup's exp and rounding run while the other's products do.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// two packed E values as floats
template <typename E>
__device__ __forceinline__ float2 widen2(unsigned u) {
  if constexpr (std::is_same<E, bf16>::value)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  else
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

template <typename E>
struct TmaType;
template <>
struct TmaType<bf16> {
  static constexpr CUtensorMapDataType kValue =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct TmaType<f16> {
  static constexpr CUtensorMapDataType kValue =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// the 3-D map (D, T, bh) of a (bh, T, D) tensor of E, in boxes of an R-row
// panel
template <typename E, int D>
bool map16(EncodeTiled encode, CUtensorMap* map, const void* ptr, int T,
           int bh, int rows) {
  return make_map3(encode, map, ptr, TmaType<E>::kValue, kB16Bytes, D, T, bh,
                   Pan<D>::kCols, rows, Pan<D>::kSwizzle);
}

#endif  // MXTPU_FLASH_WG_CUH_
