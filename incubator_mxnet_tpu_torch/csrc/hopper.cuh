// Hopper primitives shared by the kernels that feed wgmma from TMA
// (int8_matmul.cu's tma route, the 16-bit flash kernels of
// flash_attention_fwd.cu and flash_attention_bwd.cu):
// mbarriers, TMA tile loads (2-D and 3-D), wgmma shared-memory descriptors
// (K-major and MN-major, over 128- or 64-byte swizzled tiles), the wgmma
// fence / commit / wait, and, on the host, cuTensorMapEncodeTiled through the
// runtime and a 3-D tensor map. sm_90a only (wgmma).
//
// Included inside each source's anonymous namespace, after the source has
// defined smem_u32 (int8_matmul.cu itself, flash_tf32.cuh for the flash
// kernels); the source includes <cuda.h> (CUtensorMap and its enums; the
// library is not linked against libcuda) and <cuda_runtime.h> first,
// outside the namespace.
//
// A tile that TMA writes with the 128-byte swizzle holds rows of 128 bytes,
// the 16-byte chunk c of row r at chunk c ^ (r % 8), 8-row atoms of 1024
// bytes; with the 64-byte swizzle rows of 64 bytes, chunk c at c ^ ((r / 2)
// % 4), atoms of 512 bytes. wgmma reads the same layouts through a
// descriptor whose swizzle mode matches (1: 128 bytes, 2: 64 bytes), from a
// base aligned to 1024 bytes. A tile is K-major where its rows run along
// the product's M or N and its contiguous elements along K (A = Q, B = K in
// S = Q K^T); MN-major where its rows run along K and its contiguous
// elements along N (B = K in dQ = dS K): the same shared-memory image serves
// both, read through the two descriptors.

#ifndef MXTPU_HOPPER_CUH_
#define MXTPU_HOPPER_CUH_

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of `bar` with parity `parity` has completed. A wait
// that outlasts 2^25 polls (far beyond any load's latency) traps, so that a
// broken pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == (1u << 25)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of `map` at (k, row) -> shared memory at dst; its bytes count
// against `bar`'s transaction.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         unsigned bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(k),
      "r"(row)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator accesses across wgmma
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// float accumulators: as fence_operand(int&)
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// One box of a 3-D `map` at (c0, c1, c2), innermost first -> shared memory
// at dst; its bytes count against `bar`'s transaction. Elements past an
// edge of the tensor land as zeros.
__device__ __forceinline__ void tma_load3(unsigned dst, const CUtensorMap* map,
                                          unsigned bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major operand at `addr` in a swizzled tile:
// `mode` 1 (128-byte rows) or 2 (64-byte rows), M or N rows in 8-row atoms
// `atom` bytes apart. One k16 step reads 32 bytes of each row; the next one
// starts 32 bytes on (the swizzle is applied to the whole address).
__device__ __forceinline__ uint64_t kmajor_desc(unsigned addr, unsigned atom,
                                                unsigned mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(atom >> 4) << 32) | ((uint64_t)mode << 62);
}

// wgmma descriptor of an MN-major (transposed) B operand at `addr`: rows of
// 128 bytes (`mode` 1) or 64 bytes (`mode` 2) along K, each holding 64 or 32
// elements along N; `panel` bytes between two such column panels along N
// (the leading-dimension offset), `atom` bytes between two 8-row groups
// along K (the stride offset). A k16 step reads two 8-row groups; the next
// one starts 16 rows on.
__device__ __forceinline__ uint64_t mn_desc(unsigned addr, unsigned panel,
                                            unsigned atom, unsigned mode) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((panel >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(atom >> 4) << 32) | ((uint64_t)mode << 62);
}

// shared memory at src -> one box of a 3-D `map` at (c0, c1, c2), in a
// bulk group of the issuing thread; elements past an edge of the tensor
// are not written
__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           unsigned src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<unsigned long long>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the issuing thread's bulk stores: commit them as a group; wait until
// every group has read its shared memory
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// orders this thread's shared-memory writes before the async proxy's
// (TMA's) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// pulls a tensor map (a __grid_constant__ kernel parameter) into the TMA
// unit's cache ahead of its first load
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<unsigned long long>(map))
               : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime: the library
// is linked without -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A (n2, n1, n0) row-major tensor of `type` (`esize` bytes an element) at
// `ptr`, read in boxes of box0 x box1 x 1 elements with `swizzle`; reads
// past an edge fill zeros, so a box that runs past n1 never reaches the
// next (n2) slab. The strides must be multiples of 16 bytes.
inline bool make_map3(EncodeTiled encode, CUtensorMap* map,
                      const void* ptr, CUtensorMapDataType type, int esize,
                      int n0, int n1, int n2, int box0, int box1,
                      CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1,
                              (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)n0 * esize,
                                 (cuuint64_t)n0 * n1 * esize};
  const cuuint32_t box[3] = {(cuuint32_t)box0, (cuuint32_t)box1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

#endif  // MXTPU_HOPPER_CUH_
