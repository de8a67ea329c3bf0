// Building blocks shared by the flash-attention kernels on the tensor cores
// (flash_attention_fwd.cu, flash_attention_bwd.cu): fp32-accurate products
// as three TF32 mma.sync products (3xTF32), tiles staged through cp.async,
// and the fragment maps that carry an S-shaped accumulator into the next
// product without shared memory. flash_decode.cu, on the CUDA cores, takes
// the block shape, the cp.async helpers and allow_smem from here.
//
// - x = hi + lo with hi = tf32(x) and lo = tf32(x - hi), rounded as
//   cvt.rna.tf32 rounds (nearest, ties away), and a * b = hi*lo + lo*hi +
//   hi*hi (the lo*lo term dropped, as CUTLASS's OpMultiplyAddFastF32).
// - The H100's tensor cores align an mma's products and its C input to the
//   largest and cut the rest toward zero (chip_smoke.py's tc_rounding line),
//   so each k-step's three products go into a fresh accumulator, which is
//   added to the running fp32 sum on the CUDA cores (mma3).
// - Tiles sit in shared memory with rows of D + 4 floats: the fragment reads
//   (rows g, columns t; rows 2t + e, columns g) hit 32 distinct banks, and
//   each is a base register per thread plus a constant offset.
// - In a product that consumes an accumulator, the contraction index inside
//   each group of 8 is permuted (mma k-slot t holds element 2t, slot t + 4
//   element 2t + 1): frag_acc turns the accumulator fragment of one n-tile
//   into an A fragment, and pre_b_kn reads B in the same order.
//
// Included inside each source's anonymous namespace.

#ifndef MXTPU_FLASH_TF32_CUH_
#define MXTPU_FLASH_TF32_CUH_

constexpr int kBlock = 64;        // rows of a Q tile and keys of a K tile
constexpr int kWarps = 4;         // each owns 16 of the block's 64
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr float kDeadBias = -0.5e30f;   // a bias at or below it: p = 0

// Element (r, c) of a tile is at r * (D + 4) + c: a row 4 banks on from the
// one before, so that a warp's fragment reads (rows g, columns t; and rows
// 2t + e, columns g) hit 32 distinct banks, and every read is one base
// register per thread plus a constant.
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * (D + 4) + c;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; valid false writes zeros instead.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + R) of a (T, D) matrix into a padded tile, zero past T
template <int D, int R = kBlock>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int T) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < R * C4; i += kThreads) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool ok = r0 + r < T;
    cp_async16(dst + at<D>(r, c),
               ok ? src + (long long)(r0 + r) * D + c : src, ok);
  }
}

// values [r0, r0 + R) of a (T,) row into shared memory, zero past T
template <int R = kBlock>
__device__ __forceinline__ void load_row(float* dst, const float* src, int r0,
                                         int T) {
  if (threadIdx.x < R) {
    const bool ok = r0 + (int)threadIdx.x < T;
    cp_async4(dst + threadIdx.x, ok ? src + r0 + threadIdx.x : src, ok);
  }
}

// x rounded to tf32 (10 mantissa bits), to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding (infinities and NaNs stay), in the two
// integer operations it comes to, where the instruction itself lowers to a
// longer sequence
__device__ __forceinline__ unsigned tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within 2^-22 |x|, both tf32
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d = a (16 x 8, row) * b (8 x 8, col) + c, tf32 inputs, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a,
                                         const unsigned* b, const float* c) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// acc += a * b to fp32 accuracy: the two cross terms and hi * hi into a fresh
// accumulator, which is added to acc rounding to nearest
__device__ __forceinline__ void mma3(float* acc, const unsigned* ahi,
                                     const unsigned* alo, const unsigned* bhi,
                                     const unsigned* blo) {
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  float t[4];
  mma_tf32(t, ahi, blo, zero);
  mma_tf32(t, alo, bhi, t);
  mma_tf32(t, ahi, bhi, t);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// A fragment of rows r and r + 8 from a tile whose columns are the
// contraction index: k-slots t and t + 4 are columns c and c + 4 (c = 8 kk
// + t).
template <int D>
__device__ __forceinline__ void frag_a(const float* tile, int r, int c,
                                       unsigned* hi, unsigned* lo) {
  split(tile[at<D>(r, c)], hi[0], lo[0]);
  split(tile[at<D>(r + 8, c)], hi[1], lo[1]);
  split(tile[at<D>(r, c + 4)], hi[2], lo[2]);
  split(tile[at<D>(r + 8, c + 4)], hi[3], lo[3]);
}

// A fragment of rows r and r + 8, k-slots at columns c and c + 4, from a
// tile split into tf32 halves (hi in place, lo in a tile of the same layout)
template <int D>
__device__ __forceinline__ void pre_a(const float* hit, const float* lot,
                                      int r, int c, unsigned* hi,
                                      unsigned* lo) {
  hi[0] = __float_as_uint(hit[at<D>(r, c)]);
  hi[1] = __float_as_uint(hit[at<D>(r + 8, c)]);
  hi[2] = __float_as_uint(hit[at<D>(r, c + 4)]);
  hi[3] = __float_as_uint(hit[at<D>(r + 8, c + 4)]);
  lo[0] = __float_as_uint(lot[at<D>(r, c)]);
  lo[1] = __float_as_uint(lot[at<D>(r + 8, c)]);
  lo[2] = __float_as_uint(lot[at<D>(r, c + 4)]);
  lo[3] = __float_as_uint(lot[at<D>(r + 8, c + 4)]);
}

// B fragment of column n from a tile split into tf32 halves (hi in place,
// lo in a tile of the same layout): nk, a tile whose rows are the n index
// and whose columns the contraction index (c = 8 kk + t); kn, a tile whose
// rows are the contraction index in the permuted order of frag_acc (k = 8 kk
// + 2t: rows k and k + 1)
template <int D>
__device__ __forceinline__ void pre_b_nk(const float* hit, const float* lot,
                                         int n, int c, unsigned* hi,
                                         unsigned* lo) {
  hi[0] = __float_as_uint(hit[at<D>(n, c)]);
  hi[1] = __float_as_uint(hit[at<D>(n, c + 4)]);
  lo[0] = __float_as_uint(lot[at<D>(n, c)]);
  lo[1] = __float_as_uint(lot[at<D>(n, c + 4)]);
}

template <int D>
__device__ __forceinline__ void pre_b_kn(const float* hit, const float* lot,
                                         int k, int n, unsigned* hi,
                                         unsigned* lo) {
  hi[0] = __float_as_uint(hit[at<D>(k, n)]);
  hi[1] = __float_as_uint(hit[at<D>(k + 1, n)]);
  lo[0] = __float_as_uint(lot[at<D>(k, n)]);
  lo[1] = __float_as_uint(lot[at<D>(k + 1, n)]);
}

// R rows of a tile into tf32 halves: hi in place, lo to `lo` (the same
// layout)
template <int D, int R>
__device__ __forceinline__ void split_tile(float* tile, float* lo) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < R * C4; i += kThreads) {
    const int o = at<D>(i / C4, (i % C4) * 4);
    float4 x = *reinterpret_cast<float4*>(tile + o), h, l;
    h.x = __uint_as_float(tf32(x.x)); l.x = __uint_as_float(tf32(x.x - h.x));
    h.y = __uint_as_float(tf32(x.y)); l.y = __uint_as_float(tf32(x.y - h.y));
    h.z = __uint_as_float(tf32(x.z)); l.z = __uint_as_float(tf32(x.z - h.z));
    h.w = __uint_as_float(tf32(x.w)); l.w = __uint_as_float(tf32(x.w - h.w));
    *reinterpret_cast<float4*>(tile + o) = h;
    *reinterpret_cast<float4*>(lo + o) = l;
  }
}

// The A fragment of a k-step from the accumulator fragment of the n-tile
// that an S-shaped product left: (c0, c1, c2, c3) hold (row g, cols 2t,
// 2t + 1) and (row g + 8, the same), taken as k-slots (t, t + 4) of rows g
// and g + 8: the contraction runs over the tile's columns permuted, which
// pre_b_kn matches.
__device__ __forceinline__ void frag_acc(const float* c, unsigned* hi,
                                         unsigned* lo) {
  split(c[0], hi[0], lo[0]);
  split(c[2], hi[1], lo[1]);
  split(c[1], hi[2], lo[2]);
  split(c[3], hi[3], lo[3]);
}

__device__ __forceinline__ bool live_key(const float* brow, int key, int T) {
  return key < T && (brow == nullptr || !(brow[key] <= kDeadBias));
}

constexpr int kMaxDevices = 64;

// Above 48 KB a block's shared memory must be asked for explicitly. A
// kernel whose size grows with T (its list of live key tiles) is allowed
// the device's whole opt-in size (less its static shared memory) once; a
// launch still takes only what it asks for. The setting holds per device
// and kernel, so it is made on the first launch of each and remembered (a
// device numbered past kMaxDevices asks every time).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, std::atomic<bool>* done) {
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && done[device].load(std::memory_order_acquire))
    return cudaSuccess;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin - (int)attr.sharedSizeBytes);
  if (e == cudaSuccess && known)
    done[device].store(true, std::memory_order_release);
  return e;
}

#endif  // MXTPU_FLASH_TF32_CUH_
