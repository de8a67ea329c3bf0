// Paged attention of C query rows per sequence over its past (flash decode),
// fp32, for Hopper (sm_90a).
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
// the fp32 CUDA cores (67 TFLOP/s) bound it instead.
//
// What the design does about it: it reads only live positions. A block
// belongs to one (head, sequence, tile of up to 8 query rows) and loads its
// own table row and length (the TPU kernel's scalar prefetch); its four warps
// walk the live positions in tiles of 32 keys, warp w taking tiles w, w + 4,
// ..., so padded table entries and positions past lengths[s] are never read.
// A warp stages its tile of K and V rows in shared memory with cp.async (16
// bytes a copy, each 256-byte head row read as one coalesced run), scores one
// key per lane against the tile's query rows, and keeps the running max, sum
// and the D-wide accumulator of each query row in registers (D / 32 columns
// per lane). The query rows of a block share every K and V tile it loads. At
// the end the four warps' partial (m, l, acc) are merged through shared
// memory in one pass, so the kernel is one launch with no second combine
// kernel. A sequence with no past gives o = 0, m = -1e30 and l = 0 exactly,
// as in the TPU kernel. The (1, 8, H) sublane-replicated m and l outputs were
// Mosaic's layout and are gone: m and l are (S, C, H).

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileK = 32;          // keys per warp tile: one per lane
constexpr float kNegInf = -1e30f;

template <int D, int QT>
struct Smem {
  static constexpr int kKStride = D + 4;           // padded K row (floats)
  static constexpr int kQ = QT * D;                 // the block's query rows
  static constexpr int kK = kTileK * kKStride;      // per warp
  static constexpr int kV = kTileK * D;             // per warp
  static constexpr int kAcc = QT * D;               // per warp, for the merge
  static constexpr int kML = 2 * QT;                // per warp: m then l
  static constexpr size_t kBytes =
      sizeof(float) * (kQ + kWarps * (kK + kV + kAcc + kML));
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// 16-byte global -> shared copy; with valid false it writes 16 zero bytes
// and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned saddr =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// grid (H, S, ceil(C / QT)); QT query rows per block (1 for decode, 8 else)
template <int D, int QT>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths,
                    float* __restrict__ out, float* __restrict__ m_out,
                    float* __restrict__ l_out, int C, int H, int num_blocks,
                    int block_size, int max_blocks, float scale) {
  using Sm = Smem<D, QT>;
  constexpr int KS = Sm::kKStride;
  constexpr int D4 = D / 4;
  constexpr int DV = D / 32;      // output columns per lane

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* Ks = Qs + Sm::kQ + warp * (Sm::kK + Sm::kV);
  float* Vs = Ks + Sm::kK;
  float* Acc = Qs + Sm::kQ + kWarps * (Sm::kK + Sm::kV);   // [warp][QT][D]
  float* ML = Acc + kWarps * Sm::kAcc;                      // [warp][2][QT]

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int c0 = blockIdx.z * QT;
  const int nq = min(QT, C - c0);
  const long long pos_stride = (long long)H * D;   // floats per pool position

  // the block's query rows, zero past C
  for (int i = threadIdx.x; i < QT * D4; i += kThreads) {
    const int r = i / D4, c4 = i % D4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nq)
      val = reinterpret_cast<const float4*>(
          q + (((long long)s * C + c0 + r) * H + h) * D)[c4];
    reinterpret_cast<float4*>(Qs + r * D)[c4] = val;
  }
  // positions past the table's reach do not exist (as in the lax oracle)
  const int len = max(0, min(lengths[s], max_blocks * block_size));
  const int* tab = tables + (long long)s * max_blocks;
  __syncthreads();

  float m[QT], l[QT], acc[QT][DV];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DV; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (len + kTileK - 1) / kTileK;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int p0 = t * kTileK;
    const int pos = p0 + lane;
    const bool live = pos < len;
    // this lane's key: its pool row (a table entry out of range is clamped
    // into the pool, so a bad table cannot read outside it)
    long long row = 0;
    if (live) {
      int blk = tab[pos / block_size];
      blk = min(max(blk, 0), num_blocks - 1);
      row = ((long long)blk * block_size + pos % block_size) * pos_stride +
            (long long)h * D;
    }
    __syncwarp();                   // the previous tile is consumed
#pragma unroll 4
    for (int it = 0; it < D4; ++it) {
      const int i = lane + 32 * it;
      const int r = i / D4, c4 = i % D4;
      const long long src = __shfl_sync(0xffffffffu, row, r);
      const bool ok = __shfl_sync(0xffffffffu, live ? 1 : 0, r) != 0;
      cp_async16(Ks + r * KS + 4 * c4, k_pool + src + 4 * c4, ok);
      cp_async16(Vs + r * D + 4 * c4, v_pool + src + 4 * c4, ok);
    }
    cp_async_wait_all();
    __syncwarp();

    // score key p0 + lane against each query row
    float sc[QT];
#pragma unroll
    for (int r = 0; r < QT; ++r) sc[r] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(Ks + lane * KS);
#pragma unroll 4
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 kk = kr[d4];
#pragma unroll
      for (int r = 0; r < QT; ++r)
        sc[r] = dot4(reinterpret_cast<const float4*>(Qs + r * D)[d4], kk,
                     sc[r]);
    }

    float pr[QT];
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      const float sv = live ? sc[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      pr[r] = live ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(pr[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DV; ++c) acc[r][c] *= alpha;
    }

    // acc += P . V, key j's probability from lane j
    const int kn = min(kTileK, len - p0);
    for (int j = 0; j < kn; ++j) {
      float vv[DV];
#pragma unroll
      for (int c = 0; c < DV; ++c) vv[c] = Vs[j * D + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pr[r], j);
#pragma unroll
        for (int c = 0; c < DV; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

  // merge the warps' partial softmax states
  float* acc_w = Acc + warp * Sm::kAcc;
  float* ml_w = ML + warp * Sm::kML;
#pragma unroll
  for (int r = 0; r < QT; ++r) {
#pragma unroll
    for (int c = 0; c < DV; ++c) acc_w[r * D + lane + 32 * c] = acc[r][c];
    if (lane == 0) {
      ml_w[r] = m[r];
      ml_w[QT + r] = l[r];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, ML[w * Sm::kML + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(ML[w * Sm::kML + r] - M);
      L = fmaf(ML[w * Sm::kML + QT + r], e, L);
      O = fmaf(Acc[w * Sm::kAcc + r * D + d], e, O);
    }
    const bool dead = M <= 0.5f * kNegInf;
    const long long orow = ((long long)s * C + c0 + r) * H + h;
    out[orow * D + d] = dead ? 0.f : O / fmaxf(L, 1e-30f);
    if (d == 0) {
      m_out[orow] = M;
      l_out[orow] = dead ? 0.f : L;
    }
  }
}

constexpr int kMaxDevices = 64;

// Above 48 KB a block's shared memory must be asked for explicitly. The
// setting holds per device and instantiation, so it is made on the first
// launch of each and remembered (a device numbered past kMaxDevices asks on
// every launch).
template <int D, int QT>
cudaError_t allow_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  const bool known = device >= 0 && device < kMaxDevices;
  if (known && done[device].load(std::memory_order_acquire))
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_decode_kernel<D, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Smem<D, QT>::kBytes);
  if (e == cudaSuccess && known)
    done[device].store(true, std::memory_order_release);
  return e;
}

template <int D, int QT>
int launch(const float* q, const float* k_pool, const float* v_pool,
           const int* tables, const int* lengths, float* out, float* m,
           float* l, int S, int C, int H, int num_blocks, int block_size,
           int max_blocks, float scale, int device, cudaStream_t stream) {
  const cudaError_t e = allow_smem<D, QT>(device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)H, (unsigned)S, (unsigned)((C + QT - 1) / QT));
  flash_decode_kernel<D, QT><<<grid, kThreads, Smem<D, QT>::kBytes, stream>>>(
      q, k_pool, v_pool, tables, lengths, out, m, l, C, H, num_blocks,
      block_size, max_blocks, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const float* q, const float* k_pool, const float* v_pool,
             const int* tables, const int* lengths, float* out, float* m,
             float* l, int S, int C, int H, int num_blocks, int block_size,
             int max_blocks, float scale, int device, cudaStream_t stream) {
  if (C == 1)
    return launch<D, 1>(q, k_pool, v_pool, tables, lengths, out, m, l, S, C,
                        H, num_blocks, block_size, max_blocks, scale, device,
                        stream);
  return launch<D, 8>(q, k_pool, v_pool, tables, lengths, out, m, l, S, C, H,
                      num_blocks, block_size, max_blocks, scale, device,
                      stream);
}

}  // namespace

// C entry point, bound with ctypes. q, out: (S, C, H, D); k_pool, v_pool:
// (num_blocks, block_size, H, D); m, l: (S, C, H); all contiguous fp32,
// 16-byte aligned. tables: (S, max_blocks) int32; lengths: (S,) int32. D is
// 32, 64 or 128. Makes `device` current for this library's runtime, launches
// on `stream`, allocates nothing, and returns cudaGetLastError().
extern "C" int mxtpu_flash_decode_f32(
    const float* q, const float* k_pool, const float* v_pool,
    const int* tables, const int* lengths, float* out, float* m, float* l,
    int S, int C, int H, int D, int num_blocks, int block_size,
    int max_blocks, float scale, int device, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (S <= 0 || S > 65535 || C <= 0 || (C + 7) / 8 > 65535 || H <= 0 ||
      num_blocks <= 0 || block_size <= 0 || max_blocks <= 0 ||
      (long long)max_blocks * block_size > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  switch (D) {
    case 32:
      return launch_d<32>(q, k_pool, v_pool, tables, lengths, out, m, l, S, C,
                          H, num_blocks, block_size, max_blocks, scale, device,
                          stream);
    case 64:
      return launch_d<64>(q, k_pool, v_pool, tables, lengths, out, m, l, S, C,
                          H, num_blocks, block_size, max_blocks, scale, device,
                          stream);
    case 128:
      return launch_d<128>(q, k_pool, v_pool, tables, lengths, out, m, l, S,
                           C, H, num_blocks, block_size, max_blocks, scale,
                           device, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
