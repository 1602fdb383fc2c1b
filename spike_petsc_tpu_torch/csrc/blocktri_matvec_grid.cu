// Block-tridiagonal matvec y_i = L_i x_{i-1} + D_i x_i + U_i x_{i+1} over
// [nb, b, b] row-major blocks and x, y of shape [nb, b]; x_{-1} and x_{nb}
// are read as zero.
//
// Replaces the Pallas kernel `_kernel` of spike_petsc_tpu/ops/pallas/matvec.py
// (reached through `blocktri_matvec_pallas(T, x, kt)`), which computes kt
// block rows per grid step.
//
// Bound: bytes.  Every call reads 3 * nb * b * b block entries once (1.54 GB
// in f32 at the flagship conversion, nb = 7813, b = 128) for 2 flops per
// entry.  Design: one thread block (CTA) per chunk of kt block rows, which it
// walks in order (blocktri_matvec.cu, the counterpart of the DMA kernel,
// takes one block per block row and keeps its loads in registers instead):
//   * the CTA stages x_{i0-1} .. x_{i0+kt} ((kt + 2) * b floats, zero outside
//     [0, nb)) in shared memory once, so the TPU wrapper's padded copies of
//     the blocks and of x are not needed and a ragged last chunk is a short
//     walk;
//   * the walk is a stream of items, each the same 64 rows of L_i, D_i and
//     U_i (one item per block row at b = 64, two at b = 128), copied into a
//     ring of shared-memory slots with cp.async: the next row's D/L/U rows
//     are in flight while the current ones are multiplied (two slots of
//     96 KB at b = 128 in f32, up to eight for narrower items);
//   * 8 warps, each owning 8 of the item's 64 rows; a lane reads 32-bit words
//     of a row of L, D and U from the ring (conflict-free), multiplies
//     against x_{i-1}, x_i, x_{i+1} held in registers, and the row's three
//     products share one warp shuffle reduction;
//   * bf16 blocks are promoted to f32 in registers (a 16-bit shift).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItemRows = 64;                    // rows of L, D, U per item
constexpr int kRingBytes = 200 * 1024;           // shared memory for the ring
constexpr int kMaxDepth = 8;
constexpr int kMaxKt = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int PACK>
__device__ __forceinline__ float element(uint32_t word, int e) {
  if (PACK == 1) return __uint_as_float(word);
  return __uint_as_float(e == 0 ? word << 16 : word & 0xffff0000u);
}

// B: block size; PACK: block elements per 32-bit word (1 = f32, 2 = bf16).
template <int B, int PACK>
struct Cfg {
  static constexpr int kWordsPerRow = B / PACK;
  static constexpr int kWordsPerLane = kWordsPerRow / 32;
  static constexpr int kPerLane = kWordsPerLane * PACK;   // columns per lane
  static constexpr int kItemsPerRow = B / kItemRows;
  static constexpr int kRowsPerWarp = kItemRows / kWarps;
  static constexpr int kSlabWords = kItemRows * kWordsPerRow;  // one matrix
  static constexpr int kItemWords = 3 * kSlabWords;
  static constexpr int kChunks = kSlabWords / 4 / kThreads;  // 16 B copies
  static constexpr int kDepth =
      kRingBytes / (kItemWords * 4) < kMaxDepth
          ? kRingBytes / (kItemWords * 4) : kMaxDepth;
  static constexpr size_t kRingSmem =
      static_cast<size_t>(kDepth) * kItemWords * 4;
  static_assert(kWordsPerRow % 32 == 0, "row must split evenly over lanes");
  static_assert(B % kItemRows == 0, "block rows must split into items");
  static_assert((kSlabWords / 4) % kThreads == 0, "item must split evenly");
  static_assert(kDepth >= 2, "the ring needs at least two slots");
};

template <int B, int PACK>
__global__ void __launch_bounds__(kThreads, 1)
blocktri_matvec_grid_kernel(const uint32_t* __restrict__ D,
                            const uint32_t* __restrict__ L,
                            const uint32_t* __restrict__ U,
                            const float* __restrict__ x,
                            float* __restrict__ y, int nb, int kt) {
  using C = Cfg<B, PACK>;
  constexpr int DEPTH = C::kDepth, WPR = C::kWordsPerRow,
                WPL = C::kWordsPerLane, PL = C::kPerLane,
                S = C::kItemsPerRow, RPW = C::kRowsPerWarp;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem_raw);  // [DEPTH][item]
  float* xs = reinterpret_cast<float*>(ring + DEPTH * C::kItemWords);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int i0 = blockIdx.x * kt;
  const int rows = min(kt, nb - i0);
  const int items = rows * S;
  const long long total = static_cast<long long>(nb) * B;
  for (int t = tid; t < (kt + 2) * B; t += kThreads) {
    const long long c = static_cast<long long>(i0 - 1) * B + t;
    xs[t] = (c >= 0 && c < total) ? x[c] : 0.0f;
  }

  // item j: rows [s * 64, s * 64 + 64) of L, D and U of block row i0 + j / S
  auto issue = [&](int j) {
    if (j < items) {
      const size_t off =
          (static_cast<size_t>(i0 + j / S) * B + (j % S) * kItemRows) * WPR;
      uint4* dst = reinterpret_cast<uint4*>(ring + (j % DEPTH) *
                                            C::kItemWords);
      const uint4* src[3] = {reinterpret_cast<const uint4*>(L + off),
                             reinterpret_cast<const uint4*>(D + off),
                             reinterpret_cast<const uint4*>(U + off)};
#pragma unroll
      for (int m = 0; m < 3; ++m)
#pragma unroll
        for (int q = 0; q < C::kChunks; ++q)
          cp_async16(dst + m * (C::kSlabWords / 4) + tid + kThreads * q,
                     src[m] + tid + kThreads * q);
    }
    cp_async_commit();
  };

  for (int j = 0; j < DEPTH - 1; ++j) issue(j);
  for (int j = 0; j < items; ++j) {
    cp_async_wait<DEPTH - 2>();
    __syncthreads();                 // item j landed; xs staged; slot free
    issue(j + DEPTH - 1);            // into the slot of item j - 1
    const int li = j / S, s = j % S;
    float xm[PL], xc[PL], xq[PL];
#pragma unroll
    for (int c = 0; c < WPL; ++c)
#pragma unroll
      for (int e = 0; e < PACK; ++e) {
        const int col = (lane + 32 * c) * PACK + e;
        xm[c * PACK + e] = xs[li * B + col];
        xc[c * PACK + e] = xs[(li + 1) * B + col];
        xq[c * PACK + e] = xs[(li + 2) * B + col];
      }
    const uint32_t* Ls = ring + (j % DEPTH) * C::kItemWords;
    const uint32_t* Ds = Ls + C::kSlabWords;
    const uint32_t* Us = Ds + C::kSlabWords;
    float mine = 0.0f;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int r = (warp * RPW + rr) * WPR;
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < WPL; ++c) {
        const uint32_t lw = Ls[r + lane + 32 * c], dw = Ds[r + lane + 32 * c],
                       uw = Us[r + lane + 32 * c];
#pragma unroll
        for (int e = 0; e < PACK; ++e) {
          acc = fmaf(element<PACK>(lw, e), xm[c * PACK + e], acc);
          acc = fmaf(element<PACK>(dw, e), xc[c * PACK + e], acc);
          acc = fmaf(element<PACK>(uw, e), xq[c * PACK + e], acc);
        }
      }
      acc = warp_sum(acc);
      if (lane == rr) mine = acc;
    }
    if (lane < RPW)
      y[static_cast<size_t>(i0 + li) * B + s * kItemRows + warp * RPW + lane] =
          mine;
  }
  cp_async_wait<0>();
}

template <int B, int PACK>
int run(const void* D, const void* L, const void* U, const void* x, void* y,
        int nb, int kt, cudaStream_t stream) {
  auto kernel = blocktri_matvec_grid_kernel<B, PACK>;
  const size_t smem =
      Cfg<B, PACK>::kRingSmem + static_cast<size_t>(kt + 2) * B * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (nb + kt - 1) / kt;
  kernel<<<chunks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(D), static_cast<const uint32_t*>(L),
      static_cast<const uint32_t*>(U), static_cast<const float*>(x),
      static_cast<float*>(y), nb, kt);
  return static_cast<int>(cudaGetLastError());
}

template <int PACK>
int launch(const void* D, const void* L, const void* U, const void* x,
           void* y, int nb, int b, int kt, void* stream) {
  if (nb < 1 || kt < 1 || kt > kMaxKt)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128) return run<128, PACK>(D, L, U, x, y, nb, kt, s);
  if (b == 64) return run<64, PACK>(D, L, U, x, y, nb, kt, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int blocktri_matvec_grid_f32(const void* D, const void* L, const void* U,
                             const void* x, void* y, int nb, int b, int kt,
                             void* stream) {
  return launch<1>(D, L, U, x, y, nb, b, kt, stream);
}

int blocktri_matvec_grid_bf16(const void* D, const void* L, const void* U,
                              const void* x, void* y, int nb, int b, int kt,
                              void* stream) {
  return launch<2>(D, L, U, x, y, nb, b, kt, stream);
}

const char* blocktri_matvec_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
