// Block-tridiagonal matvec y_i = L_i x_{i-1} + D_i x_i + U_i x_{i+1} over
// [nb, b, b] row-major blocks, x and y of length n <= nb * b: x is read as
// zero beyond n (and x_{-1}, x_{nb} as zero), rows of y beyond n are not
// written.
//
// Replaces the Pallas kernel `_mv_dma_kernel` of
// spike_petsc_tpu/ops/pallas/matvec.py (reached through
// `blocktri_matvec_dma`).
//
// Bound: bytes.  Every call reads 3 * nb * b * b block entries once (1.54 GB
// in f32 at the flagship conversion, nb = 7813, b = 128: 1.9x the banded
// kernel's 0.81 GB) for 2 flops per entry.  Design for that:
//   * one thread block per block row (block rows are independent); it
//     stages x_{i-1}, x_i and x_{i+1} (3b floats) in shared memory, zero
//     outside [0, n), so no read leaves x (block row 0 has no x_{-1}, the
//     last has no x_{nb}) and the TPU kernel's padding to a chunk grid is not
//     needed;
//   * 8 warps, each owning b/8 rows; a lane reads 32-bit words of a row of
//     L, D and U (coalesced 128-byte lines) and the row sum is a warp shuffle
//     reduction, as in band_matvec.cu and fused_sweep.cu;
//   * the loads of kBatch rows of all three blocks are issued before any
//     arithmetic, so each lane keeps 3 * kBatch * b / (32 * PACK) words in
//     flight;
//   * bf16 blocks are promoted to f32 in registers (a 16-bit shift).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int PACK>
__device__ __forceinline__ float element(uint32_t word, int e) {
  if (PACK == 1) return __uint_as_float(word);
  return __uint_as_float(e == 0 ? word << 16 : word & 0xffff0000u);
}

// B: block size; PACK: block elements per 32-bit word (1 = f32, 2 = bf16).
template <int B, int PACK>
__global__ void __launch_bounds__(kThreads)
blocktri_matvec_kernel(const uint32_t* __restrict__ D,
                       const uint32_t* __restrict__ L,
                       const uint32_t* __restrict__ U,
                       const float* __restrict__ x, float* __restrict__ y,
                       int n) {
  constexpr int kWordsPerRow = B / PACK;
  constexpr int kWordsPerLane = kWordsPerRow / 32;
  constexpr int kRowsPerWarp = B / kWarps;
  constexpr int kElems = kWordsPerLane * PACK;
  static_assert(kWordsPerRow % 32 == 0, "row must split evenly over lanes");
  static_assert(kRowsPerWarp % kBatch == 0, "rows must split into batches");

  __shared__ float xs[3 * B];            // x_{i-1}, x_i, x_{i+1}
  const int blk = blockIdx.x;
  for (int t = threadIdx.x; t < 3 * B; t += kThreads) {
    const long long c = static_cast<long long>(blk - 1) * B + t;
    xs[t] = (c >= 0 && c < n) ? x[c] : 0.0f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the x entries this lane multiplies: column (lane + 32 c) * PACK + e
  float xm[kElems], xc[kElems], xq[kElems];
#pragma unroll
  for (int c = 0; c < kWordsPerLane; ++c)
#pragma unroll
    for (int e = 0; e < PACK; ++e) {
      const int col = (lane + 32 * c) * PACK + e;
      xm[c * PACK + e] = xs[col];
      xc[c * PACK + e] = xs[B + col];
      xq[c * PACK + e] = xs[2 * B + col];
    }

  const size_t base = static_cast<size_t>(blk) * B * kWordsPerRow;
  const long long row0 = static_cast<long long>(blk) * B;
#pragma unroll 1
  for (int r0 = warp * kRowsPerWarp; r0 < (warp + 1) * kRowsPerWarp;
       r0 += kBatch) {
    uint32_t lw[kBatch][kWordsPerLane], dw[kBatch][kWordsPerLane],
        uw[kBatch][kWordsPerLane];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
#pragma unroll
      for (int c = 0; c < kWordsPerLane; ++c) {
        const size_t w = base + static_cast<size_t>(r0 + q) * kWordsPerRow +
                         lane + 32 * c;
        lw[q][c] = __ldg(L + w);
        dw[q][c] = __ldg(D + w);
        uw[q][c] = __ldg(U + w);
      }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < kWordsPerLane; ++c)
#pragma unroll
        for (int e = 0; e < PACK; ++e) {
          acc = fmaf(element<PACK>(lw[q][c], e), xm[c * PACK + e], acc);
          acc = fmaf(element<PACK>(dw[q][c], e), xc[c * PACK + e], acc);
          acc = fmaf(element<PACK>(uw[q][c], e), xq[c * PACK + e], acc);
        }
      acc = warp_sum(acc);
      const long long row = row0 + r0 + q;
      if (lane == 0 && row < n) y[row] = acc;
    }
  }
}

template <int PACK>
int launch(const void* D, const void* L, const void* U, const void* x,
           void* y, int nb, int b, int n, void* stream) {
  if (nb < 1 || n < 1 || static_cast<long long>(nb) * b < n ||
      static_cast<long long>(nb - 1) * b >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  auto run = [&](auto kernel) -> int {
    kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(D), static_cast<const uint32_t*>(L),
        static_cast<const uint32_t*>(U), static_cast<const float*>(x),
        static_cast<float*>(y), n);
    return static_cast<int>(cudaGetLastError());
  };
  if (b == 128) return run(blocktri_matvec_kernel<128, PACK>);
  if (b == 64) return run(blocktri_matvec_kernel<64, PACK>);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int blocktri_matvec_f32(const void* D, const void* L, const void* U,
                        const void* x, void* y, int nb, int b, int n,
                        void* stream) {
  return launch<1>(D, L, U, x, y, nb, b, n, stream);
}

int blocktri_matvec_bf16(const void* D, const void* L, const void* U,
                         const void* x, void* y, int nb, int b, int n,
                         void* stream) {
  return launch<2>(D, L, U, x, y, nb, b, n, stream);
}

const char* blocktri_matvec_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
