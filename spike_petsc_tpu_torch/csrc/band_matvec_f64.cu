// Banded matvec in f64, y[i] = sum_d band[i, d] * x[i + d - kl], x zero
// outside [0, n): the residual operator of f64-grade refinement (f32
// factors, f64 residuals).
//
// Replaces the Pallas kernel `_kernel_df64` of
// spike_petsc_tpu/ops/pallas/band_matvec.py (reached through
// `banded_matvec_prepared_f64`).  The TPU has no f64 unit, so that kernel
// streams the band as hi/lo f32 pairs and rebuilds f64 products with
// mask-split Dekker products and two-sum.  The H100 runs FP64 natively, so
// this kernel reads the f64 band itself (the same 8 bytes per entry) and
// accumulates with FP64 FMA: a 53-bit mantissa against the pairs' ~48, and no
// error-free transform that a compiler's contraction or reassociation could
// break.
//
// Bound: bytes.  Every call reads the n*w f64 band entries once (1.61 GB at
// n = 1e6, w = 201) and does 2 flops per 8-byte entry; FP64 outside the
// tensor cores (34 TFLOP/s on the data sheet) costs nothing against that.
// Design, that of band_matvec.cu in double:
//   * the band is held in a one-time diagonal-major layout d3[w, ld]
//     (d3[d, i] = band[i, d], row stride ld >= n, padded to a multiple of 64);
//     thread i of diagonal d reads d3[d, i], so a warp load is two coalesced
//     128-byte lines;
//   * each block takes a tile of kTile rows and stages its f64 x window
//     (kTile + w - 1 values, zero outside [0, n)) in shared memory once;
//   * each thread keeps kRowsPerThread f64 accumulators in registers and the
//     diagonal loop is unrolled, keeping many independent loads in flight.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;

__global__ void __launch_bounds__(kThreads)
band_matvec_f64_kernel(const double* __restrict__ d3,
                       const double* __restrict__ x, double* __restrict__ y,
                       int n, long long ld, int kl, int w) {
  extern __shared__ double xs[];
  const long long i0 = static_cast<long long>(blockIdx.x) * kTile;
  const int window = kTile + w - 1;
  for (int t = threadIdx.x; t < window; t += kThreads) {
    const long long c = i0 - kl + t;
    xs[t] = (c >= 0 && c < n) ? x[c] : 0.0;
  }
  __syncthreads();

  double acc[kRowsPerThread];
  bool live[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    acc[m] = 0.0;
    live[m] = i0 + threadIdx.x + m * kThreads < n;
  }
  const double* base = d3 + i0 + threadIdx.x;
#pragma unroll 4
  for (int d = 0; d < w; ++d) {
    const double* row = base + static_cast<long long>(d) * ld;
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      if (live[m]) {
        acc[m] = fma(__ldg(row + m * kThreads),
                     xs[threadIdx.x + m * kThreads + d], acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    if (live[m]) y[i0 + threadIdx.x + m * kThreads] = acc[m];
  }
}

}  // namespace

extern "C" {

int band_matvec_f64(const void* d3, const void* x, void* y, int n,
                    long long ld, int kl, int ku, void* stream) {
  const int w = kl + ku + 1;
  const int blocks = (n + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(kTile + w - 1) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      band_matvec_f64_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  band_matvec_f64_kernel<<<blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(d3), static_cast<const double*>(x),
      static_cast<double*>(y), n, ld, kl, w);
  return static_cast<int>(cudaGetLastError());
}

const char* band_matvec_f64_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
