// The rate at which one thread block streams 16 KB matrices (64 x 64 f32)
// from device memory into a ring of shared-memory slots, doing nothing
// else with them: cp.async of 16 bytes a thread into padded rows (the
// phase-1 ring of csrc/sweeps.cu), one bulk copy (TMA) a row, and one bulk
// copy a matrix (its vector steps' ring), at ring depths 4 and 8, with 1
// and 132 blocks each streaming 1563 matrices (config 1's F), and one block
// streaming 130 matrices that sit in L2.
//
//   mkdir -p build/lab && nvcc -gencode arch=compute_90a,code=sm_90a \
//     -std=c++17 -O3 -o build/lab/stream_rate experiments/stream_rate.cu \
//     && build/lab/stream_rate
//
// One line a run: ms, microseconds a matrix and GB/s a block (CUDA events,
// the mean of five launches after one).
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>

constexpr int kThreads = 256, kLd = 68, kMat = 64 * 64;   // words

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem(dst)),
               "l"(src));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem(b)));
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\nWAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem(b)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk(void* dst, const void* src,
                                     unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem(dst)), "l"(src), "r"(bytes),
      "r"(smem(b)) : "memory");
}

template <int D>
__global__ void by_cp_async(const uint32_t* src, int n, float* sink) {
  extern __shared__ __align__(16) uint32_t sm[];
  auto issue = [&](int j) {
    if (j < n) {
      uint32_t* s = sm + (j % D) * 64 * kLd;
      const uint32_t* g = src + static_cast<size_t>(j) * kMat;
      for (int q = threadIdx.x; q < kMat / 4; q += kThreads)
        cp_async16(s + (q / 16) * kLd + (q % 16) * 4, g + 4 * q);
    }
    commit();
  };
  for (int j = 0; j < D - 1; ++j) issue(j);
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) {
    wait_group<D - 2>();
    __syncthreads();
    issue(j + D - 1);
    acc += __uint_as_float(sm[(j % D) * 64 * kLd + threadIdx.x]);
  }
  if (acc == 12345.0f) sink[0] = acc;
}

template <int D, bool ROWS>
__global__ void by_bulk(const uint32_t* src, int n, float* sink) {
  extern __shared__ __align__(16) uint32_t sm[];
  __shared__ uint64_t bars[8];
  if (threadIdx.x < D) mbar_init(&bars[threadIdx.x]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  auto issue = [&](int j) {
    if (j >= n) return;
    uint32_t* s = sm + (j % D) * 64 * kLd;
    const uint32_t* g = src + static_cast<size_t>(j) * kMat;
    if (threadIdx.x == 0) mbar_expect(&bars[j % D], kMat * 4);
    if (ROWS) {
      if (threadIdx.x < 64)
        bulk(s + threadIdx.x * kLd, g + threadIdx.x * 64, 256, &bars[j % D]);
    } else if (threadIdx.x == 0) {
      bulk(s, g, kMat * 4, &bars[j % D]);
    }
  };
  for (int j = 0; j < D - 1; ++j) issue(j);
  float acc = 0.0f;
  for (int j = 0; j < n; ++j) {
    mbar_wait(&bars[j % D], (j / D) & 1);
    __syncthreads();
    issue(j + D - 1);
    acc += __uint_as_float(sm[(j % D) * 64 * kLd + threadIdx.x]);
  }
  if (acc == 12345.0f) sink[0] = acc;
}

template <class Kernel>
void run(const char* name, Kernel kernel, const uint32_t* src, int n,
         float* sink, int blocks) {
  const int bytes = 8 * 64 * kLd * 4;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  kernel<<<blocks, kThreads, bytes>>>(src, n, sink);
  cudaEventRecord(a);
  for (int it = 0; it < 5; ++it)
    kernel<<<blocks, kThreads, bytes>>>(src, n, sink);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  ms /= 5;
  printf("%-24s blocks %3d: %.4f ms for %d matrices a block, %.3f us a "
         "matrix, %.1f GB/s a block (%s)\n", name, blocks, ms, n, 1e3 * ms / n,
         static_cast<double>(n) * kMat * 4 / (ms * 1e6),
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  const int n = 1563;
  uint32_t* src;
  float* sink;
  cudaMalloc(&src, static_cast<size_t>(n) * kMat * 4);
  cudaMemset(src, 0, static_cast<size_t>(n) * kMat * 4);
  cudaMalloc(&sink, 4);
  for (int blocks : {1, 132}) {
    run("cp.async, depth 4", by_cp_async<4>, src, n, sink, blocks);
    run("cp.async, depth 8", by_cp_async<8>, src, n, sink, blocks);
    run("bulk a row, depth 4", by_bulk<4, true>, src, n, sink, blocks);
    run("bulk a row, depth 8", by_bulk<8, true>, src, n, sink, blocks);
    run("bulk a matrix, depth 4", by_bulk<4, false>, src, n, sink, blocks);
    run("bulk a matrix, depth 8", by_bulk<8, false>, src, n, sink, blocks);
  }
  run("L2: cp.async, depth 4", by_cp_async<4>, src, 130, sink, 1);
  run("L2: bulk a row, depth 4", by_bulk<4, true>, src, 130, sink, 1);
  run("L2: bulk a matrix, depth 4", by_bulk<4, false>, src, 130, sink, 1);
  return 0;
}
