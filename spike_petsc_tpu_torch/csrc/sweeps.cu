// Block-Thomas solve for method='inv' factors in two launches:
//   forward kernel   y_0 = r_0,  y_i = r_i - F_i y_{i-1}
//   backward kernel  x_{nb-1} = Sinv_{nb-1} y_{nb-1},
//                    x_i = Sinv_i (y_i - U_i x_{i+1})
// over K independent partitions, F/U/Sinv of shape [K, nb, b, b] row-major,
// r, y and x of shape [K, nb, b]; y goes through device memory between the
// two launches.
//
// Replaces the Pallas kernels `_fwd_kernel` and `_bwd_kernel` of
// spike_petsc_tpu/ops/pallas/sweeps.py (reached through
// `blocktri_solve_batched_pallas`, `spike_solve(impl="pallas")`).
//
// Bound: bytes.  The two sweeps stream F, then U and Sinv, once: 3 * K*nb*b*b
// elements (1.55 GB in f32 at K = 64, nb = 123, b = 128), plus r in, the y
// round trip and x out, for 2 flops per element.  Each sweep is nb (2 nb - 1)
// dependent matrix-vector steps, so the latency of each b x b matrix read
// sits on the critical path.  Design (fused_sweep.cu's, split in two):
//   * one thread block per partition; the carry y_{i-1} or x_{i+1} stays in
//     shared memory (double-buffered), y_i is written to (and read back from)
//     device memory;
//   * the matrices of a sweep are one stream of items (forward F_1 ..
//     F_{nb-1}; backward Sinv_{nb-1}, then U_i, Sinv_i for i = nb-2 .. 0),
//     copied into a ring of D shared-memory slots with cp.async, D - 1 items
//     ahead of use: the current matrix is staged, the next ones prefetched;
//   * 8 warps, each owning b/8 rows; a lane reads 32-bit words of a row from
//     the ring (conflict-free), multiplies against the vector staged in
//     registers, and the row sum is a warp shuffle reduction;
//   * bf16 factors are promoted to f32 in registers (a 16-bit shift of the
//     bit pattern); the carries are f32.
// The TPU kernels' chunking of partitions into VMEM-sized grid steps is not
// carried over: a block per partition keeps its own carry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRingBytes = 200 * 1024;     // shared memory for the ring
constexpr int kMaxDepth = 8;

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

__device__ __forceinline__ float element(uint32_t word, int e, int pack) {
  if (pack == 1) return __uint_as_float(word);
  return __uint_as_float(e == 0 ? word << 16 : word & 0xffff0000u);
}

// B: block size; PACK: matrix elements per 32-bit word (1 = f32, 2 = bf16).
template <int B, int PACK>
struct Cfg {
  static constexpr int kRows = B / kWarps;             // rows per warp
  static constexpr int kWordsPerRow = B / PACK;
  static constexpr int kWordsPerLane = kWordsPerRow / 32;
  static constexpr int kPerLane = kWordsPerLane * PACK;  // columns per lane
  static constexpr int kMatWords = B * kWordsPerRow;
  static constexpr int kChunks = kMatWords / 4 / kThreads;  // 16 B copies
  static constexpr int kDepth =
      kRingBytes / (kMatWords * 4) < kMaxDepth ? kRingBytes / (kMatWords * 4)
                                               : kMaxDepth;
  // ring, carry [2][B]
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kDepth) * kMatWords * 4 +
      static_cast<size_t>(2) * B * 4;
  static_assert(kWordsPerRow % 32 == 0, "row must split evenly over lanes");
  static_assert(B % kWarps == 0 && kRows <= 32, "rows must split over warps");
  static_assert((kMatWords / 4) % kThreads == 0, "matrix must split evenly");
  static_assert(kDepth >= 3, "the ring needs at least three slots");
};

// The per-block machinery both sweeps share: the ring of matrices, the
// vector loads and the row-wise product.
template <int B, int PACK>
struct Sweep {
  using C = Cfg<B, PACK>;
  static constexpr int D = C::kDepth, R = C::kRows, PL = C::kPerLane;
  uint32_t* ring;                  // [D][kMatWords]
  int tid, warp, lane;

  __device__ Sweep(unsigned char* smem)
      : ring(reinterpret_cast<uint32_t*>(smem)), tid(threadIdx.x),
        warp(threadIdx.x / 32), lane(threadIdx.x % 32) {}

  __device__ float* carry() const {          // [2][B], after the ring
    return reinterpret_cast<float*>(ring + D * C::kMatWords);
  }
  __device__ const uint32_t* slot(int j) const {
    return ring + (j % D) * C::kMatWords;
  }
  // copy matrix ``src`` (null past the stream's end) into item j's slot;
  // one commit group per item
  __device__ void issue(const uint32_t* src, int j) {
    if (src != nullptr) {
      const uint4* s = reinterpret_cast<const uint4*>(src);
      uint4* d = reinterpret_cast<uint4*>(ring + (j % D) * C::kMatWords);
#pragma unroll
      for (int q = 0; q < C::kChunks; ++q)
        cp_async16(d + tid + kThreads * q, s + tid + kThreads * q);
    }
    cp_async_commit();
  }
  // item j has landed and every thread is past the previous step
  __device__ void wait_item() {
    cp_async_wait<D - 2>();
    __syncthreads();
  }
  // this lane's columns (lane + 32 c) * PACK + e of a vector
  __device__ void load_cols(float (&v)[PL], const float* src) const {
#pragma unroll
    for (int c = 0; c < C::kWordsPerLane; ++c)
#pragma unroll
      for (int e = 0; e < PACK; ++e)
        v[c * PACK + e] = src[(lane + 32 * c) * PACK + e];
  }
  // (M v)[warp * R + lane] for lane < R (0 elsewhere)
  __device__ float rows_dot(const uint32_t* M, const float (&v)[PL]) const {
    float mine = 0.0f;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const uint32_t* row = M + (warp * R + rr) * C::kWordsPerRow;
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < C::kWordsPerLane; ++c) {
        const uint32_t w = row[lane + 32 * c];
#pragma unroll
        for (int e = 0; e < PACK; ++e)
          acc = fmaf(element(w, e, PACK), v[c * PACK + e], acc);
      }
      acc = warp_sum(acc);
      if (lane == rr) mine = acc;
    }
    return mine;
  }
};

template <int B, int PACK>
__global__ void __launch_bounds__(kThreads, 1)
sweep_fwd_kernel(const uint32_t* __restrict__ F, const float* __restrict__ r,
                 float* __restrict__ y, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = Sweep<B, PACK>;
  S sw(smem_raw);
  float* carry = sw.carry();
  const size_t words = S::C::kMatWords;
  const size_t part = static_cast<size_t>(blockIdx.x) * nb;
  F += part * words;
  const float* rp = r + part * B;
  float* yp = y + part * B;
  // item j is F_{j+1}, j = 0 .. nb - 2
  auto matrix = [&](int j) -> const uint32_t* {
    return j < nb - 1 ? F + (j + 1) * words : nullptr;
  };

  for (int t = sw.tid; t < B; t += kThreads) {       // y_0 = r_0
    const float v = rp[t];
    carry[t] = v;
    yp[t] = v;
  }
  for (int j = 0; j < S::D - 1; ++j) sw.issue(matrix(j), j);
  const int row = sw.warp * S::R + sw.lane;  // this lane's row, lane < R
  const bool mine = sw.lane < S::R;
  float rnext = (mine && nb > 1) ? rp[B + row] : 0.0f;
  int p = 0;                                         // carry[p * B] is current
  for (int i = 1; i < nb; ++i) {
    const int j = i - 1;
    sw.wait_item();
    sw.issue(matrix(j + S::D - 1), j + S::D - 1);    // the slot of item j - 1
    const float rcur = rnext;
    if (mine && i + 1 < nb) rnext = rp[(i + 1) * B + row];
    float v[S::PL];
    sw.load_cols(v, carry + p * B);
    const float s = sw.rows_dot(sw.slot(j), v);
    if (mine) {
      const float yi = rcur - s;
      carry[(1 - p) * B + row] = yi;
      yp[i * B + row] = yi;
    }
    p ^= 1;
  }
  cp_async_wait<0>();
}

template <int B, int PACK>
__global__ void __launch_bounds__(kThreads, 1)
sweep_bwd_kernel(const uint32_t* __restrict__ Sinv,
                 const uint32_t* __restrict__ U, const float* __restrict__ y,
                 float* __restrict__ x, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = Sweep<B, PACK>;
  S sw(smem_raw);
  float* carry = sw.carry();
  const size_t words = S::C::kMatWords;
  const size_t part = static_cast<size_t>(blockIdx.x) * nb;
  Sinv += part * words;
  U += part * words;
  const float* yp = y + part * B;
  float* xp = x + part * B;
  const int items = 2 * nb - 1;
  // item 0 is Sinv_{nb-1}; then U_i (odd j), Sinv_i (even j) for
  // i = nb - 2 - (j - 1) / 2
  auto matrix = [&](int j) -> const uint32_t* {
    if (j >= items) return nullptr;
    if (j == 0) return Sinv + (nb - 1) * words;
    const int i = nb - 2 - (j - 1) / 2;
    return ((j - 1) & 1) ? Sinv + i * words : U + i * words;
  };

  for (int j = 0; j < S::D - 1; ++j) sw.issue(matrix(j), j);
  const int row = sw.warp * S::R + sw.lane;
  const bool mine = sw.lane < S::R;
  float v[S::PL];
  sw.load_cols(v, yp + (nb - 1) * B);                // y_{nb-1}
  float ybase = (mine && nb > 1) ? yp[(nb - 2) * B + row] : 0.0f;
  int p = 0;

  // x_{nb-1} = Sinv_{nb-1} y_{nb-1}, item 0
  sw.wait_item();
  sw.issue(matrix(S::D - 1), S::D - 1);
  {
    const float s = sw.rows_dot(sw.slot(0), v);
    if (mine) {
      carry[(1 - p) * B + row] = s;
      xp[(nb - 1) * B + row] = s;
    }
    p ^= 1;
  }
  for (int i = nb - 2; i >= 0; --i) {
    const int j = 1 + 2 * (nb - 2 - i);
    // t_i = y_i - U_i x_{i+1}, item j
    sw.wait_item();
    sw.issue(matrix(j + S::D - 1), j + S::D - 1);
    const float ycur = ybase;
    if (mine && i >= 1) ybase = yp[(i - 1) * B + row];
    sw.load_cols(v, carry + p * B);
    float s = sw.rows_dot(sw.slot(j), v);
    if (mine) carry[(1 - p) * B + row] = ycur - s;
    p ^= 1;
    // x_i = Sinv_i t_i, item j + 1
    sw.wait_item();
    sw.issue(matrix(j + S::D), j + S::D);
    sw.load_cols(v, carry + p * B);
    s = sw.rows_dot(sw.slot(j + 1), v);
    if (mine) {
      carry[(1 - p) * B + row] = s;
      xp[i * B + row] = s;
    }
    p ^= 1;
  }
  cp_async_wait<0>();
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int B, int PACK>
int run_fwd(const void* F, const void* r, void* y, int K, int nb,
            cudaStream_t stream) {
  auto kernel = sweep_fwd_kernel<B, PACK>;
  const size_t smem = Cfg<B, PACK>::kSmemBytes;
  const int err = prepare(kernel, smem);
  if (err != 0) return err;
  kernel<<<K, kThreads, smem, stream>>>(static_cast<const uint32_t*>(F),
                                        static_cast<const float*>(r),
                                        static_cast<float*>(y), nb);
  return static_cast<int>(cudaGetLastError());
}

template <int B, int PACK>
int run_bwd(const void* Sinv, const void* U, const void* y, void* x, int K,
            int nb, cudaStream_t stream) {
  auto kernel = sweep_bwd_kernel<B, PACK>;
  const size_t smem = Cfg<B, PACK>::kSmemBytes;
  const int err = prepare(kernel, smem);
  if (err != 0) return err;
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(Sinv), static_cast<const uint32_t*>(U),
      static_cast<const float*>(y), static_cast<float*>(x), nb);
  return static_cast<int>(cudaGetLastError());
}

template <int PACK>
int fwd(const void* F, const void* r, void* y, int K, int nb, int b,
        void* stream) {
  if (K < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128) return run_fwd<128, PACK>(F, r, y, K, nb, s);
  if (b == 64) return run_fwd<64, PACK>(F, r, y, K, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int PACK>
int bwd(const void* Sinv, const void* U, const void* y, void* x, int K,
        int nb, int b, void* stream) {
  if (K < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128) return run_bwd<128, PACK>(Sinv, U, y, x, K, nb, s);
  if (b == 64) return run_bwd<64, PACK>(Sinv, U, y, x, K, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int sweeps_fwd_f32(const void* F, const void* r, void* y, int K, int nb,
                   int b, void* stream) {
  return fwd<1>(F, r, y, K, nb, b, stream);
}

int sweeps_fwd_bf16(const void* F, const void* r, void* y, int K, int nb,
                    int b, void* stream) {
  return fwd<2>(F, r, y, K, nb, b, stream);
}

int sweeps_bwd_f32(const void* Sinv, const void* U, const void* y, void* x,
                   int K, int nb, int b, void* stream) {
  return bwd<1>(Sinv, U, y, x, K, nb, b, stream);
}

int sweeps_bwd_bf16(const void* Sinv, const void* U, const void* y, void* x,
                    int K, int nb, int b, void* stream) {
  return bwd<2>(Sinv, U, y, x, K, nb, b, stream);
}

const char* sweeps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
