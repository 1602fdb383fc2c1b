// Fused block-Thomas solve for method='spd' factors (symmetric block-LDL^T,
// F and Sinv stored, no U), both sweeps in one kernel:
//   forward   y_0 = r_0,  y_i = r_i - F_i y_{i-1}
//   backward  x_{nb-1} = Sinv_{nb-1} y_{nb-1},
//             x_i = Sinv_i y_i - F_{i+1}^T x_{i+1}
// over K independent partitions, F/Sinv of shape [K, nb, b, b] row-major,
// r and x of shape [K, nb, b].
//
// Replaces the Pallas kernel `_fused_kernel_spd` of
// spike_petsc_tpu/ops/pallas/fused_sweep.py (reached through
// `blocktri_solve_fused_pallas` on spd factors).
//
// Bound: latency.  The bytes are F twice and Sinv once (768 MB in f32 at
// K = 16, nb = 977, b = 64), but the sweep is 2 * nb - 1 dependent steps of
// small matrix-vector products on only K blocks, so each step's latency, not
// the card's memory rate, sets the time.  Design for that:
//   * one thread block per partition.  One partition's y (nb * b * 4 bytes,
//     250 KB at K = 16, n = 1e6, b = 64) does not fit shared memory, so the
//     forward sweep writes y_i into slot i of x, and the backward sweep reads
//     slot i and overwrites it with x_i (x_i needs only y_i and x_{i+1});
//     the carries stay in shared memory;
//   * the matrices are one stream of 3 * nb - 2 items (F_1 .. F_{nb-1},
//     Sinv_{nb-1}, then Sinv_i, F_{i+1} for i = nb-2 .. 0), copied into a
//     ring of D shared-memory slots with cp.async, D - 1 items ahead of use,
//     so the load latency of a step is hidden behind the steps before it;
//   * Sinv_i y_i does not depend on x_{i+1}: a backward step computes it
//     beside F_{i+1}^T x_{i+1}, so the backward sweep is nb - 1 steps, not
//     2 * (nb - 1), and only the transposed product is on the recurrence;
//   * M v (forward, and Sinv_i y_i): each warp owns b/8 rows, a lane reads
//     32-bit words of a row (conflict-free), the row sum is a warp shuffle
//     reduction.  F^T v: the same row-wise reads, each lane keeps partial
//     column sums over its warp's rows, and the warps' partial sums are
//     added in shared memory;
//   * bf16 factors are promoted to f32 in registers (a 16-bit shift of the
//     bit pattern); the carries are f32.
// This leaves 116 of 132 SMs idle at K = 16; splitting a partition's sweep
// over a thread block cluster is later work.

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
  // ring, carry [2][B], su [B], red [kWarps][B]
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kDepth) * kMatWords * 4 +
      static_cast<size_t>(3 + kWarps) * B * 4;
  static_assert(kWordsPerRow % 32 == 0, "row must split evenly over lanes");
  static_assert(B % kWarps == 0 && kRows <= 32, "rows must split over warps");
  static_assert((kMatWords / 4) % kThreads == 0, "matrix must split evenly");
  static_assert(kDepth >= 3, "the ring needs at least three slots");
};

__device__ __forceinline__ float element(uint32_t word, int e, int pack) {
  if (pack == 1) return __uint_as_float(word);
  return __uint_as_float(e == 0 ? word << 16 : word & 0xffff0000u);
}

template <int B, int PACK>
__global__ void __launch_bounds__(kThreads, 1)
fused_sweep_spd_kernel(const uint32_t* __restrict__ F,
                       const uint32_t* __restrict__ Sinv,
                       const float* __restrict__ r, float* x, int nb) {
  using C = Cfg<B, PACK>;
  constexpr int D = C::kDepth, R = C::kRows, WPL = C::kWordsPerLane,
                WPR = C::kWordsPerRow, PL = C::kPerLane;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem_raw);  // [D][kMatWords]
  float* carry = reinterpret_cast<float*>(ring + D * C::kMatWords);  // [2][B]
  float* su = carry + 2 * B;        // [B] Sinv_i y_i
  float* red = su + B;              // [kWarps][B] partial sums of F^T x

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t words = C::kMatWords;
  const size_t part = static_cast<size_t>(blockIdx.x) * nb;
  F += part * words;
  Sinv += part * words;
  const float* rp = r + part * B;
  float* xp = x + part * B;
  const int items = 3 * nb - 2;

  // item j -> its matrix: F_{j+1} for j < nb-1, Sinv_{nb-1} at j = nb-1,
  // then Sinv_i (even t), F_{i+1} (odd t) for i = nb-2-t/2, t = j - nb
  auto item_matrix = [&](int j) -> const uint32_t* {
    if (j < nb - 1) return F + (j + 1) * words;
    if (j == nb - 1) return Sinv + (nb - 1) * words;
    const int t = j - nb, i = nb - 2 - t / 2;
    return (t & 1) ? F + (i + 1) * words : Sinv + i * words;
  };
  auto slot = [&](int j) -> const uint32_t* {
    return ring + (j % D) * C::kMatWords;
  };
  // copy item j into its slot; one commit group per item, empty past the end
  auto issue = [&](int j) {
    if (j < items) {
      const uint4* src = reinterpret_cast<const uint4*>(item_matrix(j));
      uint4* dst = reinterpret_cast<uint4*>(ring + (j % D) * C::kMatWords);
#pragma unroll
      for (int q = 0; q < C::kChunks; ++q)
        cp_async16(dst + tid + kThreads * q, src + tid + kThreads * q);
    }
    cp_async_commit();
  };
  // this lane's columns (lane + 32 c) * PACK + e of a vector
  auto load_cols = [&](float (&v)[PL], const float* src) {
#pragma unroll
    for (int c = 0; c < WPL; ++c)
#pragma unroll
      for (int e = 0; e < PACK; ++e)
        v[c * PACK + e] = src[(lane + 32 * c) * PACK + e];
  };
  auto load_cols_global = [&](float (&v)[PL], const float* src) {
#pragma unroll
    for (int c = 0; c < WPL; ++c)
#pragma unroll
      for (int e = 0; e < PACK; ++e)
        v[c * PACK + e] = __ldcg(src + (lane + 32 * c) * PACK + e);
  };
  // (M v)[warp * R + lane] for lane < R (0 elsewhere)
  auto rows_dot = [&](const uint32_t* M, const float (&v)[PL]) -> float {
    float mine = 0.0f;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const uint32_t* row = M + (warp * R + rr) * WPR;
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < WPL; ++c) {
        const uint32_t w = row[lane + 32 * c];
#pragma unroll
        for (int e = 0; e < PACK; ++e)
          acc = fmaf(element(w, e, PACK), v[c * PACK + e], acc);
      }
      acc = warp_sum(acc);
      if (lane == rr) mine = acc;
    }
    return mine;
  };
  // this warp's partial sums of (M^T v) over its rows, into red[warp]
  auto cols_dot = [&](const uint32_t* M, const float* v) {
    float acc[PL];
#pragma unroll
    for (int q = 0; q < PL; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const uint32_t* row = M + (warp * R + rr) * WPR;
      const float vr = v[warp * R + rr];
#pragma unroll
      for (int c = 0; c < WPL; ++c) {
        const uint32_t w = row[lane + 32 * c];
#pragma unroll
        for (int e = 0; e < PACK; ++e)
          acc[c * PACK + e] = fmaf(element(w, e, PACK), vr, acc[c * PACK + e]);
      }
    }
#pragma unroll
    for (int c = 0; c < WPL; ++c)
#pragma unroll
      for (int e = 0; e < PACK; ++e)
        red[warp * B + (lane + 32 * c) * PACK + e] = acc[c * PACK + e];
  };

  // y_0 = r_0: the first carry, and slot 0 of x
  for (int t = tid; t < B; t += kThreads) {
    const float v = rp[t];
    carry[t] = v;
    xp[t] = v;
  }
  for (int j = 0; j < D - 1; ++j) issue(j);
  const int row = warp * R + lane;                  // this lane's row, lane < R
  float rnext = (lane < R && nb > 1) ? rp[B + row] : 0.0f;
  int p = 0;                                        // carry[p * B] is current

  // forward, item j = i - 1
  for (int i = 1; i < nb; ++i) {
    const int j = i - 1;
    cp_async_wait<D - 2>();
    __syncthreads();
    issue(j + D - 1);
    const float rcur = rnext;
    if (lane < R && i + 1 < nb) rnext = rp[(i + 1) * B + row];
    float v[PL];
    load_cols(v, carry + p * B);
    const float s = rows_dot(slot(j), v);
    if (lane < R) {
      const float y = rcur - s;
      carry[(1 - p) * B + row] = y;
      xp[i * B + row] = y;
    }
    p ^= 1;
  }

  // x_{nb-1} = Sinv_{nb-1} y_{nb-1}, item nb - 1
  float ynext[PL];
  {
    const int j = nb - 1;
    cp_async_wait<D - 2>();
    __syncthreads();
    issue(j + D - 1);
    if (nb >= 2) load_cols_global(ynext, xp + (nb - 2) * B);
    float v[PL];
    load_cols(v, carry + p * B);
    const float s = rows_dot(slot(j), v);
    if (lane < R) {
      carry[(1 - p) * B + row] = s;
      xp[(nb - 1) * B + row] = s;
    }
    p ^= 1;
  }

  // backward: items j (Sinv_i) and j + 1 (F_{i+1})
  for (int i = nb - 2; i >= 0; --i) {
    const int j = nb + 2 * (nb - 2 - i);
    cp_async_wait<D - 3>();
    __syncthreads();
    issue(j + D - 1);               // into the slot of item j - 1
    float ycur[PL];
#pragma unroll
    for (int q = 0; q < PL; ++q) ycur[q] = ynext[q];
    if (i >= 1) load_cols_global(ynext, xp + (i - 1) * B);
    const float s = rows_dot(slot(j), ycur);        // (Sinv_i y_i)[row]
    cols_dot(slot(j + 1), carry + p * B);           // F_{i+1}^T x_{i+1}
    if (lane < R) su[row] = s;
    __syncthreads();
    issue(j + D);                   // into the slot of item j, now read
    for (int t = tid; t < B; t += kThreads) {
      float acc = su[t];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc -= red[w * B + t];
      carry[(1 - p) * B + t] = acc;
      xp[i * B + t] = acc;
    }
    p ^= 1;
  }
  cp_async_wait<0>();
}

template <int B, int PACK>
int run(const void* F, const void* Sinv, const void* r, void* x, int K,
        int nb, cudaStream_t stream) {
  auto kernel = fused_sweep_spd_kernel<B, PACK>;
  const size_t smem = Cfg<B, PACK>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<K, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(F), static_cast<const uint32_t*>(Sinv),
      static_cast<const float*>(r), static_cast<float*>(x), nb);
  return static_cast<int>(cudaGetLastError());
}

template <int PACK>
int launch(const void* F, const void* Sinv, const void* r, void* x, int K,
           int nb, int b, void* stream) {
  if (K < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128) return run<128, PACK>(F, Sinv, r, x, K, nb, s);
  if (b == 64) return run<64, PACK>(F, Sinv, r, x, K, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int fused_sweep_spd_f32(const void* F, const void* Sinv, const void* r,
                        void* x, int K, int nb, int b, void* stream) {
  return launch<1>(F, Sinv, r, x, K, nb, b, stream);
}

int fused_sweep_spd_bf16(const void* F, const void* Sinv, const void* r,
                         void* x, int K, int nb, int b, void* stream) {
  return launch<2>(F, Sinv, r, x, K, nb, b, stream);
}

const char* fused_sweep_spd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
