// Multi-RHS fused block-Thomas solve for method='inv' factors, both sweeps in
// one kernel, for r right-hand sides at once:
//   forward   y_0 = r_0,  y_i = r_i - F_i y_{i-1}
//   backward  x_{nb-1} = Sinv_{nb-1} y_{nb-1},  x_i = Sinv_i (y_i - U_i x_{i+1})
// over K independent partitions.  F/Sinv/U are [K, nb, b, b] row-major; the
// right-hand sides and the solution are [K, nb, b, r] row-major (the
// caller's layout; the TPU kernel's [K, nb, r, b] swap is a lane trick).
//
// Replaces the Pallas kernel `_fused_kernel_many` of
// spike_petsc_tpu/ops/pallas/fused_sweep.py (reached through
// `blocktri_solve_fused_many_pallas`).
//
// Bound at the flagship (K = 64, nb = 123, b = 128, r = 32): balanced.
//   * bytes: F, Sinv and U are 1.55 GB in f32 (half with bf16 factors),
//     about 0.65 ms at the 2.4 TB/s the single-RHS sweep reaches;
//   * arithmetic: 128 * 128 * 32 * 2 flops x 367 steps x 64 partitions =
//     24.6 GFLOP of f32 FMA, about 0.75 ms on 64 SMs at the CUDA cores'
//     f32 rate.  Splitting the columns over two blocks per partition puts
//     128 SMs on it and halves that side; both blocks read the same matrix
//     at about the same time, so the 50 MB L2 may serve the second read.
// Design:
//   * grid (K, ceil(r / 16)): one block per partition and chunk of 16
//     columns; column chunks are independent.  At the flagship (r = 32)
//     that is 128 blocks, each reading every matrix of its partition; it
//     ran 1.38x faster than one 32-column block per partition (64 blocks);
//   * one partition's y is nb * b * r * 4 bytes (2.0 MB at the flagship),
//     too large for shared memory, so it goes through the output buffer:
//     the forward sweep writes y_i into slot i, and the backward sweep reads
//     slot i and overwrites it with x_i (x_i needs only y_i and x_{i+1});
//   * the sweeps are one stream of 3*nb - 2 matrix steps, as in
//     fused_sweep.cu.  The b x b matrix of the current step sits in shared
//     memory as f32 (row stride b + 4, so float4 reads of four rows hit four
//     bank groups); the next step's matrix and base vector are loaded into
//     registers while the current step computes (a register double buffer);
//   * the vector tile [b, RC] sits in shared memory transposed, [RC][b + 4],
//     ping-ponged between two buffers; each thread owns TM = b/32 rows
//     (strided by 32) x TN = RC/8 columns (strided by 8) of the output and
//     runs f32 FMAs over float4 reads of both operands;
//   * bf16 factors are promoted to f32 when staged (a 16-bit shift of the
//     bit pattern).  No TF32 and no bf16 rounding of the carry: the carry is
//     f32 end to end.
// This leaves the tensor cores idle; a wgmma version with a TMA ring is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColGroups = 8;                        // threads along columns
constexpr int kRowGroups = kThreads / kColGroups;    // threads along rows
constexpr int kCols = 16;                            // columns per block

// B: block size; RC: columns per block; PACK: matrix elements per 32-bit
// word (1 = f32, 2 = bf16).
template <int B, int RC, int PACK>
struct Cfg {
  static constexpr int LD = B + 4;                   // smem row stride
  static constexpr int TM = B / kRowGroups;          // rows per thread
  static constexpr int TN = RC / kColGroups;         // columns per thread
  static constexpr int kWords = B * B / PACK / kThreads;
  static constexpr size_t kSmemFloats =
      static_cast<size_t>(B) * LD + 2 * static_cast<size_t>(RC) * LD;
  static_assert(B % kRowGroups == 0, "rows must split over row groups");
  static_assert(RC % kColGroups == 0, "columns must split over col groups");
  static_assert((B * B / PACK) % kThreads == 0, "matrix must split evenly");
};

template <int B, int RC, int PACK>
__global__ void __launch_bounds__(kThreads, 1)
fused_sweep_many_kernel(const uint32_t* __restrict__ F,
                        const uint32_t* __restrict__ Sinv,
                        const uint32_t* __restrict__ U,
                        const float* rhs, float* x, int nb, int r) {
  using C = Cfg<B, RC, PACK>;
  constexpr int LD = C::LD, TM = C::TM, TN = C::TN;
  extern __shared__ __align__(16) float smem[];
  float* Ms = smem;                       // [B][LD] current matrix, f32
  float* cur = Ms + B * LD;               // [RC][LD] step input, transposed
  float* nxt = cur + RC * LD;             // [RC][LD] step output

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups, cg = tid % kColGroups;
  const int c0 = blockIdx.y * RC;
  const size_t words = static_cast<size_t>(B) * B / PACK;
  const size_t part = static_cast<size_t>(blockIdx.x) * nb;
  F += part * words;
  Sinv += part * words;
  U += part * words;
  const size_t vrow = static_cast<size_t>(B) * r;   // one block row of vectors
  const float* rp = rhs + part * vrow;
  float* xp = x + part * vrow;

  // this thread's elements: row rg + 32 i, column c0 + cg + 8 j
  int off[TM][TN];
  bool valid[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) valid[j] = c0 + cg + kColGroups * j < r;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      off[i][j] = (rg + kRowGroups * i) * r + c0 + cg + kColGroups * j;

  // step s -> matrix: F_{s+1} for s < nb-1, Sinv_{nb-1} at s = nb-1, then
  // U_i, Sinv_i alternating for i = nb-2 .. 0 (as fused_sweep.cu)
  auto matrix = [&](int s) -> const uint32_t* {
    if (s < nb - 1) return F + (s + 1) * words;
    if (s == nb - 1) return Sinv + (nb - 1) * words;
    const int t = s - nb, i = nb - 2 - t / 2;
    return ((t & 1) ? Sinv : U) + i * words;
  };
  // the vector subtracted from the product (null: none)
  auto base_of = [&](int s) -> const float* {
    if (s < nb - 1) return rp + (s + 1) * vrow;          // r_i
    if (s == nb - 1) return nullptr;
    const int t = s - nb;
    return (t & 1) ? nullptr : xp + (nb - 2 - t / 2) * vrow;  // y_i
  };
  // where the step's result is stored in x (null: shared memory only)
  auto out_of = [&](int s) -> float* {
    if (s < nb - 1) return xp + (s + 1) * vrow;          // y_i
    if (s == nb - 1) return xp + (nb - 1) * vrow;        // x_{nb-1}
    const int t = s - nb;
    return (t & 1) ? xp + (nb - 2 - t / 2) * vrow : nullptr;  // x_i
  };

  uint32_t mreg[C::kWords];
  auto load_matrix = [&](const uint32_t* m) {
#pragma unroll
    for (int q = 0; q < C::kWords; ++q) mreg[q] = __ldg(m + tid + kThreads * q);
  };
  auto stage_matrix = [&]() {
#pragma unroll
    for (int q = 0; q < C::kWords; ++q) {
      const int e = (tid + kThreads * q) * PACK;
      float* dst = Ms + (e / B) * LD + e % B;
      if (PACK == 1) {
        *dst = __uint_as_float(mreg[q]);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(
            __uint_as_float(mreg[q] << 16),
            __uint_as_float(mreg[q] & 0xffff0000u));
      }
    }
  };
  float base[TM][TN], nbase[TM][TN];
  auto load_base = [&](float (&dst)[TM][TN], const float* v) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        dst[i][j] = (v && valid[j]) ? v[off[i][j]] : 0.0f;
  };

  // y_0 = r_0: the first step's input, kept in slot 0 for the backward sweep
  load_base(base, rp);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      cur[(cg + kColGroups * j) * LD + rg + kRowGroups * i] = base[i][j];
      if (valid[j]) xp[off[i][j]] = base[i][j];
    }
  load_matrix(matrix(0));
  load_base(base, base_of(0));
  stage_matrix();
  __syncthreads();

  const int steps = 3 * nb - 2;
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (more) {
      load_matrix(matrix(s + 1));
      load_base(nbase, base_of(s + 1));
    }
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < B; k += 4) {
      float4 a[TM], v[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            Ms + (rg + kRowGroups * i) * LD + k);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        v[j] = *reinterpret_cast<const float4*>(
            cur + (cg + kColGroups * j) * LD + k);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] = fmaf(a[i].x, v[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, v[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, v[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, v[j].w, acc[i][j]);
        }
    }
    const bool has_base = base_of(s) != nullptr;
    float* g = out_of(s);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float val = has_base ? base[i][j] - acc[i][j] : acc[i][j];
        nxt[(cg + kColGroups * j) * LD + rg + kRowGroups * i] = val;
        if (g && valid[j]) g[off[i][j]] = val;
      }
    __syncthreads();               // every read of Ms and cur is done
    if (more) {
      stage_matrix();
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) base[i][j] = nbase[i][j];
    }
    __syncthreads();               // the next matrix and nxt are in place
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <int B, int RC, int PACK>
int run(const void* F, const void* Sinv, const void* U, const void* r,
        void* x, int K, int nb, int nr, cudaStream_t stream) {
  auto kernel = fused_sweep_many_kernel<B, RC, PACK>;
  const size_t smem = Cfg<B, RC, PACK>::kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(K, (nr + RC - 1) / RC);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(F), static_cast<const uint32_t*>(Sinv),
      static_cast<const uint32_t*>(U), static_cast<const float*>(r),
      static_cast<float*>(x), nb, nr);
  return static_cast<int>(cudaGetLastError());
}

template <int PACK>
int launch(const void* F, const void* Sinv, const void* U, const void* r,
           void* x, int K, int nb, int b, int nr, void* stream) {
  if (K < 1 || nb < 1 || nr < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128) return run<128, kCols, PACK>(F, Sinv, U, r, x, K, nb, nr, s);
  if (b == 64) return run<64, kCols, PACK>(F, Sinv, U, r, x, K, nb, nr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int fused_sweep_many_f32(const void* F, const void* Sinv, const void* U,
                         const void* r, void* x, int K, int nb, int b, int nr,
                         void* stream) {
  return launch<1>(F, Sinv, U, r, x, K, nb, b, nr, stream);
}

int fused_sweep_many_bf16(const void* F, const void* Sinv, const void* U,
                          const void* r, void* x, int K, int nb, int b,
                          int nr, void* stream) {
  return launch<2>(F, Sinv, U, r, x, K, nb, b, nr, stream);
}

const char* fused_sweep_many_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
