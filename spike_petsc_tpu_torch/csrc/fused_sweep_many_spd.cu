// Multi-RHS fused block-Thomas solve for method='spd' factors (symmetric
// block-LDL^T, F and Sinv stored, no U), both sweeps in one kernel, for r
// right-hand sides at once:
//   forward   y_0 = r_0,  y_i = r_i - F_i y_{i-1}
//   backward  x_{nb-1} = Sinv_{nb-1} y_{nb-1},
//             x_i = Sinv_i y_i - F_{i+1}^T x_{i+1}
// over K independent partitions.  F/Sinv are [K, nb, b, b] row-major; the
// right-hand sides and the solution are [K, nb, b, r] row-major (the
// caller's layout).
//
// Replaces the Pallas kernel `_fused_kernel_many_spd` of
// spike_petsc_tpu/ops/pallas/fused_sweep.py (reached through
// `blocktri_solve_fused_many_pallas` on spd factors).
//
// Bound: latency.  At K = 16, nb = 977, b = 64, r = 32 the work is
// 3 * nb - 2 = 2929 dependent steps of a 64 x 64 by 64 x 16 product per
// block, on 32 blocks.  The bytes (F and Sinv once, 512 MB in f32, and the
// vectors, 256 MB) take about 0.23 ms at the card's memory rate and the
// 12.3 GFLOP of f32 FMA about 0.18 ms at its f32 rate; the chain of steps,
// each a staged matrix and two barriers, takes far longer.
// The structure is fused_sweep_many.cu's, with the transposed step:
//   * grid (K, ceil(r / 16)): one block per partition and chunk of 16
//     columns;
//   * y goes through the output buffer: the forward sweep writes y_i into
//     slot i, the backward sweep reads slot i and overwrites it with x_i;
//   * the sweeps are one stream of 3*nb - 2 matrix steps: F_1 .. F_{nb-1},
//     Sinv_{nb-1}, then for i = nb-2 .. 0 an "S" step u = Sinv_i y_i (its
//     input tile is y_i, read back from slot i; its result stays in
//     registers) and a "T" step x_i = u - F_{i+1}^T x_{i+1};
//   * the b x b matrix of the current step sits in shared memory as f32
//     (row stride b + 4); F_{i+1} of a T step is staged transposed, so the
//     FMA tile loop is the same for every step.  The next step's matrix
//     and vector are loaded into registers while the current step computes;
//   * the vector tiles [b, 16] sit in shared memory transposed,
//     [16][b + 4]; each thread owns TM = b/32 rows x TN = 2 columns of the
//     output and runs f32 FMAs over float4 reads of both operands;
//   * bf16 factors are promoted to f32 when staged.  No TF32 and no bf16
//     rounding of the carry: the carry is f32 end to end.

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
  // matrix [B][LD], then three vector tiles [RC][LD]: cur, nxt, yin
  static constexpr size_t kSmemFloats =
      static_cast<size_t>(B) * LD + 3 * static_cast<size_t>(RC) * LD;
  static_assert(B % kRowGroups == 0, "rows must split over row groups");
  static_assert(RC % kColGroups == 0, "columns must split over col groups");
  static_assert((B * B / PACK) % kThreads == 0, "matrix must split evenly");
};

// step kinds: forward, the last block, S (Sinv_i y_i), T (F_{i+1}^T x)
enum Kind { kFwd, kLast, kS, kT };

template <int B, int RC, int PACK>
__global__ void __launch_bounds__(kThreads, 1)
fused_sweep_many_spd_kernel(const uint32_t* __restrict__ F,
                            const uint32_t* __restrict__ Sinv,
                            const float* rhs, float* x, int nb, int r) {
  using C = Cfg<B, RC, PACK>;
  constexpr int LD = C::LD, TM = C::TM, TN = C::TN;
  extern __shared__ __align__(16) float smem[];
  float* Ms = smem;                       // [B][LD] current matrix, f32
  float* cur = Ms + B * LD;               // [RC][LD] carry, transposed
  float* nxt = cur + RC * LD;             // [RC][LD] step output
  float* yin = nxt + RC * LD;             // [RC][LD] y_i of an S step

  const int tid = threadIdx.x;
  const int rg = tid / kColGroups, cg = tid % kColGroups;
  const int c0 = blockIdx.y * RC;
  const size_t words = static_cast<size_t>(B) * B / PACK;
  const size_t part = static_cast<size_t>(blockIdx.x) * nb;
  F += part * words;
  Sinv += part * words;
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

  // step s: F_{s+1} for s < nb-1, Sinv_{nb-1} at s = nb-1, then for
  // t = s - nb: Sinv_i (S, even t) and F_{i+1} (T, odd t), i = nb-2-t/2
  auto kind = [&](int s) -> Kind {
    if (s < nb - 1) return kFwd;
    if (s == nb - 1) return kLast;
    return ((s - nb) & 1) ? kT : kS;
  };
  auto block_of = [&](int s) -> int {   // the block row i the step writes
    if (s < nb - 1) return s + 1;
    if (s == nb - 1) return nb - 1;
    return nb - 2 - (s - nb) / 2;
  };
  auto matrix = [&](int s) -> const uint32_t* {
    const int i = block_of(s);
    switch (kind(s)) {
      case kFwd: return F + i * words;
      case kT: return F + (i + 1) * words;
      default: return Sinv + i * words;
    }
  };

  uint32_t mreg[C::kWords];
  auto load_matrix = [&](const uint32_t* m) {
#pragma unroll
    for (int q = 0; q < C::kWords; ++q) mreg[q] = __ldg(m + tid + kThreads * q);
  };
  // mreg -> Ms as f32, transposed for a T step
  auto stage_matrix = [&](bool transposed) {
#pragma unroll
    for (int q = 0; q < C::kWords; ++q) {
      const int e = (tid + kThreads * q) * PACK;
      const int row = e / B, col = e % B;
      float v[PACK];
      if (PACK == 1) {
        v[0] = __uint_as_float(mreg[q]);
      } else {
        v[0] = __uint_as_float(mreg[q] << 16);
        v[PACK - 1] = __uint_as_float(mreg[q] & 0xffff0000u);
      }
#pragma unroll
      for (int h = 0; h < PACK; ++h) {
        if (transposed)
          Ms[(col + h) * LD + row] = v[h];
        else
          Ms[row * LD + col + h] = v[h];
      }
    }
  };
  float base[TM][TN], nbase[TM][TN];
  auto load_vec = [&](float (&dst)[TM][TN], const float* v) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        dst[i][j] = (v && valid[j]) ? v[off[i][j]] : 0.0f;
  };
  auto to_tile = [&](float* tile, const float (&src)[TM][TN]) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        tile[(cg + kColGroups * j) * LD + rg + kRowGroups * i] = src[i][j];
  };
  // the vector a step needs from device memory, loaded one step ahead: r_i
  // (forward: subtracted from the product) or y_i (S: the product's input)
  auto vec_of = [&](int s) -> const float* {
    const Kind k = kind(s);
    if (k == kFwd) return rp + block_of(s) * vrow;
    if (k == kS) return xp + block_of(s) * vrow;
    return nullptr;
  };

  // y_0 = r_0: the first step's input, kept in slot 0 for the backward sweep
  load_vec(base, rp);
  to_tile(cur, base);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      if (valid[j]) xp[off[i][j]] = base[i][j];
  load_matrix(matrix(0));
  load_vec(base, vec_of(0));
  stage_matrix(kind(0) == kT);
  if (kind(0) == kS) to_tile(yin, base);
  __syncthreads();

  const int steps = 3 * nb - 2;
  for (int s = 0; s < steps; ++s) {
    const Kind k = kind(s);
    const bool more = s + 1 < steps;
    if (more) {
      load_matrix(matrix(s + 1));
      if (kind(s + 1) != kT) load_vec(nbase, vec_of(s + 1));
    }
    const float* in = k == kS ? yin : cur;
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < B; kk += 4) {
      float4 a[TM], v[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            Ms + (rg + kRowGroups * i) * LD + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        v[j] = *reinterpret_cast<const float4*>(
            in + (cg + kColGroups * j) * LD + kk);
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
    if (k == kS) {
      // u = Sinv_i y_i: the next (T) step's base, kept in registers
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) nbase[i][j] = acc[i][j];
    } else {
      // forward: r_i - F_i y_{i-1}; last: Sinv y; T: u - F_{i+1}^T x_{i+1}
      const bool has_base = k != kLast;
      float* g = xp + block_of(s) * vrow;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const float val = has_base ? base[i][j] - acc[i][j] : acc[i][j];
          nxt[(cg + kColGroups * j) * LD + rg + kRowGroups * i] = val;
          if (valid[j]) g[off[i][j]] = val;
        }
    }
    __syncthreads();               // every read of Ms, cur and yin is done
    if (more) {
      const Kind kn = kind(s + 1);
      stage_matrix(kn == kT);
      if (kn == kS) to_tile(yin, nbase);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) base[i][j] = nbase[i][j];
    }
    __syncthreads();               // the next matrix, yin and nxt are in place
    if (k != kS) {
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
}

template <int B, int RC, int PACK>
int run(const void* F, const void* Sinv, const void* r, void* x, int K,
        int nb, int nr, cudaStream_t stream) {
  auto kernel = fused_sweep_many_spd_kernel<B, RC, PACK>;
  const size_t smem = Cfg<B, RC, PACK>::kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(K, (nr + RC - 1) / RC);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(F), static_cast<const uint32_t*>(Sinv),
      static_cast<const float*>(r), static_cast<float*>(x), nb, nr);
  return static_cast<int>(cudaGetLastError());
}

template <int PACK>
int launch(const void* F, const void* Sinv, const void* r, void* x, int K,
           int nb, int b, int nr, void* stream) {
  if (K < 1 || nb < 1 || nr < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128) return run<128, kCols, PACK>(F, Sinv, r, x, K, nb, nr, s);
  if (b == 64) return run<64, kCols, PACK>(F, Sinv, r, x, K, nb, nr, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int fused_sweep_many_spd_f32(const void* F, const void* Sinv, const void* r,
                             void* x, int K, int nb, int b, int nr,
                             void* stream) {
  return launch<1>(F, Sinv, r, x, K, nb, b, nr, stream);
}

int fused_sweep_many_spd_bf16(const void* F, const void* Sinv, const void* r,
                              void* x, int K, int nb, int b, int nr,
                              void* stream) {
  return launch<2>(F, Sinv, r, x, K, nb, b, nr, stream);
}

const char* fused_sweep_many_spd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
