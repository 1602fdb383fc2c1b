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
// sits on the critical path.  Two designs, chosen per call by the chunk plan
// C (``sweeps_chunks`` in ops/cuda/sweeps.py, its single source):
//
// C = 1, many partitions (the flagship, K = 64): fused_sweep.cu's design,
// split in two:
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
//
// C > 1, few long partitions (BASELINE config 1: K = 1, nb = 1563, b = 64):
// one block walking a partition leaves the other SMs idle and is bound by
// its chain of nb dependent steps, not by bytes.  Each sweep is an affine
// recurrence (forward y_i = r_i - F_i y_{i-1}; backward
// x_i = Sinv_i y_i - (Sinv_i U_i) x_{i+1}), and affine maps compose, so each
// partition is cut into C chunks of nb / C block rows, one block each, in
// one cooperative launch a sweep with two grid barriers:
//   1. every chunk but the one that starts the sweep (chunk 0 forward,
//      chunk C - 1 backward) runs its rows from a zero carry, keeping z (its
//      last row's value) and the propagator P = the product of its steps'
//      matrices (-F_i; -Sinv_i U_i): b x b x b products on the tensor cores
//      in 3xTF32 (mma.sync; f32 grade), the matrices streamed by cp.async
//      into padded rows; the starting chunk solves its rows outright;
//   2. the starting chunk's block chains the carries through its partition,
//      carry_next = z_c + P_c carry_c: C - 2 dependent matrix-vector steps;
//   3. every other chunk sweeps its rows again from its true carry and
//      writes y (x).
// The matrix-vector steps (phases 2 and 3, the starting chunk) read their
// matrices from a ring filled by bulk copies (TMA, one a matrix: ~120 GB/s
// into one SM against ~60 by cp.async) and take four lanes a row.  The
// matrices are read twice (phases 1 and 3); the critical path is
// ~nb / C products and ~nb / C + C matrix-vector steps, not nb steps.
// bf16 factors are promoted in registers (exact in TF32: two products, not
// three).  The result is the same function with another order of
// rounding: the propagators are the sensitivities the sequential sweep
// applies implicitly (on a Laplacian's LU factor they contract).  The
// workspace (P, z and the carry of each chunk) and the barrier counts
// come from the wrapper; the kernels allocate nothing.

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


// ---------------------------------------------------------------------------
// The chunked scan (C > 1)

namespace chunked {

constexpr int kSmemBudget = 227 * 1024;     // the most a block may have
// more than half of an SM's 228 KB: one block an SM, so that the K * C
// blocks of a launch spread over K * C SMs and share no SM
constexpr int kOneBlockPerSm = 116 * 1024;
constexpr int kMaxDepth = 4;

// per chunk in device memory: P [B][B], z [B], the carry in [B]
template <int B>
struct Work {
  static constexpr int kFloats = B * B + 2 * B;
  static constexpr int kZ = B * B, kCarry = B * B + B;
};

// chunk c of C covers block rows [start(c), start(c + 1)); none is empty
// when C <= nb (the plan's rule)
__device__ __forceinline__ int chunk_start(int c, int nb, int C) {
  return static_cast<int>(static_cast<long long>(c) * nb / C);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// this thread's earlier memory accesses (generic proxy) ordered before its
// later bulk copies (async proxy), in shared and device memory
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// every block of the grid has arrived ``target`` / gridDim.x times; the
// launch is cooperative, so all blocks are resident.  Data that another
// block wrote before the barrier is read after it from L2 (ld.global.cg,
// bulk copies), never through L1
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned seen = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen) : "l"(count) : "memory");
      if (seen >= target) break;
      __nanosleep(32);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// one arrival that also expects `bytes` of bulk-copy traffic this phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from device memory into shared memory, one
// bulk copy, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

struct Item {                 // a matrix and an f32 vector, either absent
  const uint32_t* mat;
  const float* vec;
};

// A ring of D shared-memory slots, each a b x b matrix and an f32 vector
// of b.  BULK = false: rows padded by 16 bytes (neighbouring rows 4 banks
// apart), filled by cp.async, one commit group an item; phase 1's products
// read it.  BULK = true: rows unpadded, an item one bulk copy of its
// matrix and one of its vector on the slot's mbarrier, issued by thread 0
// (a single SM streams at ~120 GB/s so, ~60 by cp.async); the
// matrix-vector steps read it.
template <int B, int PACK, int D, bool BULK>
struct Ring {
  static constexpr int kDepth = D;
  static constexpr bool kBulk = BULK;
  static constexpr int kW = B / PACK;          // 32-bit words of a row
  static constexpr int kLd = BULK ? kW : kW + 4;
  static constexpr int kMatWords = B * kLd;
  static constexpr int kSlotWords = kMatWords + B;
  uint32_t* base;
  uint64_t* bars;                              // kMaxDepth mbarriers

  __device__ uint32_t* slot(int j) const {
    return base + (j % D) * kSlotWords;
  }
  __device__ void issue(Item it, int j) const {
    uint32_t* s = slot(j);
    if constexpr (BULK) {
      const uint32_t bar = smem_u32(bars + j % D);
      const uint32_t mb = it.mat != nullptr ? kMatWords * 4 : 0;
      const uint32_t vb = it.vec != nullptr ? B * 4 : 0;
      mbar_expect(bar, mb + vb);
      if (mb != 0 && vb != 0 && it.vec == reinterpret_cast<const float*>(
                                              it.mat + kMatWords)) {
        bulk_copy(smem_u32(s), it.mat, mb + vb, bar);   // one piece (P, z)
        return;
      }
      if (mb != 0) bulk_copy(smem_u32(s), it.mat, mb, bar);
      if (vb != 0) bulk_copy(smem_u32(s + kMatWords), it.vec, vb, bar);
    } else {
      if (it.mat != nullptr) {
#pragma unroll 4
        for (int q = threadIdx.x; q < B * kW / 4; q += kThreads)
          cp_async16(s + (q / (kW / 4)) * kLd + (q % (kW / 4)) * 4,
                     it.mat + 4 * q);
      }
      if (it.vec != nullptr && threadIdx.x < B / 4)
        cp_async16(s + kMatWords + 4 * threadIdx.x, it.vec + 4 * threadIdx.x);
      cp_async_commit();
    }
  }
};

// Stream items 0 .. n-1 through the ring, D - 1 ahead of use: step(j, slot)
// runs once item j has landed and every thread is past step j - 1.  Ends
// with no copy in flight and the block synchronized.  `phases` holds the
// parity of each mbarrier's next phase (every bulk item is waited once).
template <class RingT, class ItemF, class StepF>
__device__ __forceinline__ void run_items(const RingT& ring, int n,
                                          ItemF item, StepF step,
                                          uint32_t& phases) {
  constexpr int D = RingT::kDepth;
  constexpr Item none{nullptr, nullptr};
  if constexpr (RingT::kBulk) {
    fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0)
      for (int j = 0; j < D - 1 && j < n; ++j) ring.issue(item(j), j);
  } else {
    for (int j = 0; j < D - 1; ++j) ring.issue(j < n ? item(j) : none, j);
  }
  for (int j = 0; j < n; ++j) {
    const int jn = j + D - 1;                 // into the slot of item j - 1
    if constexpr (RingT::kBulk) {
      const int k = j % D;
      mbar_wait(smem_u32(ring.bars + k), (phases >> k) & 1u);
      phases ^= 1u << k;
      __syncthreads();
      if (threadIdx.x == 0 && jn < n) ring.issue(item(jn), jn);
    } else {
      cp_async_wait<D - 2>();
      __syncthreads();
      ring.issue(jn < n ? item(jn) : none, jn);
    }
    step(j, static_cast<const uint32_t*>(ring.slot(j)));
  }
  if constexpr (!RingT::kBulk) cp_async_wait<0>();
  __syncthreads();
}

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// (A v)[row] for this thread's rows, row = threadIdx.x / 4 + 64 k: four
// neighbouring lanes share a row, lane q taking the 16-byte groups g = q
// (mod 4) of it, two partial sums each, and two shuffles add the four
// (every lane of the four holds the row's value).  On unpadded rows (LD =
// the row's words, a multiple of 32 banks) each row takes its groups in an
// order rotated by the row, so that the eight rows of a warp spread over
// all banks
template <int B, int PACK, int LD>
__device__ __forceinline__ void matvec(const uint32_t* A, const float* v,
                                       float (&out)[B / 64]) {
  constexpr int kJ = B / PACK / 16;            // groups a lane takes
  constexpr bool kRotate = LD == B / PACK;
  static_assert(kJ % 2 == 0, "the rotation needs an even count");
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < B / 64; ++k) {
    const int row = (threadIdx.x >> 2) + 64 * k;
    const uint32_t* a = A + row * LD;
    float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int g = q + 4 * (kRotate ? (row + j) % kJ : j);
      if constexpr (PACK == 1) {
        const float4 m = *reinterpret_cast<const float4*>(a + 4 * g);
        const float4 x = *reinterpret_cast<const float4*>(v + 4 * g);
        acc0 = fmaf(m.x, x.x, acc0);
        acc1 = fmaf(m.y, x.y, acc1);
        acc0 = fmaf(m.z, x.z, acc0);
        acc1 = fmaf(m.w, x.w, acc1);
      } else {
        const uint4 m = *reinterpret_cast<const uint4*>(a + 4 * g);
        const float4 x0 = *reinterpret_cast<const float4*>(v + 8 * g);
        const float4 x1 = *reinterpret_cast<const float4*>(v + 8 * g + 4);
        acc0 = fmaf(lo_bf16(m.x), x0.x, acc0);
        acc1 = fmaf(hi_bf16(m.x), x0.y, acc1);
        acc0 = fmaf(lo_bf16(m.y), x0.z, acc0);
        acc1 = fmaf(hi_bf16(m.y), x0.w, acc1);
        acc0 = fmaf(lo_bf16(m.z), x1.x, acc0);
        acc1 = fmaf(hi_bf16(m.z), x1.y, acc1);
        acc0 = fmaf(lo_bf16(m.w), x1.z, acc0);
        acc1 = fmaf(hi_bf16(m.w), x1.w, acc1);
      }
    }
    float acc = acc0 + acc1;
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    out[k] = acc;
  }
}

// the nearest TF32 value (ties away from zero) of x, as cvt.rna.tf32.f32
// gives it: half a TF32 unit added to the magnitude, 13 bits cleared
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a b, a 16 x 8 TF32 fragment, b 8 x 8, d 16 x 8 f32
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element (r, c) of a matrix stored with a row stride of LD words
template <int PACK, int LD>
__device__ __forceinline__ float element_at(const uint32_t* A, int r,
                                            int c) {
  if constexpr (PACK == 1) return __uint_as_float(A[r * LD + c]);
  const uint32_t w = A[r * LD + c / 2];
  return (c & 1) ? hi_bf16(w) : lo_bf16(w);
}

// The phase-1 product's tiles: M is f32 [B][B + 8] (the B-fragment loads
// of a warp then hit 32 distinct banks); warp w owns rows 16 (MT (w % 4) +
// mt) + [0, 16) and columns 8 (NT (w / 4) + nt) + [0, 8)
template <int B>
struct Tiles {
  static constexpr int kLdm = B + 8;
  static constexpr int kMt = B / 64, kNt = B / 16;
};

// acc = A M on the tensor cores at f32 grade: each operand split into TF32
// parts, hi + lo, and hi hi + hi lo + lo hi summed in f32 (lo lo is below
// f32's rounding); a bf16 A is exact in TF32, so its lo is 0 and two
// products do
template <int B, int PACK>
__device__ __forceinline__ void matmul(
    const uint32_t* A, const float* M,
    float (&acc)[Tiles<B>::kMt][Tiles<B>::kNt][4]) {
  constexpr int LD = Ring<B, PACK, 1, false>::kLd, LDM = Tiles<B>::kLdm;
  constexpr int MT = Tiles<B>::kMt, NT = Tiles<B>::kNt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * MT * (warp & 3), c0 = 8 * NT * (warp >> 2);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < B; k += 8) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = r0 + 16 * mt + g;
      const float a[4] = {element_at<PACK, LD>(A, r, k + t),
                          element_at<PACK, LD>(A, r + 8, k + t),
                          element_at<PACK, LD>(A, r, k + 4 + t),
                          element_at<PACK, LD>(A, r + 8, k + 4 + t)};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[mt][e] = tf32(a[e]);
        al[mt][e] = tf32(a[e] - __uint_as_float(ah[mt][e]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float b0 = M[(k + t) * LDM + c0 + 8 * nt + g];
      const float b1 = M[(k + 4 + t) * LDM + c0 + 8 * nt + g];
      const uint32_t bh0 = tf32(b0), bh1 = tf32(b1);
      const uint32_t bl0 = tf32(b0 - __uint_as_float(bh0));
      const uint32_t bl1 = tf32(b1 - __uint_as_float(bh1));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (PACK == 1) mma(acc[mt][nt], al[mt], bh0, bh1);
        mma(acc[mt][nt], ah[mt], bl0, bl1);
        mma(acc[mt][nt], ah[mt], bh0, bh1);
      }
    }
  }
}

template <int B>
__device__ __forceinline__ void store_tiles(
    float* M, const float (&acc)[Tiles<B>::kMt][Tiles<B>::kNt][4], float s) {
  constexpr int LDM = Tiles<B>::kLdm, MT = Tiles<B>::kMt, NT = Tiles<B>::kNt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * MT * (warp & 3), c0 = 8 * NT * (warp >> 2);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* d = M + (r0 + 16 * mt + g) * LDM + c0 + 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(d) =
          make_float2(s * acc[mt][nt][0], s * acc[mt][nt][1]);
      *reinterpret_cast<float2*>(d + 8 * LDM) =
          make_float2(s * acc[mt][nt][2], s * acc[mt][nt][3]);
    }
}

// a step of a sweep: next = vec + s A prev (a missing matrix or vector is
// 0), from a slot of the bulk ring; the first lane of each four writes its
// rows to next and, where out is given, to device memory
template <int B, int PACK>
__device__ __forceinline__ void vstep(const uint32_t* slot, bool has_mat,
                                      bool has_vec, float s, const float* prev,
                                      float* next, float* out) {
  using R = Ring<B, PACK, 1, true>;
  const float* vec = reinterpret_cast<const float*>(slot + R::kMatWords);
  float o[B / 64];
#pragma unroll
  for (int k = 0; k < B / 64; ++k) o[k] = 0.0f;
  if (has_mat) matvec<B, PACK, R::kLd>(slot, prev, o);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int k = 0; k < B / 64; ++k) {
      const int row = (threadIdx.x >> 2) + 64 * k;
      const float v = (has_vec ? vec[row] : 0.0f) + s * o[k];
      next[row] = v;
      if (out != nullptr) out[row] = v;
    }
  }
}

// a step of phase 1, from a slot of the copy ring: M <- sm A M and
// z_next = vec + sz A z; the first step of a chunk (M = I and z = 0 before
// it) sets M <- sm A, z_next = vec
template <int B, int PACK>
__device__ __forceinline__ void mstep(const uint32_t* slot, bool first,
                                      bool has_vec, float sm, float sz,
                                      float* M, const float* z, float* znext) {
  using R = Ring<B, PACK, 1, false>;
  constexpr int LDM = Tiles<B>::kLdm;
  const float* vec = reinterpret_cast<const float*>(slot + R::kMatWords);
  if (first) {
    for (int i = threadIdx.x; i < B * B / 4; i += kThreads) {
      const int r = 4 * i / B, c = 4 * i % B;
      float a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[e] = element_at<PACK, R::kLd>(slot, r, c + e);
      *reinterpret_cast<float4*>(M + r * LDM + c) =
          make_float4(sm * a[0], sm * a[1], sm * a[2], sm * a[3]);
    }
    if (threadIdx.x < B)
      znext[threadIdx.x] = has_vec ? vec[threadIdx.x] : 0.0f;
    return;
  }
  float acc[Tiles<B>::kMt][Tiles<B>::kNt][4];
  matmul<B, PACK>(slot, M, acc);
  float o[B / 64];
  matvec<B, PACK, R::kLd>(slot, z, o);
  __syncthreads();                           // every thread has read M
  store_tiles<B>(M, acc, sm);
  if ((threadIdx.x & 3) == 0) {
#pragma unroll
    for (int k = 0; k < B / 64; ++k) {
      const int row = (threadIdx.x >> 2) + 64 * k;
      znext[row] = (has_vec ? vec[row] : 0.0f) + sz * o[k];
    }
  }
}

// P_c (from M's padded rows) and z_c of a chunk to device memory
template <int B>
__device__ __forceinline__ void save(float* w, const float* M,
                                     const float* z) {
  for (int i = threadIdx.x; i < B * B / 4; i += kThreads) {
    const int r = 4 * i / B, c = 4 * i % B;
    reinterpret_cast<float4*>(w)[i] =
        *reinterpret_cast<const float4*>(M + r * Tiles<B>::kLdm + c);
  }
  if (threadIdx.x < B) w[Work<B>::kZ + threadIdx.x] = z[threadIdx.x];
}

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Shared memory: [the copy ring | M | the carry [2][B] | the mbarriers];
// the bulk rings of the sweeps and of the chain reuse [copy ring | M]
template <int B, int PACK>
struct Geo {
  static constexpr int kMWords = B * Tiles<B>::kLdm;
  static constexpr int kTailWords = 2 * B + 2 * kMaxDepth;
  static constexpr int kDepth = cmin(
      kMaxDepth, (kSmemBudget - (kMWords + kTailWords) * 4) /
                     (Ring<B, PACK, 1, false>::kSlotWords * 4));
  static constexpr int kArea =
      kDepth * Ring<B, PACK, 1, false>::kSlotWords + kMWords;
  static constexpr int kSweepDepth =
      cmin(kMaxDepth, kArea / Ring<B, PACK, 1, true>::kSlotWords);
  static constexpr int kChainDepth =
      cmin(kMaxDepth, kArea / Ring<B, 1, 1, true>::kSlotWords);
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kArea + kTailWords) * 4;
  static constexpr size_t kLaunchSmem =
      kSmemBytes > kOneBlockPerSm ? kSmemBytes : kOneBlockPerSm;
  static_assert(kDepth >= 2 && kSweepDepth >= 2 && kChainDepth >= 2,
                "rings need two slots");
  static_assert(kLaunchSmem <= kSmemBudget, "shared memory");
  static_assert(B % 64 == 0, "four lanes a row, 64 rows a pass");
};

// the block's pieces of shared memory
template <int B, int PACK>
struct Smem {
  using G = Geo<B, PACK>;
  Ring<B, PACK, G::kDepth, false> ring;        // phase 1's products
  Ring<B, PACK, G::kSweepDepth, true> sweep;   // the sweeps' steps
  Ring<B, 1, G::kChainDepth, true> chain;      // phase 2
  float* M;
  float* vec;                                  // [2][B], double-buffered

  __device__ explicit Smem(unsigned char* raw) {
    uint32_t* sm = reinterpret_cast<uint32_t*>(raw);
    M = reinterpret_cast<float*>(sm + G::kArea - G::kMWords);
    vec = reinterpret_cast<float*>(sm + G::kArea);
    uint64_t* bars = reinterpret_cast<uint64_t*>(vec + 2 * B);
    ring = {sm, bars};
    sweep = {sm, bars};
    chain = {sm, bars};
    if (threadIdx.x < kMaxDepth) mbar_init(smem_u32(bars + threadIdx.x), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
  }
};

template <int B, int PACK>
__global__ void __launch_bounds__(kThreads, 1)
chunked_fwd_kernel(const uint32_t* __restrict__ F, const float* __restrict__ r,
                   float* __restrict__ y, int nb, int C,
                   float* __restrict__ work, unsigned* __restrict__ bar) {
  using W = Work<B>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<B, PACK> sh(smem_raw);
  float* M = sh.M;
  float* vec = sh.vec;
  const int part = blockIdx.x / C, c = blockIdx.x % C;
  const size_t words = static_cast<size_t>(B) * B / PACK;
  F += static_cast<size_t>(part) * nb * words;
  r += static_cast<size_t>(part) * nb * B;
  y += static_cast<size_t>(part) * nb * B;
  float* wp = work + static_cast<size_t>(part) * C * W::kFloats;
  const int s = chunk_start(c, nb, C), e = chunk_start(c + 1, nb, C);
  // row i: F_i (not read for i = 0: y_0 = r_0) and r_i
  auto item = [&](int j) {
    const int i = s + j;
    return Item{i > 0 ? F + i * words : nullptr,
                r + static_cast<size_t>(i) * B};
  };
  uint32_t phases = 0;
  int p = 0;
  auto sweep = [&](int j, const uint32_t* sl) {       // y_i = r_i - F_i y
    const int i = s + j;
    vstep<B, PACK>(sl, i > 0, true, -1.0f, vec + p * B, vec + (1 - p) * B,
                   y + static_cast<size_t>(i) * B);
    p ^= 1;
  };

  // phase 1: chunk 0 solves its rows; the others propagate from a zero
  // carry (z = their last row's y, P = the product of -F_i)
  if (c == 0) {
    run_items(sh.sweep, e - s, item, sweep, phases);
  } else {
    run_items(sh.ring, e - s, item, [&](int j, const uint32_t* sl) {
      mstep<B, PACK>(sl, j == 0, true, -1.0f, -1.0f, M, vec + p * B,
                     vec + (1 - p) * B);
      p ^= 1;
    }, phases);
    save<B>(wp + c * W::kFloats, M, vec + p * B);
  }
  grid_barrier(bar, gridDim.x);

  // phase 2: chunk 0's block chains the carries, carry_1 = y_{e_0 - 1},
  // carry_{c+1} = z_c + P_c carry_c
  if (c == 0) {
    if (threadIdx.x < B)
      wp[W::kFloats + W::kCarry + threadIdx.x] = vec[p * B + threadIdx.x];
    run_items(sh.chain, C - 2,
              [&](int j) {
                const float* w = wp + (1 + j) * W::kFloats;
                return Item{reinterpret_cast<const uint32_t*>(w), w + W::kZ};
              },
              [&](int j, const uint32_t* sl) {
                vstep<B, 1>(sl, true, true, 1.0f, vec + p * B,
                            vec + (1 - p) * B,
                            wp + (2 + j) * W::kFloats + W::kCarry);
                p ^= 1;
              },
              phases);
  }
  grid_barrier(bar, 2 * gridDim.x);

  // phase 3: the other chunks sweep their rows again from their carry
  if (c > 0) {
    p = 0;
    if (threadIdx.x < B)
      vec[threadIdx.x] = __ldcg(wp + c * W::kFloats + W::kCarry + threadIdx.x);
    run_items(sh.sweep, e - s, item, sweep, phases);
  }
}

template <int B, int PACK>
__global__ void __launch_bounds__(kThreads, 1)
chunked_bwd_kernel(const uint32_t* __restrict__ Sinv,
                   const uint32_t* __restrict__ U, const float* __restrict__ y,
                   float* __restrict__ x, int nb, int C,
                   float* __restrict__ work, unsigned* __restrict__ bar) {
  using W = Work<B>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<B, PACK> sh(smem_raw);
  float* M = sh.M;
  float* vec = sh.vec;
  const int part = blockIdx.x / C, c = blockIdx.x % C;
  const size_t words = static_cast<size_t>(B) * B / PACK;
  Sinv += static_cast<size_t>(part) * nb * words;
  U += static_cast<size_t>(part) * nb * words;
  y += static_cast<size_t>(part) * nb * B;
  x += static_cast<size_t>(part) * nb * B;
  float* wp = work + static_cast<size_t>(part) * C * W::kFloats;
  const int s = chunk_start(c, nb, C), e = chunk_start(c + 1, nb, C);
  const int n = 2 * (e - s);
  // rows e-1 .. s, two items each: U_i with y_i (no U at i = nb - 1), then
  // Sinv_i
  auto item = [&](int j) {
    const int i = e - 1 - j / 2;
    if (j & 1) return Item{Sinv + i * words, nullptr};
    return Item{i < nb - 1 ? U + i * words : nullptr,
                y + static_cast<size_t>(i) * B};
  };
  uint32_t phases = 0;
  int p = 0;
  auto sweep = [&](int j, const uint32_t* sl) {
    const int i = e - 1 - j / 2;
    if (j & 1)                                 // x_i = Sinv_i t_i
      vstep<B, PACK>(sl, true, false, 1.0f, vec + p * B, vec + (1 - p) * B,
                     x + static_cast<size_t>(i) * B);
    else                                       // t_i = y_i - U_i x_{i+1}
      vstep<B, PACK>(sl, i < nb - 1, true, -1.0f, vec + p * B,
                     vec + (1 - p) * B, nullptr);
    p ^= 1;
  };

  // phase 1: chunk C - 1 solves its rows; the others propagate from a zero
  // carry (z = x_s, P = the product of -Sinv_i U_i)
  if (c == C - 1) {
    run_items(sh.sweep, n, item, sweep, phases);
  } else {
    run_items(sh.ring, n, item, [&](int j, const uint32_t* sl) {
      if (j & 1)                               // M <- -Sinv M, z <- Sinv z
        mstep<B, PACK>(sl, false, false, -1.0f, 1.0f, M, vec + p * B,
                       vec + (1 - p) * B);
      else                                     // M <- U M, z <- y - U z
        mstep<B, PACK>(sl, j == 0, true, 1.0f, -1.0f, M, vec + p * B,
                       vec + (1 - p) * B);
      p ^= 1;
    }, phases);
    save<B>(wp + c * W::kFloats, M, vec + p * B);
  }
  grid_barrier(bar, gridDim.x);

  // phase 2: chunk C - 1's block chains the carries down,
  // carry_{C-2} = x_{s_{C-1}}, carry_{c-1} = z_c + P_c carry_c
  if (c == C - 1) {
    if (threadIdx.x < B)
      wp[(C - 2) * W::kFloats + W::kCarry + threadIdx.x] =
          vec[p * B + threadIdx.x];
    run_items(sh.chain, C - 2,
              [&](int j) {
                const float* w = wp + (C - 2 - j) * W::kFloats;
                return Item{reinterpret_cast<const uint32_t*>(w), w + W::kZ};
              },
              [&](int j, const uint32_t* sl) {
                vstep<B, 1>(sl, true, true, 1.0f, vec + p * B,
                            vec + (1 - p) * B,
                            wp + (C - 3 - j) * W::kFloats + W::kCarry);
                p ^= 1;
              },
              phases);
  }
  grid_barrier(bar, 2 * gridDim.x);

  // phase 3: the other chunks sweep their rows again from their carry
  if (c < C - 1) {
    p = 0;
    if (threadIdx.x < B)
      vec[threadIdx.x] = __ldcg(wp + c * W::kFloats + W::kCarry + threadIdx.x);
    run_items(sh.sweep, n, item, sweep, phases);
  }
}

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int blocks, void** args,
           cudaStream_t stream) {
  const int err = prepare(kernel, smem);
  if (err != 0) return err;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(kThreads),
      args, smem, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int B, int PACK>
int run_fwd(const void* F, const void* r, void* y, int K, int nb, int C,
            void* work, void* bar, cudaStream_t stream) {
  const uint32_t* f = static_cast<const uint32_t*>(F);
  const float* rr = static_cast<const float*>(r);
  float* yy = static_cast<float*>(y);
  float* w = static_cast<float*>(work);
  unsigned* b = static_cast<unsigned*>(bar);
  void* args[] = {&f, &rr, &yy, &nb, &C, &w, &b};
  return launch(chunked_fwd_kernel<B, PACK>, Geo<B, PACK>::kLaunchSmem,
                K * C, args, stream);
}

template <int B, int PACK>
int run_bwd(const void* Sinv, const void* U, const void* y, void* x, int K,
            int nb, int C, void* work, void* bar, cudaStream_t stream) {
  const uint32_t* si = static_cast<const uint32_t*>(Sinv);
  const uint32_t* u = static_cast<const uint32_t*>(U);
  const float* yy = static_cast<const float*>(y);
  float* xx = static_cast<float*>(x);
  float* w = static_cast<float*>(work);
  unsigned* b = static_cast<unsigned*>(bar);
  void* args[] = {&si, &u, &yy, &xx, &nb, &C, &w, &b};
  return launch(chunked_bwd_kernel<B, PACK>, Geo<B, PACK>::kLaunchSmem,
                K * C, args, stream);
}

template <int PACK>
int fwd(const void* F, const void* r, void* y, int K, int nb, int b, int C,
        void* work, void* bar, void* stream) {
  if (K < 1 || C < 2 || C > nb) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128) return run_fwd<128, PACK>(F, r, y, K, nb, C, work, bar, s);
  if (b == 64) return run_fwd<64, PACK>(F, r, y, K, nb, C, work, bar, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int PACK>
int bwd(const void* Sinv, const void* U, const void* y, void* x, int K,
        int nb, int b, int C, void* work, void* bar, void* stream) {
  if (K < 1 || C < 2 || C > nb) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128)
    return run_bwd<128, PACK>(Sinv, U, y, x, K, nb, C, work, bar, s);
  if (b == 64) return run_bwd<64, PACK>(Sinv, U, y, x, K, nb, C, work, bar, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace chunked

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

int sweeps_chunked_fwd_f32(const void* F, const void* r, void* y, int K,
                           int nb, int b, int C, void* work, void* bar,
                           void* stream) {
  return chunked::fwd<1>(F, r, y, K, nb, b, C, work, bar, stream);
}

int sweeps_chunked_fwd_bf16(const void* F, const void* r, void* y, int K,
                            int nb, int b, int C, void* work, void* bar,
                            void* stream) {
  return chunked::fwd<2>(F, r, y, K, nb, b, C, work, bar, stream);
}

int sweeps_chunked_bwd_f32(const void* Sinv, const void* U, const void* y,
                           void* x, int K, int nb, int b, int C, void* work,
                           void* bar, void* stream) {
  return chunked::bwd<1>(Sinv, U, y, x, K, nb, b, C, work, bar, stream);
}

int sweeps_chunked_bwd_bf16(const void* Sinv, const void* U, const void* y,
                            void* x, int K, int nb, int b, int C, void* work,
                            void* bar, void* stream) {
  return chunked::bwd<2>(Sinv, U, y, x, K, nb, b, C, work, bar, stream);
}

const char* sweeps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
