// Multi-RHS fused block-Thomas solve for method='inv' factors, both sweeps in
// one kernel, for r right-hand sides at once:
//   forward   y_0 = r_0,  y_i = r_i - F_i y_{i-1}
//   backward  x_{nb-1} = Sinv_{nb-1} y_{nb-1},  x_i = Sinv_i (y_i - U_i x_{i+1})
// over K independent partitions.  F/Sinv/U are [K, nb, b, b] row-major, f32
// or bf16, 16-byte aligned; the right-hand sides and the solution are
// [K, nb, b, r] row-major f32 (the caller's layout), r a multiple of 32 and
// both 16-byte aligned (the wrapper pads other r with zero columns).
//
// Replaces the Pallas kernel `_fused_kernel_many` of
// spike_petsc_tpu/ops/pallas/fused_sweep.py (reached through
// `blocktri_solve_fused_many_pallas`).
//
// Bound at the flagship (K = 64, nb = 123, b = 128, r = 32): bytes.  F, Sinv
// and U are 1.55 GB in f32 (half with bf16 factors), 0.46 ms at the card's
// 3.35 TB/s, and each partition is a chain of 3 nb - 2 dependent matrix
// steps: ~1.25 us of bytes a step for one partition's share of the memory
// rate.  The products, 128 x 128 by 128 x 32 a step, take ~1.3 us a step
// as f32 FMAs on the CUDA cores of two SMs, so they go to the tensor cores.
// Measured on the H100 (PERF.md): ~1.9 us a step in f32, ~1.5 in bf16,
// set by the chain of a step inside the SM (fragment loads, mma, the
// epilogue's stores, the barrier), not by the bytes: the kernel reading one
// matrix from L2 every step took as long.  wgmma in place of mma.sync (A
// from registers, B from shared memory) was 15% slower in f32.
// Design:
//   * a thread block cluster of 2 blocks takes one (partition, 32 columns);
//     each block computes 16 of the columns.  Both need every matrix of the
//     partition, so each block loads half the rows of each matrix with TMA
//     and multicasts them to both: each matrix leaves L2 once a partition;
//   * one producer warp keeps a ring of whole matrices in shared memory
//     filled (128-byte column slabs of b rows, swizzled 128B by the TMA),
//     with a full and an empty mbarrier a slot.  A slot's empty barrier
//     counts the consumer warps of both blocks, since either block's
//     producer writes into both;
//   * the products run as mma.sync m16n8k8 TF32 with f32 accuracy: 3xTF32
//     for f32 factors (A_hi v_hi + A_hi v_lo + A_lo v_hi, the split done in
//     registers, rounding to nearest), 2xTF32 for bf16 factors (exact in
//     TF32: A v_hi + A v_lo).  One pass of TF32 keeps ~3 digits and is not
//     used;
//   * each of b / 16 consumer warps owns 16 rows of every output; its A
//     fragments come from the swizzled slabs by ldmatrix (conflict-free:
//     the 16-byte chunk index XOR row % 8), into a chain of accumulators
//     for each TF32 product and parity of the k step;
//   * the vector (the last y or x, b x 16) sits in shared memory already
//     split into TF32 hi and lo parts, laid out as the B fragments of the
//     next step (one 16-byte load a lane and k step for each part), double
//     buffered.  Each step's output, y or x minus its base, is f32 in
//     registers, written to device memory and split into the next tile,
//     one 16-byte store a lane and part (one shuffle with the lane holding
//     the fragment's other row), conflict-free both ways;
//   * the consumer warps meet at one named barrier a step (bar.sync 1,
//     never the producer warp), once the next tile is written;
//   * one partition's y is nb * b * r * 4 bytes (2.0 MB at the flagship),
//     too large for shared memory, so it goes through the output buffer:
//     the forward sweep writes y_i into slot i, and the backward sweep reads
//     it back and overwrites it with x_i.  The base vectors (r_i forward,
//     y_i backward) go by cp.async, two steps ahead, into shared memory
//     that only the thread that reads them (and wrote y_i) touches: a
//     register copy one step ahead waited for device-memory latency
//     every step.
// The carry is f32 end to end; no TF32 rounding reaches it.  kCluster,
// kCols and kRingBytes are the constants chosen by measurement (PERF.md).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 2;          // blocks a cluster (one column chunk each)
constexpr int kCols = 16;            // columns a block: two n8 tiles
constexpr int kRingBytes = 128 * 1024;   // the matrix ring
constexpr int kBarBytes = 1024;      // the mbarriers, padded to the swizzle
// steps ahead that a base vector is copied in: y_{nb-2} is written at step
// nb - 3 and read at step nb, so two is the most the turn allows
constexpr int kBaseAhead = 2;

static_assert(kCluster == 2, "the multicast mask and the column pairing "
              "assume clusters of two");
static_assert(kCols == 16, "a block's columns are two n8 tiles");
static_assert(kBaseAhead == 1 || kBaseAhead == 2, "see kBaseAhead");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of `addr` (this block's) in block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// an arrival on the mbarrier of another block of the cluster.  Release at
// the CTA scope: a cluster-scope release would wait for this thread's
// device-memory stores in flight (the y and x writes), ~1-2 us a step
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also expects `bytes` of TMA traffic this phase
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

// the same, for a barrier that other blocks of the cluster arrive on
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// the consumer warps only (the producer warp never joins)
template <int THREADS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// a 2-D TMA box into this block's and the peer's shared memory at the same
// offset, completing on the mbarrier at the same offset in each
__device__ __forceinline__ void tma_multicast(uint32_t dst,
                                              const CUtensorMap* map, int col,
                                              int row, uint32_t bar) {
  const uint16_t mask = (1u << kCluster) - 1;
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
      "r"(row), "h"(mask)
      : "memory");
}

// 8 bytes from device memory into this thread's shared memory, async
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest N groups of this thread's cp.async copies are done
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the nearest TF32 value (ties away from zero), as cvt.rna.tf32.f32 gives
// it, in two integer operations on the bit pattern: half a TF32 unit added
// to the magnitude, the 13 bits below cleared (4% faster in f32 than the
// conversion instruction, PERF.md)
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

// the 16-byte chunk of B-fragment lane l (column n = l / 4, k row t = l % 4)
// in a k step's 512 bytes of a vector tile: a permutation under which both
// the fragment loads (8 lanes: two columns, four rows) and the stores of
// the epilogue (8 lanes: four columns, two rows; for bf16, one row) hit 8
// distinct 16-byte bank groups
template <int PACK>
__device__ __forceinline__ int vpos(int l) {
  const int n = l >> 2, t = l & 3, u = n >> 1;
  if constexpr (PACK == 1)
    return (u << 3) | (((n & 1) ^ (u & 1)) << 2) | (t ^ (u & 2));
  return (u << 3) | ((n & 1) << 2) | (t ^ u);
}

// B: block size; PACK: matrix elements per 32-bit word (1 = f32, 2 = bf16)
template <int B, int PACK>
struct Cfg {
  static constexpr int ES = 4 / PACK;              // bytes an element
  static constexpr int SLAB_K = 128 / ES;          // k a 128-byte slab
  static constexpr int SLABS = B / SLAB_K;         // slabs a matrix
  static constexpr int SLAB_BYTES = B * 128;
  static constexpr int MAT_BYTES = SLABS * SLAB_BYTES;
  static constexpr int DEPTH = kRingBytes / MAT_BYTES;   // ring slots
  static constexpr int WARPS = B / 16;             // consumer warps
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BOX_ROWS = B / kCluster;    // rows a block loads
  static constexpr int TILE = B / 8 * 32 * 4;      // floats of a hi/lo tile
  // the base vectors: [kBaseAhead][4][THREADS] float2
  static constexpr int BASES = kBaseAhead * 4 * THREADS * 2;
  static constexpr size_t kSmemBytes =
      1024 + kBarBytes + static_cast<size_t>(DEPTH) * MAT_BYTES +
      (4 * static_cast<size_t>(TILE) + BASES) * 4;
  static_assert(BOX_ROWS % 8 == 0 && BOX_ROWS <= 256, "TMA box rows");
  static_assert(DEPTH >= 2, "the ring must hold two matrices");
  static_assert(16 * DEPTH <= kBarBytes, "mbarriers");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

template <int B, int PACK>
__global__ void __launch_bounds__(Cfg<B, PACK>::THREADS + 32, 1)
fused_sweep_many_kernel(const __grid_constant__ CUtensorMap mF,
                        const __grid_constant__ CUtensorMap mS,
                        const __grid_constant__ CUtensorMap mU,
                        const float* rhs, float* x, int nb, int r,
                        int pairs) {
  using G = Cfg<B, PACK>;
  constexpr int PASSES = PACK == 1 ? 3 : 2;   // TF32 products a k step
  constexpr int WARPS = G::WARPS, THREADS = G::THREADS, DEPTH = G::DEPTH,
                TILE = G::TILE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled slabs need 1024-byte alignment; both blocks of a cluster
  // compute the same offsets (the multicast writes at the same offset)
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t bars = smem_addr(smem);           // full[DEPTH], empty[DEPTH]
  const uint32_t ring = bars + kBarBytes;          // [DEPTH] matrices
  float* tiles = reinterpret_cast<float*>(smem + kBarBytes +
                                          DEPTH * G::MAT_BYTES);
  float2* bases = reinterpret_cast<float2*>(tiles + 4 * TILE);
  auto full = [&](int q) { return bars + 8 * q; };
  auto empty = [&](int q) { return bars + 8 * (DEPTH + q); };

  cg::cluster_group cluster = cg::this_cluster();
  const uint32_t rank = cluster.block_rank();
  const uint32_t peer = rank ^ 1u;
  const int ci = blockIdx.x / kCluster;
  const int part = ci / pairs;
  const int c0 = ((ci % pairs) * kCluster + static_cast<int>(rank)) * kCols;
  const size_t vrow = static_cast<size_t>(B) * r;  // one block row of vectors
  const float* rp = rhs + static_cast<size_t>(part) * nb * vrow + c0;
  float* xp = x + static_cast<size_t>(part) * nb * vrow + c0;
  const int steps = 3 * nb - 2;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int q = 0; q < DEPTH; ++q) {
      mbar_init(full(q), 1);                       // the local producer
      mbar_init(empty(q), WARPS * kCluster);       // both blocks' readers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // both blocks' mbarriers are set up before any multicast or remote arrival
  cluster.sync();

  if (warp == WARPS) {               // the producer warp: lane 0 issues
    if (lane == 0) {
      const size_t part_row = static_cast<size_t>(part) * nb;
      for (int s = 0; s < steps; ++s) {
        // step s -> matrix: F_{s+1} for s < nb-1, Sinv_{nb-1} at s = nb-1,
        // then U_i, Sinv_i alternating for i = nb-2 .. 0
        const CUtensorMap* map;
        int i;
        if (s < nb - 1) {
          map = &mF;
          i = s + 1;
        } else if (s == nb - 1) {
          map = &mS;
          i = nb - 1;
        } else {
          const int t = s - nb;
          map = (t & 1) ? &mS : &mU;
          i = nb - 2 - t / 2;
        }
        const int row = static_cast<int>((part_row + i) * B) +
                        static_cast<int>(rank) * G::BOX_ROWS;
        const int slot = s % DEPTH;
        if (s >= DEPTH) mbar_wait_cluster(empty(slot), ((s / DEPTH) - 1) & 1);
        mbar_expect(full(slot), G::MAT_BYTES);      // both blocks' boxes
        const uint32_t dst = ring + slot * G::MAT_BYTES +
                             rank * G::BOX_ROWS * 128;
#pragma unroll
        for (int q = 0; q < G::SLABS; ++q)
          tma_multicast(dst + q * G::SLAB_BYTES, map, q * G::SLAB_K, row,
                        full(slot));
      }
    }
    __syncwarp();
    cluster.sync();                  // the peer is done with this block
    return;
  }

  // a consumer warp: rows 16 warp .. 16 warp + 15 of every output
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp;
  const uint32_t peer_bars = map_rank(bars, peer);

  // the vector tiles: [buffer][hi, lo][B / 8][32 chunks of 4 floats]
  auto tile = [&](int buf, int part_lo) {
    return tiles + (2 * buf + part_lo) * TILE;
  };
  // the next step's B fragments: a k8 step q holds rows 8q .. 8q+7 of the
  // vector, a 16-byte chunk for each fragment lane 4 n' + t' (column n'):
  // {b0, b1} of column n' and of column 8 + n', b0 / b1 the rows t' and
  // t' + 4 for f32, 2t' and 2t' + 1 for bf16 (the order of its A
  // fragments).  This thread holds rows g and g + 8 of columns 2t, 2t + 1
  // (and 8 more); with the lane holding the chunk's other row (lane ^ 16
  // for f32, lane ^ 4 for bf16) it swaps one column, so each lane stores one
  // whole chunk, split into TF32 hi and lo, a k step
  const bool low = PACK == 1 ? g < 4 : (g & 1) == 0;   // holds b0's row
  const int partner = PACK == 1 ? 16 : 4;
  const int chunk_of_lane =
      vpos<PACK>(4 * (2 * t + (low ? 0 : 1)) + (PACK == 1 ? (g & 3) : g >> 1));
  auto put = [&](int buf, int q, const float (&v)[2][2]) {   // [n][col j]
    float c[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float mine = low ? v[n][0] : v[n][1];
      const float theirs =
          __shfl_xor_sync(0xffffffffu, low ? v[n][1] : v[n][0], partner);
      c[2 * n] = low ? mine : theirs;
      c[2 * n + 1] = low ? theirs : mine;
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = tf32(c[e]);
      lo[e] = tf32(c[e] - __uint_as_float(hi[e]));
    }
    const int e = (q * 32 + chunk_of_lane) * 4;
    *reinterpret_cast<uint4*>(tile(buf, 0) + e) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(tile(buf, 1) + e) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  };
  // the vector subtracted from step s's product (null: none)
  auto base_of = [&](int s) -> const float* {
    if (s < nb - 1) return rp + (s + 1) * vrow;          // r_i
    if (s == nb - 1) return nullptr;
    const int u = s - nb;
    return (u & 1) ? nullptr : xp + (nb - 2 - u / 2) * vrow;   // y_i
  };
  // where step s's result goes in x (null: the next tile only)
  auto out_of = [&](int s) -> float* {
    if (s < nb - 1) return xp + (s + 1) * vrow;          // y_i
    if (s == nb - 1) return xp + (nb - 1) * vrow;        // x_{nb-1}
    const int u = s - nb;
    return (u & 1) ? xp + (nb - 2 - u / 2) * vrow : nullptr;   // x_i
  };
  // this thread's outputs: rows row0 + g (+ 8 h), columns 8 n + 2t (+ 1)
  auto offset = [&](int n, int h) {
    return static_cast<size_t>(row0 + g + 8 * h) * r + 8 * n + 2 * t;
  };
  // the base vector of step s, this thread's elements, in a ring of
  // kBaseAhead slots of shared memory that only this thread touches
  auto bslot = [&](int s, int n, int h) {
    return bases + ((s % kBaseAhead) * 4 + 2 * n + h) * THREADS + tid;
  };
  auto fetch = [&](int s) {         // one cp.async group a step
    const float* v = s < steps ? base_of(s) : nullptr;
    if (v) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          cp_async8(smem_addr(bslot(s, n, h)), v + offset(n, h));
    }
    cp_async_commit();
  };
  auto emit = [&](int buf, float* out, const float (&v)[2][4],
                  bool tile_too) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (out)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          *reinterpret_cast<float2*>(out + offset(n, h)) =
              make_float2(v[n][2 * h], v[n][2 * h + 1]);
      if (tile_too) {
        const float w[2][2] = {{v[0][2 * h], v[0][2 * h + 1]},
                               {v[1][2 * h], v[1][2 * h + 1]}};
        put(buf, (row0 + 8 * h) >> 3, w);
      }
    }
  };

  // y_0 = r_0: slot 0 of x and the first tile
  {
    float y0[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 w = *reinterpret_cast<const float2*>(rp + offset(n, h));
        y0[n][2 * h] = w.x;
        y0[n][2 * h + 1] = w.y;
      }
    emit(0, xp, y0, true);
    for (int s = 0; s < kBaseAhead; ++s) fetch(s);
  }
  consumer_sync<THREADS>();

  // ldmatrix row addresses of this lane: the tile row and 16-byte chunk
  // offsets inside a slab, before the swizzle
  const int lrow = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lchunk = lane >> 4;

  for (int s = 0; s < steps; ++s) {
    const int slot = s % DEPTH;
    const uint32_t mat = ring + slot * G::MAT_BYTES;
    const uint4* vhi = reinterpret_cast<const uint4*>(tile(s & 1, 0));
    const uint4* vlo = reinterpret_cast<const uint4*>(tile(s & 1, 1));
    // a chain of accumulators for each TF32 pass and parity of the k step
    float acc[2 * PASSES][2][4];
#pragma unroll
    for (int c = 0; c < 2 * PASSES; ++c)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][n][e] = 0.0f;
    mbar_wait(full(slot), (s / DEPTH) & 1);
#pragma unroll
    for (int q = 0; q < B / 8; q += PACK) {          // k8 steps
      // its 16-byte chunks in its slab (f32: two a step, the lane's half
      // by lchunk; bf16: one a step, q and q + 1 together)
      const int slab = PACK == 1 ? q >> 2 : q >> 3;
      const int chunk = PACK == 1 ? 2 * (q & 3) + lchunk : (q & 7) + lchunk;
      uint32_t wa[4], a[PACK][4];
      ldmatrix4(mat + slab * G::SLAB_BYTES + lrow * 128 +
                    ((chunk ^ (lrow & 7)) << 4), wa);
      if constexpr (PACK == 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[0][e] = wa[e];
      } else {               // (q: wa0, wa1; q + 1: wa2, wa3), lo half first
        a[0][0] = wa[0] << 16;
        a[0][1] = wa[1] << 16;
        a[0][2] = wa[0] & 0xffff0000u;
        a[0][3] = wa[1] & 0xffff0000u;
        a[1][0] = wa[2] << 16;
        a[1][1] = wa[3] << 16;
        a[1][2] = wa[2] & 0xffff0000u;
        a[1][3] = wa[3] & 0xffff0000u;
      }
#pragma unroll
      for (int h = 0; h < PACK; ++h) {
        const uint4 bh = vhi[(q + h) * 32 + vpos<PACK>(lane)];
        const uint4 bl = vlo[(q + h) * 32 + vpos<PACK>(lane)];
        float (*d)[2][4] = acc + ((q + h) & 1) * PASSES;
        if constexpr (PACK == 1) {           // 3xTF32
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float f = __uint_as_float(a[0][e]);
            ah[e] = tf32(f);
            al[e] = tf32(f - __uint_as_float(ah[e]));
          }
          mma(d[0][0], ah, bh.x, bh.y);
          mma(d[0][1], ah, bh.z, bh.w);
          mma(d[1][0], ah, bl.x, bl.y);
          mma(d[1][1], ah, bl.z, bl.w);
          mma(d[2][0], al, bh.x, bh.y);
          mma(d[2][1], al, bh.z, bh.w);
        } else {                             // 2xTF32: bf16 is exact
          mma(d[0][0], a[h], bh.x, bh.y);
          mma(d[0][1], a[h], bh.z, bh.w);
          mma(d[1][0], a[h], bl.x, bl.y);
          mma(d[1][1], a[h], bl.z, bl.w);
        }
      }
    }
    __syncwarp();                    // this warp is done with the matrix
    if (lane == 0) {
      mbar_arrive(empty(slot));
      mbar_arrive_remote(peer_bars + (empty(slot) - bars));
    }

    float v[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {      // the small terms first
        float sum = 0.0f;
#pragma unroll
        for (int c = PASSES - 1; c >= 0; --c)
          sum += acc[c][n][e] + acc[PASSES + c][n][e];
        v[n][e] = sum;
      }
    if (base_of(s)) {
      cp_async_wait<kBaseAhead - 1>();       // step s's group is in
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 w = *bslot(s, n, h);
          v[n][2 * h] = w.x - v[n][2 * h];
          v[n][2 * h + 1] = w.y - v[n][2 * h + 1];
        }
    }
    emit((s + 1) & 1, out_of(s), v, s + 1 < steps);
    // into the slot just read; the y_i it reads back were written at
    // least one step ago by this thread
    fetch(s + kBaseAhead);
    consumer_sync<THREADS>();        // the next tile is in place
  }
  cluster.sync();                    // no block exits while its peer can
}                                    // still arrive on its mbarriers

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime
// (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows, B] view of one factor array, boxes of one 128-byte slab by the
// rows a block loads, swizzled 128B
template <int B, int PACK>
cudaError_t encode(CUtensorMap* map, const void* ptr, size_t rows) {
  using G = Cfg<B, PACK>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(B), rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(B) * G::ES};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(G::SLAB_K),
                             static_cast<cuuint32_t>(G::BOX_ROWS)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = fn(
      map, PACK == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int B, int PACK>
int run(const void* F, const void* Sinv, const void* U, const void* r,
        void* x, int K, int nb, int nr, cudaStream_t stream) {
  using G = Cfg<B, PACK>;
  auto kernel = fused_sweep_many_kernel<B, PACK>;
  const size_t rows = static_cast<size_t>(K) * nb * B;
  const int pairs = nr / (kCluster * kCols);
  const long long blocks = static_cast<long long>(kCluster) * K * pairs;
  if (rows > static_cast<size_t>(INT_MAX) || blocks > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[3];
  const void* ptrs[3] = {F, Sinv, U};
  for (int q = 0; q < 3; ++q) {
    const cudaError_t err = encode<B, PACK>(&maps[q], ptrs[q], rows);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(G::THREADS + 32);      // + the producer warp
  cfg.dynamicSmemBytes = G::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1], maps[2],
                           static_cast<const float*>(r),
                           static_cast<float*>(x), nb, nr, pairs);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out: blocks a cluster, columns a block, consumer warps, ring depth in
// matrices, shared memory bytes
template <int B, int PACK>
int describe(int* out) {
  using G = Cfg<B, PACK>;
  out[0] = kCluster;
  out[1] = kCols;
  out[2] = G::WARPS;
  out[3] = G::DEPTH;
  out[4] = static_cast<int>(G::kSmemBytes);
  return 0;
}

template <int PACK>
int launch(const void* F, const void* Sinv, const void* U, const void* r,
           void* x, int K, int nb, int b, int nr, void* stream) {
  // r a multiple of the 32 columns of a cluster (the wrapper pads)
  if (K < 1 || nb < 1 || nr < 1 || nr % (kCluster * kCols) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128) return run<128, PACK>(F, Sinv, U, r, x, K, nb, nr, s);
  if (b == 64) return run<64, PACK>(F, Sinv, U, r, x, K, nb, nr, s);
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

int fused_sweep_many_config(int b, int bf16, int* out) {
  if (b == 128) return bf16 ? describe<128, 2>(out) : describe<128, 1>(out);
  if (b == 64) return bf16 ? describe<64, 2>(out) : describe<64, 1>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_sweep_many_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
