// Multi-RHS fused block-Thomas solve for method='spd' factors (symmetric
// block-LDL^T, F and Sinv stored, no U), both sweeps in one kernel, for r
// right-hand sides at once:
//   forward   y_0 = r_0,  y_i = r_i - F_i y_{i-1}
//   backward  x_{nb-1} = Sinv_{nb-1} y_{nb-1},
//             x_i = Sinv_i y_i - F_{i+1}^T x_{i+1}
// over K independent partitions.  F/Sinv are [K, nb, b, b] row-major; the
// right-hand sides and the solution are [K, nb, b, r] row-major (the
// caller's layout), r a multiple of 4 and both 16-byte aligned (the wrapper
// pads other r with zero columns).
//
// Replaces the Pallas kernel `_fused_kernel_many_spd` of
// spike_petsc_tpu/ops/pallas/fused_sweep.py (reached through
// `blocktri_solve_fused_many_pallas` on spd factors).
//
// Bound: latency.  At K = 16, nb = 977, b = 64, r = 32 the bytes (F twice
// and Sinv once, and the vectors) take about 0.23 ms at the card's memory
// rate, but the solve is a chain of 2 nb - 1 dependent steps per partition,
// each a 64 x 64 by 64 x r product.  Design for that (every choice measured
// on the H100, PERF.md):
//   * a thread block cluster of C blocks takes one (partition, chunk of RC
//     columns); block c owns rows [c b/C, (c+1) b/C) of every step's
//     output and streams only its slab of each matrix: b/C rows of F_i or
//     Sinv_i, and b/C columns of F_{i+1} for the transposed product.  At
//     C = 2, RC = 8 the grid is 2 * K * ceil(r / 8) blocks (128 at config
//     2, one an SM) where one block a (partition, 16 columns) gave 32;
//   * the carry (the last y or x, b x RC) sits in shared memory in every
//     block of the cluster, double-buffered: after a step each block writes
//     its rows of the new carry into all C blocks' next buffer through
//     distributed shared memory with st.async, whose bytes complete on an
//     mbarrier of the receiving block; a block takes the carry when its
//     mbarrier has counted all of it.  No step pays a release fence (a
//     cluster barrier with release semantics waits for the block's
//     device-memory traffic in flight: ~2.5 us a step): one cluster barrier
//     where the forward sweep turns makes its y writes visible to the
//     backward sweep.  Each block writes its own rows of y and x to device
//     memory;
//   * copy warps apart from the compute warps keep a ring of D shared-memory
//     slots filled with cp.async, up to D steps ahead: a step's slabs and
//     the vector it reads from device memory (r_i in the forward sweep, y_i
//     in the backward one), with a full and an empty mbarrier a slot.  Each
//     thread's cp.async costs the issuing warp hundreds of cycles a step,
//     so the compute warps issue none; nothing is staged through registers;
//   * a backward step computes x_i = Sinv_i y_i - F_{i+1}^T x_{i+1} as two
//     products into one accumulator, Sinv_i y_i before the carry arrives
//     (y_i read back from slot i of x, which it then overwrites with x_i),
//     so the chain is 2 nb - 1 steps, not 3 nb - 2, and only F^T x waits
//     for the carry;
//   * F_{i+1}^T is read as stored: its column slab sits in shared memory as
//     [b][b/C + pad] rows of F, and each thread reads the 2 adjacent rows
//     it owns at each k, a conflict-free access; row slabs are
//     [b/C][b + pad] read as 4 consecutive k, with the pad spreading a
//     warp's rows over distinct banks;
//   * each thread computes a 2 x 2 tile of the output over one of KS
//     splits of the k range, in two accumulators; the splits are summed
//     through shared memory and each carry row goes out in 16-byte pieces;
//   * bf16 factors are promoted to f32 at the read (a 16-bit shift).  No
//     TF32 and no bf16 rounding of the carry: the carry is f32 end to end.
// C, RC and the copy warps are constants chosen by measurement (kCluster,
// kCols, kCopyWarps).  b = 128 takes a cluster of at least 4, so that a
// ring slot (two slabs) leaves room for three slots.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 2;              // blocks a cluster (b = 64)
constexpr int kCluster128 = kCluster < 4 ? 4 : kCluster;   // (b = 128)
constexpr int kCols = 8;                 // columns a cluster
constexpr int kCopyWarps = 4;
constexpr int kThreads = 256;            // the compute warps
constexpr int kCopy = 32 * kCopyWarps;   // the copy warps' threads
constexpr int kRingBytes = 170 * 1024;   // the ring at one block an SM
constexpr int kHalfSmem = 113 * 1024;    // a block's share at two an SM
constexpr int kMaxDepth = 8;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// 16 bytes, or 16 zero bytes where `ok` is false (nothing is read then)
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

// an arrival on `bar` once this thread's cp.async copies so far are done
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(bar)))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

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

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// the compute warps only (the copy warps never join)
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// one arrival that also expects `bytes` of st.async traffic this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// 16 bytes into another block's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async4(uint32_t addr, float4 v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr), "f"(v.x), "f"(v.y),
      "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float lo16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// B: block size; C: blocks per cluster; RC: columns per cluster; PACK:
// matrix elements per 32-bit word (1 = f32, 2 = bf16).
template <int B, int C, int RC, int PACK>
struct Cfg {
  static constexpr int ROWS = B / C;             // output rows per block
  static constexpr int ES = 4 / PACK;            // bytes per matrix element
  static constexpr int LDA = B + 4 * PACK;       // row slab stride, elements
  static constexpr int LDB = ROWS + 4 * PACK;    // column slab stride
  static constexpr int RCP = RC + 4;             // vector tile stride (f32)
  static constexpr int TM = 2, TN = 2;           // rows, columns a thread
  static constexpr int OUT = ROWS * RC;          // outputs per block
  static constexpr int KS = 4 * kThreads / OUT;  // splits of the k range
  static constexpr int KB = B / KS;              // k per split
  static constexpr int TC = RC / TN;             // threads along columns
  static constexpr int TR = ROWS / TM;           // threads along rows
  // a ring slot: the row slab [ROWS][LDA], the column slab [B][LDB] and
  // the step's vector tile [B][RCP] (f32)
  static constexpr int kABytes = ROWS * LDA * ES;
  static constexpr int kBBytes = B * LDB * ES;
  static constexpr int kVBytes = B * RCP * 4;
  static constexpr int kSlotBytes = kABytes + kBBytes + kVBytes;
  // two blocks an SM where a ring of at least three slots leaves room
  // (more clusters run at once: 30 of 4 blocks at one block an SM, 62 at
  // two), else one block an SM with the larger ring
  static constexpr int kFixed = 8 * (2 + 2 * kMaxDepth) +
      (2 * B * RCP + 2 * KS * ROWS * RCP) * 4;
  static constexpr int kTwoDepth = (kHalfSmem - kFixed) / kSlotBytes;
  static constexpr int kMinBlocks = kTwoDepth >= 3 ? 2 : 1;
  static constexpr int kRoom = kMinBlocks == 2 ? kTwoDepth
                                               : kRingBytes / kSlotBytes;
  static constexpr int kDepth = kRoom < kMaxDepth ? kRoom : kMaxDepth;
  // mbarriers (the carry's two; a full and an empty one a ring slot),
  // ring, carry [2][B][RCP], red [2][KS][ROWS][RCP]
  static constexpr int kHead = 8 * (2 + 2 * kMaxDepth);
  static constexpr size_t kSmemBytes =
      kHead + static_cast<size_t>(kDepth) * kSlotBytes +
      (2 * static_cast<size_t>(B) * RCP +
       2 * static_cast<size_t>(KS) * ROWS * RCP) * 4;
  static_assert(B % C == 0, "the cluster must split the rows evenly");
  static_assert(KS >= 2, "at most 512 outputs a block (the k splits are "
                "summed in shared memory)");
  static_assert(TR * TC * KS == kThreads, "the tiles must fill the block");
  static_assert((TR * TC) % 32 == 0, "a warp must lie in one k split");
  static_assert(KB % 4 == 0, "k splits must be multiples of 4");
  static_assert((ROWS * ES) % 16 == 0, "column slab rows are 16-byte copies");
  static_assert(kDepth >= 3, "the ring needs at least three slots");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

// 4 consecutive elements of row `row` from column `k` of a row slab
template <int LD, int PACK>
__device__ __forceinline__ void row4(const unsigned char* slab, int row,
                                     int k, float (&v)[4]) {
  if constexpr (PACK == 1) {
    const float4 w = *reinterpret_cast<const float4*>(
        slab + (static_cast<size_t>(row) * LD + k) * 4);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(
        slab + (static_cast<size_t>(row) * LD + k) * 2);
    v[0] = lo16(w.x); v[1] = hi16(w.x); v[2] = lo16(w.y); v[3] = hi16(w.y);
  }
}

// 2 consecutive elements of row `k` from column `col` of a column slab
template <int LD, int PACK>
__device__ __forceinline__ void col2(const unsigned char* slab, int k,
                                     int col, float (&v)[2]) {
  const size_t e = static_cast<size_t>(k) * LD + col;
  if constexpr (PACK == 1) {
    const float2 w = *reinterpret_cast<const float2*>(slab + e * 4);
    v[0] = w.x; v[1] = w.y;
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(slab + e * 2);
    v[0] = lo16(w); v[1] = hi16(w);
  }
}

template <int B, int C, int RC, int PACK>
__global__ void __launch_bounds__(kThreads + kCopy,
                                  (Cfg<B, C, RC, PACK>::kMinBlocks))
fused_sweep_many_spd_kernel(const unsigned char* __restrict__ F,
                            const unsigned char* __restrict__ Sinv,
                            const float* rhs, float* x, int nb, int r,
                            int nchunks) {
  using G = Cfg<B, C, RC, PACK>;
  constexpr int ROWS = G::ROWS, ES = G::ES, LDA = G::LDA, LDB = G::LDB,
                RCP = G::RCP, TM = G::TM, TN = G::TN, KS = G::KS,
                KB = G::KB, TC = G::TC, TR = G::TR, D = G::kDepth;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);        // [2] carry
  uint64_t* full = bars + 2;                                 // [D] ring
  uint64_t* empty = full + kMaxDepth;                        // [D] ring
  unsigned char* ring = smem + G::kHead;                     // [D] slots
  float* carry = reinterpret_cast<float*>(ring + D * G::kSlotBytes);
  float* red = carry + 2 * B * RCP;                    // [2][KS][ROWS][RCP]

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int ci = blockIdx.x / C;
  const int c0 = (ci % nchunks) * RC;
  const size_t part = static_cast<size_t>(ci / nchunks) * nb;
  uint32_t rcarry[C], rbars[C];     // the carry and mbarriers of every
#pragma unroll                      // block of the cluster
  for (int q = 0; q < C; ++q) {
    rcarry[q] = map_rank(smem_addr(carry), q);
    rbars[q] = map_rank(smem_addr(bars), q);
  }

  const int tid = threadIdx.x;
  const int ks = tid / (TR * TC);
  const int tc = tid % TC, tr = (tid / TC) % TR;
  const int lr0 = tr * TM, lc0 = tc * TN, k0 = ks * KB;
  const int grow0 = c * ROWS;       // the first row this block owns
  const size_t mat = static_cast<size_t>(B) * B * ES;
  F += part * mat;
  Sinv += part * mat;
  const size_t vrow = static_cast<size_t>(B) * r;
  const float* rp = rhs + part * vrow;
  float* xp = x + part * vrow;
  const int steps = 2 * nb - 1;
  constexpr uint32_t kCarryBytes = B * RC * 4;   // one phase's st.async bytes

  // step s writes block row out_row(s): forward s < nb - 1 (i = s + 1),
  // the last block at s = nb - 1, backward s >= nb (i = 2 nb - 2 - s)
  auto out_row = [&](int s) -> int {
    return s < nb - 1 ? s + 1 : (s == nb - 1 ? nb - 1 : 2 * nb - 2 - s);
  };
  auto slot_of = [&](int j) { return ring + (j % D) * G::kSlotBytes; };
  // the copy warps: step j's slabs and vector into its ring slot.  The
  // vector is its rows of r_i (forward) or all of y_i (backward, read back
  // from slot i of x), columns past r zero-filled
  auto issue = [&](int j, int lane) {     // lane < kCopy
    unsigned char* slot = slot_of(j);
    const int i = out_row(j);
    const unsigned char* a = (j < nb - 1 ? F + i * mat : Sinv + i * mat) +
                             static_cast<size_t>(grow0) * B * ES;
    constexpr int ACH = B * ES / 16;              // 16-byte chunks a row
    for (int q = lane; q < ROWS * ACH; q += kCopy) {
      const int row = q / ACH, ch = q % ACH;
      cp_async16(slot + row * LDA * ES + ch * 16, a + row * B * ES + ch * 16);
    }
    if (j >= nb) {                                // F_{i+1}, columns R_c
      const unsigned char* f = F + (i + 1) * mat + grow0 * ES;
      constexpr int BCH = ROWS * ES / 16;
      for (int q = lane; q < B * BCH; q += kCopy) {
        const int k = q / BCH, ch = q % BCH;
        cp_async16(slot + G::kABytes + k * LDB * ES + ch * 16,
                   f + k * B * ES + ch * 16);
      }
    }
    if (j == nb - 1) return;                      // the last block: none
    const int rows = j < nb - 1 ? ROWS : B;
    const float* src = j < nb - 1
        ? rp + i * vrow + static_cast<size_t>(grow0) * r
        : xp + i * vrow;
    float* dst = reinterpret_cast<float*>(slot + G::kABytes + G::kBBytes);
    constexpr int VCH = RC / 4;
    for (int q = lane; q < rows * VCH; q += kCopy) {
      const int row = q / VCH, col = 4 * (q % VCH);
      const bool ok = c0 + col < r;               // r is a multiple of 4
      cp_async16z(dst + row * RCP + col,
                  ok ? src + static_cast<size_t>(row) * r + c0 + col : src,
                  ok);
    }
  };
  // row lr of this block, columns lc .. lc + 3 of step s's output: to x
  // and to the next carry of every block of the cluster
  auto emit4 = [&](int s, int lr, int lc, float4 v) {
    const int row = grow0 + lr;
    if (c0 + lc < r)                // r a multiple of 4: all in or out
      *reinterpret_cast<float4*>(xp + out_row(s) * vrow +
                                 static_cast<size_t>(row) * r + c0 + lc) = v;
    if (s + 1 == steps) return;     // the last carry: nobody reads it
    const uint32_t nxt = (((s + 1) & 1) * B * RCP + row * RCP + lc) * 4;
    const uint32_t bar = ((s + 1) & 1) * 8;
#pragma unroll
    for (int q = 0; q < C; ++q) st_async4(rcarry[q] + nxt, v, rbars[q] + bar);
  };
  // acc[k % 2] += (+-) M V over this thread's k split: M a row slab (rows
  // lr0.., 4 consecutive k) or, transposed, a column slab (k, rows lr0..)
  auto product = [&](float (&acc)[2][TM][TN], const unsigned char* M,
                     bool transposed, const float* V) {
#pragma unroll
    for (int kk = 0; kk < KB; kk += 4) {
      const int k = k0 + kk;
      float a[4][TM];
      if (transposed) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float f[TM];
          col2<LDB, PACK>(M, k + q, lr0, f);
#pragma unroll
          for (int m = 0; m < TM; ++m) a[q][m] = -f[m];
        }
      } else {
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          float w[4];
          row4<LDA, PACK>(M, lr0 + m, k, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) a[q][m] = w[q];
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = *reinterpret_cast<const float2*>(
            V + (k + q) * RCP + lc0);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          acc[q & 1][m][0] = fmaf(a[q][m], v.x, acc[q & 1][m][0]);
          acc[q & 1][m][1] = fmaf(a[q][m], v.y, acc[q & 1][m][1]);
        }
      }
    }
  };

  auto step = [&](int s) {
    // the forward sweep's last y that the backward sweep reads from device
    // memory was written at step nb - 3: publish the y writes to the
    // cluster (the copy warps join before they copy the first y_i)
    if (s == nb - 2) cluster.sync();
    const unsigned char* slot = slot_of(s);
    const float* vin = reinterpret_cast<const float*>(slot + G::kABytes +
                                                      G::kBBytes);
    const float* cur = carry + (s & 1) * B * RCP;
    const bool back = s >= nb, fwd = s < nb - 1;
    float acc[2][TM][TN];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) acc[h][m][n] = 0.0f;
    // Sinv_i y_i does not need the carry: before the wait
    if (back) product(acc, slot, false, vin);
    // step s + 1's slot is in (its copy of y_{i-1} must land before this
    // block's carry lets any block of the cluster write x_{i-1} over it),
    // waited for here, beside the wait for the carry
    if (s + 1 < steps) mbar_wait(full + (s + 1) % D, ((s + 1) / D) & 1);
    if (s >= 1) {                   // the carry step s - 1 sent
      mbar_wait(bars + (s & 1), ((s - 1) >> 1) & 1);
      if (tid == 0 && s + 2 < steps) mbar_expect(bars + (s & 1), kCarryBytes);
    }
    if (back)
      product(acc, slot + G::kABytes, true, cur);   // - F_{i+1}^T x_{i+1}
    else
      product(acc, slot, false, cur);               // F_i y_{i-1}; Sinv y
    // the k splits' partial sums, through shared memory
    float* rs = red + (s & 1) * KS * ROWS * RCP;
#pragma unroll
    for (int m = 0; m < TM; ++m)
      *reinterpret_cast<float2*>(rs + (ks * ROWS + lr0 + m) * RCP + lc0) =
          make_float2(acc[0][m][0] + acc[1][m][0],
                      acc[0][m][1] + acc[1][m][1]);
    compute_sync();
    for (int p = tid; p < ROWS * RC / 4; p += kThreads) {
      const int lr = p / (RC / 4), lc = 4 * (p % (RC / 4));
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int h = 0; h < KS; ++h) {
        const float4 w = *reinterpret_cast<const float4*>(
            rs + (h * ROWS + lr) * RCP + lc);
        v.x += w.x;
        v.y += w.y;
        v.z += w.z;
        v.w += w.w;
      }
      if (fwd) {                    // r_i - F_i y_{i-1}: r_i's rows in vin
        const float4 base = *reinterpret_cast<const float4*>(
            vin + lr * RCP + lc);
        v = make_float4(base.x - v.x, base.y - v.y, base.z - v.z,
                        base.w - v.w);
      }
      emit4(s, lr, lc, v);
    }
    __syncwarp();                   // this warp is done with the slot
    if ((tid & 31) == 0) mbar_arrive(empty + s % D);
  };

  // y_0 = r_0: the first carry (every block loads all of it) and slot 0
  for (int e = tid; e < B * RC; e += kThreads + kCopy) {
    const int row = e / RC, col = e % RC;
    const float v = c0 + col < r ? rp[static_cast<size_t>(row) * r + c0 + col]
                                 : 0.0f;
    carry[row * RCP + col] = v;
    if (row >= grow0 && row < grow0 + ROWS && c0 + col < r)
      xp[static_cast<size_t>(row) * r + c0 + col] = v;
  }
  if (tid == 0) {                   // the phases of steps 1 and 2
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    for (int q = 0; q < D; ++q) {
      mbar_init(full + q, kCopy);               // the copy warps' threads
      mbar_init(empty + q, kThreads / 32);      // the compute warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bars + 1, kCarryBytes);
    if (steps > 2) mbar_expect(bars, kCarryBytes);
  }
  // every block of the cluster is running, its mbarriers are set up, and
  // slot 0 of x (y_0) is visible to the cluster
  cluster.sync();
  if (tid >= kThreads) {            // the copy warps: the ring, D ahead
    const int lane = tid - kThreads;
    for (int j = 0; j < steps; ++j) {
      if (j >= D) mbar_wait(empty + j % D, (j / D - 1) & 1);
      if (j == nb) cluster.sync();  // the compute warps' at step nb - 2
      issue(j, lane);
      cp_async_arrive(full + j % D);
    }
    cp_async_wait_all();
    return;
  }
  mbar_wait(full, 0);               // step 0's slot (each step waits for
  for (int s = 0; s < steps; ++s) step(s);   // the next one's)
}

template <int B, int C, int RC, int PACK>
int run(const void* F, const void* Sinv, const void* r, void* x, int K,
        int nb, int nr, cudaStream_t stream) {
  auto kernel = fused_sweep_many_spd_kernel<B, C, RC, PACK>;
  const size_t smem = Cfg<B, C, RC, PACK>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nchunks = (nr + RC - 1) / RC;
  const long long blocks = static_cast<long long>(C) * K * nchunks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads + kCopy);      // + the copy warps
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const unsigned char*>(F),
                           static_cast<const unsigned char*>(Sinv),
                           static_cast<const float*>(r),
                           static_cast<float*>(x), nb, nr, nchunks);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out: cluster size C, columns per cluster RC, ring depth D
template <int B, int C, int RC, int PACK>
int describe(int* out) {
  out[0] = C;
  out[1] = RC;
  out[2] = Cfg<B, C, RC, PACK>::kDepth;
  return 0;
}

template <int PACK>
int launch(const void* F, const void* Sinv, const void* r, void* x, int K,
           int nb, int b, int nr, void* stream) {
  // r a multiple of 4 (16-byte rows of the vector tiles; the wrapper pads)
  if (K < 1 || nb < 1 || nr < 1 || nr % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128)
    return run<128, kCluster128, kCols, PACK>(F, Sinv, r, x, K, nb, nr, s);
  if (b == 64) return run<64, kCluster, kCols, PACK>(F, Sinv, r, x, K, nb, nr, s);
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

int fused_sweep_many_spd_config(int b, int bf16, int* out) {
  if (b == 128)
    return bf16 ? describe<128, kCluster128, kCols, 2>(out)
                : describe<128, kCluster128, kCols, 1>(out);
  if (b == 64)
    return bf16 ? describe<64, kCluster, kCols, 2>(out)
                : describe<64, kCluster, kCols, 1>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_sweep_many_spd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
