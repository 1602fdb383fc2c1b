// Fused block-Thomas solve for method='spd' factors (symmetric block-LDL^T,
// F and Sinv stored, no U), both sweeps in one kernel:
//   forward   y_0 = r_0,  y_i = r_i - F_i y_{i-1}
//   backward  x_{nb-1} = Sinv_{nb-1} y_{nb-1},
//             x_i = Sinv_i y_i - F_{i+1}^T x_{i+1}
// over K independent partitions, F/Sinv of shape [K, nb, b, b] row-major,
// r and x of shape [K, nb, b] (r 16-byte aligned: the wrapper copies a
// misaligned one).
//
// Replaces the Pallas kernel `_fused_kernel_spd` of
// spike_petsc_tpu/ops/pallas/fused_sweep.py (reached through
// `blocktri_solve_fused_pallas` on spd factors).
//
// Bound: latency.  The bytes are F twice and Sinv once (768 MB in f32 at
// K = 16, nb = 977, b = 64), but each partition is a chain of 2 nb - 1
// dependent steps, each a b x b matrix-vector product, so the latency of a
// step, not the card's memory rate, sets the time.  Design for that (every
// choice measured on the H100, PERF.md):
//   * a thread block cluster of C blocks takes one partition; block c owns
//     rows [c b/C, (c+1) b/C) of every step's output and streams only its
//     slabs: b/C rows of F_i or Sinv_i, and b/C columns of F_{i+1} for the
//     transposed product.  At C = 4 the grid is 4 K blocks (64 at config
//     2) where one block a partition gave 16;
//   * the carry (the last y or x, b floats) sits in shared memory in every
//     block of the cluster, double-buffered: each lane sends its row's
//     result into the next buffer of its share of the cluster's blocks
//     through distributed shared memory with st.async, whose bytes
//     complete on an mbarrier of the receiving block.  No step pays a
//     cluster barrier: one where the forward sweep turns makes its y
//     writes (slot i of x, read back by the backward sweep) visible to the
//     cluster;
//   * copy warps apart from the compute warps keep a ring of D shared-memory
//     slots full with cp.async, with a full and an empty mbarrier a slot: a
//     step's slabs and the vector it reads from device memory (its rows of
//     r_i forward, all of y_i backward); the compute warps issue no copies.
//     A slot holds two steps, so a compute warp waits on the ring every
//     other step (a wait costs ~50 ns even when the slot is in);
//   * a compute warp owns 8 output rows (4 lanes a row, each lane 4-wide
//     chunks of the row), so a row's sum is a 2-level warp shuffle and a
//     step needs no block barrier.  Everything a step reads from its slot
//     (the slab elements into registers, and backward Sinv_i y_i entire) is
//     read before the wait for the carry; after the wait only the carry
//     loads, b/4 FMAs a lane, the shuffles and the sends remain;
//   * a step waits for the next step's slot before it sends its carry: a
//     block of the cluster overwrites slot i of x (y_i) with x_i only once
//     every block's copy of y_i has landed;
//   * the ring stays small (96 KB at config 2): with blocks of ~177 KB the
//     sweep took 1.9x as long (too few clusters fit the card at once);
//   * bf16 factors are promoted to f32 at the read (a 16-bit shift).  No
//     TF32 and no bf16 rounding of the carry: the carry is f32 end to end.
// C, the rows a compute warp and the copy warps are constants chosen by
// measurement (kCluster, kWarpRows, kCopyWarps), as are the two steps a
// slot and the ring's size.  No block sends a carry after the last step,
// so none writes into a block that may have exited.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;              // blocks a cluster
constexpr int kWarpRows = 8;             // output rows a compute warp
constexpr int kCopyWarps = 2;
constexpr int kRingBytes = 96 * 1024;    // the ring, two steps a slot

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
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

// 4 bytes into another block's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, float v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 "
      "[%0], %1, [%2];\n" ::"r"(addr), "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float lo16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// B: block size; C: blocks per cluster; PACK: matrix elements per 32-bit
// word (1 = f32, 2 = bf16).
template <int B, int C, int PACK>
struct Cfg {
  static constexpr int ROWS = B / C;             // output rows per block
  static constexpr int ES = 4 / PACK;            // bytes per matrix element
  static constexpr int RW = kWarpRows;           // output rows per warp
  static constexpr int W = ROWS / RW;            // compute warps
  static constexpr int Q = 32 / RW;              // lanes per row
  static constexpr int SENDS = (C + Q - 1) / Q;  // carry sends per lane
  static constexpr int NC = B / Q;               // columns per lane
  static constexpr int NCH = NC / 4;             // 4-wide chunks per lane
  static constexpr int LDA = B + 16;             // row slab stride, elements
  static constexpr int LDB = ROWS + 16 / ES;     // column slab stride
  static constexpr int kCompute = 32 * W;
  static constexpr int kCopy = 32 * kCopyWarps;
  static constexpr int kThreads = kCompute + kCopy;
  // a step's part of a ring slot: the row slab [ROWS][LDA], the column
  // slab [B][LDB] and the step's vector (ROWS rows of r_i, or y_i) in f32
  static constexpr int kABytes = ROWS * LDA * ES;
  static constexpr int kBBytes = B * LDB * ES;
  static constexpr int kVBytes = B * 4;
  static constexpr int kStepBytes = kABytes + kBBytes + kVBytes;
  static constexpr int kSlotBytes = 2 * kStepBytes;
  // the ring takes kRingBytes (4 slots at b = 64 in f32, 8 in bf16), but
  // at least three slots (b = 128 needs more)
  static constexpr int kRoom = kRingBytes / kSlotBytes;
  static constexpr int kDepth = kRoom < 3 ? 3 : kRoom;
  // mbarriers (the carry's two; a full and an empty one a ring slot),
  // ring, carry [2][B]
  static constexpr int kHead = 8 * (2 + 2 * kDepth);
  static constexpr size_t kSmemBytes =
      kHead + static_cast<size_t>(kDepth) * kSlotBytes + 2 * B * 4;
  static_assert(B % C == 0 && ROWS % RW == 0,
                "the cluster and its warps must split the rows evenly");
  static_assert(32 % RW == 0 && RW % 4 == 0 && NC % 4 == 0,
                "a warp's rows split its lanes into 4-column chunks");
  static_assert((ROWS * ES) % 16 == 0 && (ROWS * 4) % 16 == 0,
                "slab rows and vector rows are 16-byte copies");
  static_assert(kABytes % 16 == 0 && kBBytes % 16 == 0,
                "ring slots stay 16-byte aligned");
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

// element (k, col) of a column slab
template <int LD, int PACK>
__device__ __forceinline__ float elem(const unsigned char* slab, int k,
                                      int col) {
  const size_t e = static_cast<size_t>(k) * LD + col;
  if constexpr (PACK == 1) {
    return *reinterpret_cast<const float*>(slab + e * 4);
  } else {
    const uint32_t h = *reinterpret_cast<const uint16_t*>(slab + e * 2);
    return __uint_as_float(h << 16);
  }
}

template <int B, int C, int PACK>
__global__ void __launch_bounds__(Cfg<B, C, PACK>::kThreads, 1)
fused_sweep_spd_kernel(const unsigned char* __restrict__ F,
                       const unsigned char* __restrict__ Sinv,
                       const float* __restrict__ r, float* x, int nb) {
  using G = Cfg<B, C, PACK>;
  constexpr int ROWS = G::ROWS, ES = G::ES, LDA = G::LDA, LDB = G::LDB,
                RW = G::RW, Q = G::Q, NC = G::NC, NCH = G::NCH,
                D = G::kDepth;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);        // [2] carry
  uint64_t* full = bars + 2;                                 // [D] ring
  uint64_t* empty = full + D;                                // [D] ring
  unsigned char* ring = smem + G::kHead;                     // [D] slots
  float* carry = reinterpret_cast<float*>(ring + D * G::kSlotBytes);

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const size_t part = static_cast<size_t>(blockIdx.x / C) * nb;
  const int tid = threadIdx.x;
  const int grow0 = c * ROWS;       // the first row this block owns
  const size_t mat = static_cast<size_t>(B) * B * ES;
  F += part * mat;
  Sinv += part * mat;
  const float* rp = r + part * B;
  float* xp = x + part * B;
  const int steps = 2 * nb - 1;
  constexpr uint32_t kCarryBytes = B * 4;        // one phase's st.async bytes

  // step s writes block row out_row(s): forward s < nb - 1 (i = s + 1),
  // the last block at s = nb - 1, backward s >= nb (i = 2 nb - 2 - s)
  auto out_row = [&](int s) -> int {
    return s < nb - 1 ? s + 1 : (s == nb - 1 ? nb - 1 : 2 * nb - 2 - s);
  };
  // steps 2g and 2g + 1 share the g-th fill of a ring slot
  auto slot_of = [&](int j) {
    return ring + (j / 2 % D) * G::kSlotBytes + (j % 2) * G::kStepBytes;
  };
  // the ring slot's mbarrier index and phase parity of step j
  auto bar_of = [&](int j) { return j / 2 % D; };
  auto parity_of = [&](int j) { return (j / 2 / D) & 1; };
  // the last step of a slot (or of the sweep)
  auto slot_ends = [&](int j) { return j % 2 == 1 || j + 1 == steps; };
  // the copy threads (t < kCopy): step j's slabs and vector into its part
  // of its slot
  auto issue = [&](int j, int t) {
    unsigned char* slot = slot_of(j);
    const int i = out_row(j);
    const unsigned char* a = (j < nb - 1 ? F : Sinv) + i * mat +
                             static_cast<size_t>(grow0) * B * ES;
    constexpr int ACH = B * ES / 16;              // 16-byte chunks a row
    for (int q = t; q < ROWS * ACH; q += G::kCopy) {
      const int row = q / ACH, ch = q % ACH;
      cp_async16(slot + row * LDA * ES + ch * 16, a + row * B * ES + ch * 16);
    }
    float* v = reinterpret_cast<float*>(slot + G::kABytes + G::kBBytes);
    if (j < nb - 1) {                             // this block's rows of r_i
      const float* src = rp + static_cast<size_t>(i) * B + grow0;
      for (int q = t; q < ROWS / 4; q += G::kCopy)
        cp_async16(v + 4 * q, src + 4 * q);
    } else if (j >= nb) {                         // F_{i+1}'s columns, y_i
      const unsigned char* f = F + (i + 1) * mat + grow0 * ES;
      constexpr int BCH = ROWS * ES / 16;
      for (int q = t; q < B * BCH; q += G::kCopy) {
        const int k = q / BCH, ch = q % BCH;
        cp_async16(slot + G::kABytes + k * LDB * ES + ch * 16,
                   f + k * B * ES + ch * 16);
      }
      const float* src = xp + static_cast<size_t>(i) * B;
      for (int q = t; q < B / 4; q += G::kCopy)
        cp_async16(v + 4 * q, src + 4 * q);
    }
  };

  // y_0 = r_0: the first carry (every block loads all of it) and slot 0
  for (int e = tid; e < B; e += G::kThreads) {
    const float v = rp[e];
    carry[e] = v;
    if (e >= grow0 && e < grow0 + ROWS) xp[e] = v;
  }
  if (tid == 0) {                   // the phases of steps 1 and 2
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    for (int q = 0; q < D; ++q) {
      mbar_init(full + q, G::kCopy);            // the copy threads
      mbar_init(empty + q, G::W);               // the compute warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bars + 1, kCarryBytes);
    if (steps > 2) mbar_expect(bars, kCarryBytes);
  }
  // every block of the cluster is running, its mbarriers are set up, and
  // slot 0 of x (y_0) is visible to the cluster
  cluster.sync();
  // the forward sweep's last y that the backward sweep reads from device
  // memory is written at step nb - 3; one cluster barrier between steps
  // nb - 3 and nb - 2 (the copy warps: before they fill the slot of the
  // first y_i, step nb) publishes the y writes to the cluster
  const int turn = nb > 1 ? nb - 2 : 0;
  if (tid >= G::kCompute) {         // the copy warps: the ring, D slots ahead
    const int t = tid - G::kCompute;
    auto copy = [&](int j) {
      const int g = j / 2;          // the slot's g-th fill
      if (j % 2 == 0 && g >= D)
        mbar_wait(empty + g % D, (g / D - 1) & 1);
      issue(j, t);
      if (slot_ends(j)) cp_async_arrive(full + bar_of(j));
    };
    // the first slot filled after the barrier: the one that holds step nb
    // (or nb - 1 and nb when nb is odd); the compute warps' barrier comes
    // before step nb - 2, which does not need it
    const int first_back = nb > 1 ? nb / 2 * 2 : steps;
    for (int j = 0; j < first_back; ++j) copy(j);
    if (nb > 1) cluster.sync();
    for (int j = first_back; j < steps; ++j) copy(j);
    cp_async_wait_all();
    return;
  }

  // the compute warps: lane (jj, q) sums row `row` over its columns
  // 4 (q + Q m) .. + 3 (and, transposed, its k of the same form)
  const int lane = tid % 32, warp = tid / 32;
  const int jj = lane / Q, q = lane % Q;
  const int row = warp * RW + jj;   // block-local
  // the blocks this lane sends its row's carry to: q, q + Q, ... < C
  uint32_t rcarry[G::SENDS], rbar[G::SENDS];
#pragma unroll
  for (int k = 0; k < G::SENDS; ++k) {
    const int dst = (q + Q * k) % C;
    rcarry[k] = map_rank(smem_addr(carry), dst);
    rbar[k] = map_rank(smem_addr(bars), dst);
  }
  // sum over this lane's columns of M[row, col] v[col], M's elements in a
  auto dot = [&](const float (&a)[NC], const float* v) -> float {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      const float4 w = *reinterpret_cast<const float4*>(v + 4 * (q + Q * m));
      d[0] = fmaf(a[4 * m], w.x, d[0]);
      d[1] = fmaf(a[4 * m + 1], w.y, d[1]);
      d[2] = fmaf(a[4 * m + 2], w.z, d[2]);
      d[3] = fmaf(a[4 * m + 3], w.w, d[3]);
    }
    return (d[0] + d[1]) + (d[2] + d[3]);
  };

  auto step = [&](int s) {
    const unsigned char* slot = slot_of(s);
    const float* vin = reinterpret_cast<const float*>(slot + G::kABytes +
                                                      G::kBBytes);
    const bool fwd = s < nb - 1, back = s >= nb;
    // everything this step reads from its slot, before the carry
    float a[NC], ft[NC];
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      float w[4];
      row4<LDA, PACK>(slot, row, 4 * (q + Q * m), w);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[4 * m + e] = w[e];
    }
    float sy = 0.0f, rin = 0.0f;
    if (back) {
      sy = dot(a, vin);                             // Sinv_i y_i
#pragma unroll
      for (int m = 0; m < NCH; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ft[4 * m + e] = elem<LDB, PACK>(slot + G::kABytes,
                                          4 * (q + Q * m) + e, row);
    }
    if (fwd) rin = vin[row];                        // r_i[row]
    __syncwarp();                   // this warp is done with the step
    if (lane == 0 && slot_ends(s)) mbar_arrive(empty + bar_of(s));
    // step s + 1's slot is in (its copy of y_{i-1} must land before this
    // block's carry lets any block of the cluster write x_{i-1} over it),
    // waited for here, beside the wait for the carry
    if (s + 1 < steps && (s + 1) % 2 == 0)
      mbar_wait(full + bar_of(s + 1), parity_of(s + 1));
    if (s >= 1) {                   // the carry step s - 1 sent
      mbar_wait(bars + (s & 1), ((s - 1) >> 1) & 1);
      if (tid == 0 && s + 2 < steps) mbar_expect(bars + (s & 1), kCarryBytes);
    }
    const float* cur = carry + (s & 1) * B;
    // this lane's part: Sinv_i y_i - F_{i+1}^T x_{i+1} backward, else
    // F_i y_{i-1} (forward) or Sinv_{nb-1} y_{nb-1}
    float acc = back ? sy - dot(ft, cur) : dot(a, cur);
#pragma unroll
    for (int o = Q / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    const float out = fwd ? rin - acc : acc;
    if (q == 0)
      xp[static_cast<size_t>(out_row(s)) * B + grow0 + row] = out;
    if (s + 1 == steps) return;     // the last carry: nobody reads it
    // every lane of the row holds its sum: lane q sends it to blocks q,
    // q + Q, ... of the cluster
    const uint32_t nxt = (((s + 1) & 1) * B + grow0 + row) * 4;
#pragma unroll
    for (int k = 0; k < G::SENDS; ++k)
      if (q + Q * k < C)
        st_async(rcarry[k] + nxt, out, rbar[k] + ((s + 1) & 1) * 8);
  };

  mbar_wait(full, 0);               // step 0's slot (each step waits for
  for (int s = 0; s < turn; ++s) step(s);   // the next one's)
  if (nb > 1) cluster.sync();
  for (int s = turn; s < steps; ++s) step(s);
}

template <int B, int C, int PACK>
int run(const void* F, const void* Sinv, const void* r, void* x, int K,
        int nb, cudaStream_t stream) {
  using G = Cfg<B, C, PACK>;
  auto kernel = fused_sweep_spd_kernel<B, C, PACK>;
  const size_t smem = G::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(C) * K;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(G::kThreads);             // compute + copy warps
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
                           static_cast<float*>(x), nb);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out: cluster size, compute warps, copy warps, ring slots, steps a slot
template <int B, int C, int PACK>
int describe(int* out) {
  using G = Cfg<B, C, PACK>;
  out[0] = C;
  out[1] = G::W;
  out[2] = kCopyWarps;
  out[3] = G::kDepth;
  out[4] = 2;
  return 0;
}

template <int PACK>
int launch(const void* F, const void* Sinv, const void* r, void* x, int K,
           int nb, int b, void* stream) {
  if (K < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (b == 128) return run<128, kCluster, PACK>(F, Sinv, r, x, K, nb, s);
  if (b == 64) return run<64, kCluster, PACK>(F, Sinv, r, x, K, nb, s);
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

int fused_sweep_spd_config(int b, int bf16, int* out) {
  if (b == 128)
    return bf16 ? describe<128, kCluster, 2>(out)
                : describe<128, kCluster, 1>(out);
  if (b == 64)
    return bf16 ? describe<64, kCluster, 2>(out)
                : describe<64, kCluster, 1>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_sweep_spd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
