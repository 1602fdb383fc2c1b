// Fused block-Thomas solve for method='inv' factors, both sweeps in one kernel:
//   forward   y_0 = r_0,  y_i = r_i - F_i y_{i-1}
//   backward  x_{nb-1} = Sinv_{nb-1} y_{nb-1},  x_i = Sinv_i (y_i - U_i x_{i+1})
// over K independent partitions, F/Sinv/U of shape [K, nb, b, b] row-major,
// f32 or bf16, 16-byte aligned; r and x of shape [K, nb, b] f32.
//
// Replaces the Pallas kernel `_fused_kernel` of
// spike_petsc_tpu/ops/pallas/fused_sweep.py (reached through
// `blocktri_solve_fused_pallas`).
//
// Bound: bytes where partitions are many.  A solve reads each matrix it
// uses once, 3 nb - 2 a partition (F_0 and U_{nb-1} are never read):
// K (3 nb - 2) b^2 elements (1.54 GB in f32 at the flagship, K = 64,
// nb = 123, b = 128; half with bf16 factors), plus r in and x out,
// 0.462 ms at the card's 3.35 TB/s, for 2 flops an element.  Each
// partition is a chain of 3 nb - 2 dependent b x b matrix-vector steps,
// so where K nb is small (config 4's inner factor, K = 16, nb = 49; or
// K = 1) the latency of a step sets the time instead.  The first
// design, one block a partition with one matrix of prefetch in registers,
// took 0.62-0.64 ms at the flagship: 64 of the 132 SMs at work, one load
// in flight a block.
// Design (every choice timed with experiments/torch_lab_fused_sweep.py on
// an H100 80GB HBM3 at 700 W, the first design built beside it in the same
// calls, f32 factors unless named):
//   * a thread block cluster of C blocks takes one partition; block j owns
//     rows [j b/C, (j+1) b/C) of every step's output and streams only its
//     row slab of F_i, Sinv_i or U_i.  C comes from the plan
//     (fused_sweep_cluster in ops/cuda/fused_sweep.py: the largest of 4 and
//     2 with K C <= the SM count, else 1).  At the flagship C = 2 (128
//     blocks) took 0.486 ms, C = 4 (two blocks an SM) 0.538 and C = 1
//     0.577; at K = 16, C = 4 beat C = 8 (two sends a lane) by 8-16%, at
//     K = 1 they tied, so C = 8 was dropped;
//   * the carry (the last y, t or x, b floats) sits in shared memory in
//     every block of the cluster, double-buffered: each lane sends its
//     row's value into the next buffer of its share of the cluster's blocks
//     with st.async, whose bytes complete on an mbarrier of the receiving
//     block (as fused_sweep_spd.cu).  No step pays a cluster barrier;
//   * a producer warp keeps a ring of D slabs (kRingBytes: 3 to 8 slots)
//     full, one bulk copy (TMA) a slab, with a full and an empty mbarrier
//     a slot.  Its first thread sets up the mbarriers and issues the first
//     D copies before the cluster barrier (7% off K = 1, nb = 157).  The
//     copies carry an L2 evict-first policy, since the matrices pass
//     through once and the vectors r, y and x are read again: the flagship
//     went from 0.514 to 0.499 ms (bf16 0.277 to 0.257), the zero-diagonal
//     factor (K = 64, nb = 245, b = 64) from 0.302 to 0.260 (bf16 0.232 to
//     0.188), config 4's inner factor from 0.062 to 0.054 and K = 512,
//     nb = 16 from 0.524 to 0.508;
//   * a compute warp owns 8 output rows, 4 lanes a row, each lane 4-wide
//     chunks of the row taken in an order rotated by the row, so that the
//     rows a quarter-warp reads fall in distinct banks of the unpadded slab
//     (one contiguous bulk copy).  A row's sum is a 2-level shuffle and no
//     step needs a block barrier.  A step reads its slab into registers
//     before it waits for the carry; after the wait only the carry loads,
//     b/4 FMAs a lane, the shuffles, the store and the sends remain;
//   * y_i goes into slot i of x (every lane of a row stores it) and the
//     backward sweep reads it back two block rows ahead, each lane its own
//     store, before x_i overwrites it; r_i is read kAhead steps ahead into
//     registers.  Shared memory holds no vector of the partition, so any
//     nb fits (the rule's nb limit is the first design's, kept so that the
//     route does not change);
//   * bf16 factors are promoted to f32 in registers (a 16-bit shift); the
//     carry is f32 end to end.  A row is summed in the same order at every
//     C (the same bits at 1, 2 and 4).  On the zero-diagonal factor that
//     order reads 7.8e-5 from the f64 sweep, copies summing each row
//     serially 3.9e-5 and 4.8e-5, the first design 3.9e-5; on random
//     right-hand sides it reads 1.0e-6 to 1.4e-6, the plain f32 sweep
//     1.1e-6 to 1.7e-6 (experiments/torch_lab_fused_sweep.py --orders).
// Tried and dropped, no gain beyond the spread: a ring of 48 or 192 KB in
// place of 96, two slots at C = 1, a slab in four bulk copies, r_i eight
// steps ahead, 16 rows a warp (2 lanes a row; 16% slower at K = 1), and
// two blocks an SM at C = 1 by the launch bounds (spills, slower).  At
// K = 512 (C = 1: one 198 KB block an SM) C = 2 is 2% faster in f32 and
// no faster in bf16; the plan keeps one block a partition there.  No block
// sends a carry after the last step, so none writes into a block that may
// have exited.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpRows = 8;             // output rows a compute warp
constexpr int kRingBytes = 96 * 1024;    // the ring of slabs
constexpr int kMinDepth = 3;
constexpr int kMaxDepth = 8;
constexpr int kAhead = 4;                // steps a base value is loaded ahead

// B: block size; C: blocks per cluster; PACK: matrix elements per 32-bit
// word (1 = f32, 2 = bf16).
template <int B, int C, int PACK>
struct Cfg {
  static constexpr int ROWS = B / C;             // output rows per block
  static constexpr int ES = 4 / PACK;            // bytes per matrix element
  static constexpr int W = ROWS / kWarpRows;     // compute warps
  static constexpr int Q = 32 / kWarpRows;       // lanes per row
  static constexpr int SENDS = (C + Q - 1) / Q;  // carry sends per lane
  static constexpr int NC = B / Q;               // columns per lane
  static constexpr int NCH = NC / 4;             // 4-wide chunks per lane
  static constexpr int kCompute = 32 * W;
  static constexpr int kThreads = 32 + kCompute;   // + the producer warp
  // a ring slot: one step's row slab of its matrix, unpadded (one bulk copy)
  static constexpr int kSlabBytes = ROWS * B * ES;
  static constexpr int kRoom = kRingBytes / kSlabBytes;
  static constexpr int kDepth =
      kRoom < kMinDepth ? kMinDepth : (kRoom > kMaxDepth ? kMaxDepth : kRoom);
  // mbarriers (the carry's two; a full and an empty one a slot), padded
  static constexpr int kHead = (8 * (2 + 2 * kDepth) + 127) / 128 * 128;
  // mbarriers, ring, carry [2][B]
  static constexpr size_t kSmemBytes =
      kHead + static_cast<size_t>(kDepth) * kSlabBytes + 2 * B * 4;
  static_assert(B % C == 0 && ROWS % kWarpRows == 0,
                "the cluster and its warps must split the rows evenly");
  static_assert(NCH >= 4 && (NCH & (NCH - 1)) == 0,
                "the rotation of a lane's chunks needs 4, 8, ... of them");
  static_assert(kSlabBytes % 128 == 0, "ring slots stay aligned");
  static_assert(kSmemBytes <= 232448, "shared memory of one block");
};

// 4 consecutive elements of row `row` of an unpadded slab from column `k`
template <int B, int PACK>
__device__ __forceinline__ void row4(const unsigned char* slab, int row,
                                     int k, float (&v)[4]) {
  if constexpr (PACK == 1) {
    const float4 w = *reinterpret_cast<const float4*>(
        slab + (static_cast<size_t>(row) * B + k) * 4);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(
        slab + (static_cast<size_t>(row) * B + k) * 2);
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xffff0000u);
  }
}

template <int B, int C, int PACK>
__global__ void __launch_bounds__(Cfg<B, C, PACK>::kThreads, 1)
fused_sweep_kernel(const unsigned char* __restrict__ F,
                   const unsigned char* __restrict__ Sinv,
                   const unsigned char* __restrict__ U,
                   const float* __restrict__ r, float* x, int nb) {
  using G = Cfg<B, C, PACK>;
  constexpr int ROWS = G::ROWS, ES = G::ES, Q = G::Q, NC = G::NC,
                NCH = G::NCH, D = G::kDepth;
  constexpr uint32_t kSlab = G::kSlabBytes;
  constexpr uint32_t kCarryBytes = B * 4;        // one phase's st.async bytes
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);        // [2] carry
  uint64_t* full = bars + 2;                                 // [D] ring
  uint64_t* empty = full + D;                                // [D] ring
  unsigned char* ring = smem + G::kHead;                     // [D] slabs
  float* carry = reinterpret_cast<float*>(ring + D * kSlab);  // [2][B]

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const size_t part = static_cast<size_t>(blockIdx.x / C) * nb;
  const int tid = threadIdx.x;
  const int grow0 = c * ROWS;       // the first row this block owns
  const size_t mat = static_cast<size_t>(B) * B * ES;
  F += part * mat;
  Sinv += part * mat;
  U += part * mat;
  const float* rp = r + part * B;
  float* xp = x + part * B;
  const int steps = 3 * nb - 2;

  // step s's matrix: F_{s+1} for s < nb - 1, Sinv_{nb-1} at s = nb - 1,
  // then U_i, Sinv_i for i = nb - 2 .. 0; this block's slab of it
  auto slab_src = [&](int s) -> const unsigned char* {
    const unsigned char* m;
    if (s < nb - 1) {
      m = F + static_cast<size_t>(s + 1) * mat;
    } else if (s == nb - 1) {
      m = Sinv + static_cast<size_t>(nb - 1) * mat;
    } else {
      const int t = s - nb, i = nb - 2 - t / 2;
      m = ((t & 1) ? Sinv : U) + static_cast<size_t>(i) * mat;
    }
    return m + static_cast<size_t>(grow0) * B * ES;
  };

  // warp 0 is the producer: its first thread sets up the mbarriers and
  // issues the first D slabs at once, then keeps the ring D slabs ahead.
  // The matrices are read once a solve; r, y and x are read again
  const uint64_t policy = evict_first_policy();
  auto fill = [&](int j) {
    const int k = j % D;
    mbar_expect(full + k, kSlab);
    bulk_copy(ring + k * kSlab, slab_src(j), kSlab, full + k, policy);
  };
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    for (int q = 0; q < D; ++q) {
      mbar_init(full + q, 1);                   // the producer's arrival
      mbar_init(empty + q, G::W);               // the compute warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (steps > 1) mbar_expect(bars + 1, kCarryBytes);   // step 0's sends
    if (steps > 2) mbar_expect(bars, kCarryBytes);       // step 1's
    for (int j = 0; j < D && j < steps; ++j) fill(j);
  }
  // y_0 = r_0: the first carry, every block loads all of it
  for (int e = tid; e < B; e += G::kThreads) carry[e] = rp[e];
  // every block of the cluster is running and its mbarriers are set up
  cluster.sync();

  if (tid < 32) {
    if (tid == 0) {
      for (int j = D; j < steps; ++j) {
        mbar_wait(empty + j % D, (j / D - 1) & 1);
        fill(j);
      }
    }
    return;
  }

  // the compute warps: lane (jj, q) sums row `row` over its chunks m =
  // 0 .. NCH - 1, columns 4 (q + Q ((m + jj) % NCH)) .. + 3.  The rotation
  // by jj puts the rows a quarter-warp reads in distinct banks
  const int lane = tid % 32, warp = tid / 32 - 1;
  const int jj = lane / Q, q = lane % Q;
  const int row = warp * kWarpRows + jj;   // block-local
  const int grow = grow0 + row;
  auto col = [&](int m) { return 4 * (q + Q * ((m + jj) & (NCH - 1))); };
  // the blocks this lane sends its row's carry to: q, q + Q, ... < C
  uint32_t rcarry[G::SENDS], rbar[G::SENDS];
#pragma unroll
  for (int k = 0; k < G::SENDS; ++k) {
    const int dst = (q + Q * k) % C;
    rcarry[k] = map_rank(smem_addr(carry), dst);
    rbar[k] = map_rank(smem_addr(bars), dst);
  }

  // one step: out = base - M v (sub) or M v for this lane's row, M this
  // block's slab in ring slot s % D, v the carry step s - 1 sent; out is
  // stored at dst (every lane of the row: each later reads only its own
  // store) and sent to every block of the cluster as the next carry
  auto step = [&](int s, float base, bool sub, float* dst) {
    const int k = s % D;
    mbar_wait(full + k, (s / D) & 1);
    const unsigned char* slab = ring + k * kSlab;
    float a[NC];
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      float w[4];
      row4<B, PACK>(slab, row, col(m), w);
#pragma unroll
      for (int e = 0; e < 4; ++e) a[4 * m + e] = w[e];
    }
    __syncwarp();                   // this warp is done with the slot
    if (lane == 0) mbar_arrive(empty + k);
    if (s >= 1) {                   // the carry step s - 1 sent
      mbar_wait(bars + (s & 1), ((s - 1) >> 1) & 1);
      if (tid == 32 && s + 2 < steps)
        mbar_expect(bars + (s & 1), kCarryBytes);
    }
    const float* cur = carry + (s & 1) * B;
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int m = 0; m < NCH; ++m) {
      const float4 v = *reinterpret_cast<const float4*>(cur + col(m));
      d[0] = fmaf(a[4 * m], v.x, d[0]);
      d[1] = fmaf(a[4 * m + 1], v.y, d[1]);
      d[2] = fmaf(a[4 * m + 2], v.z, d[2]);
      d[3] = fmaf(a[4 * m + 3], v.w, d[3]);
    }
    float acc = (d[0] + d[1]) + (d[2] + d[3]);
#pragma unroll
    for (int o = Q / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    const float out = sub ? base - acc : acc;
    if (dst != nullptr) *dst = out;
    if (s + 1 == steps) return;     // the last carry: nobody reads it
    const uint32_t nxt = (((s + 1) & 1) * B + grow) * 4;
#pragma unroll
    for (int k2 = 0; k2 < G::SENDS; ++k2)
      if (q + Q * k2 < C)
        st_async(rcarry[k2] + nxt, out, rbar[k2] + ((s + 1) & 1) * 8);
  };

  // forward, step i - 1: y_i = r_i - F_i y_{i-1} into slot i of x; r_i's
  // element kAhead steps ahead in registers
  float rq[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    rq[k] = 1 + k < nb ? __ldg(rp + static_cast<size_t>(1 + k) * B + grow)
                       : 0.0f;
  for (int i = 1; i < nb; ++i) {
    const float base = rq[0];
#pragma unroll
    for (int k = 0; k + 1 < kAhead; ++k) rq[k] = rq[k + 1];
    rq[kAhead - 1] = i + kAhead < nb
        ? __ldg(rp + static_cast<size_t>(i + kAhead) * B + grow) : 0.0f;
    step(i - 1, base, true, xp + static_cast<size_t>(i) * B + grow);
  }
  // the backward sweep's y_i (this thread's own stores; y_0 is r_0), two
  // block rows (four steps) ahead
  auto ybase = [&](int i) -> float {
    return i == 0 ? __ldg(rp + grow) : xp[static_cast<size_t>(i) * B + grow];
  };
  float y0 = nb >= 2 ? ybase(nb - 2) : 0.0f;
  float y1 = nb >= 3 ? ybase(nb - 3) : 0.0f;
  // x_{nb-1} = Sinv_{nb-1} y_{nb-1}
  step(nb - 1, 0.0f, false, xp + static_cast<size_t>(nb - 1) * B + grow);
  for (int i = nb - 2; i >= 0; --i) {
    const float base = y0;
    y0 = y1;
    y1 = i >= 2 ? ybase(i - 2) : 0.0f;
    const int s = nb + 2 * (nb - 2 - i);
    step(s, base, true, nullptr);                   // t_i = y_i - U_i x_{i+1}
    step(s + 1, 0.0f, false,                        // x_i = Sinv_i t_i
         xp + static_cast<size_t>(i) * B + grow);
  }
}

template <int B, int C, int PACK>
int run(const void* F, const void* Sinv, const void* U, const void* r,
        void* x, int K, int nb, cudaStream_t stream) {
  using G = Cfg<B, C, PACK>;
  auto kernel = fused_sweep_kernel<B, C, PACK>;
  const size_t smem = G::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(C) * K;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(G::kThreads);             // producer + compute warps
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const unsigned char*>(F),
                           static_cast<const unsigned char*>(Sinv),
                           static_cast<const unsigned char*>(U),
                           static_cast<const float*>(r),
                           static_cast<float*>(x), nb);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out: compute warps, ring slots, shared memory bytes a block
template <int B, int C, int PACK>
int describe(int* out) {
  using G = Cfg<B, C, PACK>;
  out[0] = G::W;
  out[1] = G::kDepth;
  out[2] = static_cast<int>(G::kSmemBytes);
  return 0;
}

template <int PACK>
int launch(const void* F, const void* Sinv, const void* U, const void* r,
           void* x, int K, int nb, int b, int cluster, void* stream) {
  if (K < 1 || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define RUN(B, C, P) run<B, C, P>(F, Sinv, U, r, x, K, nb, s)
  if (b == 128) {
    switch (cluster) {
      case 1: return RUN(128, 1, PACK);
      case 2: return RUN(128, 2, PACK);
      case 4: return RUN(128, 4, PACK);
    }
  } else if (b == 64) {
    switch (cluster) {
      case 1: return RUN(64, 1, PACK);
      case 2: return RUN(64, 2, PACK);
      case 4: return RUN(64, 4, PACK);
    }
  }
#undef RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int PACK>
int config(int b, int cluster, int* out) {
  if (b == 128) {
    switch (cluster) {
      case 1: return describe<128, 1, PACK>(out);
      case 2: return describe<128, 2, PACK>(out);
      case 4: return describe<128, 4, PACK>(out);
    }
  } else if (b == 64) {
    switch (cluster) {
      case 1: return describe<64, 1, PACK>(out);
      case 2: return describe<64, 2, PACK>(out);
      case 4: return describe<64, 4, PACK>(out);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int fused_sweep_f32(const void* F, const void* Sinv, const void* U,
                    const void* r, void* x, int K, int nb, int b, int cluster,
                    void* stream) {
  return launch<1>(F, Sinv, U, r, x, K, nb, b, cluster, stream);
}

int fused_sweep_bf16(const void* F, const void* Sinv, const void* U,
                     const void* r, void* x, int K, int nb, int b, int cluster,
                     void* stream) {
  return launch<2>(F, Sinv, U, r, x, K, nb, b, cluster, stream);
}

int fused_sweep_config(int b, int bf16, int cluster, int* out) {
  return bf16 ? config<2>(b, cluster, out) : config<1>(b, cluster, out);
}

const char* fused_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
