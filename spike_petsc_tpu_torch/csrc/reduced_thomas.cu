// Block-Thomas solve of one method='inv' factor with no partitions, both
// sweeps in one kernel:
//   forward   y_0 = r_0,  y_i = r_i - F_i y_{i-1}
//   backward  x_{nb-1} = Sinv_{nb-1} y_{nb-1},  x_i = Sinv_i (y_i - U_i x_{i+1})
// F/Sinv/U of shape [nb, B, B] row-major f32, 16-byte aligned, B even and
// at most 256; r and x contiguous [nb, B, ncols] f32 (ncols = 1: [nb, B]).
//
// Replaces no Pallas kernel: the JAX package runs this solve as one
// compiled lax.scan (spike_petsc_tpu/ops/blocktri.py).  The port's plain
// version (ops/blocktri.py blocktri_solve) is a Python loop of 3 nb - 2
// products and 2 nb - 2 subtractions: about 500 launches a solve of the
// flagship's reduced system (nb = 63, B = 200, 32 columns), whose host time
// paced the whole PC apply.
//
// Bound: the chain.  A solve reads 3 nb - 2 matrices once (29.9 MB at the
// flagship: 9 us at 3.35 TB/s; 0.24 GFMA at r = 32: 7 us at 67 TFLOP/s
// f32), but each of its 3 nb - 2 steps needs the whole result of the step
// before.  Design:
//   * the columns are independent: cluster g of the grid takes columns
//     [g RC, (g + 1) RC); the blocks of a cluster split each step's B rows,
//     block j rows [j R, j R + R_j), R B a multiple of 4 so that every row
//     slab starts and ends on 16 bytes;
//   * the carry (the last y, t or x: B x RC floats) sits in shared memory in
//     every block of the cluster, double-buffered; each output value goes to
//     every block of the cluster by st.async, whose bytes complete on an
//     mbarrier of the receiving block (as fused_sweep.cu).  No step pays a
//     cluster barrier;
//   * the matrices do not depend on the carry: a producer warp keeps a ring
//     of D row slabs full, one bulk copy (TMA) a slab under L2 evict-first,
//     and a compute warp reads its rows of the next slab into registers
//     before it waits for the carry;
//   * a compute warp owns 4 rows; lane l takes the columns l, l + 32, ... of
//     the matrix (conflict-free reads of the slab and of the carry) for all
//     RC carry columns, so a carry value loaded once serves 4 rows.  The
//     4 RC sums of a lane are reduced and scattered over the warp in one
//     butterfly (4 RC - 1 + 5 - log2(4 RC) shuffles a lane), after which
//     each lane holds one (row, column) result and sends it to its share of
//     the cluster's blocks;
//   * products are f32 FMAs: no TF32, no lower-precision factor.
// The cluster size C, the columns a cluster RC and the ring depth D come
// from the plan in ops/cuda/reduced_thomas.py (timed there).  No block sends
// a carry after the last step, so none writes into a block that may have
// exited.
// Measured (experiments/torch_lab_reduced.py, an H100 80GB HBM3 at 700 W):
// 0.199 ms a solve at [63, 200, 200], r = 32, 0.167 at r = 1: about 1 us a
// step, where #1 takes 0.25-0.33 us a step on one partition of 63 block
// rows (b = 64, 128).  Clock reads in an instrumented copy put 40-50% of a
// step in the carry product and its butterfly, ~20% in reading the slab and
// ~10% each in the ring wait, the carry wait and the sends.  Tried without
// gain: ring depths 2 to 8, L2 evict-last, 12 and 16 blocks a cluster,
// sending only to its own block (the exchange is not the cost), bases read
// without the global loads, test_wait spins, one lane waiting for its warp
// (slower), and one loop over the steps in place of the four call sites
// (slower).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarpRows = 4;              // rows a compute warp
constexpr int kMaxB = 256;
constexpr int kMaxT = kMaxB / 32;         // matrix columns a lane, at most
constexpr int kMaxRows = 64;              // rows a block
constexpr int kMaxWarps = kMaxRows / kWarpRows;
constexpr int kMaxThreads = 32 * (1 + kMaxWarps);
constexpr int kMaxDepth = 8;
constexpr int kMaxCluster = 16;
constexpr int kHead = 256;                // mbarriers: carry 2, ring 2 x 8
constexpr int kAhead = 4;                 // steps a base value is read ahead
static_assert(8 * (2 + 2 * kMaxDepth) <= kHead, "mbarriers fit the head");

__host__ __device__ constexpr int ring_slot_bytes(int rows, int b) {
  return (rows * b * 4 + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t smem_bytes(int rows, int b, int rc,
                                                int depth) {
  return kHead + static_cast<size_t>(depth) * ring_slot_bytes(rows, b) +
         2 * static_cast<size_t>(b) * rc * 4;
}

// row k of one carry buffer ([B][RC] floats): one vector load, and
// consecutive lanes read consecutive vectors
template <int RC>
__device__ __forceinline__ void load_carry(const float* buf, int k,
                                           float (&v)[RC]) {
  if constexpr (RC == 1) {
    v[0] = buf[k];
  } else if constexpr (RC == 2) {
    const float2 w = *reinterpret_cast<const float2*>(buf + 2 * k);
    v[0] = w.x; v[1] = w.y;
  } else {
    const float4 w = *reinterpret_cast<const float4*>(buf + 4 * k);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  }
}

// reduce and scatter the V sums of each lane over the warp: at offset o
// (16, 8, ...) the lanes with bit o keep the upper half of their sums and
// send the lower half, the others the reverse; once one sum is left the
// offsets below reduce it whole.  Lane l ends with sum l >> (5 - log2 V)
template <int V, int L>
__device__ __forceinline__ void butterfly(float (&acc)[V], int lane) {
  constexpr int o = 16 >> L, n = V >> L;
  if constexpr (n > 1) {
    const bool up = lane & o;
#pragma unroll
    for (int e = 0; e < n / 2; ++e) {
      const float lo = acc[e], hi = acc[e + n / 2];
      acc[e] = (up ? hi : lo) +
               __shfl_xor_sync(0xffffffffu, up ? lo : hi, o);
    }
  } else {
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
  }
  if constexpr (L < 4) butterfly<V, L + 1>(acc, lane);
}

template <int RC>
__global__ void __launch_bounds__(kMaxThreads, 1)
reduced_thomas_kernel(const float* __restrict__ F,
                      const float* __restrict__ Sinv,
                      const float* __restrict__ U,
                      const float* __restrict__ r, float* x, int nb,
                      int B, int ncols, int R, int D) {
  constexpr int V = kWarpRows * RC;       // sums a lane, before the butterfly
  constexpr int LV = V == 4 ? 2 : V == 8 ? 3 : 4;
  constexpr int NR = 32 / V;              // lanes holding each result
  static_assert(RC == 1 || RC == 2 || RC == 4, "RC is 1, 2 or 4");
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);        // [2] carry
  uint64_t* full = bars + 2;                                 // [D] ring
  uint64_t* empty = full + kMaxDepth;                        // [D] ring
  const int slot = ring_slot_bytes(R, B);
  unsigned char* ring = smem + kHead;
  float* carry = reinterpret_cast<float*>(ring + static_cast<size_t>(D) *
                                          slot);             // [2][B RC]

  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int col0 = static_cast<int>(blockIdx.x) / C * RC;
  const int tid = threadIdx.x;
  const int grow0 = c * R;                     // the first row this block owns
  const int rows = min(R, B - grow0);          // > 0 by the plan
  const int warps = (rows + kWarpRows - 1) / kWarpRows;
  const size_t mat = static_cast<size_t>(B) * B;
  const uint32_t kSlab = static_cast<uint32_t>(rows) * B * 4;
  const uint32_t kCarryBytes = static_cast<uint32_t>(B) * RC * 4;
  const int steps = 3 * nb - 2;
  const long long bstride = static_cast<long long>(B) * ncols;  // block row

  // step s's matrix: F_{s+1} for s < nb - 1, Sinv_{nb-1} at s = nb - 1,
  // then U_i, Sinv_i for i = nb - 2 .. 0; this block's slab of it
  auto slab_src = [&](int s) -> const float* {
    const float* m;
    if (s < nb - 1) {
      m = F + static_cast<size_t>(s + 1) * mat;
    } else if (s == nb - 1) {
      m = Sinv + static_cast<size_t>(nb - 1) * mat;
    } else {
      const int t = s - nb, i = nb - 2 - t / 2;
      m = ((t & 1) ? Sinv : U) + static_cast<size_t>(i) * mat;
    }
    return m + static_cast<size_t>(grow0) * B;
  };

  const uint64_t policy = evict_first_policy();
  auto fill = [&](int j) {
    const int k = j % D;
    mbar_expect(full + k, kSlab);
    bulk_copy(ring + k * slot, slab_src(j), kSlab, full + k, policy);
  };
  if (tid == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 1, 1);
    for (int q = 0; q < D; ++q) {
      mbar_init(full + q, 1);                   // the producer's arrival
      mbar_init(empty + q, warps);              // the compute warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (steps > 1) mbar_expect(bars + 1, kCarryBytes);   // step 0's sends
    if (steps > 2) mbar_expect(bars, kCarryBytes);       // step 1's
    for (int j = 0; j < D && j < steps; ++j) fill(j);
  }
  // y_0 = r_0: the first carry, every block loads all of it
  for (int e = tid; e < B * RC; e += blockDim.x) {
    const int k = e / RC, cc = e % RC, col = col0 + cc;
    carry[e] = col < ncols ? r[static_cast<size_t>(k) * ncols + col] : 0.0f;
  }
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
  const int warp = tid / 32 - 1, lane = tid % 32;
  if (warp >= warps) return;                   // rows past this block's

  // after the butterfly lane l holds sum idx = l >> (5 - LV): row
  // idx / RC of the warp, column idx % RC; its NR copies split the sends
  const int idx = lane >> (5 - LV), rep = lane & (NR - 1);
  const int wrow = warp * kWarpRows;           // block-local
  const int row = wrow + idx / RC, cc = idx % RC;
  const int grow = grow0 + row, col = col0 + cc;
  const bool live = row < rows;                // a row of the matrix
  const bool real = live && col < ncols;       // and a column of r
  const float* rrow = nullptr;
  float* xrow = nullptr;
  if (real) {
    rrow = r + static_cast<size_t>(grow) * ncols + col;
    xrow = x + static_cast<size_t>(grow) * ncols + col;
  }
  const uint32_t carry_addr =
      smem_addr(carry) + (grow * RC + cc) * 4;
  const uint32_t bar_addr = smem_addr(bars);

  auto rval = [&](int i) -> float {
    return real ? __ldg(rrow + i * bstride) : 0.0f;
  };

  // one step: out = base - M v (sub) or M v for this lane's (row, column),
  // M this block's slab in ring slot s % D, v the carry step s - 1 sent;
  // out is stored at x row dst (none for dst < 0) and sent to every block
  // of the cluster as the next carry
  auto step = [&](int s, float base, bool sub, int dst) {
    const int k = s % D;
    mbar_wait(full + k, (s / D) & 1);
    const float* slab = reinterpret_cast<const float*>(ring + k * slot);
    float a[kWarpRows][kMaxT];
#pragma unroll
    for (int tr = 0; tr < kWarpRows; ++tr)
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        const int kk = lane + 32 * t;
        a[tr][t] = (wrow + tr < rows && kk < B)
                       ? slab[(wrow + tr) * B + kk] : 0.0f;
      }
    __syncwarp();                   // this warp is done with the slot
    if (lane == 0) mbar_arrive(empty + k);
    if (s >= 1) {                   // the carry step s - 1 sent
      mbar_wait(bars + (s & 1), ((s - 1) >> 1) & 1);
      if (tid == 32 && s + 2 < steps)
        mbar_expect(bars + (s & 1), kCarryBytes);
    }
    const float* cur = carry + (s & 1) * B * RC;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int kk = lane + 32 * t;
      if (32 * t < B) {             // the same for every lane of the warp
        float v[RC];
        if (kk < B) {
          load_carry<RC>(cur, kk, v);
        } else {
#pragma unroll
          for (int e = 0; e < RC; ++e) v[e] = 0.0f;
        }
#pragma unroll
        for (int tr = 0; tr < kWarpRows; ++tr)
#pragma unroll
          for (int e = 0; e < RC; ++e)
            acc[tr * RC + e] = fmaf(a[tr][t], v[e], acc[tr * RC + e]);
      }
    }
    butterfly<V, 0>(acc, lane);
    const float out = sub ? base - acc[0] : acc[0];
    if (dst >= 0 && real) xrow[dst * bstride] = out;
    if (s + 1 == steps || !live) return;   // the last carry: nobody reads it
    const uint32_t nxt = ((s + 1) & 1) * kCarryBytes;
    for (int b2 = rep; b2 < C; b2 += NR)
      st_async(map_rank(carry_addr + nxt, b2), out,
               map_rank(bar_addr + ((s + 1) & 1) * 8, b2));
  };

  // forward, step i - 1: y_i = r_i - F_i y_{i-1} into row i of x; r_i
  // kAhead steps ahead in registers
  float rq[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) rq[k] = 1 + k < nb ? rval(1 + k) : 0.0f;
  for (int i = 1; i < nb; ++i) {
    const float base = rq[0];
#pragma unroll
    for (int k = 0; k + 1 < kAhead; ++k) rq[k] = rq[k + 1];
    rq[kAhead - 1] = i + kAhead < nb ? rval(i + kAhead) : 0.0f;
    step(i - 1, base, true, i);
  }
  // the backward sweep's y_i (this thread's own stores; y_0 is r_0), two
  // block rows (four steps) ahead
  auto ybase = [&](int i) -> float {
    if (!real) return 0.0f;
    return i == 0 ? rval(0) : xrow[i * bstride];
  };
  float y0 = nb >= 2 ? ybase(nb - 2) : 0.0f;
  float y1 = nb >= 3 ? ybase(nb - 3) : 0.0f;
  // x_{nb-1} = Sinv_{nb-1} y_{nb-1}
  step(nb - 1, 0.0f, false, nb - 1);
  for (int i = nb - 2; i >= 0; --i) {
    const float base = y0;
    y0 = y1;
    y1 = i >= 2 ? ybase(i - 2) : 0.0f;
    const int s = nb + 2 * (nb - 2 - i);
    step(s, base, true, -1);                        // t_i = y_i - U_i x_{i+1}
    step(s + 1, 0.0f, false, i);                    // x_i = Sinv_i t_i
  }
}

template <int RC>
int run(const float* F, const float* Sinv, const float* U, const float* r,
        float* x, int nb, int B, int ncols, int cluster, int R, int D,
        cudaStream_t stream) {
  auto kernel = reduced_thomas_kernel<RC>;
  const size_t smem = smem_bytes(R, B, RC, D);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long groups = (static_cast<long long>(ncols) + RC - 1) / RC;
  const long long blocks = groups * cluster;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(32 * (1 + (R + kWarpRows - 1) / kWarpRows));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, F, Sinv, U, r, x, nb, B, ncols, R,
                           D);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// cluster: blocks a cluster (1 .. 16); cols: columns a cluster (1, 2 or
// 4); rows: rows a block, at most 64, rows B a multiple of 4, with
// (cluster - 1) rows < B <= cluster rows; depth: ring slots (2 .. 8)
int reduced_thomas_f32(const void* F, const void* Sinv, const void* U,
                       const void* r, void* x, int nb, int B, int ncols,
                       int cluster, int cols, int rows, int depth,
                       void* stream) {
  if (nb < 1 || ncols < 1 || B < 2 || B > kMaxB || B % 2 || cluster < 1 ||
      cluster > kMaxCluster || rows < 1 ||
      rows * B % 4 || rows > kMaxRows || (cluster - 1) * rows >= B ||
      cluster * rows < B || depth < 2 || depth > kMaxDepth ||
      smem_bytes(rows, B, cols, depth) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(F);
  const auto* si = static_cast<const float*>(Sinv);
  const auto* u = static_cast<const float*>(U);
  const auto* rr = static_cast<const float*>(r);
  auto* xx = static_cast<float*>(x);
#define RUN(RC) \
  run<RC>(f, si, u, rr, xx, nb, B, ncols, cluster, rows, depth, s)
  switch (cols) {
    case 1: return RUN(1);
    case 2: return RUN(2);
    case 4: return RUN(4);
  }
#undef RUN
  return static_cast<int>(cudaErrorInvalidValue);
}

// the shared memory bytes a block of this geometry takes
int reduced_thomas_smem(int B, int cols, int rows, int depth) {
  return static_cast<int>(smem_bytes(rows, B, cols, depth));
}

const char* reduced_thomas_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
