// Multi-RHS banded matvec Y[i, c] = sum_d band[i, d] * X[i + d - kl, c],
// X and Y [n, r] row-major f32, X zero outside rows [0, n).
//
// Replaces no Pallas kernel: the JAX package applies a band to r columns
// as a column loop of its band kernel or as batched block products
// (spike_petsc_tpu/solvers/operator.py `as_matvec_many`).  The port did
// the same (32 launches of band_matvec.cu and a stack a matvec, or a
// second at-rest copy of the operator in 128-blocks, 3 * 128 entries a row,
// and batched products), reading the band once a column or 1.9x its bytes.
// This kernel reads the band once for all r columns.
//
// Bound: bytes, and FMAs where the band is wide.  A call reads the n*w
// band entries once, X and writes Y: at n = 1e6, r = 32, f32, 388 MB at
// w = 33 (0.116 ms at 3.35 TB/s) and 1.06 GB at w = 201 (0.317 ms), for
// 2 n w r flops (12.9 GFLOP at w = 201: 0.192 ms at 67 TFLOP/s).  So the
// band streams through shared memory once, the FMAs run from registers,
// and shared memory must feed them without becoming the limit.  Design
// (each choice timed with experiments/torch_lab_band_many.py on an H100
// 80GB HBM3 at 700 W, n = 1e6, r = 32):
//   * a tile is kTile = 128 rows by kCols = 32 columns; a grid of
//     persistent blocks (as many as fit the SMs) walks the tiles (r > 32:
//     a tile per 32 columns, the ragged edge masked; r < 32 leaves lanes
//     idle, the band's bytes, which bound the apply, still read once);
//   * the diagonals of a tile come in chunks of dc (the plan,
//     ops/cuda/band_matvec_many.py), each chunk a stage of a ring of S
//     stages (2 or 3): the band slab d3[d0:d0+dc, i0:i0+128] of the
//     one-time diagonal-major layout (band_matvec.cu's), one bulk copy
//     (TMA) a diagonal under an L2 evict-first policy (the band passes
//     once), and the X window, rows [i0 + d0 - kl, i0 + 128 + d0 + dc - 1
//     - kl): one bulk copy under evict-normal (the next chunk and the
//     neighbouring tiles read its rows again) where X is [n, 32]
//     contiguous, the rows outside [0, n) zeroed by the threads (w = 201:
//     0.538 ms against 0.635 by 16-byte cp.async), else by 4-byte cp.async
//     that zero-fill rows outside [0, n) and columns past r.  The next
//     stages' copies are in flight while a stage is summed.  At w = 201
//     (f32) a stage of 34 diagonals (6 a tile, 3 blocks an SM) timed best:
//     101 (1 block an SM) 0.88 ms, 51 0.68, 34 0.63, 23 0.72, 12 0.89 (by
//     cp.async); a narrow band whose whole width fits a stage takes 3
//     stages (w = 33: 0.144 ms against 0.155 with 2), a wide one 2 (a
//     third costs it blocks an SM).  Tried and dropped: the next diagonal's loads one
//     step ahead, 16 rows a thread (200 registers), 256 threads a block,
//     X through L1 (cp.async.ca), a minimum of 3 blocks an SM by the
//     launch bounds: none faster;
//   * a thread owns 8 consecutive rows by 4 columns, 32 accumulators.  At
//     diagonal d row m needs X row m + d of its window, so the 8 X rows in
//     use slide by one a diagonal: they stay in registers and each
//     diagonal loads one new float4 of X and the 8 band entries of its
//     rows (two float4, or one of bf16), for 32 FMAs.  A warp (4 row
//     groups by 8 column groups) reads 4 whole X rows and 128 bytes of
//     band a diagonal: no bank conflicts, under one shared-memory
//     wavefront for 5 FFMA instructions;
//   * each row is summed over d in ascending order by fmaf from zero, as
//     band_matvec.cu does, so every column equals that kernel's result on
//     it bit for bit; bf16 band storage is promoted to f32 in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "async.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;                          // rows a thread
constexpr int kVec = 4;                           // columns a thread
constexpr int kCols = 32;                         // columns a tile
constexpr int kGroups = kCols / kVec;             // threads across a row
constexpr int kTile = kThreads / kGroups * kRows; // rows a tile: 128
constexpr int kMaxStages = 3;                     // the ring's depth, most
constexpr int kHead = 128;                        // the ring's mbarriers
constexpr int kMaxSmem = 232448;

__host__ __device__ inline long long round128(long long b) {
  return (b + 127) / 128 * 128;
}

// bytes of a stage's band slab and of a stage (band slab, X window)
__host__ __device__ inline long long band_slab_bytes(int dc, int es) {
  return round128(static_cast<long long>(dc) * kTile * es);
}

__host__ __device__ inline long long stage_bytes(int dc, int es) {
  return band_slab_bytes(dc, es) +
         round128(static_cast<long long>(kTile + dc - 1) * kCols * 4);
}

__host__ inline long long smem_bytes(int dc, int es, int stages) {
  return kHead + stages * stage_bytes(dc, es);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// an L2 policy for lines read again soon (the X rows that the next chunk
// and the neighbouring tiles share)
__device__ __forceinline__ uint64_t evict_normal_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// wait until at most `pending` of this thread's copy groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// the band entries of a thread's rows at one diagonal
__device__ __forceinline__ void band_rows(const float* p, float (&b)[kRows]) {
#pragma unroll
  for (int k = 0; k < kRows; k += 4) {
    const float4 u = *reinterpret_cast<const float4*>(p + k);
    b[k] = u.x; b[k + 1] = u.y; b[k + 2] = u.z; b[k + 3] = u.w;
  }
}

__device__ __forceinline__ void band_rows(const uint16_t* p,
                                          float (&b)[kRows]) {
  // bf16 -> f32 is a 16-bit left shift of the bit pattern
#pragma unroll
  for (int k = 0; k < kRows; k += 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p + k);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[k + 2 * j] = __uint_as_float(w[j] << 16);
      b[k + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ void load4(const float* p, float (&v)[kVec]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}

// Diagonals d .. d + kRows - 1 of a chunk of dn (d a multiple of kRows).
// `bs` and `xs` point at the thread's first row of the band slab and of
// the X window; window row j (from the thread's first) lives in slot
// j % kRows of `xw`.  kTail guards the diagonals at and past dn.
template <typename T, bool kTail>
__device__ __forceinline__ void diagonals(const T* bs, const float* xs,
                                          int d, int dn,
                                          float (&xw)[kRows][kVec],
                                          float (&acc)[kRows][kVec]) {
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    if (!kTail || d + s < dn) {
      load4(xs + (d + s + kRows - 1) * kCols, xw[(s + kRows - 1) % kRows]);
      float b[kRows];
      band_rows(bs + (d + s) * kTile, b);
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
#pragma unroll
        for (int c = 0; c < kVec; ++c) {
          acc[m][c] = fmaf(b[m], xw[(s + m) % kRows][c], acc[m][c]);
        }
      }
    }
  }
}

struct Args {
  const void* d3;
  const float* x;
  float* y;
  int n, kl, w, r, dc, chunks, col_tiles;
  long long ld, ldx, tiles;
  int band_bytes, stage_bytes;
  bool whole_rows, vec_y;
};

// S: the ring's depth (stages)
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
band_matvec_many_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kHead;
  const T* d3 = static_cast<const T*>(a.d3);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cg = tid % kGroups, rg = tid / kGroups;
  // this block's tiles: blockIdx.x, + gridDim.x, ... (the grid is at most
  // the tile count); an item is one chunk of one tile
  const long long items =
      (a.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * a.chunks;

  if (tid == 0) {
    for (int q = 0; q < S; ++q) mbar_init(full + q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const uint64_t policy = evict_first_policy();
  const uint64_t x_policy = evict_normal_policy();

  // the copies of item k into stage k % S (a commit group either way)
  auto fetch = [&](long long k) {
    if (k < items) {
      const long long tile = blockIdx.x + k / a.chunks * gridDim.x;
      const int d0 = static_cast<int>(k % a.chunks) * a.dc;
      const int dn = min(a.dc, a.w - d0);
      const long long i0 = tile / a.col_tiles * kTile;
      const int c0 = static_cast<int>(tile % a.col_tiles) * kCols;
      const int q = static_cast<int>(k % S);
      unsigned char* st = ring + q * a.stage_bytes;
      float* xs = reinterpret_cast<float*>(st + a.band_bytes);
      const long long g0 = i0 + d0 - a.kl;
      const int rows = kTile + dn - 1;
      // the window's rows [lo, hi) inside [0, n)
      const long long lo = min(max(g0, 0LL), g0 + rows);
      const long long hi = max(min(g0 + rows, static_cast<long long>(a.n)),
                               lo);
      const uint32_t x_bytes =
          a.whole_rows ? static_cast<uint32_t>(hi - lo) * kCols * 4 : 0;
      if (warp == 0) {
        // the band slab's rows stop at the layout's row stride
        const uint32_t row_bytes = static_cast<uint32_t>(
            min(static_cast<long long>(kTile), a.ld - i0) * sizeof(T));
        if (lane == 0) {
          mbar_expect(full + q, dn * row_bytes + x_bytes);
          if (x_bytes) {
            bulk_copy(xs + (lo - g0) * kCols, a.x + lo * kCols, x_bytes,
                      full + q, x_policy);
          }
        }
        __syncwarp();
        for (int d = lane; d < dn; d += 32) {
          bulk_copy(st + static_cast<size_t>(d) * kTile * sizeof(T),
                    d3 + (d0 + d) * a.ld + i0, row_bytes, full + q, policy);
        }
      }
      if (a.whole_rows) {
        // zeros for the rows outside [0, n) (the first and last tiles)
        const int head = static_cast<int>(lo - g0);
        const int tail = rows - static_cast<int>(hi - g0);
        if (head + tail > 0) {
          for (int e = tid; e < (head + tail) * kCols; e += kThreads) {
            const int j = e / kCols;
            xs[(j < head ? j : j - head + static_cast<int>(hi - g0)) * kCols +
               e % kCols] = 0.0f;
          }
          // before a later bulk copy writes the same bytes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
      } else {
        for (int e = tid; e < rows * kCols; e += kThreads) {
          const int j = e / kCols, c = c0 + e % kCols;
          const long long g = g0 + j;
          const bool live = g >= 0 && g < a.n && c < a.r;
          cp_async4(xs + j * kCols + c - c0, live ? a.x + g * a.ldx + c : a.x,
                    live ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };

  float acc[kRows][kVec];
  for (int k = 0; k < S - 1; ++k) fetch(k);
  for (long long k = 0; k < items; ++k) {
    const int chunk = static_cast<int>(k % a.chunks);
    const int dn = min(a.dc, a.w - chunk * a.dc);
    cp_async_wait<S - 2>();                // this thread's X copies of k
    mbar_wait(full + k % S, static_cast<uint32_t>((k / S) & 1));
    // everyone's copies of item k are in, and everyone is done with item
    // k - 1, whose stage the next copies fill
    __syncthreads();
    fetch(k + S - 1);
    const unsigned char* st = ring + k % S * a.stage_bytes;
    const T* bs = reinterpret_cast<const T*>(st) + rg * kRows;
    const float* xs = reinterpret_cast<const float*>(st + a.band_bytes) +
                      rg * kRows * kCols + cg * kVec;
    if (chunk == 0) {
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < kVec; ++c) acc[m][c] = 0.0f;
    }
    float xw[kRows][kVec];
#pragma unroll
    for (int j = 0; j < kRows - 1; ++j) load4(xs + j * kCols, xw[j]);
    int d = 0;
    for (; d + kRows <= dn; d += kRows) {
      diagonals<T, false>(bs, xs, d, dn, xw, acc);
    }
    if (d < dn) diagonals<T, true>(bs, xs, d, dn, xw, acc);

    if (chunk == a.chunks - 1) {
      const long long tile = blockIdx.x + k / a.chunks * gridDim.x;
      const long long i = tile / a.col_tiles * kTile + rg * kRows;
      const int c = static_cast<int>(tile % a.col_tiles) * kCols + cg * kVec;
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        if (i + m >= a.n) break;
        float* out = a.y + (i + m) * a.r + c;
        if (a.vec_y && c + kVec <= a.r) {
          *reinterpret_cast<float4*>(out) =
              make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            if (c + j < a.r) out[j] = acc[m][j];
          }
        }
      }
    }
  }
}

// The most blocks a grid of `kernel` (one storage type and ring depth)
// holds at once on device `dev` (SMs times blocks an SM at `smem` bytes):
// queried once for each kernel, device and shared-memory size, so a launch
// only sets the attribute.
cudaError_t grid_cap(const void* kernel, int dev, long long smem,
                     long long* blocks) {
  struct Cap {
    const void* kernel;
    int dev;
    long long smem, blocks;
  };
  static std::mutex mu;
  static std::vector<Cap> caps;
  std::lock_guard<std::mutex> lock(mu);
  for (const Cap& c : caps) {
    if (c.kernel == kernel && c.dev == dev && c.smem == smem) {
      *blocks = c.blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, static_cast<size_t>(smem))) !=
          cudaSuccess)
    return err;
  *blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  caps.push_back({kernel, dev, smem, *blocks});
  return cudaSuccess;
}

template <typename T>
int run(const void* d3, const void* x, void* y, int n, long long ld, int kl,
        int ku, int r, long long ldx, int dc, int stages,
        cudaStream_t stream) {
  const int w = kl + ku + 1;
  const long long smem = smem_bytes(dc, sizeof(T), stages);
  if (n < 1 || r < 1 || kl < 0 || ku < 0 || ld < n || ld % 64 ||
      ldx < r || dc < 1 || dc > w || stages < 2 || stages > kMaxStages ||
      smem > kMaxSmem || reinterpret_cast<uintptr_t>(d3) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = stages == 2 ? band_matvec_many_kernel<T, 2>
                            : band_matvec_many_kernel<T, 3>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  long long cap = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = grid_cap(reinterpret_cast<const void*>(kernel), dev, smem,
                      &cap)) != cudaSuccess)
    return static_cast<int>(err);
  Args a;
  a.d3 = d3;
  a.x = static_cast<const float*>(x);
  a.y = static_cast<float*>(y);
  a.n = n;
  a.kl = kl;
  a.w = w;
  a.r = r;
  a.dc = dc;
  a.chunks = (w + dc - 1) / dc;
  a.col_tiles = (r + kCols - 1) / kCols;
  a.ld = ld;
  a.ldx = ldx;
  a.tiles = (static_cast<long long>(n) + kTile - 1) / kTile * a.col_tiles;
  a.band_bytes = static_cast<int>(band_slab_bytes(dc, sizeof(T)));
  a.stage_bytes = static_cast<int>(stage_bytes(dc, sizeof(T)));
  a.whole_rows = r == kCols && ldx == kCols &&
                 reinterpret_cast<uintptr_t>(x) % 16 == 0;
  a.vec_y = r % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const long long grid = a.tiles < cap ? a.tiles : cap;
  kernel<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem),
           stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// d3: the diagonal-major band [w, ld] (band_matvec.cu's layout, ld a
// multiple of 64 >= n, 16-byte aligned); x: [n, r] f32 with row stride
// ldx >= r; y: [n, r] f32 contiguous; dc: diagonals a stage (1 .. w);
// stages: the ring's depth (2 or 3)
int band_matvec_many_f32(const void* d3, const void* x, void* y, int n,
                         long long ld, int kl, int ku, int r, long long ldx,
                         int dc, int stages, void* stream) {
  return run<float>(d3, x, y, n, ld, kl, ku, r, ldx, dc, stages,
                    static_cast<cudaStream_t>(stream));
}

int band_matvec_many_bf16(const void* d3, const void* x, void* y, int n,
                          long long ld, int kl, int ku, int r, long long ldx,
                          int dc, int stages, void* stream) {
  return run<uint16_t>(d3, x, y, n, ld, kl, ku, r, ldx, dc, stages,
                       static_cast<cudaStream_t>(stream));
}

const char* band_matvec_many_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
