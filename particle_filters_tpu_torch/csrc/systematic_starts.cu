// Kernel S: the child-run ends (or starts) of systematic resampling, from
// normalized weights or from log-weights and their log-normalizer, in one
// deterministic pass structure.
//
// For B rows of N f32 weights w and one f32 uniform u a row, with M
// positions (u + i)/M:
//   cdf   = the inclusive prefix sums of the row, accumulated in f64 and
//           rounded once to f32, kept nondecreasing by a running maximum
//           over the whole row;
//   t_j   = clamp(ceil(M * (cdf_j / cdf_{N-1}) - u), 0, M), each operation
//           rounded as PyTorch rounds it (an f32 divide, an f32 multiply by
//           float(M), an f32 subtract: no contracted FMA, which would round
//           M * cdf - u once where the plain version rounds twice);
// written as the (B, N) int32 run ends t, or (M = N) as the (B * N,) starts
// kernel B2 reads: row b's t shifted by one, its first start 0, all offset
// by b * N.
//
// Log domain: given a device pointer to the rows' f32 log-normalizers
// log_z (B,), the rows hold log-weights, and every pass that reads them
// forms w_i = expf(logw_i - log_z) (full precision) as it stages the tile;
// the rest is the same arithmetic on those w. No normalization pass comes
// before it: the caller's log_z is the filter step's row (kernel B1's). A
// log_z of -inf (every log-weight -inf) takes log(1e-30), the guarded value
// of the plain log_normalize, so the weights are 0 and not NaN. The mode is
// a template argument, so the linear kernels hold no trace of it.
//
// Replaces no TPU kernel. It replaces the plain version's ~35 PyTorch ops
// (ops/systematic_starts.py: a blocked f64 cumsum, a running maximum, the
// run-end arithmetic and the starts' shift), which move ~2.5 GB through HBM at
// N = 2^24 where the work needs one f32 weight read and one int32 written
// a row. What bounds it on the H100: bytes. The design reads the weights
// twice and writes the output once.
//
// Determinism: no atomics and no decoupled look-back. Every sum has one
// association, fixed by the shape alone:
// - a tile is kTile = 8192 weights of a row, staged in shared memory and
//   cut into kPerThread = 32 consecutive weights a thread; a thread's
//   partial sums are serial in f64 (from 0), the threads' totals are
//   scanned by a fixed shuffle pattern within a warp and serially over the
//   warps; s_i = base_thread + partial_i;
// - pass 1 (rows longer than one tile) writes each tile's total and its
//   largest prefix; pass 2, one block a row, scans the totals in the same
//   way into each tile's f64 offset O_k, and carries each tile's floor
//   g_k = max over earlier tiles j of fl32(O_j + largest prefix_j), which
//   is the guarded cdf at the tile's left edge because rounding is
//   monotone; the row's last cdf value is the largest of them;
// - pass 3 re-reads its tile, recomputes the same in-tile sums, and writes
//   t from max(g_k, the running maximum of fl32(O_k + s_i)).
// A row of one tile (the flows' clouds) takes pass 3 alone with O = 0 and
// no floor: the same arithmetic, so the bits do not depend on the path.
// Plain C interface, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 32;                // consecutive weights a thread
constexpr int kTile = kThreads * kPerThread;  // weights a tile
constexpr int kMaxN = 1 << 24;
constexpr int kMaxTiles = kMaxN / kTile;                    // tiles a row
constexpr int kTilesPerThread = kMaxTiles / kThreads;        // pass 2's share
// Blocks of the tile passes resident on an SM (registers capped to fit): 4 x
// 256 threads x 32 loads of 4 bytes in flight, far more than the HBM needs.
constexpr int kBlocksPerSM = 4;

// A tile in shared memory, one word of padding after every 32: a thread's
// 32 consecutive entries and a warp's 32 strided ones both fall in 32
// distinct banks.
constexpr int kStage = kTile + kTile / 32;
__device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

// Row's log-normalizer, with log_normalize's guard for a row of -inf.
__device__ __forceinline__ float row_log_z(const float* __restrict__ log_z, int row) {
  const float lz = __ldg(log_z + row);
  return lz == -INFINITY ? logf(1e-30f) : lz;
}

// Entries [0, len) of the tile at w into sm (zeros past len), coalesced:
// 16-byte loads where vec (w 16-byte aligned, len a multiple of 4). With
// kLog the entries are log-weights and go in as the weights exp(x - lz):
// each exp runs as its register goes to shared memory, once all the
// thread's loads are in flight.
template <bool kLog>
__device__ __forceinline__ void stage(const float* __restrict__ w, int len, float* sm,
                                      bool vec, float lz) {
  if (vec) {
    float4 v[kPerThread / 4];
#pragma unroll
    for (int r = 0; r < kPerThread / 4; ++r) {
      const int e = 4 * (r * kThreads + threadIdx.x);
      v[r] = e < len ? __ldg(reinterpret_cast<const float4*>(w + e))
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int r = 0; r < kPerThread / 4; ++r) {
      const int e = 4 * (r * kThreads + threadIdx.x);
      if (kLog && e < len) {
        v[r] = make_float4(expf(v[r].x - lz), expf(v[r].y - lz), expf(v[r].z - lz),
                           expf(v[r].w - lz));
      }
      sm[padded(e)] = v[r].x;
      sm[padded(e + 1)] = v[r].y;
      sm[padded(e + 2)] = v[r].z;
      sm[padded(e + 3)] = v[r].w;
    }
  } else {
    float v[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = r * kThreads + threadIdx.x;
      v[r] = e < len ? __ldg(w + e) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = r * kThreads + threadIdx.x;
      sm[padded(e)] = kLog && e < len ? expf(v[r] - lz) : v[r];
    }
  }
  __syncthreads();
}

// This thread's serial f64 sum of its kPerThread entries, and the largest
// partial sum over those below len (-inf if none).
__device__ __forceinline__ void thread_sums(const float* sm, int len, double& sum,
                                            double& top) {
  const int e0 = threadIdx.x * kPerThread;
  double s = 0.0, mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    s += static_cast<double>(sm[padded(e0 + j)]);
    if (e0 + j < len) mx = fmax(mx, s);
  }
  sum = s;
  top = mx;
}

// The exclusive prefix of v over the block's threads (lane shuffles, then
// the warps' totals serially) and, in total, the block's sum.
__device__ __forceinline__ double block_exclusive_sum(double v, double* warp_sum,
                                                      double& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = up + incl;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  double before = 0.0, all = 0.0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    if (k < warp) before += warp_sum[k];
    all += warp_sum[k];
  }
  total = all;
  return before + excl;
}

// The largest v over the threads before this one (-inf for thread 0) and,
// in all, over the whole block. Exact in any order.
__device__ __forceinline__ float block_exclusive_max(float v, float* warp_max, float& all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = fmaxf(up, incl);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = -INFINITY;
  if (lane == 31) warp_max[warp] = incl;
  __syncthreads();
  float before = -INFINITY, most = -INFINITY;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    if (k < warp) before = fmaxf(before, warp_max[k]);
    most = fmaxf(most, warp_max[k]);
  }
  all = most;
  return fmaxf(before, excl);
}

// t for the guarded cdf value y of a row whose last value is last.
__device__ __forceinline__ int run_end(float y, float last, float fm, float u) {
  const float c = __fdiv_rn(y, last);
  const float v = ceilf(__fsub_rn(__fmul_rn(fm, c), u));
  return static_cast<int>(fminf(fmaxf(v, 0.0f), fm));
}

// Pass 1: each tile's f64 total and largest prefix, at scratch[2 * tile].
// The tiles go last first, so that pass 3, first first, finds in L2 the
// weights this pass read last.
template <bool kLog>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
systematic_starts_tile_sums_kernel(const float* __restrict__ w,
                                   const float* __restrict__ log_z, int n, int tiles,
                                   double* __restrict__ scratch, bool vec) {
  __shared__ float sm[kStage];
  __shared__ double warp_sum[kWarps];
  __shared__ double warp_top[kWarps];
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int row = tile / tiles, k = tile % tiles;
  const int len = min(kTile, n - k * kTile);
  stage<kLog>(w + static_cast<long long>(row) * n + static_cast<long long>(k) * kTile, len, sm,
              vec, kLog ? row_log_z(log_z, row) : 0.0f);
  double sum, top;
  thread_sums(sm, len, sum, top);
  double total;
  top = block_exclusive_sum(sum, warp_sum, total) + top;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) top = fmax(top, __shfl_xor_sync(0xffffffffu, top, o));
  if ((threadIdx.x & 31) == 0) warp_top[threadIdx.x >> 5] = top;
  __syncthreads();
  if (threadIdx.x == 0) {
    double most = -INFINITY;
    for (int q = 0; q < kWarps; ++q) most = fmax(most, warp_top[q]);
    scratch[2LL * tile] = total;
    scratch[2LL * tile + 1] = most;
  }
}

// Pass 2's row of (total, largest prefix) pairs in shared memory, one
// double of padding after every 16: a thread's run of pairs and a warp's
// coalesced copy both spread over the banks.
__device__ __forceinline__ int padded2(int i) { return i + (i >> 4); }

// Pass 2, one block a row: in place of each tile's (total, largest prefix)
// its f64 offset O_k and its floor g_k; the row's last cdf value in last.
// The row's pairs go through shared memory, copied in and out coalesced.
__global__ void __launch_bounds__(kThreads)
systematic_starts_tile_offsets_kernel(double* __restrict__ scratch, int tiles,
                                      double* __restrict__ last) {
  __shared__ double pairs[2 * kMaxTiles + 2 * kMaxTiles / 16];
  __shared__ double warp_sum[kWarps];
  __shared__ float warp_max[kWarps];
  double* g = scratch + 2LL * blockIdx.x * tiles;
  for (int i = threadIdx.x; i < 2 * tiles; i += kThreads) pairs[padded2(i)] = g[i];
  __syncthreads();
  const int per = (tiles + kThreads - 1) / kThreads;  // <= kTilesPerThread
  const int k0 = min(static_cast<int>(threadIdx.x) * per, tiles);
  const int k1 = min(k0 + per, tiles);
  double tot[kTilesPerThread], top[kTilesPerThread];
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < kTilesPerThread; ++i) {
    tot[i] = top[i] = 0.0;
    if (k0 + i < k1) {
      tot[i] = pairs[padded2(2 * (k0 + i))];
      top[i] = pairs[padded2(2 * (k0 + i) + 1)];
      sum += tot[i];
    }
  }
  double total;
  double run = block_exclusive_sum(sum, warp_sum, total);
  double off[kTilesPerThread];
  float y[kTilesPerThread];
  float most = -INFINITY;
#pragma unroll
  for (int i = 0; i < kTilesPerThread; ++i) {
    off[i] = run;
    y[i] = -INFINITY;
    if (k0 + i < k1) {
      y[i] = __double2float_rn(run + top[i]);
      run = run + tot[i];
      most = fmaxf(most, y[i]);
    }
  }
  float all;
  float floor = block_exclusive_max(most, warp_max, all);
#pragma unroll
  for (int i = 0; i < kTilesPerThread; ++i) {
    if (k0 + i < k1) {
      pairs[padded2(2 * (k0 + i))] = off[i];
      pairs[padded2(2 * (k0 + i) + 1)] = static_cast<double>(floor);
      floor = fmaxf(floor, y[i]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * tiles; i += kThreads) g[i] = pairs[padded2(i)];
  if (threadIdx.x == 0) last[blockIdx.x] = static_cast<double>(all);
}

// Pass 3 (the only pass for a row of one tile): the tile's run ends, or the
// starts (shifted by one, offset by row * n).
template <bool kLog>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
systematic_starts_write_kernel(const float* __restrict__ w, const float* __restrict__ log_z,
                               const float* __restrict__ u,
                               const double* __restrict__ scratch,
                               const double* __restrict__ last, int* __restrict__ out,
                               int n, int tiles, int m, int starts_form, bool vec) {
  __shared__ float sm[kStage];  // the weights, then the run ends' bits in their slots
  __shared__ double warp_sum[kWarps];
  __shared__ float warp_max[kWarps];
  const int row = blockIdx.x / tiles, k = blockIdx.x % tiles;
  const int len = min(kTile, n - k * kTile);
  const long long at = static_cast<long long>(row) * n + static_cast<long long>(k) * kTile;
  double off = 0.0;
  float floor = -INFINITY;
  if (tiles > 1) {
    off = scratch[2LL * blockIdx.x];
    floor = static_cast<float>(scratch[2LL * blockIdx.x + 1]);
  }
  stage<kLog>(w + at, len, sm, vec, kLog ? row_log_z(log_z, row) : 0.0f);
  double sum, top;
  thread_sums(sm, len, sum, top);
  double total;
  const double base = block_exclusive_sum(sum, warp_sum, total);
  float all;
  float run = fmaxf(floor, block_exclusive_max(__double2float_rn(off + (base + top)),
                                               warp_max, all));
  const float end = tiles > 1 ? static_cast<float>(last[row]) : all;
  const float fm = static_cast<float>(m), uu = __ldg(u + row);

  const int e0 = threadIdx.x * kPerThread;
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    s += static_cast<double>(sm[padded(e0 + j)]);
    run = fmaxf(run, __double2float_rn(off + (base + s)));
    sm[padded(e0 + j)] = __int_as_float(run_end(run, end, fm, uu));
  }
  __syncthreads();

  // Output e is run end e, or start e = run end e - 1 (the tile's first from
  // its floor), offset by row * n.
  int* dst = out + at;
  const int shift = starts_form ? row * n : 0;
  const int back = starts_form ? 1 : 0;
  const int first = k == 0 ? 0 : run_end(floor, end, fm, uu);
  const auto value = [&](int e) {
    return shift + (e < back ? first : __float_as_int(sm[padded(e - back)]));
  };
  if (vec) {  // 16-byte stores
#pragma unroll 4
    for (int r = 0; r < kPerThread / 4; ++r) {
      const int e = 4 * (r * kThreads + threadIdx.x);
      if (e < len) {
        *reinterpret_cast<int4*>(dst + e) =
            make_int4(value(e), value(e + 1), value(e + 2), value(e + 3));
      }
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < kPerThread; ++r) {
      const int e = r * kThreads + threadIdx.x;
      if (e < len) dst[e] = value(e);
    }
  }
}

}  // namespace

// rows x n weights w (log-weights where log_z, rows log-normalizers, is not
// null) and rows uniforms u; scratch holds 2 * rows * tiles + rows doubles
// where tiles > 1 (none for one tile); out rows * n int32. starts_form needs
// m == n. Returns the first launch error, or 0.
extern "C" int pf_systematic_starts(const float* w, const float* log_z, const float* u,
                                    double* scratch, int* out, int rows, int n, int tiles,
                                    int m, int starts_form, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (n > kMaxN || m <= 0 || m > kMaxN || tiles != (n + kTile - 1) / kTile ||
      static_cast<long long>(rows) * n > 0x7fffffffLL || (starts_form && m != n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = rows * tiles;
  const bool vec = n % 4 == 0 && reinterpret_cast<unsigned long long>(w) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(out) % 16 == 0;
  double* last = tiles > 1 ? scratch + 2LL * blocks : nullptr;
  const auto tile_sums = log_z != nullptr ? &systematic_starts_tile_sums_kernel<true>
                                          : &systematic_starts_tile_sums_kernel<false>;
  const auto write = log_z != nullptr ? &systematic_starts_write_kernel<true>
                                      : &systematic_starts_write_kernel<false>;
  if (tiles > 1) {
    tile_sums<<<blocks, kThreads, 0, s>>>(w, log_z, n, tiles, scratch, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    systematic_starts_tile_offsets_kernel<<<rows, kThreads, 0, s>>>(scratch, tiles, last);
    const cudaError_t err2 = cudaGetLastError();
    if (err2 != cudaSuccess) return static_cast<int>(err2);
  }
  write<<<blocks, kThreads, 0, s>>>(w, log_z, u, scratch, last, out, n, tiles, m, starts_form,
                                    vec);
  return static_cast<int>(cudaGetLastError());
}
