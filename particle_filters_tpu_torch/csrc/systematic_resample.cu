// Kernel B2: systematic-resampled particle values from the sorted child-run
// starts, by a merge-path load-balanced search.
//
// out[i, :] = p[j(i), :] with j(i) = max{j : starts[j] <= off + i} for the
// n outputs i < n, over M starts and M rows of p, where starts[j] =
// ceil(N * cdf[j-1] - u) is the first output slot of ancestor j
// (nondecreasing, starts[0] <= off). An ancestor with no children shares its
// start with the next one, and the largest such j wins. The whole cloud is
// M = n, off = 0; a rank's slice of a sharded resample is its n outputs from
// off = rank * n, over the gathered cloud (M = N) or over its neighbour pool
// (M = (2r + 1) * n). Every start is read through min(max(s - off, 0), n),
// which keeps the starts sorted, so the merge below is that of M clamped
// starts with n outputs and the shift costs no pass of its own.
//
// Replaces particle_filters_tpu/ops/resample_pallas.py::_resample_kernel. The
// function is ModernGPU's load-balancing search: merge the M starts with the
// n output positions, a start j before output i when starts[j] <= i (ties
// take the start first, which is what makes zero-child ancestors come out
// right); the ancestor of an output is the last start merged before it.
//
// What bounds it on the H100: bytes (12 MiB at N = 2^20, d = 1). A search
// per output is 20 dependent L2 round trips; here the M + n merge items are cut
// along merge-path diagonals into blocks of kItems, so every block does the
// same work at any weight degeneracy (a block of a point mass holds only
// starts, or only outputs of one ancestor), and:
// 1. warps 0 and 1 bracket the splits (a0, b0) and (a1, b1) of the block's
//    two diagonals to at most kBracket candidates each, kWays probes a round
//    counted by ballots (no block barrier): the first round on a global grid,
//    the same points for every block (they hit in L1 and L2), the next ones
//    within the bracket (two rounds at N = 2^20);
// 2. the block stages starts[a0 - bracket, a1 + bracket) in shared memory
//    with 16-byte cp.async copies and finds both splits there;
// 3. the ancestors of the block's outputs by a scatter and a scan, with no
//    serial merge: the last start j of each run of equal starts s marks
//    output s (mark[s - b0] = j), and an inclusive max-scan of the marks from
//    a0 - 1 gives every output max{j : starts[j] <= i} (marks grow with the
//    output). Each thread scans kPerThread consecutive marks in registers,
//    the warps combine by shuffles; a serial merge of 16 items a thread
//    issued about eight times the instructions, with divergent branches;
// 4. the block copies the ancestors' values to its consecutive outputs with
//    16-byte stores (rows of d floats, any d; a scalar head and tail).
// On the card each of these phases waits about one memory latency and the
// blocks, all resident at once, pass through them together, so at N = 2^20
// the phases more than the bytes set the kernel's time (PERF.md). The copy
// is exact, so the result equals p[idx] bit for bit.
//
// Gate: given a device pointer to an int32 trigger, every block reads it
// first and returns at once where it is 0, writing nothing (the fused SIR
// filter's captured run launches B2 every step and lets its step's trigger,
// written by kernel B1, decide). A null gate launches as without one. Plain C
// interface, bound with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;                 // marks a thread scans
constexpr int kItems = kPerThread * kThreads;  // merge items per block
constexpr int kProbes = 4;                     // search probes a lane a round
constexpr int kWays = 32 * kProbes;            // search probes a round (one warp)
constexpr int kBracket = 128;                  // candidates staged with the window

// The starts as the merge sees them: shifted by off and clamped to [0, n].
struct Starts {
  const int* __restrict__ p;
  int m, n, off;
  __device__ __forceinline__ int at(int v) const { return min(max(v - off, 0), n); }
  __device__ __forceinline__ int load(long long g) const { return at(__ldg(p + g)); }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// The split of diagonal d of the merge is the number of starts among its
// first d items: P(a) = starts[a] <= d - 1 - a holds for a below it and
// fails from it on. One search round of a warp: probe k (k = lane * kProbes
// + r) at grid[k]; Q(k) = grid[k] < lo || (grid[k] < hi && P(grid[k])) is
// true then false over k, and the count c of true probes brackets the split
// between grid[c - 1] + 1 and grid[c]. All lanes return the same bracket.
template <typename Grid>
__device__ __forceinline__ void search_round(const Starts& starts, long long d, int& lo,
                                             int& hi, Grid grid) {
  const int lane = threadIdx.x & 31;
  int v[kProbes];
#pragma unroll
  for (int r = 0; r < kProbes; ++r) {  // every load of the round in flight at once
    const long long g = grid(lane * kProbes + r);
    v[r] = (g >= lo && g < hi) ? starts.load(g) : 0;
  }
  int c = 0;
#pragma unroll
  for (int r = 0; r < kProbes; ++r) {
    const long long g = grid(lane * kProbes + r);
    c += __popc(__ballot_sync(0xffffffffu, g < lo || (g < hi && v[r] <= d - 1 - g)));
  }
  const int new_lo =
      c > 0 ? static_cast<int>(max(static_cast<long long>(lo), grid(c - 1) + 1)) : lo;
  hi = c < kWays ? static_cast<int>(min(static_cast<long long>(hi), grid(c))) : hi;
  lo = new_lo;
}

// [lo, hi] brackets the split of diagonal d, hi - lo <= kBracket.
__device__ __forceinline__ void bracket_split(const Starts& starts, long long d, int& lo,
                                              int& hi) {
  const int n = starts.n, m = starts.m;
  lo = static_cast<int>(d > n ? d - n : 0);
  hi = static_cast<int>(d < m ? d : m);
  const long long step = (m + kWays - 1) / kWays;
  search_round(starts, d, lo, hi, [=](int k) { return k * step; });
  while (hi - lo > kBracket) {  // one more round at N = 2^20
    const long long base = lo;
    const long long s = (hi - lo + kWays - 1) / kWays;
    search_round(starts, d, lo, hi, [=](int k) { return base + k * s; });
  }
}

// The split of diagonal d in [lo, hi], from win[a - base] = starts[a].
__device__ __forceinline__ int split_in(const Starts& starts, const int* win, int base,
                                        long long d, int lo, int hi) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (starts.at(win[mid - base]) <= d - 1 - mid) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Marks are stored with 4 words of padding after every 16, so that the
// 16-byte accesses of a thread's kPerThread marks are free of bank conflicts.
__device__ __forceinline__ int padded(int i) { return i + 4 * (i >> 4); }

__device__ __forceinline__ float ancestor_value(const float* __restrict__ p,
                                                const int* anc, int b0, int d, long long e) {
  const long long row = e / d;
  return __ldg(p + static_cast<long long>(anc[padded(static_cast<int>(row - b0))]) * d +
               (e - row * d));
}

__global__ void __launch_bounds__(kThreads)
merge_path_resample_kernel(const float* __restrict__ p, const Starts starts,
                           float* __restrict__ out, const int* gate, int d) {
  // starts[base, wend) from a 16-byte boundary: the brackets and the block's starts.
  __shared__ __align__(16) int win[kItems + 2 * kBracket + 8];
  // The marks, then the ancestor of each of the block's outputs (padded).
  __shared__ __align__(16) int anc[kItems + kItems / 4];
  __shared__ int bracket[4];
  __shared__ int warp_max[kThreads / 32];
  static_assert(kPerThread == 16, "a thread's marks are one padded row of 16");

  if (gate != nullptr && *gate == 0) return;  // the same for every block
  const int m = starts.m;
  const long long d0 = static_cast<long long>(blockIdx.x) * kItems;
  const long long d1 = min(d0 + kItems, static_cast<long long>(m) + starts.n);
  if (threadIdx.x < 64) {  // warp 0 the first diagonal, warp 1 the second
    const int w = threadIdx.x >> 5;
    int lo, hi;
    bracket_split(starts, w == 0 ? d0 : d1, lo, hi);
    if ((threadIdx.x & 31) == 0) {
      bracket[2 * w] = lo;
      bracket[2 * w + 1] = hi;
    }
  }
  __syncthreads();

  // Both brackets hold at most kBracket candidates around splits kItems
  // apart at most, so the window holds at most kItems + 2 * kBracket starts.
  const int base = min(bracket[0], bracket[2]) & ~3;
  const int wend = max(bracket[1], bracket[3]);
  for (int v = threadIdx.x; 4 * v < wend - base; v += kThreads) {
    const int g = base + 4 * v;  // g < wend <= m
    cp_async16(win + 4 * v, starts.p + g, 4 * min(4, m - g));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  int4* my_marks = reinterpret_cast<int4*>(anc + padded(threadIdx.x * kPerThread));
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) my_marks[q] = make_int4(-1, -1, -1, -1);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  const int a0 = split_in(starts, win, base, d0, bracket[0], bracket[1]);
  const int a1 = split_in(starts, win, base, d1, bracket[2], bracket[3]);
  const int b0 = static_cast<int>(d0 - a0);
  const int b1 = static_cast<int>(d1 - a1);
  const int nb = b1 - b0;
  if (nb == 0) return;  // only starts: no output

  // Scatter: the last start of each run marks its output.
  for (int j = a0 + threadIdx.x; j < a1; j += kThreads) {
    const int sj = starts.at(win[j - base]);  // sj >= b0 for j >= a0
    if (sj < b1 && (j + 1 == a1 || starts.at(win[j + 1 - base]) != sj)) {
      anc[padded(sj - b0)] = j;
    }
  }
  __syncthreads();

  // Inclusive max-scan of the marks from a0 - 1: this thread's 16, then the
  // lanes before it, then the warps before its warp.
  int4 m4[kPerThread / 4];
  int run = a0 - 1;
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    m4[q] = my_marks[q];
    m4[q].x = run = max(run, m4[q].x);
    m4[q].y = run = max(run, m4[q].y);
    m4[q].z = run = max(run, m4[q].z);
    m4[q].w = run = max(run, m4[q].w);
  }
  const int lane = threadIdx.x & 31;
  int incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = max(incl, up);
  }
  if (lane == 31) warp_max[threadIdx.x >> 5] = incl;
  int before = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) before = a0 - 1;
  __syncthreads();
  for (int w = 0; w < static_cast<int>(threadIdx.x >> 5); ++w) {
    before = max(before, warp_max[w]);
  }
#pragma unroll
  for (int q = 0; q < kPerThread / 4; ++q) {
    m4[q].x = max(before, m4[q].x);
    m4[q].y = max(before, m4[q].y);
    m4[q].z = max(before, m4[q].z);
    m4[q].w = max(before, m4[q].w);
    my_marks[q] = m4[q];
  }
  __syncthreads();

  // Copy: elements [e0, e1) of out, 16-byte stores on [v0, v1).
  const long long e0 = static_cast<long long>(b0) * d;
  const long long e1 = static_cast<long long>(b1) * d;
  long long v0 = (e0 + 3) & ~3LL;
  long long v1 = e1 & ~3LL;
  if (v0 > v1) v0 = v1 = e1;
#pragma unroll 4
  for (long long v = v0 + 4LL * threadIdx.x; v < v1; v += 4LL * kThreads) {
    float4 val;
    if (d == 1) {
      val.x = __ldg(p + anc[padded(static_cast<int>(v - b0))]);
      val.y = __ldg(p + anc[padded(static_cast<int>(v + 1 - b0))]);
      val.z = __ldg(p + anc[padded(static_cast<int>(v + 2 - b0))]);
      val.w = __ldg(p + anc[padded(static_cast<int>(v + 3 - b0))]);
    } else {
      val.x = ancestor_value(p, anc, b0, d, v);
      val.y = ancestor_value(p, anc, b0, d, v + 1);
      val.z = ancestor_value(p, anc, b0, d, v + 2);
      val.w = ancestor_value(p, anc, b0, d, v + 3);
    }
    *reinterpret_cast<float4*>(out + v) = val;
  }
  // Scalar head [e0, v0) and tail [v1, e1): at most 3 elements each.
  const int t = threadIdx.x;
  const long long e = t < 4 ? e0 + t : v1 + (t - 4);
  if (t < 8 && (t < 4 ? e < v0 : (e < e1 && e >= v0))) {
    out[e] = ancestor_value(p, anc, b0, d, e);
  }
}

}  // namespace

// A no-op where gate is not null and reads 0.
extern "C" int pf_resample_by_starts(const float* p, const int* starts, float* out,
                                     const int* gate, int m, int n, int d, int off,
                                     void* stream) {
  if (n <= 0 || d <= 0) return 0;
  if (m <= 0 || m > (1 << 30) || n > (1 << 30) || off < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long items = static_cast<long long>(m) + n;
  const int blocks = static_cast<int>((items + kItems - 1) / kItems);
  merge_path_resample_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, Starts{starts, m, n, off}, out, gate, d);
  return static_cast<int>(cudaGetLastError());
}
