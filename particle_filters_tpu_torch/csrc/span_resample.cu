// Probe X2: span-checked compare-and-sum of the blocked systematic resample, d = 1.
//
// Replaces benchmarks/exp_resample_dma.py::_dma_kernel. Outputs are cut into
// sub-groups of 128 and particles into fine chunks of 128; a0[b] is the fine
// chunk of sub-group b's first ancestor, nondecreasing in b. For output k of
// sub-group b, at the position pos = b*128 + k:
//
//   out = base[a0[b]] + sum_{r < Q} sum_{l < 128} [starts_f[a0[b]+r, l] <= pos] * diffs[a0[b]+r, l]
//
// with starts_f the child-run starts as f32 (a sentinel past N), diffs the
// telescoping particle differences p[j] - p[j-1] and base[m] = p[128*m - 1].
// The sum over a sorted window telescopes to p[j(pos)] - base, so out is the
// resampled value up to f32 rounding of partial sums of up to Q*128 terms.
//
// The TPU kernel copies, for each super-group of SG sub-groups, the span of
// rows [a0[first], a0[last] + Q) into VMEM with one DMA of ROWS rows. This
// kernel keeps that contract and reads it from a0 alone: a super-group whose
// span exceeds rows_max (ROWS), or leaves the n_rows rows, gets NaN, and so
// does a sub-group whose window leaves its super-group's span (a0 not
// nondecreasing). It stages nothing more than each sub-group's own window:
// the rows that neighbouring sub-groups share come from the 50 MB L2.
//
// What bounds it on the H100: bytes. The windows are sorted (sorted_window.cuh
// says why), so an output's count is an upper-bound search and its sum a
// scan, not a walk of Q*128 entries: at N = 2^20 the search and the scan take
// at most N*(9 + 2) + N/128 * 384 = 1.5e7 operations, while the function
// reads 4.26 MB of starts, 4.26 MB of diffs, the bases and a0 (0.03 MB each)
// and writes 4.19 MB: 12.78 MB, 3.8 us at 3.35 TB/s. A warp takes one
// sub-group at a time: it stages the window's Q rows of starts and diffs
// (3 KB, contiguous) with 16-byte cp.async copies and runs
// sorted_window::window_values (one pass over the starts that checks they
// are sorted and marks where their runs end, a max-scan of the marks for the
// counts and a shuffle scan of the diffs for the sums, or the walk where the
// window is not sorted), then adds the chunk base. Each lane loads the a0
// entries and base of one of the warp's next 32 sub-groups, so those loads
// wait in line behind no search. The grid is persistent (blocks of 8 warps,
// 4 a SM) and each warp has two buffers, so the next sub-group's window is
// in flight while the current one is searched. Positions are f32, exact
// below 2^24. Plain C interface, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>

#include "sorted_window.cuh"

namespace {

using sorted_window::kPerLane;
using sorted_window::kSub;

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
span_resample_kernel(const float* __restrict__ starts_f,
                     const float* __restrict__ diffs,
                     const float* __restrict__ base,
                     const int* __restrict__ a0, float* __restrict__ out,
                     int n_rows, int n_subs, int sg, int q, int rows_max, int vec16) {
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w = q * kSub;
  float* bufs = reinterpret_cast<float*>(smem4) + warp * 2 * 2 * w;
  int* marks = reinterpret_cast<int*>(smem4) + kWarps * 2 * 2 * w + warp * kSub;
  const int stride = gridDim.x * kWarps;

  // Lane l holds the window row of the warp's sub-group i0 + l (-1 where the
  // contract writes NaN) and its chunk base, all 32 loaded at once, so that
  // no load of a0 or of a base waits in line behind a window's search.
  int row_l = -1;
  float base_l = 0.0f;
  auto fetch = [&](int i0) {
    const int b = blockIdx.x * kWarps + warp + (i0 + lane) * stride;
    row_l = -1;
    if (b < n_subs) {
      const int sup0 = b - b % sg;
      const int first = __ldg(a0 + sup0);
      const int rows = __ldg(a0 + sup0 + sg - 1) + q - first;
      const int off = __ldg(a0 + b) - first;
      if (first >= 0 && rows <= rows_max && first + rows <= n_rows && off >= 0 &&
          off + q <= rows) {
        row_l = first + off;
      }
    }
    base_l = row_l >= 0 ? __ldg(base + row_l) : 0.0f;
  };
  auto stage = [&](int row, int buf) {
    if (row >= 0) {
      float* dst = bufs + buf * 2 * w;
      const long long off = static_cast<long long>(row) * kSub;
      sorted_window::stage(dst, starts_f + off, w, vec16, lane);
      sorted_window::stage(dst + w, diffs + off, w, vec16, lane);
    }
    sorted_window::commit();  // an empty group past the end keeps the count
  };

  fetch(0);
  int row = __shfl_sync(sorted_window::kFull, row_l, 0);
  int buf = 0;
  stage(row, buf);
  for (int i = 0, b = blockIdx.x * kWarps + warp; b < n_subs; ++i, b += stride) {
    const float bv = __shfl_sync(sorted_window::kFull, base_l, i % 32);
    if (i % 32 == 31) fetch(i + 1);
    const int row_next = __shfl_sync(sorted_window::kFull, row_l, (i + 1) % 32);
    stage(row_next, buf ^ 1);
    sorted_window::wait_all_but_one();
    __syncwarp();
    float v[kPerLane];
    if (row >= 0) {
      float* s = bufs + buf * 2 * w;
      sorted_window::window_values(s, s + w, w, b * kSub, marks, lane, v);
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) v[j] += bv;
    } else {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) v[j] = NAN;
    }
    reinterpret_cast<float4*>(out + static_cast<long long>(b) * kSub)[lane] =
        make_float4(v[0], v[1], v[2], v[3]);
    __syncwarp();  // every lane is done with this buffer before it is refilled
    buf ^= 1;
    row = row_next;
  }
}

}  // namespace

extern "C" int pf_span_resample(const float* starts_f, const float* diffs,
                                const float* base, const int* a0, float* out,
                                int n_rows, int n_super, int sg, int q,
                                int rows_max, void* stream) {
  if (n_super <= 0) return 0;
  const int n_subs = n_super * sg;
  const size_t smem = kWarps * (2 * 2 * static_cast<size_t>(q) * kSub * sizeof(float) +
                                kSub * sizeof(int));
  int grid = 0;
  const cudaError_t err = sorted_window::persistent_grid(
      span_resample_kernel, kWarps, smem, (n_subs + kWarps - 1) / kWarps, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  span_resample_kernel<<<grid, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      starts_f, diffs, base, a0, out, n_rows, n_subs, sg, q, rows_max,
      sorted_window::aligned16(starts_f, diffs));
  return static_cast<int>(cudaGetLastError());
}
