// Probe X1: windowed compare-and-sum of the blocked systematic resample.
//
// Replaces benchmarks/exp_kernel_var.py::kern_v0. For super-group s, sub-group
// i and output k < 128, at the global position pos = (s*SG + i)*128 + k:
//
//   out = sum_w [s_win[s, i, w] <= pos] * d_win[s, i, 0, w]    (w < W = Q*128)
//
// or the count of w with s_win <= pos when sum_only. With transpose the output
// is (S, SG, 128), else (S, 128, SG).
//
// What bounds it on the H100: bytes. The windows are sorted (sorted_window.cuh
// says why), so an output's count is an upper-bound search and its sum a
// scan, not a walk of W entries: at N = 2^20, Q = 4 the search and the scan
// take at most N*(log2 W + 2) + N/128 * W = 1.6e7 operations, but the
// function reads 16.8 MB of starts and 16.8 MB of diffs and writes 4.2 MB,
// 37.75 MB or 11.3 us at 3.35 TB/s.
//
// The design keeps the copies in flight. A warp takes one sub-group: it
// stages the window's W starts and W diffs (4 KB at Q = 4; starts only when
// sum_only) in shared memory with 16-byte cp.async copies, and runs
// sorted_window::window_values on it: one pass over the starts that checks
// they are sorted and marks where their runs end, a max-scan of the marks
// for the 128 counts, a shuffle scan of the diffs for the sums, or the walk
// where the window is not sorted. The grid is persistent (as many blocks of
// up to 8 warps as fit on the card, 3 a SM at Q = 4); block tile t is
// sub-groups t*warps .. +warps, and each warp has two buffers, so the next
// tile's window is in flight while the current one is searched. With
// transpose a lane stores its 4 consecutive outputs as one 16-byte vector;
// without it the block gathers its (128 x warps) tile in shared memory and
// writes rows of `warps` consecutive floats (a full 32-byte sector at 8
// warps) instead of one float a sector. Positions are f32, exact below
// 2^24; the wrapper refuses larger N. Plain C interface, bound with ctypes.

#include <cuda_runtime.h>

#include "sorted_window.cuh"

namespace {

using sorted_window::kPerLane;
using sorted_window::kSub;

constexpr int kMaxWarps = 8;
constexpr size_t kBufferBudget = 96 * 1024;  // the warps' window buffers, a block
constexpr int kPitch = kSub + 4;             // a row of the output tile

__global__ void __launch_bounds__(kMaxWarps * 32)
window_compare_sum_kernel(const float* __restrict__ s_win, const float* __restrict__ d_win,
                          float* __restrict__ out, int n_subs, int sg, int w, int sum_only,
                          int transpose, int vec16) {
  extern __shared__ float4 smem4[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int arrays = sum_only ? 1 : 2;  // starts, and diffs unless counting
  float* bufs = reinterpret_cast<float*>(smem4) + warp * 2 * arrays * w;
  // The (S, 128, SG) layout's tile: warp i's 128 outputs at i*kPitch. The 4
  // words of padding a row keep both its 16-byte writes and the column reads
  // of 8 warps free of bank conflicts.
  float* tile = reinterpret_cast<float*>(smem4) + warps * 2 * arrays * w;
  int* marks = reinterpret_cast<int*>(tile + warps * kPitch) + warp * kSub;
  const int n_tiles = (n_subs + warps - 1) / warps;

  auto stage = [&](int t, int buf) {
    const int b = t * warps + warp;
    if (t < n_tiles && b < n_subs) {
      float* dst = bufs + buf * arrays * w;
      const long long off = static_cast<long long>(b) * w;
      sorted_window::stage(dst, s_win + off, w, vec16, lane);
      if (!sum_only) sorted_window::stage(dst + w, d_win + off, w, vec16, lane);
    }
    sorted_window::commit();  // an empty group past the end keeps the count
  };

  int buf = 0;
  stage(blockIdx.x, buf);
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    stage(t + gridDim.x, buf ^ 1);
    sorted_window::wait_all_but_one();
    __syncwarp();
    const int b = t * warps + warp;
    float v[kPerLane] = {};
    if (b < n_subs) {
      float* s = bufs + buf * arrays * w;
      sorted_window::window_values(s, sum_only ? nullptr : s + w, w, b * kSub, marks, lane, v);
    }
    const float4 v4 = make_float4(v[0], v[1], v[2], v[3]);
    if (transpose) {
      if (b < n_subs) reinterpret_cast<float4*>(out + static_cast<long long>(b) * kSub)[lane] = v4;
    } else {
      reinterpret_cast<float4*>(tile + warp * kPitch)[lane] = v4;
      __syncthreads();
      for (int e = threadIdx.x; e < kSub * warps; e += blockDim.x) {
        const int k = e / warps;
        const int i = e - k * warps;
        const int bb = t * warps + i;
        if (bb < n_subs) {
          const int s = bb / sg;
          out[(static_cast<long long>(s) * kSub + k) * sg + (bb - s * sg)] = tile[i * kPitch + k];
        }
      }
      __syncthreads();
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
    buf ^= 1;
  }
}

}  // namespace

extern "C" int pf_window_compare_sum(const float* s_win, const float* d_win,
                                     float* out, int n_subs, int sg, int w,
                                     int sum_only, int transpose,
                                     void* stream) {
  if (n_subs <= 0) return 0;
  const size_t per_warp = 2 * (sum_only ? 1 : 2) * static_cast<size_t>(w) * sizeof(float);
  int warps = static_cast<int>(kBufferBudget / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = warps * (per_warp + kPitch * sizeof(float) + kSub * sizeof(int));
  int grid = 0;
  const cudaError_t err = sorted_window::persistent_grid(
      window_compare_sum_kernel, warps, smem, (n_subs + warps - 1) / warps, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_compare_sum_kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      s_win, d_win, out, n_subs, sg, w, sum_only, transpose,
      sorted_window::aligned16(s_win, d_win));
  return static_cast<int>(cudaGetLastError());
}
