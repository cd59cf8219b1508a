// Probe X1: windowed compare-and-sum of the blocked systematic resample.
//
// Replaces benchmarks/exp_kernel_var.py::kern_v0. For super-group s, sub-group
// i and output k < 128, at the global position pos = (s*SG + i)*128 + k:
//
//   out = sum_w [s_win[s, i, w] <= pos] * d_win[s, i, 0, w]    (w < W = Q*128)
//
// or the count of w with s_win <= pos when sum_only. With transpose the output
// is (S, SG, 128), else (S, 128, SG). The window's starts are sorted, so the
// selected diffs are a prefix and the sum telescopes to p[j(pos)] - p[base].
//
// What bounds it on the H100: operations. At N = 2^20, Q = 4 it reads 32 MiB
// of windows and writes 4 MiB (11 us at 3.35 TB/s), but makes 2^20 * 512
// compare-select-add triples, 1.6e9 fp32 operations (24 us at 67 TFLOP/s).
// The design keeps the triples' operands on chip: one block of 128 threads
// per sub-group stages the sub-group's W starts and W diffs (4 KB at Q = 4)
// in shared memory once, and each thread walks the window for its own output
// position, reading 16-byte vectors that every thread of a warp shares (one
// broadcast, no bank conflict). Positions are f32, exact below 2^24; the
// wrapper refuses larger N. Plain C interface, bound with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kSub = 128;

__global__ void window_compare_sum_kernel(const float* __restrict__ s_win,
                                          const float* __restrict__ d_win,
                                          float* __restrict__ out, int sg,
                                          int w, int sum_only,
                                          int transpose) {
  extern __shared__ float4 smem4[];
  float4* s_sh = smem4;           // w / 4 vectors of starts
  float4* d_sh = smem4 + w / 4;   // w / 4 vectors of diffs
  const int b = blockIdx.x;       // = s * sg + i, the sub-group
  const int k = threadIdx.x;      // output position within the sub-group
  const float4* s_src = reinterpret_cast<const float4*>(s_win + static_cast<long long>(b) * w);
  const float4* d_src = reinterpret_cast<const float4*>(d_win + static_cast<long long>(b) * w);
  for (int v = k; v < w / 4; v += kSub) {
    s_sh[v] = s_src[v];
    if (!sum_only) d_sh[v] = d_src[v];
  }
  __syncthreads();

  const float pos = static_cast<float>(b * kSub + k);
  float acc = 0.0f;
  if (sum_only) {
    for (int v = 0; v < w / 4; ++v) {
      const float4 s = s_sh[v];
      acc += (s.x <= pos) ? 1.0f : 0.0f;
      acc += (s.y <= pos) ? 1.0f : 0.0f;
      acc += (s.z <= pos) ? 1.0f : 0.0f;
      acc += (s.w <= pos) ? 1.0f : 0.0f;
    }
  } else {
    for (int v = 0; v < w / 4; ++v) {
      const float4 s = s_sh[v];
      const float4 d = d_sh[v];
      acc += (s.x <= pos) ? d.x : 0.0f;
      acc += (s.y <= pos) ? d.y : 0.0f;
      acc += (s.z <= pos) ? d.z : 0.0f;
      acc += (s.w <= pos) ? d.w : 0.0f;
    }
  }
  if (transpose) {
    out[static_cast<long long>(b) * kSub + k] = acc;
  } else {
    const int s = b / sg;
    const int i = b - s * sg;
    out[(static_cast<long long>(s) * kSub + k) * sg + i] = acc;
  }
}

}  // namespace

extern "C" int pf_window_compare_sum(const float* s_win, const float* d_win,
                                     float* out, int n_subs, int sg, int w,
                                     int sum_only, int transpose,
                                     void* stream) {
  if (n_subs <= 0) return 0;
  const size_t smem = 2 * static_cast<size_t>(w) * sizeof(float);
  window_compare_sum_kernel<<<n_subs, kSub, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      s_win, d_win, out, sg, w, sum_only, transpose);
  return static_cast<int>(cudaGetLastError());
}
