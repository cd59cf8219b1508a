// Probe X2: span-staged compare-and-sum of the blocked systematic resample, d = 1.
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
// A block takes a super-group of SG sub-groups (SG*128 = 8192 outputs). Since
// a0 is nondecreasing, the rows its sub-groups read form one contiguous span
// [a0[first], a0[last] + Q), and the block copies just that span of starts,
// diffs and bases into shared memory with coalesced 16-byte loads (the TPU
// kernel's one DMA of ROWS rows into VMEM). The wrapper refuses a0 whose
// span exceeds the budget of rows_max rows; a block that meets one anyway
// writes NaN rather than read past its shared memory. Each warp then takes
// one sub-group at a time, each lane four output positions, and walks the Q
// rows in shared memory: every lane of a warp reads the same 16-byte vector
// (a broadcast), and each vector feeds four positions.
//
// What bounds it on the H100: operations. At N = 2^20 it moves about 12 MiB
// (3.8 us at 3.35 TB/s) but makes 2^20 * 384 compare-select-add triples,
// 1.2e9 fp32 operations (18 us at 67 TFLOP/s). Positions are f32, exact
// below 2^24. The shared span needs rows_max * 257 * 4 bytes (128.5 KB at
// rows_max = 128), above the 48 KB default, so the first launch raises the
// kernel's dynamic shared memory limit. Plain C interface, bound with ctypes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kSub = 128;
constexpr int kThreads = 512;
constexpr int kPerLane = kSub / 32;  // output positions per lane

__global__ void __launch_bounds__(kThreads)
span_resample_kernel(const float* __restrict__ starts_f,
                     const float* __restrict__ diffs,
                     const float* __restrict__ base,
                     const int* __restrict__ a0, float* __restrict__ out,
                     int n_rows, int sg, int q, int rows_max) {
  extern __shared__ float4 smem4[];
  float* s_sh = reinterpret_cast<float*>(smem4);  // rows_max x 128 starts
  float* d_sh = s_sh + rows_max * kSub;           // rows_max x 128 diffs
  float* b_sh = d_sh + rows_max * kSub;           // rows_max chunk bases

  const int sub0 = blockIdx.x * sg;
  const int first = a0[sub0];
  const int rows = a0[sub0 + sg - 1] + q - first;
  float* out_blk = out + static_cast<long long>(sub0) * kSub;
  if (first < 0 || rows > rows_max || first + rows > n_rows) {
    for (int t = threadIdx.x; t < sg * kSub; t += kThreads) out_blk[t] = NAN;
    return;
  }

  const float4* s_src = reinterpret_cast<const float4*>(starts_f + static_cast<long long>(first) * kSub);
  const float4* d_src = reinterpret_cast<const float4*>(diffs + static_cast<long long>(first) * kSub);
  float4* s_dst = reinterpret_cast<float4*>(s_sh);
  float4* d_dst = reinterpret_cast<float4*>(d_sh);
  for (int v = threadIdx.x; v < rows * (kSub / 4); v += kThreads) {
    s_dst[v] = s_src[v];
    d_dst[v] = d_src[v];
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) b_sh[r] = base[first + r];
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = warp; i < sg; i += kThreads / 32) {
    const int off = a0[sub0 + i] - first;
    float* dst = out_blk + i * kSub + lane;
    if (off < 0 || off + q > rows) {  // a0 not nondecreasing
      for (int j = 0; j < kPerLane; ++j) dst[32 * j] = NAN;
      continue;
    }
    float pos[kPerLane];
    float acc[kPerLane];
    for (int j = 0; j < kPerLane; ++j) {
      pos[j] = static_cast<float>((sub0 + i) * kSub + lane + 32 * j);
      acc[j] = 0.0f;
    }
    for (int r = 0; r < q; ++r) {
      const float4* srow = reinterpret_cast<const float4*>(s_sh + (off + r) * kSub);
      const float4* drow = reinterpret_cast<const float4*>(d_sh + (off + r) * kSub);
      float racc[kPerLane];
      for (int j = 0; j < kPerLane; ++j) racc[j] = 0.0f;
#pragma unroll 4
      for (int v = 0; v < kSub / 4; ++v) {
        const float4 s = srow[v];
        const float4 d = drow[v];
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          racc[j] += (s.x <= pos[j]) ? d.x : 0.0f;
          racc[j] += (s.y <= pos[j]) ? d.y : 0.0f;
          racc[j] += (s.z <= pos[j]) ? d.z : 0.0f;
          racc[j] += (s.w <= pos[j]) ? d.w : 0.0f;
        }
      }
      for (int j = 0; j < kPerLane; ++j) acc[j] += racc[j];
    }
    const float b = b_sh[off];
    for (int j = 0; j < kPerLane; ++j) dst[32 * j] = acc[j] + b;
  }
}

}  // namespace

extern "C" int pf_span_resample(const float* starts_f, const float* diffs,
                                const float* base, const int* a0, float* out,
                                int n_rows, int n_super, int sg, int q,
                                int rows_max, void* stream) {
  if (n_super <= 0) return 0;
  const int smem = (2 * kSub + 1) * rows_max * static_cast<int>(sizeof(float));
  static int smem_set = 0;  // the largest limit set so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        span_resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  span_resample_kernel<<<n_super, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      starts_f, diffs, base, a0, out, n_rows, sg, q, rows_max);
  return static_cast<int>(cudaGetLastError());
}
