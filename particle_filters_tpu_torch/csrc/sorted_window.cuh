// One warp computes a window's compare-and-sum at 128 consecutive output
// positions: the device routine that probes X1 (window_resample.cu) and X2
// (span_resample.cu) share.
//
// A window is w fine-chunk entries (w a multiple of 128) of starts s and
// particle differences d in shared memory. At position pos its value is
//
//   sum_{x < w} [s[x] <= pos] * d[x]     (or the count, without d).
//
// The windows both probes get are sorted: the systematic starts are
// nondecreasing, the sentinel past N is above all of them, and a window is
// consecutive fine-chunk rows. In a sorted window the selected entries form a
// prefix, so the count is an upper-bound search, j = #{x : s[x] <= pos}, and
// the sum is the inclusive scan of d at j - 1 (0 at j = 0): about log2(w)
// compares an output instead of w compare-select-adds. The warp first checks
// that the window is sorted (a vote; a NaN fails it) and otherwise walks every
// entry, so the routine computes the windowed function on any input.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sorted_window {

constexpr int kSub = 128;            // output positions of a window
constexpr int kPerLane = kSub / 32;  // a lane's positions: pos0 + 4 lane + t
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most one group of this thread's copies is still in flight.
__device__ __forceinline__ void wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The warp's lanes copy n floats (n a multiple of 4) to shared memory without
// waiting: 16-byte vectors where both ends are 16-byte aligned, else words.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, bool vec16,
                                      int lane) {
  if (vec16) {
    for (int x = 4 * lane; x < n; x += 4 * 32) cp_async16(dst + x, src + x);
  } else {
    for (int x = lane; x < n; x += 32) cp_async4(dst + x, src + x);
  }
}

// 1 where both pointers are 16-byte aligned.
__host__ __forceinline__ int aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// The first of the window's positions pos0 + k, k < 128, at which start sv
// is selected: positions are integers, so sv <= pos0 + k exactly when
// ceil(sv) <= pos0 + k. 128 where it is selected at none.
__device__ __forceinline__ int first_position(float sv, int pos0) {
  const float k = ceilf(sv) - static_cast<float>(pos0);
  return k <= 0.0f ? 0 : (k < static_cast<float>(kSub) ? static_cast<int>(k) : kSub);
}

// One pass over the starts: true on every lane when s[0..w) is nondecreasing
// (a NaN fails), and then the run ends in `marks` (kSub ints, zeroed by the
// caller). In a sorted window the entries' first positions k_x are
// nondecreasing, so the count at pos0 + k, #{x : k_x <= k}, is one more than
// the last x with k_x <= k: the last entry x of each run of equal k_x < 128
// stores marks[k_x] = x + 1, and the counts are a running max of the marks
// (the merge of the sorted starts with the sorted positions that B2's
// load-balancing search also does). Lane l reads the vectors at 4 l + 128 i
// (no bank conflict) and gets the entry after its last by a shuffle.
__device__ __forceinline__ bool sorted_run_ends(const float* s, int w, int pos0, int* marks,
                                                int lane) {
  bool ok = true;
  for (int x = 4 * lane; x < w; x += kSub) {
    const float4 v = *reinterpret_cast<const float4*>(s + x);
    float next = __shfl_down_sync(kFull, v.x, 1);
    if (lane == 31) next = x + 4 < w ? s[x + 4] : INFINITY;  // a run ends with the window
    ok = ok && v.x <= v.y && v.y <= v.z && v.z <= v.w && v.w <= next;
    const int k0 = first_position(v.x, pos0);
    const int k1 = first_position(v.y, pos0);
    const int k2 = first_position(v.z, pos0);
    const int k3 = first_position(v.w, pos0);
    const int kn = first_position(next, pos0);
    if (k0 < kSub && k0 != k1) marks[k0] = x + 1;
    if (k1 < kSub && k1 != k2) marks[k1] = x + 2;
    if (k2 < kSub && k2 != k3) marks[k2] = x + 3;
    if (k3 < kSub && k3 != kn) marks[k3] = x + 4;
  }
  return __all_sync(kFull, ok);
}

// j[t] = the count at position pos0 + 4 lane + t: the running max of the
// marks, lane l holding marks 4 l .. 4 l + 3, then a shuffle max-scan.
__device__ __forceinline__ void counts_from_marks(const int* marks, int lane,
                                                  int j[kPerLane]) {
  const int4 m = reinterpret_cast<const int4*>(marks)[lane];
  j[0] = m.x;
  j[1] = max(j[0], m.y);
  j[2] = max(j[1], m.z);
  j[3] = max(j[2], m.w);
  int t = j[3];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, t, o);
    if (lane >= o) t = max(t, u);
  }
  int before = __shfl_up_sync(kFull, t, 1);
  if (lane == 0) before = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) j[i] = max(j[i], before);
}

// d[0..w) becomes its inclusive scan, 128 entries a round: each lane scans
// its 4, the warp scans the lanes' totals by shuffles, and a carry passes
// the round's total on.
__device__ __forceinline__ void inclusive_scan(float* d, int w, int lane) {
  float carry = 0.0f;
  for (int x = 4 * lane; x < w; x += kSub) {
    float4 v = *reinterpret_cast<float4*>(d + x);
    v.y += v.x;
    v.z += v.y;
    v.w += v.z;
    float t = v.w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += u;
    }
    float before = __shfl_up_sync(kFull, t, 1);
    if (lane == 0) before = 0.0f;
    const float off = carry + before;
    v.x += off;
    v.y += off;
    v.z += off;
    v.w += off;
    *reinterpret_cast<float4*>(d + x) = v;
    carry = __shfl_sync(kFull, v.w, 31);
  }
}

// v[t] = the window's value at position pos0 + 4 lane + t. d is null for
// the count; otherwise a sorted window's d is left holding its scan. marks
// is the warp's kSub ints of scratch.
__device__ __forceinline__ void window_values(const float* s, float* d, int w, int pos0,
                                              int* marks, int lane, float v[kPerLane]) {
  reinterpret_cast<int4*>(marks)[lane] = make_int4(0, 0, 0, 0);
  __syncwarp();
  if (sorted_run_ends(s, w, pos0, marks, lane)) {
    if (d != nullptr) inclusive_scan(d, w, lane);
    __syncwarp();
    int j[kPerLane];
    counts_from_marks(marks, lane, j);
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) {
      if (d == nullptr) {
        v[t] = static_cast<float>(j[t]);
      } else {
        v[t] = j[t] > 0 ? d[j[t] - 1] : 0.0f;
      }
    }
    return;
  }

  // Not sorted (or a NaN start): walk every entry, as the TPU kernel does.
  // All lanes read the same vector (a broadcast), and each feeds 4 positions.
  // In such a window the partial sums no longer telescope: they wander like
  // a random walk (to ~30 at w = 512 on N(0, 1) particles), and a plain f32
  // sum of 512 of them drifts ~2e-5 from the exact one. So each vector's 4
  // selected terms are added into the sum with Kahan's compensation.
  float pos[kPerLane];
#pragma unroll
  for (int t = 0; t < kPerLane; ++t) {
    pos[t] = static_cast<float>(pos0 + kPerLane * lane + t);
    v[t] = 0.0f;
  }
  if (d == nullptr) {
    for (int x = 0; x < w; x += 4) {
      const float4 sv = *reinterpret_cast<const float4*>(s + x);
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        v[t] += (sv.x <= pos[t]) ? 1.0f : 0.0f;
        v[t] += (sv.y <= pos[t]) ? 1.0f : 0.0f;
        v[t] += (sv.z <= pos[t]) ? 1.0f : 0.0f;
        v[t] += (sv.w <= pos[t]) ? 1.0f : 0.0f;
      }
    }
  } else {
    float comp[kPerLane];  // Kahan's compensation: what the sum lost so far
#pragma unroll
    for (int t = 0; t < kPerLane; ++t) comp[t] = 0.0f;
    for (int x = 0; x < w; x += 4) {
      const float4 sv = *reinterpret_cast<const float4*>(s + x);
      const float4 dv = *reinterpret_cast<const float4*>(d + x);
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        float g = (sv.x <= pos[t]) ? dv.x : 0.0f;
        g += (sv.y <= pos[t]) ? dv.y : 0.0f;
        g += (sv.z <= pos[t]) ? dv.z : 0.0f;
        g += (sv.w <= pos[t]) ? dv.w : 0.0f;
        const float y = g - comp[t];
        const float sum = v[t] + y;
        comp[t] = (sum - v[t]) - y;
        v[t] = sum;
      }
    }
  }
}

// The persistent grid of a kernel with blocks of `warps` warps and `smem`
// bytes of dynamic shared memory: the blocks that fit on the device at once,
// at most `work`. Raises the kernel's dynamic shared memory limit first.
template <typename Kernel>
__host__ inline cudaError_t persistent_grid(Kernel kernel, int warps, size_t smem, int work,
                                            int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * warps, smem);
  }
  const int fit = (per_sm > 0 ? per_sm : 1) * sms;
  *grid = fit < work ? fit : work;
  return err;
}

}  // namespace sorted_window
