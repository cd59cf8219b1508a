// Systematic-resampled particle values from the sorted child-run starts.
//
// out[i, :] = p[j(i), :] with j(i) = max{j : starts[j] <= i}, where
// starts[j] = ceil(N * cdf[j-1] - u) is the first output slot of ancestor j
// (starts[0] = 0, nondecreasing, values in [0, N]). An ancestor with no
// children shares its start with the next one, and the largest such j wins.
//
// One thread per output row: a binary search over the starts (log2 N probes,
// the upper levels of the search tree stay resident in L2), then a copy of the
// d values of the ancestor. The copy is exact, so the result equals p[idx]
// bit for bit at any weight degeneracy. Plain C interface, bound with ctypes.

#include <cuda_runtime.h>

namespace {

__global__ void resample_by_starts_kernel(const float* __restrict__ p,
                                          const int* __restrict__ starts,
                                          float* __restrict__ out,
                                          int n, int d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // Invariant: starts[lo] <= i (starts[0] == 0), the answer lies in [lo, hi).
  int lo = 0;
  int hi = n;
  while (hi - lo > 1) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(starts + mid) <= i) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  const float* src = p + static_cast<long long>(lo) * d;
  float* dst = out + static_cast<long long>(i) * d;
  for (int k = 0; k < d; ++k) dst[k] = __ldg(src + k);
}

}  // namespace

extern "C" int pf_resample_by_starts(const float* p, const int* starts,
                                     float* out, int n, int d,
                                     void* stream) {
  if (n <= 0 || d <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  resample_by_starts_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      p, starts, out, n, d);
  return static_cast<int>(cudaGetLastError());
}
