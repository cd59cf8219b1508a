// Probe X3: the floor cost of one kernel launch.
//
// Replaces benchmarks/profile_small_n.py::_noop_kernel: out = x + 1 on one
// (8, 128) f32 tile, in one block of 1024 threads, one element a thread. It
// moves 8 KB and does 1024 additions, so what it costs is the launch itself:
// the host's enqueue when launched eagerly, the device's per-kernel overhead
// inside a CUDA graph. Plain C interface, bound with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int n) {
  const int i = threadIdx.x;
  if (i < n) out[i] = x[i] + 1.0f;
}

}  // namespace

extern "C" int pf_add_one(const float* x, float* out, int n, void* stream) {
  if (n <= 0 || n > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  add_one_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}
