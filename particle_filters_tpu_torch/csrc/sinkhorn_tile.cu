// The Sinkhorn resampler's N^2 passes as tile kernels that form the cost in
// registers: the damped c-transform half-update and the plan-and-projection
// pass of resampling/ot.py::sinkhorn_ot_resample, for a cloud x of N
// particles in d <= 4 dimensions, f32 throughout.
//
// Half-update (one launch each; tau_g is the same kernel, the cost being
// symmetric):
//   out_i = (1 - damping) p_i + damping * (-eps * logsumexp_j ((h_j - C_ij) / eps)),
//   C_ij = sum_k (x_ik - x_jk)^2,
// with h = g + eps log b, p = f for tau_f and h = f_new + eps log a, p = g for
// tau_g; out may be p (updated in place: row i's p_i is read by the thread
// that writes out_i, and the launch reads the other potential as h).
// Projection (one launch): x'_j = exp(g_j / eps) sum_i exp((h_i - C_ij) / eps) x_i
// with h = f + eps log a, which is the plan P = a b^T exp((f + g - C) / eps)
// times x divided by b_j.
//
// Replaces no TPU kernel: the JAX package's Sinkhorn is plain jnp. It was
// added because the dense torch path moves ~3.2 GB through HBM a
// half-update at N = 8192 (C formed, then 5 read-and-write passes and 2
// reads of N x N f32), where the work needs the N-long cloud and
// potentials. What bounds it on the H100: the N^2 exponentials. The SFU
// issues 16 a clock on each of the 132 SMs, ~16-18 us a half-update at
// N = 8192; each cell's other work (a subtract and an FMA a dimension, a
// max, a subtract and an add) fits in the FP32 pipes' shadow. The design:
// - the exponent is formed pre-scaled to base 2: with k = log2(e) / eps and
//   x~ = sqrt(k) x, a cell's argument is s_j - sum_k (x~_ik - x~_jk)^2 with
//   s_j = k (pot_j + eps logm_j), and each term is one ex2.approx.ftz
//   (~2 ulp; a term below 2^-126 of its row's largest flushes to 0). Every
//   pass, the projection's too, takes the cost as sum (x~_i - x~_j)^2, so
//   f32's rounding of sqrt(k)^2 against k scales the whole problem's cost
//   alike (an eps off by ~1e-7 of itself) and never the cost of one pass
//   against another's, which at eps = 0.1 and C = 64 would move the plan
//   by up to ~8e-5 of itself;
// - a block takes kRows = 32 rows, one a lane; its 16 warps split the
//   columns; 256 blocks at N = 8192, two resident on an SM (32 warps, 64
//   registers a thread), so that one warp's exps overlap another's FMAs;
// - a warp stages its columns' (x~_j, s_j) in its own shared buffer, and
//   each record, read by a broadcast load (two columns a 16-byte load at
//   d = 1), serves its 32 rows from registers; nothing N x N is ever stored;
// - a row keeps a running max and a rescaled sum over chunks of 32 columns
//   (the flash-attention recurrence): a row far from every other particle
//   keeps its own max and never underflows to a zero sum;
// - the warps' (max, sum) pairs of a row are combined in a fixed order in
//   shared memory, and the damping goes into that epilogue, so a launch is
//   deterministic. tau = -(max + log2 sum) / k, consistent with k's use in s;
// - the projection runs the same loop with a d-wide accumulator of x~_j,
//   divided by sqrt(k) at the end, and scales a row by exp2(k g_j + max),
//   formed by one FMA (a single rounding of a number near 0);
// - each pass is launched as a programmatic dependent of the one before
//   (griddepcontrol): it may launch once the previous pass's warps are past
//   their column loop, loads its rows' x (which no pass writes), and waits
//   for the whole previous pass before it reads the potentials.
// The dual loop's entry makes 2 n_iters launches on the caller's stream and
// never synchronises; with a delta pointer each half-update also folds
// max |out_i - p_i| into delta[iteration] (an atomicMax on the bits of a
// non-negative float, which is order-free). Plain C interface, bound with
// ctypes (ops/sinkhorn_tile.py, where the plain version lies beside it).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerLane = 1;
constexpr int kRows = 32 * kRowsPerLane;  // rows a block
constexpr int kChunk = 32;                // columns a running-max step
constexpr int kTileFloats = 512;          // a warp's staging buffer
constexpr int kMaxD = 4;

// A column's record in shared memory: its d coordinates and s, padded to a
// width that 8- or 16-byte loads read whole.
template <int D>
constexpr int kRecord = D == 1 ? 2 : 4 * ((D + 4) / 4);

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

template <int P>
__device__ __forceinline__ void load_record(const float* p, float (&r)[P]) {
  if constexpr (P == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  }
}

template <int P>
__device__ __forceinline__ void store_record(float* p, const float (&r)[P]) {
  if constexpr (P == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
#pragma unroll
    for (int q = 0; q < P / 4; ++q) {
      reinterpret_cast<float4*>(p)[q] =
          make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
    }
  }
}

// A chunk's max and sum are kept in kLanes partial registers a row, each
// taking every kLanes-th column (constant indices, so they stay in registers).
constexpr int kLanes = 4;

// One pass over all columns for the block's kRows rows, a_ij = s_j -
// sum_d (x~_id - x~_jd)^2 with x~ = xs * x:
//   kProject false: out_i = (1 - damping) prev_i + damping * tau_i; delta
//     (may be null) gets max |out_i - prev_i|;
//   kProject true: out_i = exp2(k prev_i + max_i) * sum_j exp2(a_ij - max_i) x~_j / xs.
template <int D, bool kProject>
__global__ void __launch_bounds__(kThreads, kProject ? 1 : 2)
    sinkhorn_tile_kernel(const float* __restrict__ x, const float* __restrict__ pot,
                         const float* __restrict__ logm, const float* prev, float* out,
                         float* __restrict__ delta, int n, float eps, float k, float xs,
                         float damping) {
  constexpr int P = kRecord<D>;
  constexpr int kTileCols = kTileFloats / P;  // a multiple of kChunk
  __shared__ __align__(16) float smem[kWarps * kTileFloats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRows;

  float xr[kRowsPerLane][D], m[kRowsPerLane], sum[kRowsPerLane], acc[kRowsPerLane][D];
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r) {
    const int i = row0 + r * 32 + lane;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      xr[r][d] = i < n ? xs * x[static_cast<long long>(i) * D + d] : 0.0f;
      acc[r][d] = 0.0f;
    }
    m[r] = -INFINITY;
    sum[r] = 0.0f;
  }
  // No pass writes x; pot and prev are the previous pass's outputs, and out
  // may be what it reads: wait for all of it (a no-op without the launch
  // attribute).
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // This warp's columns: whole chunks [c_begin, c_end), the last ragged.
  const int chunks = (n + kChunk - 1) / kChunk;
  const int c_begin = static_cast<int>(static_cast<long long>(warp) * chunks / kWarps) * kChunk;
  const int c_end =
      static_cast<int>(static_cast<long long>(warp + 1) * chunks / kWarps) * kChunk;
  float* buf = smem + warp * kTileFloats;

  for (int t0 = c_begin; t0 < c_end; t0 += kTileCols) {
    const int cols = min(kTileCols, c_end - t0);
    for (int c = lane; c < cols; c += 32) {  // stage: a column past n gets s = -inf
      const int j = t0 + c;
      float rec[P];
#pragma unroll
      for (int q = 0; q < P; ++q) rec[q] = 0.0f;
      if (j < n) {
#pragma unroll
        for (int d = 0; d < D; ++d) rec[d] = xs * x[static_cast<long long>(j) * D + d];
        rec[D] = k * (pot[j] + eps * logm[j]);
      } else {
        rec[D] = -INFINITY;
      }
      store_record<P>(buf + c * P, rec);
    }
    __syncwarp();

    for (int c0 = 0; c0 < cols; c0 += kChunk) {
      const float* cb = buf + c0 * P;
      float a[kRowsPerLane][kChunk], top[kRowsPerLane][kLanes];
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
#pragma unroll
        for (int q = 0; q < kLanes; ++q) top[r][q] = -INFINITY;
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        float rec[P];
        load_record<P>(cb + c * P, rec);
#pragma unroll
        for (int r = 0; r < kRowsPerLane; ++r) {
          float v = rec[D];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            const float df = xr[r][d] - rec[d];
            v = fmaf(-df, df, v);
          }
          a[r][c] = v;
          top[r][c % kLanes] = fmaxf(top[r][c % kLanes], v);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerLane; ++r) {
        const float new_m = fmaxf(fmaxf(fmaxf(top[r][0], top[r][1]), fmaxf(top[r][2], top[r][3])),
                                  m[r]);
        const float shift = new_m == -INFINITY ? 0.0f : new_m;  // nothing seen yet
        const float rescale = ex2(m[r] - shift);
        m[r] = new_m;
        if constexpr (kProject) {
#pragma unroll
          for (int d = 0; d < D; ++d) acc[r][d] *= rescale;
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            const float e = ex2(a[r][c] - shift);
#pragma unroll
            for (int d = 0; d < D; ++d) acc[r][d] = fmaf(e, cb[c * P + d], acc[r][d]);
          }
        } else {
          float part[kLanes] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int c = 0; c < kChunk; ++c) part[c % kLanes] += ex2(a[r][c] - shift);
          sum[r] = fmaf(sum[r], rescale, (part[0] + part[1]) + (part[2] + part[3]));
        }
      }
    }
    __syncwarp();
  }

  // The next pass may launch now: its blocks take an SM as this pass's
  // leave it, and wait for this whole pass before they read its output.
  asm volatile("griddepcontrol.launch_dependents;");

  // Combine the warps' partials of each row, warp by warp in order.
  __syncthreads();  // every warp is done with its staging buffer
  constexpr int kParts = kProject ? D : 1;
  float* pm = smem;                   // [kWarps][kRows] maxima
  float* ps = smem + kWarps * kRows;  // [kWarps][kRows][kParts] sums or accumulators
#pragma unroll
  for (int r = 0; r < kRowsPerLane; ++r) {
    const int rl = r * 32 + lane;
    pm[warp * kRows + rl] = m[r];
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      ps[(warp * kRows + rl) * kParts + q] = kProject ? acc[r][q] : sum[r];
    }
  }
  __syncthreads();
  if (threadIdx.x >= kRows) return;
  const int rl = threadIdx.x, i = row0 + rl;
  float top = -INFINITY;
  for (int w = 0; w < kWarps; ++w) top = fmaxf(top, pm[w * kRows + rl]);
  float part[kParts];
#pragma unroll
  for (int q = 0; q < kParts; ++q) part[q] = 0.0f;
  for (int w = 0; w < kWarps; ++w) {
    const float scale = ex2(pm[w * kRows + rl] - top);  // 0 for a warp with no columns
#pragma unroll
    for (int q = 0; q < kParts; ++q) part[q] = fmaf(ps[(w * kRows + rl) * kParts + q], scale, part[q]);
  }
  if constexpr (kProject) {
    if (i < n) {
      const float norm = exp2f(fmaf(k, prev[i], top));
#pragma unroll
      for (int d = 0; d < D; ++d) out[static_cast<long long>(i) * D + d] = norm * part[d] / xs;
    }
  } else {
    float change = 0.0f;
    if (i < n) {
      const float tau = -(top + log2f(part[0])) / k;
      const float p = prev[i];
      const float v = (1.0f - damping) * p + damping * tau;
      out[i] = v;
      change = fabsf(v - p);
    }
    if (delta != nullptr) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) change = fmaxf(change, __shfl_xor_sync(0xffffffffu, change, o));
      if (lane == 0) atomicMax(reinterpret_cast<int*>(delta), __float_as_int(change));
    }
  }
}

template <int D, bool kProject>
cudaError_t launch(const float* x, const float* pot, const float* logm, const float* prev,
                   float* out, float* delta, int n, float eps, float k, float xs,
                   float damping, cudaStream_t s) {
  // Each pass a programmatic dependent of the one before: its launch and its
  // rows' loads overlap that pass's epilogue and tail.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, sinkhorn_tile_kernel<D, kProject>, x, pot,
                                             logm, prev, out, delta, n, eps, k, xs, damping);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kProject>
cudaError_t launch_d(int d, const float* x, const float* pot, const float* logm,
                     const float* prev, float* out, float* delta, int n, float eps, float k,
                     float xs, float damping, cudaStream_t s) {
  switch (d) {
    case 1: return launch<1, kProject>(x, pot, logm, prev, out, delta, n, eps, k, xs, damping, s);
    case 2: return launch<2, kProject>(x, pot, logm, prev, out, delta, n, eps, k, xs, damping, s);
    case 3: return launch<3, kProject>(x, pot, logm, prev, out, delta, n, eps, k, xs, damping, s);
    case 4: return launch<4, kProject>(x, pot, logm, prev, out, delta, n, eps, k, xs, damping, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int n, int d) {
  return n <= 0 || d <= 0 || d > kMaxD || static_cast<long long>(n) * d > 0x7fffffffLL;
}

}  // namespace

// The dual loop: f = g = 0, then n_iters times f <- tau_f (h = g + eps log_b),
// g <- tau_g (h = f + eps log_a), damped, in place; 2 n_iters launches on
// stream. x is n x d (d <= 4), the rest n-long; delta, if not null, gets
// n_iters entries, entry t the largest change of f or g in iteration t.
// k = log2(e) / eps and xs = sqrt(k), both as the caller rounded them.
// Returns the first launch error, or 0.
extern "C" int pf_sinkhorn_dual(const float* x, const float* log_a, const float* log_b,
                                float* f, float* g, float* delta, int n, int d, int n_iters,
                                float eps, float k, float xs, float damping, void* stream) {
  if (bad_shape(n, d) || n_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(f, 0, sizeof(float) * n, s);
  if (err == cudaSuccess) err = cudaMemsetAsync(g, 0, sizeof(float) * n, s);
  if (err == cudaSuccess && delta != nullptr && n_iters > 0) {
    err = cudaMemsetAsync(delta, 0, sizeof(float) * n_iters, s);
  }
  for (int it = 0; it < n_iters && err == cudaSuccess; ++it) {
    float* slot = delta != nullptr ? delta + it : nullptr;
    err = launch_d<false>(d, x, g, log_b, f, f, slot, n, eps, k, xs, damping, s);
    if (err == cudaSuccess) {
      err = launch_d<false>(d, x, f, log_a, g, g, slot, n, eps, k, xs, damping, s);
    }
  }
  return static_cast<int>(err);
}

// The projection: out (n x d) = exp(g_j / eps) sum_i exp((f_i + eps log_a_i - C_ij) / eps) x_i,
// one launch on stream, k and xs as for the dual loop. Returns its launch
// error, or 0.
extern "C" int pf_sinkhorn_project(const float* x, const float* log_a, const float* f,
                                   const float* g, float* out, int n, int d, float eps,
                                   float k, float xs, void* stream) {
  if (bad_shape(n, d)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_d<true>(d, x, f, log_a, g, out, nullptr, n, eps, k, xs, 1.0f,
                                         static_cast<cudaStream_t>(stream)));
}
