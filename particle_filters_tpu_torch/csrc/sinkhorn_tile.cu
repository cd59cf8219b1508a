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
// non-negative float, which is order-free). With a saved buffer (a gradient
// will be taken) the same launches write f and g after every iteration to
// its rows, and each half-update's row normalizer t_i = k tau_i (base 2) to
// an lse buffer: (4 n_iters + 2) N floats in all, nothing N x N.
//
// The vector-Jacobian product (pf_sinkhorn_vjp; sinkhorn_vjp_kernel) is the
// unrolled loop's, through every iteration and the projection, from what
// the forward saved. A half-update's softmax pi_ij = 2^(t_i + s_j - k C_ij),
// s_j = k (h_j + eps log m_j), needs no running max (t is known, pi <= 1);
// with u = damping * out-bar:
//   p-bar += (1 - damping) out-bar,
//   x-bar_i += 2 u_i sum_j pi_ij (x_i - x_j)            (the row pass),
//   h-bar_j = -sum_i u_i pi_ij, log m-bar_j = eps h-bar_j,
//   x-bar_j += 2 sum_i u_i pi_ij (x_j - x_i)            (the column pass);
// the projection's plan Pi_ij = 2^(k (f_i + eps log a_i) + k g_j - k C_ij)
// with y-bar the cotangent of x':
//   V_i = sum_j Pi_ij y-bar_j, f-bar_i = x_i . V_i / eps, log a-bar_i = x_i . V_i,
//   x-bar_i = V_i - (2/eps) sum_j Pi_ij (y-bar_j . x_i)(x_i - x_j)   (row pass),
//   g-bar_j = y-bar_j . x'_j / eps,
//   x-bar_j -= (2/eps) sum_i Pi_ij (y-bar_j . x_i)(x_j - x_i)       (column pass).
// Each pass is the forward's loop with one thread a point and the block's
// 16 warps splitting its partners, the cost formed in registers and N^2
// exponentials a pass, so a half-update's VJP costs two forward passes; a
// column pass is a row pass of the transposed plan (the cost is symmetric),
// so no sum crosses blocks and nothing is atomic: the warps' partials are
// combined in a fixed order and a launch is deterministic. The epilogues
// carry the cotangents of f and g from half-update to half-update (the
// column pass of tau_g folds h-bar into f-bar and scales it by 1 - damping
// for the next tau_f, and tau_f's into g-bar), so the reverse loop,
// 4 n_iters + 2 launches, is one call on the stream with no sync. Plain C
// interface, bound with ctypes (ops/sinkhorn_tile.py, where the plain
// versions lie beside it).

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
//     (may be null) gets max |out_i - prev_i|, lse_out (may be null) k tau_i;
//   kProject true: out_i = exp2(k prev_i + max_i) * sum_j exp2(a_ij - max_i) x~_j / xs.
template <int D, bool kProject>
__global__ void __launch_bounds__(kThreads, kProject ? 1 : 2)
    sinkhorn_tile_kernel(const float* __restrict__ x, const float* __restrict__ pot,
                         const float* __restrict__ logm, const float* prev, float* out,
                         float* __restrict__ delta, float* __restrict__ lse_out, int n,
                         float eps, float k, float xs, float damping) {
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
      const float lse = top + log2f(part[0]);
      const float tau = -lse / k;
      if (lse_out != nullptr) lse_out[i] = -lse;
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
                   float* out, float* delta, float* lse, int n, float eps, float k, float xs,
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
                                             logm, prev, out, delta, lse, n, eps, k, xs,
                                             damping);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kProject>
cudaError_t launch_d(int d, const float* x, const float* pot, const float* logm,
                     const float* prev, float* out, float* delta, float* lse, int n, float eps,
                     float k, float xs, float damping, cudaStream_t s) {
#define PF_LAUNCH(D) \
  launch<D, kProject>(x, pot, logm, prev, out, delta, lse, n, eps, k, xs, damping, s)
  switch (d) {
    case 1: return PF_LAUNCH(1);
    case 2: return PF_LAUNCH(2);
    case 3: return PF_LAUNCH(3);
    case 4: return PF_LAUNCH(4);
    default: return cudaErrorInvalidValue;
  }
#undef PF_LAUNCH
}

// --- the vector-Jacobian product -------------------------------------------

// The four passes of the VJP. A row pass gives each thread a point i on the
// row side of the plan (the half-update's output, the projection's source)
// and loops over the partners j; a column pass gives it a point j on the
// column side (the half-update's h, the projection's target) and loops over
// the i. Either way a cell's argument is r_i + c_j - k C_ij.
enum VjpPass { kHalfRow, kHalfCol, kProjRow, kProjCol };

constexpr int padded(int w) { return w <= 2 ? 2 : w <= 4 ? 4 : w <= 8 ? 8 : 16; }

template <int D, int kPass>
struct VjpShape {
  static constexpr bool kRowPass = kPass == kHalfRow || kPass == kProjRow;
  // A partner's record: its D coordinates, its scalar, then its weight
  // u = damping * out-bar (kHalfCol) or its cotangent row y-bar (kProjRow).
  static constexpr int kRecordW =
      padded(D + 1 + (kPass == kHalfCol ? 1 : kPass == kProjRow ? D : 0));
  // A thread's sums: x-bar's (kHalfRow, kProjCol), S and x-bar's (kHalfCol),
  // V and x-bar's (kProjRow).
  static constexpr int kParts = kPass == kHalfCol ? D + 1 : kPass == kProjRow ? 2 * D : D;
};

// What one VJP pass reads and writes (only what its pass needs is set).
struct VjpArgs {
  const float* x;      // n x D cloud
  const float* lse;    // row side's t = k tau (half-updates), or null: the projection's
  const float* rpot;   //   r = k (rpot + eps rlogm): f and log a
  const float* rlogm;
  const float* cpot;   // column side's c = k (cpot + eps clogm): h and log m, or g (clogm null)
  const float* clogm;
  const float* ybar;   // the cotangent of x' (n x D) and x' itself (projection)
  const float* yout;
  const float* cot_out;  // the half-update's out-bar (u = damping * out-bar)
  float* cot_h;          // h-bar, updated to keep * h-bar - S (kHalfCol)
  float* cot_f;          // f-bar and g-bar, set by the projection's passes
  float* cot_g;
  float* cla;            // log a-bar: set by kProjRow, added to by kHalfCol (may be null)
  float* xbar;           // x-bar (n x D): set by kProjRow, added to by the rest
  int n;
  float eps, k, xs, damping, keep;
};

__device__ __forceinline__ float row_scalar(const VjpArgs& a, int i) {
  return a.lse != nullptr ? a.lse[i] : a.k * (a.rpot[i] + a.eps * a.rlogm[i]);
}

__device__ __forceinline__ float col_scalar(const VjpArgs& a, int j) {
  return a.clogm != nullptr ? a.k * (a.cpot[j] + a.eps * a.clogm[j]) : a.k * a.cpot[j];
}

template <int D, int kPass>
__global__ void __launch_bounds__(kThreads, 2) sinkhorn_vjp_kernel(const VjpArgs a) {
  using S = VjpShape<D, kPass>;
  constexpr int P = S::kRecordW;
  constexpr int kParts = S::kParts;
  constexpr int kTileCols = kTileFloats / P;
  constexpr float kLn2 = 0.693147180559945f;
  __shared__ __align__(16) float smem[kWarps * kTileFloats];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kRows + lane;  // this lane's point
  const bool live = i < a.n;

  // Before the wait only what the forward wrote: the cloud, the saved
  // potentials and normalizers (the cotangents are the previous pass's).
  float xo[D], acc[kParts];
#pragma unroll
  for (int d = 0; d < D; ++d) xo[d] = live ? a.xs * a.x[static_cast<long long>(i) * D + d] : 0.0f;
#pragma unroll
  for (int q = 0; q < kParts; ++q) acc[q] = 0.0f;
  const float own = !live ? -INFINITY : S::kRowPass ? row_scalar(a, i) : col_scalar(a, i);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  float yo[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    yo[d] = kPass == kProjCol && live ? a.ybar[static_cast<long long>(i) * D + d] : 0.0f;
  }

  const int c_begin = static_cast<int>(static_cast<long long>(warp) * a.n / kWarps);
  const int c_end = static_cast<int>(static_cast<long long>(warp + 1) * a.n / kWarps);
  float* buf = smem + warp * kTileFloats;
  for (int t0 = c_begin; t0 < c_end; t0 += kTileCols) {
    const int cols = min(kTileCols, c_end - t0);
    for (int c = lane; c < cols; c += 32) {
      const int j = t0 + c;
      float rec[P];
#pragma unroll
      for (int q = 0; q < P; ++q) rec[q] = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) rec[d] = a.xs * a.x[static_cast<long long>(j) * D + d];
      rec[D] = S::kRowPass ? col_scalar(a, j) : row_scalar(a, j);
      if constexpr (kPass == kHalfCol) rec[D + 1] = a.damping * a.cot_out[j];
      if constexpr (kPass == kProjRow) {
#pragma unroll
        for (int d = 0; d < D; ++d) rec[D + 1 + d] = a.ybar[static_cast<long long>(j) * D + d];
      }
      store_record<P>(buf + c * P, rec);
    }
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < cols; ++c) {
      float rec[P];
      load_record<P>(buf + c * P, rec);
      float v = own + rec[D], df[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        df[d] = xo[d] - rec[d];
        v = fmaf(-df[d], df[d], v);
      }
      const float e = ex2(v);  // pi or Pi: at most ~1, no running max
      if constexpr (kPass == kHalfRow) {
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(e, df[d], acc[d]);
      } else if constexpr (kPass == kHalfCol) {
        const float ew = e * rec[D + 1];
        acc[0] += ew;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[1 + d] = fmaf(ew, df[d], acc[1 + d]);
      } else {
        // z~ = y-bar_j . x~_i: the projection's row pass has y-bar staged and
        // x~_i its own, the column pass the other way round.
        float z = 0.0f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          z = kPass == kProjRow ? fmaf(rec[D + 1 + d], xo[d], z) : fmaf(yo[d], rec[d], z);
        }
        const float ez = e * z;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          if constexpr (kPass == kProjRow) {
            acc[d] = fmaf(e, rec[D + 1 + d], acc[d]);
            acc[D + d] = fmaf(ez, df[d], acc[D + d]);
          } else {
            acc[d] = fmaf(ez, df[d], acc[d]);
          }
        }
      }
    }
    __syncwarp();
  }

  asm volatile("griddepcontrol.launch_dependents;");

  // Combine the warps' partials of each point, warp by warp in order.
  __syncthreads();
  float* ps = smem;  // [kWarps][kRows][kParts]
#pragma unroll
  for (int q = 0; q < kParts; ++q) ps[(warp * kRows + lane) * kParts + q] = acc[q];
  __syncthreads();
  if (threadIdx.x >= kRows) return;
  const int p = blockIdx.x * kRows + threadIdx.x;
  if (p >= a.n) return;
  float part[kParts];
#pragma unroll
  for (int q = 0; q < kParts; ++q) part[q] = 0.0f;
  for (int w = 0; w < kWarps; ++w) {
#pragma unroll
    for (int q = 0; q < kParts; ++q) part[q] += ps[(w * kRows + threadIdx.x) * kParts + q];
  }
  float* gx = a.xbar + static_cast<long long>(p) * D;
  // d tau / d x per unit of pi times the scaled difference: 2 xs / k.
  const float half = 2.0f * a.xs / a.k;
  if constexpr (kPass == kHalfRow) {
    const float u = half * a.damping * a.cot_out[p];
#pragma unroll
    for (int d = 0; d < D; ++d) gx[d] = fmaf(u, part[d], gx[d]);
  } else if constexpr (kPass == kHalfCol) {
    a.cot_h[p] = fmaf(a.keep, a.cot_h[p], -part[0]);
    if (a.cla != nullptr) a.cla[p] = fmaf(-a.eps, part[0], a.cla[p]);
#pragma unroll
    for (int d = 0; d < D; ++d) gx[d] = fmaf(half, part[1 + d], gx[d]);
  } else if constexpr (kPass == kProjRow) {
    float xv = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) xv = fmaf(a.x[static_cast<long long>(p) * D + d], part[d], xv);
    a.cot_f[p] = kLn2 * a.k * xv;
    a.cla[p] = kLn2 * a.k * a.eps * xv;
#pragma unroll
    for (int d = 0; d < D; ++d) gx[d] = fmaf(-2.0f * kLn2, part[D + d], part[d]);
  } else {
    float yv = 0.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const long long q = static_cast<long long>(p) * D + d;
      yv = fmaf(a.ybar[q], a.yout[q], yv);
    }
    a.cot_g[p] = kLn2 * a.k * yv;
#pragma unroll
    for (int d = 0; d < D; ++d) gx[d] = fmaf(-2.0f * kLn2, part[d], gx[d]);
  }
}

template <int D, int kPass>
cudaError_t launch_vjp(const VjpArgs& a, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.n + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, sinkhorn_vjp_kernel<D, kPass>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kPass>
cudaError_t launch_vjp_d(int d, const VjpArgs& a, cudaStream_t s) {
  switch (d) {
    case 1: return launch_vjp<1, kPass>(a, s);
    case 2: return launch_vjp<2, kPass>(a, s);
    case 3: return launch_vjp<3, kPass>(a, s);
    case 4: return launch_vjp<4, kPass>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_shape(int n, int d) {
  return n <= 0 || d <= 0 || d > kMaxD || static_cast<long long>(n) * d > 0x7fffffffLL;
}

}  // namespace

// The dual loop: f = g = 0, then n_iters times f <- tau_f (h = g + eps log_b),
// g <- tau_g (h = f + eps log_a), damped; 2 n_iters launches on stream. x is
// n x d (d <= 4), the rest n-long; delta, if not null, gets n_iters entries,
// entry t the largest change of f or g in iteration t. Without saved, f and
// g are updated in place; with saved ((n_iters + 1) x 2 x n: row 2t is f and
// row 2t + 1 g after t iterations, row 0 and 1 zeros) and lse (n_iters x 2 x
// n: k tau of iteration t's tau_f, then tau_g) every iteration's are kept,
// and f and g (then ignored, may be null) are the last rows of saved.
// k = log2(e) / eps and xs = sqrt(k), both as the caller rounded them.
// Returns the first launch error, or 0.
extern "C" int pf_sinkhorn_dual(const float* x, const float* log_a, const float* log_b,
                                float* f, float* g, float* delta, float* saved, float* lse,
                                int n, int d, int n_iters, float eps, float k, float xs,
                                float damping, void* stream) {
  if (bad_shape(n, d) || n_iters < 0 || (saved == nullptr && lse != nullptr) ||
      (saved != nullptr && lse == nullptr && n_iters > 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = n;
  cudaError_t err = saved != nullptr ? cudaMemsetAsync(saved, 0, sizeof(float) * 2 * N, s)
                                     : cudaMemsetAsync(f, 0, sizeof(float) * n, s);
  if (err == cudaSuccess && saved == nullptr) err = cudaMemsetAsync(g, 0, sizeof(float) * n, s);
  if (err == cudaSuccess && delta != nullptr && n_iters > 0) {
    err = cudaMemsetAsync(delta, 0, sizeof(float) * n_iters, s);
  }
  for (int it = 0; it < n_iters && err == cudaSuccess; ++it) {
    float* slot = delta != nullptr ? delta + it : nullptr;
    float *f_old = f, *g_old = g, *f_new = f, *g_new = g, *lse_f = nullptr, *lse_g = nullptr;
    if (saved != nullptr) {
      f_old = saved + 2 * it * N;
      g_old = f_old + N;
      f_new = g_old + N;
      g_new = f_new + N;
      lse_f = lse + 2 * it * N;
      lse_g = lse_f + N;
    }
    err = launch_d<false>(d, x, g_old, log_b, f_old, f_new, slot, lse_f, n, eps, k, xs, damping, s);
    if (err == cudaSuccess) {
      err = launch_d<false>(d, x, f_new, log_a, g_old, g_new, slot, lse_g, n, eps, k, xs, damping,
                            s);
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
  return static_cast<int>(launch_d<true>(d, x, f, log_a, g, out, nullptr, nullptr, n, eps, k, xs,
                                         1.0f, static_cast<cudaStream_t>(stream)));
}

// The VJP of the dual loop and the projection together, from what
// pf_sinkhorn_dual saved (saved, lse) and the projection's output x_out:
// grad_x (n x d) and grad_log_a (n) of <grad_out, x_out>, through every
// iteration. cot_f and cot_g are n-long scratch (the cotangents of f and g
// as the reverse loop carries them). The projection's two passes, then for
// t = n_iters - 1 ... 0 tau_g's row and column passes and tau_f's: 4 n_iters
// + 2 launches on stream, no sync. Returns the first launch error, or 0.
extern "C" int pf_sinkhorn_vjp(const float* x, const float* log_a, const float* log_b,
                               const float* saved, const float* lse, const float* x_out,
                               const float* grad_out, float* grad_x, float* grad_log_a,
                               float* cot_f, float* cot_g, int n, int d, int n_iters, float eps,
                               float k, float xs, float damping, void* stream) {
  if (bad_shape(n, d) || n_iters < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = n;
  VjpArgs a = {};
  a.x = x;
  a.xbar = grad_x;
  a.n = n;
  a.eps = eps;
  a.k = k;
  a.xs = xs;
  a.damping = damping;
  VjpArgs pr = a;  // the projection, from f and g after the last iteration
  pr.rpot = saved + 2 * n_iters * N;
  pr.rlogm = log_a;
  pr.cpot = pr.rpot + N;
  pr.ybar = grad_out;
  pr.yout = x_out;
  pr.cot_f = cot_f;
  pr.cot_g = cot_g;
  pr.cla = grad_log_a;
  cudaError_t err = launch_vjp_d<kProjRow>(d, pr, s);
  if (err == cudaSuccess) err = launch_vjp_d<kProjCol>(d, pr, s);
  for (int it = n_iters - 1; it >= 0 && err == cudaSuccess; --it) {
    const float* g_old = saved + (2 * it + 1) * N;
    VjpArgs tg = a;  // tau_g of iteration it: h = f after it, m = a; its h-bar goes to f-bar
    tg.lse = lse + (2 * it + 1) * N;
    tg.cpot = g_old + N;
    tg.clogm = log_a;
    tg.cot_out = cot_g;
    tg.cot_h = cot_f;
    tg.keep = it == n_iters - 1 ? 1.0f : 1.0f - damping;  // f-bar of the later tau_f's p
    tg.cla = grad_log_a;
    VjpArgs tf = a;  // tau_f: h = g before it, m = b (a constant); its h-bar goes to g-bar
    tf.lse = lse + 2 * it * N;
    tf.cpot = g_old;
    tf.clogm = log_b;
    tf.cot_out = cot_f;
    tf.cot_h = cot_g;
    tf.keep = 1.0f - damping;  // g-bar of tau_g's p
    err = launch_vjp_d<kHalfRow>(d, tg, s);
    if (err == cudaSuccess) err = launch_vjp_d<kHalfCol>(d, tg, s);
    if (err == cudaSuccess) err = launch_vjp_d<kHalfRow>(d, tf, s);
    if (err == cudaSuccess) err = launch_vjp_d<kHalfCol>(d, tf, s);
  }
  return static_cast<int>(err);
}
