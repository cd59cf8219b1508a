#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds every hand-written kernel from the sources in this checkout (B2 and
the probes X1-X3 with nvcc into build/torch_kernels/, one nvcc per source,
all started together; B1 by Triton) and holds each against its plain
PyTorch version on the card at N = 2^20 (B2 also at N = 3000, a ragged last
block; B1 and B2 also at the exact path's N = 2^25, B2 there on the exact
integer starts; B1's row and its counter also after CUDA-graph replays; X1
and X2 within 1e-5: they telescope f32 differences in another order; X2
also against B2; X1 and X2 both on their sorted windows, where they search,
and on shuffled ones, where they walk; X1 kernel and plain each held against
the f64 sums of its windows, also at W = 128 and 6144 and on a NaN start, X2
also launched past its span budget, where exactly the over-budget
super-groups get NaN); kernel S (the systematic starts from the weights)
against the plain chain at rows x N = 1 x 2^24, 1 x 2^20, 1 x 3000,
100 x 200 and 100 x 10^4 on five weight regimes (run ends within one of
plain at no more than 1e-5 of the positions, the count printed, and a wrong
u shown to move more; the starts sorted and bounded; two calls bit-equal),
its log-domain input (log-weights and their log-normalizers) against the
chain fed exp(logw - log_z) under the same share, its linear mode bit for
bit as before that input (SHA-256 digests on integer-made inputs), and
degenerate clouds (all -inf, one finite weight, a +inf) as the normalized
path gives them;
the Sinkhorn tile kernels (the dual loop and the projection) against their
plain version at N x d from 1 x 1 to 20000 x 3 on a spread cloud and on a
point mass with a particle 8 sigma out (potentials, dual changes and new
particles within stated tolerances, launches by the plan); the Sinkhorn VJP
kernels against their plain version from one saved history at N = 8192,
d = 1 and 3 (the gradients for the cloud and log a within 1e-4 of the
largest entry, launches by the plan).
Then:

- the main path: the SIR filter on the 1-D stochastic-volatility model
  (alpha=0.95, sigma=0.2, beta=1; N = 2^20, T = 200, systematic resampling
  when ESS < N/2) through ``FusedSIRFilter`` and through the general
  ``ParticleFilter``, checked, with B1 and B2 counted; the fused run is one
  CUDA graph replay (captured by a run before it), whose every step
  launches B1, kernel S in its log domain (B1's log Z, no normalization of
  its own) and B2, the last two gated by B1's trigger; that replay and its
  steps launched eagerly equal the host's loop bit for bit; S and B2 with a
  0 trigger leave their outputs alone and with a 1 equal the ungated calls
  (2^20 and 2^24); a run that never resamples must launch B1, S and B2
  once a step and no other kernel per step;
- the entry path (``particle_filters_tpu_torch/entry.py``): ``entry()``'s
  one fused step at N = 2^20 (B1 launched once, B2 as often as it
  resampled, a finite state, 0 < ESS <= N), its posterior mean within 5
  combined standard errors of ``entry_generic()``'s step at N = 65536, the
  step's median time over 20 CUDA-event timings; then
  ``dryrun_multichip`` over the visible cards (one NCCL rank a card, a
  process of its own): the four phases' asserts, B1 and B2 launched in its
  fused phase;
- the exact path: the run ends at N = 2^25 on the card bit-equal to the
  same call on the CPU (lognormal sigma = 2 and a point mass), and
  ``FusedSIRFilter`` on the SV model at N = 2^25, T = 50 (B1, and B2 on
  exact starts), with B1 and B2 counted; here and on the SNLG, skew-t and
  MAT paths no row takes kernel S's log-domain input;
- the SNLG path (``benchmarks.snlg``): KF, KF at sigma_z = 1, UKF, EDH-200,
  LEDH-200 and EDH-10000 on the sensor network, d = 64, T = 50, 100 trials
  batched, each held to the JAX package's MSE (KF and UKF within 1e-3
  relative, the flows within 5 %), B2 counted on the flows' resample steps
  (once a step for all triggered trials);
- the skew-t path (``benchmarks.skewt``): EKF, UKF, EDH-200, EDH-10000 and
  LEDH-200 on the d = 144 skew-t sensor network with Poisson counts, T = 10,
  100 trials batched, on the JAX package's committed data: EKF and UKF
  within 1e-3 of its MSE, the flows within 5 %, post-resample ESS within its
  rounding of N, finite histories, B2 once a step with a resample, LEDH-200's
  peak memory;
- the MAT path (``benchmarks.mat``): EKF, UKF, and EDH and LEDH over 16
  seeds of 500 particles on the committed acoustic-tracking data: the
  Kalman OMATs within 1e-3 of the JAX package's (or twice its own one-ulp
  spread, where wider), each flow's median OMAT inside the JAX package's
  quartiles over 16 keys and below the Kalman rows where the JAX package's
  is, B2 once a step with a resample for EDH and never for LEDH; EDH again
  on 16 more seeds, and each flow's OMATs against the JAX package's 16 by a
  rank test;
- the KPF path (``benchmarks.kpf``): the kernel PF on Lorenz-96 at nx = 1000,
  Np = 20, three analyses against the JAX package's committed posteriors
  (the same pseudo-steps as a user runs them; with the factor's jitter
  pinned at the JAX package's rung, the same pseudo-steps and the stated
  tolerance; the localized analysis beating the forecast);
- B2 held bit-equal to its plain version at the flows' shapes, (2e4, 64),
  (1e6, 64), (2e4, 144), (1e6, 144) and (8000, 16), with trial-offset
  starts and a point-mass trial, and at the SPF's SIR PF, (1e4, 9);
- the port's skew-t, MAT and Lorenz-96 simulators on the card (their draws
  take the card's generator), held to the JAX package's data by moments;
- the SPF path (``benchmarks.spf``): the optimal beta* on the card against
  the same solve on the CPU (example 1's at n_grid 1001, example 2's first
  batched solve of its 20 runs), example 1 (20 runs of N = 50, 1000
  lambda-steps, linear and optimal; 8 sets of 20 runs against the JAX
  package's 8 by a two-sample test) and example 2's first 10 time steps
  (the SPF of 20 runs batched, optimal and linear, and the SIR PF at
  N = 10^4, which resamples 10^4 x 9 through B2), run by run against the
  JAX package's on the same trajectories by a paired test, B2 counted;
- the DPF path (``benchmarks.dpf``): dpf_linear and dpf_nonlinear (soft,
  OT, RNN baseline; 8 seeds a row against the JAX package's 64 keys by a
  two-sample test), 20 Adam steps of the trained RNN timed a step, and the
  committed trained GRU's held-out NLL 10x below baseline mode's;
- the OT path (``benchmarks.ot_large``): dense (on the card, the Sinkhorn
  tile kernels) against blockwise Sinkhorn at N = 4096, and blockwise at
  N = 4096, 16384 and 65536 with peak memory; then ``DPF_OT.run_filter`` at
  N = 8192 for 5 steps, every resample through the tile kernels (counted),
  and ``torch.autograd.grad`` of its log-evidence in (alpha, sigma, beta),
  every backward resample through the VJP kernels (counted, from zero);
- the run_chunked path: ParticleFilter on the SV model at N = 2^20 run in
  pieces, interrupted and resumed from its checkpoint, bit-equal to run;
- determinism: two FusedSIRFilter runs and two ParticleFilter runs (with
  the degeneracy panel) from one seed at N = 2^20, T = 200, bit-equal;
- the parallel path (``benchmarks.sharded``), in a one-card NCCL group (a
  world of one: every collective a real NCCL call): the sharded fused SV
  run at N = 2^20, T = 200 in all-gather mode bit-equal to
  ``FusedSIRFilter`` and in neighbour mode within ``sharded.NEIGHBOR_TOL``
  of it (B1 and B2 counted, ms/step beside the unsharded run's); B1 as four
  ranks' launches over 2^18 bit-equal to one over 2^20, their partials
  folded by ``fold_ranks`` (the filter's cross-rank step) within
  ``sharded.FOLD_TOL`` of one launch's row; B2's M→n form
  bit-equal to its plain version and to ``repeat_interleave`` at a pool of
  5·2^18, the all-gather slice of 2^20 and (10^4, 2000, 9), timed; the
  pooled exact run ends at 2^25 equal to ``exact_child_run_ends_u`` on card
  and CPU; the sharded ``ParticleFilter`` in neighbour mode at 2^20 held to
  the main path's gates; the sharded EDH-10000 on SNLG d = 64 against the
  unsharded flow; the sharded DPF train step (8 SV sequences, N = 100,
  T = 100) equal to the unsharded step; the collectives' host cost;
- the sv_classic column uncut (EKF, UKF, the SIR PF at N = 2000, T = 2000)
  through the harness (``benchmarks.run_benchmarks``, to a temporary file:
  its record's keys the JAX record's less ``reference*``, the card fields
  filled) and the nlngssm column (EDH, LEDH, KPF at N = 500) cut to its first 100
  steps, each against the JAX package's committed values (Kalman RMSEs
  within 1e-3, the others by Welch tests over seeds, p >= 1e-3);
- the north-star scripts: the bench twin (``benchmarks.bench``: the main
  path's workload, the best of 5 runs after a warm-up, its JSON on a line
  of its own) held to the main path's gates, and the scaling curve
  (``benchmarks.scaling_curve``) at N = 2^14 ... 2^24, each N's ms/step,
  particle-steps/s, resample fraction and device busy share, finite
  histories at every N; B1 and B2 counted;
- the examples path: the seven notebook examples that no column reproduces
  (``particle_filters_tpu_torch/examples``), each at its own size but for
  the cuts named at ``EX15_T`` (fewer steps and seeds), their tables
  printed, each held to its module's gates (ex15's boundary resample
  fractions exactly 0 and 1; ex14's EKF/UKF RMSEs within 1e-3 of the JAX
  package's and its PF RMSEs against the JAX package's 8 keys; ex01's mean
  NEES in the chi^2 band; ex12's variance reductions, and its diagonal
  kernel in float64 at jitter 1e-5 reducing both >= 0.85; ex11's linear beta
  below beta*, and beta* on the card equal to the CPU's within 3e-7; ex08's
  finite cells and best cell within 5 standard errors of the JAX package's;
  ex07's decreasing loss and final a), B2 counted on the PF rows;
- the profiling path: the small-N step decomposition
  (``benchmarks.profile_small_n``, N = 2^14, 2^16, 2^20), probe X1's
  variants (``benchmarks.exp_kernel_var``) and probe X2 against B2
  (``benchmarks.exp_resample_dma``), with X1-X3 counted;
- each kernel timed against its plain version, its bound and, where one
  PyTorch call computes the same function, that call; B1 also with
  injected normals and over its programs per SM, B2 also at a point mass
  and at the flows' shapes (d = 64, 144 and 16) and the SIR PF's (1e4, 9),
  X1 and X2 on sorted windows beside the same windows shuffled, X3 against ``torch.add`` in
  alternating pairs; the exact run ends at 2^25 beside the f32 ones at 2^24;
  S against the plain chain at 1 x 2^24, 1 x 2^20 and 100 x 200.

Every phase raises on failure, so the exit code is non-zero. Without a CUDA
device it exits non-zero at once. The last three lines of standard output are
the kernels' JSON line, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import torch.distributed as dist

from h100_bench.roofline import FP32_OPS_PER_S, HBM_BYTES_PER_S, least_s
from particle_filters_tpu_torch import entry
from particle_filters_tpu_torch.benchmarks import (
    bench,
    dpf,
    exp_kernel_var,
    exp_resample_dma,
    kpf,
    mat,
    nlngssm,
    ot_large,
    profile_small_n,
    run_benchmarks,
    scaling_curve,
    sharded,
    skewt,
    snlg,
    spf,
    sv_classic,
)
from particle_filters_tpu_torch.benchmarks._stats import P_MIN
from particle_filters_tpu_torch.examples import (
    ex01_kalman_lgssm as ex01,
    ex07_train_dpf as ex07,
    ex08_dpf_ot_tuning as ex08,
    ex11_spf_ledh_beta_schedule as ex11,
    ex12_kernel_pf_experiments as ex12,
    ex14_sv_variance_stabilized as ex14,
    ex15_pf_degeneracy_analysis as ex15,
)
from particle_filters_tpu_torch.models import ParticleFilter
from particle_filters_tpu_torch.models.kernel_particle_filter import FACTOR_RESID_MAX
from particle_filters_tpu_torch.ops import launch_probe as x3
from particle_filters_tpu_torch.ops import resample as b2
from particle_filters_tpu_torch.ops import sinkhorn_tile as ot_tile
from particle_filters_tpu_torch.ops import span_resample as x2
from particle_filters_tpu_torch.ops import systematic_starts as ks
from particle_filters_tpu_torch.ops import window_resample as x1
from particle_filters_tpu_torch.ops.fused_pf import (
    FusedSIRFilter,
    PROGRAMS_PER_SM,
    LinearObsFirstModel,
    StepWork,
    SVModel,
    fused_step,
    fused_step_reference,
    row_width,
)
from particle_filters_tpu_torch.ops.resample_blocked import fine_chunks
from particle_filters_tpu_torch.parallel.launch import process_group
from particle_filters_tpu_torch.resampling.hard import (
    _child_run_ends_u,
    _systematic_starts,
    _weights_from,
    batched_starts,
)
from particle_filters_tpu_torch.simulators import simulate_sv_1d
from particle_filters_tpu_torch.utils.timing import card as card_of
from particle_filters_tpu_torch.utils.timing import profile_device

N = 1 << 20
T = 200
CARD_RUN_SEED = 31  # the generator of check_card_run's runs
ALPHA, SIGMA, BETA = 0.95, 0.2, 1.0
PROBE_TOL = 1e-5  # X1, X2: f32 telescoping sums of up to 512 terms in two orders
SMALL_N_SLOPE = (50, 850, 5)  # profile_small_n's m_lo, m_hi, reps here
B2_RAGGED_N = 3000  # B2's checks again where the last block is ragged
EXACT_N, EXACT_T = 1 << 25, 50  # the exact path: past the f32 run ends' 2^24
# The flows' resample, trials x N x d: SNLG d = 64, skew-t d = 144 (EDH-200
# and LEDH-200, EDH-10000), MAT's EDH d = 16 over its 16 seeds of 500.
B2_TRIAL_SHAPES = ((100, 200, 64), (100, 10000, 64), (100, 200, 144), (100, 10000, 144),
                   (16, 500, 16))
# MAT's flows: the port's OMATs against the JAX package's 16 by a two-sided
# rank test; a p under this flags a shift of the port's flow, not chance.
MAT_RANK_P = 1e-3
DET_SEED = 11  # the determinism check's generator seed
# Kernel S against the plain chain: rows x N (the SV cells, a ragged tile,
# the flows' 200 and 10^4 a cloud), and the shapes it is timed at.
S_SHAPES = ((1, 1 << 24), (1, 1 << 20), (1, 3000), (100, 200), (100, 10_000))
S_TIMED = ((1, 1 << 24), (1, 1 << 20), (100, 200))
# The run ends kernel S may give off the chain's, each by one, as a share of
# rows x N: none below 10^5 positions, at most 167 at 2^24. A cdf sum
# associated in another order rounds to another f32 only where the f64 sum
# lies within a few of its ulps of an f32 rounding boundary; a u read from
# another row, or none, moves about a third of the run ends.
S_DIFF_SHARE = 1e-5
# Kernel S's linear mode, bit for bit as it was before its log-domain input:
# the SHA-256 of its run ends (M = N) and starts at each of S_SHAPES, on
# inputs made by integer arithmetic alone (_s_pinned: the same bits on any
# host), as the kernel before the log-domain input wrote them on the H100.
S_LINEAR_SHA256 = {
    (1, 1 << 24): "4c452ce824f534ca847ba0b101fdb69df214268c4c04d84185218e103ea2d099",
    (1, 1 << 20): "52ffcd5c2c0c08faa98ba78d2dce8fee37bb5c83d8cf3155c9e2b0be20f48c1d",
    (1, 3000): "fdbc69c0526211188ee6532bd9a102bd7f99425e1681c57d30ac525c6bb25523",
    (100, 200): "465491822ed8db18ba8a077ab00f30baf63015e75293518a239df218127d2622",
    (100, 10_000): "80e9b688d3949133462b8cf467adf9ef461d3f695eba9d4a077ecf199f148770",
}
B2_SIR_SHAPE = (1, spf.N_SIR, 9)  # SPF example 2's SIR PF: one cloud of 10^4 x 9
SPF_BETA_TOL = 1e-4  # beta* on the card against the CPU port
# SPF example 2 runs its first SPF_EX2_STEPS time steps here (the module runs
# all 50: python -m particle_filters_tpu_torch.benchmarks.spf).
SPF_EX2_STEPS = 10
DPF_TRAIN_STEPS = 20  # Adam steps of the trained RNN timed here (the module takes 300)
OT_DENSE_TOL = 1e-4  # dense (the tile kernels) against blockwise Sinkhorn at N = 4096
# The Sinkhorn tile kernels against their plain version: N x d (one
# particle, a ragged chunk, the DPF-OT cell's 8192, a ragged block, more
# columns than 8192), each on two clouds, 50 damped iterations at eps 0.1.
OT_TILE_SHAPES = ((1, 1), (1, 3), (100, 1), (100, 3), (8192, 1), (8192, 3), (8193, 1),
                  (8193, 3), (20000, 1), (20000, 3))
OT_TILE_EPS, OT_TILE_DAMPING, OT_TILE_ITERS = 0.1, 0.5, 50
# Kernel against plain: ex2.approx (2 ulp) against torch.exp2, and sums in
# other orders (four partials over 32 columns, then chunks, then 16 warps,
# against torch's), re-rounded by each of the 100 half-updates: the
# potentials and the dual changes in the cost's units, the new particles in
# the input cloud's std (the output cloud of a point mass has almost none).
OT_TILE_POT_TOL, OT_TILE_PARTICLE_TOL = 1e-4, 1e-4
DPF_OT_N, DPF_OT_T = 8192, 5  # DPF_OT.run_filter through the tile kernels
# The VJP kernels against their plain version from one saved history (the
# spread cloud, a normal cotangent), as the card tests hold them: the
# gradients' largest gap over their largest entry. ex2.approx against
# torch.exp2 and sums in another order over 202 passes (a bfloat16 backward,
# ~4e-3 a rounding, is far outside).
OT_VJP_SHAPES = ((8192, 1), (8192, 3))
OT_VJP_TOL = 1e-4
CHUNK_T, CHUNK_SIZE, CHUNK_STOP = 30, 10, 2  # run_chunked at N = 2^20: interrupt after 2
# The north-star phase: the scaling curve's timed runs of each length after
# the warm-up (the module takes 4, as the JAX script does).
SCALING_REPS = 1
# The examples phase, at the examples' own sizes but for these cuts, which
# the phases' 150 s forces (the general PF and the Kalman loops take 1.7-4
# ms a step on the card's host; the modules run them uncut): ex15 over the
# first EX15_T of its 2000 steps, experiment 3 over EX15_SEEDS seeds (16);
# ex14 over its first T_CUT = 500 steps (held to the JAX package's values
# over those steps), its PF rows over EX14_PF_SEEDS seeds a form (8); ex01
# over the first EX01_SEEDS of its 10 seeds.
EX15_T, EX15_SEEDS = 500, 4
EX14_PF_SEEDS = 3
EX01_SEEDS = 4
ENTRY_SE, ENTRY_REPS = 5.0, 20  # entry() against entry_generic(); its timed calls
EX11_BETA_TOL = 3e-7  # beta* on the card against the CPU port, from the same M0 and Mh
A2 = [[0.9, 0.1], [0.0, 0.8]]  # nx = 2 linear model of the B1 checks
Q2 = [[0.05, 0.01], [0.01, 0.02]]


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _time_ms(fn, reps: int = 10, samples: int = 5) -> float:
    """Median over ``samples`` of the CUDA-event time of ``reps`` calls / reps."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


# --- B2 -----------------------------------------------------------------------
def _point_masses(n, device, *where):
    w = torch.zeros(n, device=device)
    w[list(where)] = 1.0
    return w / w.sum()


def _b2_cases(gen, n, device):
    """(label, weights) at the regimes of the TPU kernel's three tiers and
    at the edges of the merge: point masses at 0, N/3 and N-1 (long runs
    of equal starts, and starts equal to N), and two point masses."""
    z = torch.randn(n, generator=gen, device=device)
    for sigma in (0.5, 2.0, 6.0):
        yield f"lognormal sigma={sigma}", torch.softmax(sigma * z, 0)
    yield "point mass at N/3", _point_masses(n, device, n // 3)
    yield "point mass at 0", _point_masses(n, device, 0)
    yield "point mass at N-1", _point_masses(n, device, n - 1)
    yield "two point masses", _point_masses(n, device, n // 4, (3 * n) // 4)


def check_b2(gen, n, device, dims=(1, 3)) -> float:
    """B2 against its plain version: equal bit for bit (both copy values)."""
    max_err = 0.0
    for label, w in _b2_cases(gen, n, device):
        raw = torch.cumsum(w, 0)  # the card's parallel scan, before _cdf's running max
        descents = int((raw[1:] < raw[:-1]).sum())
        starts = _systematic_starts(gen, w, n)
        _check(bool((starts[1:] >= starts[:-1]).all()), f"starts nondecreasing ({label})")
        print(f"B2 {label:22s}: raw cumsum descents {descents}, starts nondecreasing (N={n})")
        for d in dims:
            p = torch.randn((n, d), generator=gen, device=device)
            out = b2.resample_by_starts(p, starts)
            ref = b2.resample_by_starts_reference(p, starts)
            max_err = max(max_err, (out - ref).abs().max().item())
            _check(torch.equal(out, ref), f"B2 == plain bit for bit ({label}, d={d})")
            print(f"B2 {label:22s} d={d}: equal to plain (N={n})")
    return max_err


def _trial_weights(gen, trials, n, device):
    """(trials, n) weights: lognormal sigma = 2 rows, a point mass in row 1."""
    w = torch.softmax(2.0 * torch.randn((trials, n), generator=gen, device=device), dim=1)
    if trials > 1:
        w[1] = 0.0
        w[1, n // 3] = 1.0
    return w


def check_b2_trials(gen, trials, n, d, device) -> float:
    """B2 at the flows' resample: all trials' starts offset by b*n in one
    sorted array, values (trials*n, d); equal to plain bit for bit, and no
    trial's values come from another trial."""
    w = _trial_weights(gen, trials, n, device)
    starts = batched_starts(w, torch.rand(trials, generator=gen, device=device))
    _check(bool((starts[1:] >= starts[:-1]).all()), "trial starts nondecreasing")
    firsts = starts.view(trials, n)[:, 0]
    _check(torch.equal(firsts, torch.arange(trials, device=device, dtype=torch.int32) * n),
           "each trial's first start is its offset")
    p = torch.randn((trials * n, d), generator=gen, device=device)
    out = b2.resample_by_starts(p, starts)
    ref = b2.resample_by_starts_reference(p, starts)
    _check(torch.equal(out, ref), f"B2 == plain bit for bit ({trials} x {n}, d={d})")
    _check(bool((out.view(trials, n, d)[1] == p[n + n // 3]).all()),
           "the point-mass trial holds its own particle only")
    print(f"B2 trial-offset starts {trials} x {n} = {trials * n} rows, d={d}: equal to plain, "
          f"point-mass trial intact")
    return (out - ref).abs().max().item()


# --- S ------------------------------------------------------------------------
_S_LOGNORMAL = "lognormal sigma=2"


def _s_cases(gen, rows, n, device):
    """(label, weights) a row: lognormal sigma = 2, one weight 1 and the
    rest 0, all equal, tiny weights (every 1024th 1, the rest 1e-39, in f32
    subnormals after the normalization) and unnormalized weights all under
    1e-38."""
    yield _S_LOGNORMAL, torch.softmax(
        2.0 * torch.randn((rows, n), generator=gen, device=device), dim=1)
    one = torch.zeros((rows, n), device=device)
    one[torch.arange(rows, device=device), torch.arange(rows, device=device) * 7919 % n] = 1.0
    yield "one weight 1", one
    yield "all equal", torch.full((rows, n), 1.0 / n, device=device)
    tiny = torch.full((rows, n), 1e-39, device=device)
    tiny[:, ::1024] = 1.0
    yield "tiny weights", tiny / tiny.sum(1, keepdim=True)
    yield "all under 1e-38", torch.full((rows, n), 1e-40, device=device)


def _s_pinned(rows, n, device):
    """Weights over 40 binades with hashed mantissas (their f64 sums round,
    so the order of the additions shows in the bits) and u's, from integer
    arithmetic alone."""
    i = torch.arange(rows * n, dtype=torch.int64, device=device)
    h = (i * 2654435761 + 12345) % (1 << 32)
    g = ((i ^ (i >> 7)) * 2246822519 + 777) % (1 << 32)
    bits = ((127 - h % 40) << 23) | (g & 0x7FFFFF)
    w = bits.to(torch.int32).view(torch.float32).view(rows, n).contiguous()
    k = torch.arange(1, rows + 1, dtype=torch.int64, device=device)
    return w, ((k * 40503) % 65536).to(torch.float32) / 65536


def check_starts_linear_pinned(rows, n, device) -> str:
    """Kernel S's linear mode (no log_z) on ``_s_pinned``'s inputs: its run
    ends and starts hash to ``S_LINEAR_SHA256``'s digest for the shape, so
    they are the bits the kernel wrote before its log-domain input. Returns
    the digest."""
    w, u = _s_pinned(rows, n, device)
    t, s = ks.systematic_run_ends(w, n, u), ks.systematic_starts(w, u)
    digest = hashlib.sha256(t.cpu().numpy().tobytes() + s.cpu().numpy().tobytes()).hexdigest()
    want = S_LINEAR_SHA256.get((rows, n))
    _check(digest == want, f"S linear mode at {rows} x {n}: digest {digest}, want {want}")
    print(f"S linear mode {rows} x {n}: run ends and starts bit-equal to before ({digest[:16]})")
    return digest


def _log_cases(gen, rows, n, device):
    """``_s_cases``' weights as log-weights, each row shifted by a constant
    in [-40, 40] (no longer normalized), with their log-normalizers."""
    for label, w in _s_cases(gen, rows, n, device):
        lw = torch.log(w) + (80.0 * torch.rand((rows, 1), generator=gen, device=device) - 40.0)
        yield label, lw.contiguous(), torch.logsumexp(lw, dim=1)


def check_starts_log(gen, rows, n, device) -> int:
    """Kernel S's log-domain input against the plain chain fed
    exp(logw − log_z): starts within one at no more than ``S_DIFF_SHARE``
    of the positions, two calls bit-equal, the launches and the log rows
    counted. Returns the largest difference (0 or 1)."""
    most = 0
    passes = ks.plan(rows, n).passes
    allowed = int(S_DIFF_SHARE * rows * n)
    for label, lw, lz in _log_cases(gen, rows, n, device):
        u = torch.rand(rows, generator=gen, device=device)
        launches, log_rows = ks.systematic_starts.launches, ks.systematic_starts.log_rows
        s = ks.systematic_starts(lw, u, log_z=lz)
        s2 = ks.systematic_starts(lw, u, log_z=lz)
        torch.cuda.synchronize()
        _check(ks.systematic_starts.launches == launches + 2 * passes,
               f"S log domain launched {ks.systematic_starts.launches - launches}, "
               f"want {2 * passes}")
        _check(ks.systematic_starts.log_rows == log_rows + 2 * rows,
               f"S log rows {ks.systematic_starts.log_rows - log_rows}, want {2 * rows}")
        _check(torch.equal(s, s2), f"S log domain two calls bit-equal ({label})")
        ref = ks.starts_reference(torch.exp(lw - lz[:, None]), u)
        diff = (s.long() - ref.long()).abs()
        count = int((diff != 0).sum())
        _check(int(diff.max()) <= 1, f"S log domain within one of plain ({label}, {rows} x {n})")
        _check(count <= allowed, f"S log domain off plain at {count} of {rows * n} positions, "
                                 f"at most {allowed} allowed ({label})")
        most = max(most, int(diff.max()))
        print(f"S log {label:18s} {rows} x {n}: {count} starts differ by one from the chain "
              f"fed exp(logw - log_z) (of {rows * n}, at most {allowed} allowed), two calls "
              f"bit-equal, {passes} passes")
    return most


S_DEGENERATE = ("all -inf", "all -inf, guarded log Z", "one finite weight", "+inf log Z")


def check_starts_degenerate(label, device, n=20_000) -> None:
    """A degenerate cloud through kernel S's log-domain input gives the
    starts of the normalized path (``log_normalize``, then the linear
    mode), bit for bit: all weights 0, one weight 1, NaN at a +inf."""
    gen = torch.Generator(device=device).manual_seed(9)
    lw = torch.full((1, n), -math.inf, device=device)
    if label == "one finite weight":
        lw[0, 1234] = 3.25
    elif label == "+inf log Z":
        lw = 2.0 * torch.randn((1, n), generator=gen, device=device)
        lw[0, 77] = math.inf
    lz = torch.logsumexp(lw, dim=1)
    if label == "all -inf, guarded log Z":
        lz = torch.log(torch.full((1,), 1e-30, device=device))
    u = torch.rand(1, generator=gen, device=device)
    got = batched_starts(lw, u, log_z=lz)
    want = batched_starts(_weights_from(None, lw), u)
    _check(torch.equal(got, want), f"S log domain, {label}: the normalized path's starts")
    print(f"S log domain, {label} (log Z {float(lz[0])}): starts equal to the normalized path's")


def _wrong_u(u):
    """Uniforms a faulty kernel might read: another row's, or none."""
    return {"another row's u": u.roll(1) if u.numel() > 1 else (u + 0.5) % 1.0,
            "u = 0": torch.zeros_like(u)}


def check_starts(gen, rows, n, device) -> int:
    """Kernel S against the plain chain on the card, both forms: run ends
    within one of the chain's at no more than ``S_DIFF_SHARE`` of the
    positions (counted and printed), the starts the shifted run ends (first
    0, offset by b·N, sorted, in [b·N, (b+1)·N]), two calls bit-equal, the
    launches counted. On the lognormal weights the check shows its power:
    the chain's run ends for a wrong u differ from the right ones at more
    than the allowed positions. Returns the largest difference of a run end
    (0 or 1)."""
    most = 0
    passes = ks.plan(rows, n).passes
    allowed = int(S_DIFF_SHARE * rows * n)
    for label, w in _s_cases(gen, rows, n, device):
        u = torch.rand(rows, generator=gen, device=device)
        before = ks.systematic_starts.launches
        t = ks.systematic_run_ends(w, n, u)
        t2 = ks.systematic_run_ends(w, n, u)
        s = ks.systematic_starts(w, u)
        s2 = ks.systematic_starts(w, u)
        torch.cuda.synchronize()
        _check(ks.systematic_starts.launches == before + 4 * passes,
               f"S launched {ks.systematic_starts.launches - before}, want {4 * passes}")
        _check(torch.equal(t, t2) and torch.equal(s, s2), f"S two calls bit-equal ({label})")
        ref = ks.run_ends_reference(w, n, u)
        diff = (t.long() - ref.long()).abs()
        _check(int(diff.max()) <= 1, f"S run ends within one of plain ({label}, {rows} x {n})")
        count = int((diff != 0).sum())
        _check(count <= allowed, f"S run ends off plain at {count} of {rows * n} positions, "
                                 f"at most {allowed} allowed ({label})")
        _check(torch.equal(s, ks.starts_from_run_ends(t)), f"S starts = shifted run ends ({label})")
        sv = s.view(rows, n).long()
        off = torch.arange(rows, device=device)[:, None] * n
        _check(bool((sv[:, :1] == off).all()), f"S first start b·N ({label})")
        _check(bool((s[1:] >= s[:-1]).all()), f"S starts sorted ({label})")
        _check(bool(((sv >= off) & (sv <= off + n)).all()), f"S starts in range ({label})")
        most = max(most, int(diff.max()))
        caught = ""
        if label == _S_LOGNORMAL:
            moved = {k: int((ks.run_ends_reference(w, n, v) != ref).sum())
                     for k, v in _wrong_u(u).items()}
            _check(min(moved.values()) > allowed, f"S check too weak: a wrong u moves {moved}")
            caught = ", a wrong u would move " + ", ".join(f"{v} ({k})" for k, v in moved.items())
        print(f"S {label:18s} {rows} x {n}: {count} run ends differ by one from plain "
              f"(of {rows * n}, at most {allowed} allowed{caught}), two calls bit-equal, "
              f"starts sorted and bounded, {passes} passes")
    return most


# --- B1 -----------------------------------------------------------------------
def _b1_inputs(gen, model, Q, n, device, uniform: bool):
    nx = model.nx
    f = FusedSIRFilter(model, Q, Np=n, device=device)
    x = (1.0 + 0.7 * torch.randn((nx, n), generator=gen, device=device)).contiguous()
    if nx > 1:
        x[1] += 0.5 * x[0]  # correlated rows: off-diagonal moments away from 0
    lw = (2.0 * torch.randn(n, generator=gen, device=device) - math.log(n)).contiguous()
    off_u = torch.tensor([0.3, 1.0 if uniform else 0.0], device=device)
    z = torch.tensor([0.8], device=device)
    return f, x, lw, off_u, z


def _check_b1_finish(work, row, n, thresh, label):
    """The counter is back to 0; the trigger and the carry match the row."""
    _check(int(work.counter.item()) == 0, f"B1 counter reset ({label})")
    want = int(bool(row[1] < thresh * n))  # in f32, as the kernel compares
    _check(int(work.trigger.item()) == want, f"B1 trigger == (ess < thresh*N) ({label})")
    _check(torch.equal(work.carry, torch.stack([row[0], torch.zeros_like(row[0])])),
           f"B1 carry == (log_z, 0) ({label})")


def _check_b1_graph(x, lw, off_u, z, f, model, eps, row_ref, thresh, label):
    """B1 captured in a CUDA graph and replayed three times: its row still
    matches the plain one and the counter is back to 0 after the replays."""
    work = StepWork(model.nx, x.device)
    row = torch.empty(row_width(model.nx), device=x.device)

    def step():
        fused_step(x, lw, off_u, z, f.Lq, f.params, model, seed=1, eps=eps,
                   resample_thresh=thresh, work=work, row_out=row)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(row, row_ref, rtol=1e-4, atol=1e-6)
    _check_b1_finish(work, row, x.shape[1], thresh, f"{label}, 3 graph replays")


def check_b1(gen, n, device) -> float:
    """Injected ε: B1 against its plain version, its row, counter, trigger
    and carry after one launch and after graph replays. Drawn ε: normal
    statistics of every state row."""
    max_err = 0.0
    for model, Q in ((SVModel(ALPHA, BETA), [[SIGMA**2]]), (LinearObsFirstModel(A2, 0.1), Q2)):
        nx = model.nx
        for uniform, thresh in ((False, 0.5), (True, 0.9)):
            label = f"nx={nx} uniform={uniform}"
            f, x, lw, off_u, z = _b1_inputs(gen, model, Q, n, device, uniform)
            eps = torch.randn((nx, n), generator=gen, device=device)
            work = StepWork(nx, device)
            xk, lwk, rk = fused_step(x, lw, off_u, z, f.Lq, f.params, model, seed=1, eps=eps,
                                     resample_thresh=thresh, work=work)
            xr, lwr, rr = fused_step_reference(x, lw, off_u, z, eps, f.Lq, model)
            # Triton's exp/log and its reduction order differ from torch's.
            torch.testing.assert_close(xk, xr, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(lwk, lwr, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(rk, rr, rtol=1e-4, atol=1e-6)
            _check_b1_finish(work, rk, n, thresh, label)
            _check_b1_graph(x, lw, off_u, z, f, model, eps, rr, thresh, label)
            err = max((xk - xr).abs().max().item(), (lwk - lwr).abs().max().item())
            max_err = max(max_err, err)
            print(f"B1 {label}: max |kernel - plain| = {err:.3e}, row within rtol 1e-4, "
                  f"trigger {int(work.trigger.item())}, counter 0 after a launch and "
                  f"3 graph replays (N={n})")

        f, x, lw, off_u, z = _b1_inputs(gen, model, Q, n, device, False)
        xk, _, _ = fused_step(x, lw, off_u, z, f.Lq, f.params, model, seed=12345)
        resid = (xk - model.g(x)).double()
        eps_hat = torch.linalg.solve_triangular(f.Lq.double(), resid, upper=False)
        for i in range(nx):
            mu, var = eps_hat[i].mean().item(), eps_hat[i].var().item()
            _check(abs(mu) < 5 / math.sqrt(n), f"Philox normals mean {mu} (nx={nx})")
            _check(abs(var - 1) < 5 * math.sqrt(2 / n), f"Philox normals var {var} (nx={nx})")
            print(f"B1 nx={nx} drawn eps row {i}: mean {mu:+.2e}, var {var:.5f}")
    return max_err


# --- the probes X1-X3 -------------------------------------------------------
def check_x3(device) -> float:
    """X3 against its plain version: equal bit for bit (one addition)."""
    x = torch.randn(x3.TILE, device=device)
    _check(torch.equal(x3.add_one(x), x3.add_one_reference(x)), "X3 == plain bit for bit")
    print("X3 add_one: equal to plain")
    return 0.0


def _shuffled(gen, *arrays):
    """``arrays`` with the entries of each last-axis row permuted, one
    permutation a row shared by all of them: X1's windows, X2's rows."""
    shape = (-1, arrays[0].shape[-1])
    keys = torch.rand(arrays[0].reshape(shape).shape, generator=gen, device=arrays[0].device)
    perm = torch.argsort(keys, dim=1)
    return tuple(torch.gather(a.reshape(shape), 1, perm).reshape(a.shape) for a in arrays)


def _sorted_rows(a):
    """Whether each last-axis row of ``a`` is nondecreasing (NaN is not)."""
    return (a[..., 1:] >= a[..., :-1]).all(-1)


def _check_x1(label, s_win, d_win, transpose, sum_only):
    """X1 and its plain version each held against the f64 sums of the same
    windows (the plain version run on f64 copies), within PROBE_TOL, so the
    bar measures the kernel and not the plain version's own f32 rounding;
    counts equal plain exactly. Returns (|kernel - plain|, |kernel - f64|,
    |plain - f64|), maxima."""
    out = x1.window_compare_sum(s_win, d_win, sum_only=sum_only, transpose=transpose)
    ref = x1.window_compare_sum_reference(s_win, d_win, sum_only=sum_only, transpose=transpose)
    exact = x1.window_compare_sum_reference(s_win.double(), d_win.double(), sum_only=sum_only,
                                            transpose=transpose)
    err = (out - ref).abs().max().item()
    err_k = (out.double() - exact).abs().max().item()
    err_p = (ref.double() - exact).abs().max().item()
    del exact
    if sum_only:
        _check(torch.equal(out, ref), f"X1 {label}: counts == plain")
    _check(err_k <= PROBE_TOL, f"X1 {label}: max |kernel - f64| {err_k} <= {PROBE_TOL}")
    _check(err_p <= PROBE_TOL, f"X1 {label}: max |plain - f64| {err_p} <= {PROBE_TOL}")
    return err, err_k, err_p


def check_x1(gen, n, device) -> float:
    """X1 against its plain version on the windows of
    ``exp_kernel_var.make_inputs``: the six variants at N = ``n``, v0-v2 at
    W = 128 (N = ``n``) and W = 6144 (N ≤ 2^16: the plain version holds an
    (N, W) mask), each on its sorted windows (the search) and with every
    window shuffled (the walk); and a window holding a NaN start. Counts
    equal, kernel and plain sums each within PROBE_TOL of the f64 sums."""
    cases = [(*variant, n) for variant in exp_kernel_var.VARIANTS]
    for q, n_q in ((1, n), (48, min(n, 1 << 16))):
        cases += [(f"{label[:2]} at W={q * x1.SUB}", q, sg, transpose, sum_only, n_q)
                  for label, _, sg, transpose, sum_only in exp_kernel_var.VARIANTS[:3]]
    max_err = 0.0
    for label, q, sg, transpose, sum_only, n_case in cases:
        s_win, d_win = exp_kernel_var.make_inputs(q, sg, n=n_case, device=device)
        _check(bool(_sorted_rows(s_win).all()), f"X1 {label}: every window sorted")
        shuffled = _shuffled(gen, s_win, d_win)
        unsorted = int((~_sorted_rows(shuffled[0])).sum())
        errs = [_check_x1(f"{label}, {kind}", s, d, transpose, sum_only)
                for kind, (s, d) in (("sorted", (s_win, d_win)), ("shuffled", shuffled))]
        max_err = max(max_err, errs[0][0], errs[1][0])
        print(f"X1 {label}: sorted: |kernel - plain| {errs[0][0]:.3e}, |kernel - f64| "
              f"{errs[0][1]:.3e}, |plain - f64| {errs[0][2]:.3e}; each window shuffled "
              f"({unsorted} of {s_win.shape[0] * sg} unsorted): |kernel - plain| "
              f"{errs[1][0]:.3e}, |kernel - f64| {errs[1][1]:.3e}, |plain - f64| "
              f"{errs[1][2]:.3e} (N={n_case}; bar {PROBE_TOL} on both f64 columns)")
    s_win, d_win = exp_kernel_var.make_inputs(4, 64, n=n, device=device)
    s_win[0, 1, 5] = float("nan")  # one window fails the sortedness vote
    for transpose, sum_only in ((True, False), (True, True)):
        label = f"a NaN start, sum_only={sum_only}"
        err, err_k, err_p = _check_x1(label, s_win, d_win, transpose, sum_only)
        max_err = max(max_err, err)
        print(f"X1 {label}: |kernel - plain| {err:.3e}, |kernel - f64| {err_k:.3e}, "
              f"|plain - f64| {err_p:.3e} (N={n})")
    return max_err


def _x2_cases(gen, n, device):
    """(label, weights, the refusal expected or None): X2's path is
    lognormal weights down to ESS ≈ N/3 and point masses; heavier
    degeneracy leaves a sub-group's Q-chunk window, a weight desert the
    span budget."""
    z = torch.randn(n, generator=gen, device=device)
    for sigma in (0.5, 1.0, 1.5):
        yield f"lognormal sigma={sigma}", torch.softmax(sigma * z, 0), None
    mass = torch.zeros(n, device=device)
    mass[n // 3] = 1.0
    yield "point mass", mass, None
    yield "lognormal sigma=3.0", torch.softmax(3.0 * z, 0), "window"
    desert = torch.where(torch.arange(n, device=device) < n // 2, 1e-3, 1.0)
    yield "weight desert", desert / desert.sum(), "spanD"


def _check_x2_budget(label, chunks, a0) -> float:
    """X2 launched on ``a0`` as it is, past the wrapper's refusal: NaN for
    exactly the super-groups whose span exceeds ROWS, the plain values
    (within PROBE_TOL) everywhere else."""
    a0s = a0.view(-1, x2.SG)
    over = a0s[:, -1] + x2.Q - a0s[:, 0] > x2.ROWS
    out = x2.span_compare_sum(*chunks, a0).view(a0s.shape[0], -1)
    ref = x2.span_compare_sum_reference(*chunks, a0).view(a0s.shape[0], -1)
    _check(bool(out[over].isnan().all()), f"X2 {label}: NaN in every over-budget super-group")
    _check(not bool(out[~over].isnan().any()), f"X2 {label}: no NaN within the budget")
    err = (out[~over] - ref[~over]).abs().max().item() if bool((~over).any()) else 0.0
    _check(err <= PROBE_TOL, f"X2 {label}: max |kernel - plain| {err} <= {PROBE_TOL} in budget")
    print(f"X2 {label:22s}: launched anyway: NaN in exactly the {int(over.sum())} of "
          f"{over.numel()} super-groups over budget, elsewhere max |kernel - plain| = {err:.3e}")
    return err


def check_x2(gen, n, device) -> float:
    """X2 against its plain version and against B2 on the same starts on
    its path, and against plain with each row's entries shuffled (the
    walk); refused off its path, and launched there anyway through
    ``span_compare_sum``, where only the over-budget super-groups get NaN."""
    max_err = 0.0
    for label, w, refusal in _x2_cases(gen, n, device):
        starts = _systematic_starts(gen, w, n)
        a0, _ = exp_resample_dma.rank_a0(starts, n, n // x2.SUB)
        p = torch.randn((n, 1), generator=gen, device=device)
        chunks = fine_chunks(starts, p, n // x2.SUB, x2.ROWS)
        if refusal is not None:
            try:
                x2.span_resample_values(starts, p, a0)
            except ValueError as e:
                _check(refusal in str(e), f"X2 {label}: refused for its {refusal} ({e})")
                print(f"X2 {label:22s}: refused ({e})")
                max_err = max(max_err, _check_x2_budget(label, chunks, a0))
                continue
            raise RuntimeError(f"check failed: X2 {label}: not refused")
        out = x2.span_compare_sum(*chunks, a0)
        ref = x2.span_compare_sum_reference(*chunks, a0)
        vs_b2 = x2.span_resample_values(starts, p, a0) - b2.resample_by_starts(p, starts)
        shuffled = (*_shuffled(gen, *chunks[:2]), chunks[2])
        err_shuf = (x2.span_compare_sum(*shuffled, a0)
                    - x2.span_compare_sum_reference(*shuffled, a0)).abs().max().item()
        err, err_b2 = (out - ref).abs().max().item(), vs_b2.abs().max().item()
        max_err = max(max_err, err, err_shuf)
        _check(err <= PROBE_TOL, f"X2 {label}: max |kernel - plain| {err} <= {PROBE_TOL}")
        _check(err_b2 <= PROBE_TOL, f"X2 {label}: max |X2 - B2| {err_b2} <= {PROBE_TOL}")
        _check(err_shuf <= PROBE_TOL,
               f"X2 {label}, rows shuffled: max |kernel - plain| {err_shuf} <= {PROBE_TOL}")
        print(f"X2 {label:22s}: spanD {int(x2.span_rows(a0))}, max |kernel - plain| = "
              f"{err:.3e}, max |X2 - B2| = {err_b2:.3e}, rows shuffled: max |kernel - plain| = "
              f"{err_shuf:.3e} (N={n})")
    return max_err


# --- the main path and the general path -----------------------------------
def _check_history(hist, sv, label: str):
    for k, v in hist.items():
        _check(bool(torch.isfinite(v.float()).all()), f"{label}: finite history[{k}]")
    rmse = torch.sqrt(torch.mean((hist["mean"][:, 0] - sv.X) ** 2)).item()
    frac = hist["resampled"].float().mean().item()
    _check(rmse < 1.5, f"{label}: sv_rmse {rmse} < 1.5")
    _check(0.02 <= frac <= 0.3, f"{label}: resample_frac {frac} in [0.02, 0.3]")
    return rmse, frac


def run_main_path(n, device):
    """The main path (FusedSIRFilter) and the general path (ParticleFilter)
    on one SV data set, each checked; returns the main path's launch counts
    and the fused filter, generator, state and data for the timing phase."""
    sv = simulate_sv_1d(T, ALPHA, SIGMA, BETA, seed=42, device=device)
    zs = sv.Y[:, None]
    var0 = SIGMA**2 / (1 - ALPHA**2)
    model = SVModel(ALPHA, BETA)
    f = FusedSIRFilter(model, [[SIGMA**2]], Np=n, resample_thresh=0.5, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state0 = f.initialize(gen, [0.0], [[var0]])
    # The first run of a shape captures it (its eager warm-up steps count
    # their launches too); the counted run below is one replay.
    f.run(torch.Generator(device=device).manual_seed(99), state0, zs)
    fused_step.launches = 0
    b2.resample_by_starts.launches = 0
    ks.systematic_starts.launches = 0
    ks.systematic_starts.log_rows = 0
    graphs = (FusedSIRFilter.graph_captures, FusedSIRFilter.graph_replays + 1)
    _, hist = f.run(gen, state0, zs)
    counts = {"B1": fused_step.launches, "B2": b2.resample_by_starts.launches,
              "S": ks.systematic_starts.launches, "S log rows": ks.systematic_starts.log_rows}
    rmse, frac = _check_history(hist, sv, "fused")
    n_res = int(hist["resampled"].sum())
    print(f"fused SV run N={n} T={T}: sv_rmse {rmse:.4f}, resample_frac {frac:.3f}, "
          f"launches {counts}")
    if device.type == "cuda":
        # One replay of the captured run: every step launches B1, S and B2,
        # the last two gated by the step's trigger (no-ops where it is 0).
        _check(counts["B1"] == T, f"B1 launched {counts['B1']} times, want {T}")
        _check(counts["B2"] == T and n_res > 0,
               f"B2 launched {counts['B2']} times, want {T} (gated), with {n_res} > 0 resamples")
        want = ks.plan(1, n).passes * T
        _check(counts["S"] == want, f"S launched {counts['S']} times, want {want}")
        # Every step's starts take the step's log Z into kernel S's log domain.
        _check(counts["S log rows"] == counts["B2"],
               f"S read {counts['S log rows']} rows as log-weights, want B2's {counts['B2']}")
        got = (FusedSIRFilter.graph_captures, FusedSIRFilter.graph_replays)
        _check(got == graphs, f"graph captures and replays {got}, want {graphs}")

    pf = ParticleFilter(
        lambda x, u: model.g(x), None, Q=[[SIGMA**2]], R=None, Np=n,
        resample_thresh=0.5, obs_loglik=model.obs_loglik, device=device,
    )
    gen_g = torch.Generator(device=device).manual_seed(1)
    st = pf.initialize(gen_g, [0.0], [[var0]])
    b2.resample_by_starts.launches = 0
    _, hist_g = pf.run(gen_g, st, zs)
    rmse_g, frac_g = _check_history(hist_g, sv, "general")
    n_res_g = int(hist_g["resampled"].sum())
    if device.type == "cuda":
        _check(b2.resample_by_starts.launches == n_res_g > 0,
               f"general path: B2 launched {b2.resample_by_starts.launches}, want {n_res_g}")
    ll_f = hist["log_evidence"].sum().item()
    ll_g = hist_g["log_evidence"].sum().item()
    _check(abs(ll_g - ll_f) <= 0.03 * abs(ll_f) + 3.0,
           f"log evidence general {ll_g} vs fused {ll_f}")
    print(f"general SV run N={n} T={T}: sv_rmse {rmse_g:.4f}, resample_frac {frac_g:.3f}, "
          f"B2 launches {b2.resample_by_starts.launches}; log evidence {ll_g:.3f} "
          f"(fused {ll_f:.3f})")
    return counts, (f, gen, state0, zs)


def check_card_run(n, device):
    """The main path's run decided on the card against the host's loop, at
    N = ``n``, T = 200 on the main path's data, from one seed: the graph
    replay (``run``) and the same steps launched eagerly (``_CardRun.steps``:
    B1's ``DECIDE`` form, S and B2 gated) each give ``_host_run``'s history
    and final state bit for bit (both draw a run's seeds and uniforms
    alike)."""
    sv = simulate_sv_1d(T, ALPHA, SIGMA, BETA, seed=42, device=device)
    zs = sv.Y[:, None]
    f = FusedSIRFilter(SVModel(ALPHA, BETA), [[SIGMA**2]], Np=n, resample_thresh=0.5,
                       device=device)
    state0 = f.initialize(torch.Generator(device=device).manual_seed(6), [0.0],
                          [[SIGMA**2 / (1 - ALPHA**2)]])

    def gen():
        return torch.Generator(device=device).manual_seed(CARD_RUN_SEED)

    (p_h, lw_h, off_h), hist_h = f._host_run(gen(), state0, zs)
    (p_r, lw_r, off_r), hist_r = f.run(gen(), state0, zs)
    card = f._card_runs[(T, 1)]
    card.load(gen(), state0, zs)
    card.steps()
    (p_e, lw_e, off_e), rows_e, trig_e = card.outputs()
    hist_e = f._hist_dict(rows_e, trig_e)
    n_res = int(hist_h["resampled"].sum())
    _check(0 < n_res < T, f"card run: {n_res} resample steps of {T}, want both kinds")
    for label, (p, lw, off), hist in (("replay", (p_r, lw_r, off_r), hist_r),
                                      ("eager steps", (p_e.view(n), lw_e, off_e), hist_e)):
        for k in ("resampled", "log_evidence", "ess", "mean", "cov"):
            _check(torch.equal(hist[k], hist_h[k]),
                   f"card run ({label}): history[{k}] == the host's loop's, bit for bit")
        for name, a, b in (("particles", p, p_h), ("log-weights", lw, lw_h),
                           ("off_u", off, off_h)):
            _check(torch.equal(a, b), f"card run ({label}): final {name} == the host's loop's")
    print(f"card run N={n} T={T}: the graph replay and the eager decided steps equal the "
          f"host's loop bit for bit (history and final state; {n_res} resample steps)")


def check_gates(gen, device):
    """Kernels S and B2 gated by a trigger on the card, at 2^20 and 2^24:
    a 0 trigger leaves ``out=`` as it was, a 1 trigger gives the ungated
    call's result bit for bit."""
    for n in (N, 1 << 24):
        logw = 2.0 * torch.randn((1, n), generator=gen, device=device)
        log_z = torch.logsumexp(logw, 1)
        u = torch.rand(1, generator=gen, device=device)
        p = torch.randn((n, 1), generator=gen, device=device)
        starts = ks.systematic_starts(logw, u, log_z=log_z)
        values = b2.resample_by_starts(p, starts)
        for open_ in (0, 1):
            trig = torch.full((1,), open_, dtype=torch.int32, device=device)
            s_out = torch.full((n,), -7, dtype=torch.int32, device=device)
            v_out = torch.full((n, 1), 9.0, device=device)
            ks.systematic_starts(logw, u, log_z=log_z, trigger=trig, out=s_out)
            b2.resample_by_starts(p, starts, trigger=trig, out=v_out)
            torch.cuda.synchronize()
            s_want = starts if open_ else torch.full_like(s_out, -7)
            v_want = values if open_ else torch.full_like(v_out, 9.0)
            _check(torch.equal(s_out, s_want), f"gated S at {n}, trigger {open_}")
            _check(torch.equal(v_out, v_want), f"gated B2 at {n}, trigger {open_}")
        print(f"gated S and B2 N={n}: trigger 0 leaves out= as it was, trigger 1 equals the "
              f"ungated call bit for bit")


def run_entry_path(device, card):
    """``entry.entry()`` (one fused step at N = 2^20: B1 launched once, B2
    as often as the step resampled, counted just before and after the
    step), its posterior mean within ``ENTRY_SE`` combined standard errors
    of ``entry_generic()``'s on the card, the step's median CUDA-event time
    over ``ENTRY_REPS`` calls after a warm-up; then ``dryrun_multichip``
    over the visible cards (one NCCL rank a card), with B1 and B2 launched
    in its fused phase. Returns the launches by part."""
    step_fn, args = entry.entry(device)
    fused_step.launches = 0
    b2.resample_by_starts.launches = 0
    (x, lw, _), info = step_fn(*args)
    counts = {"B1": fused_step.launches, "B2": b2.resample_by_starts.launches}
    ess = float(info["ess"])
    _check(counts == {"B1": 1, "B2": int(bool(info["resampled"]))},
           f"entry(): launches {counts}, resampled {bool(info['resampled'])}")
    _check(bool(torch.isfinite(x).all() and torch.isfinite(lw).all())
           and all(bool(torch.isfinite(v.float()).all()) for v in info.values()),
           "entry(): finite state and row")
    _check(0 < ess <= entry.N_ENTRY, f"entry(): 0 < ESS {ess} <= {entry.N_ENTRY}")
    m_f, se_f = float(info["mean"][0]), math.sqrt(float(info["cov"][0, 0]) / ess)
    gen_fn, gen_args = entry.entry_generic(device)
    st = gen_fn(*gen_args)
    ess_g = float(1 / torch.sum(torch.exp(2 * st.log_weights.double())))
    m_g, se_g = float(st.mean[0]), math.sqrt(float(st.cov[0, 0]) / ess_g)
    _check(abs(m_f - m_g) <= ENTRY_SE * math.hypot(se_f, se_g),
           f"entry() mean {m_f} within {ENTRY_SE} SE of entry_generic()'s {m_g}")
    times = []
    for i in range(ENTRY_REPS + 1):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        step_fn(*args)
        t1.record()
        torch.cuda.synchronize()
        if i:  # the first call is the warm-up
            times.append(t0.elapsed_time(t1))
    print(f"entry(): fused step N={entry.N_ENTRY}, B1 x{counts['B1']}, B2 x{counts['B2']}, "
          f"ESS {ess:.1f}, mean {m_f:.6f} ± {se_f:.6f} (entry_generic N={entry.N_GENERIC}: "
          f"{m_g:.6f} ± {se_g:.6f}); {statistics.median(times):.4f} ms a step (median of "
          f"{ENTRY_REPS}, CUDA events)  [{card}]")
    t0 = time.perf_counter()
    r = entry.dryrun_multichip(torch.cuda.device_count(), device)
    dry = r["launches"]
    _check(dry["B1"] > 0 and dry["B2"] > 0, f"dry run's fused phase: B1 and B2 launched, {dry}")
    print(f"dryrun_multichip({torch.cuda.device_count()}): {time.perf_counter() - t0:.1f} s with "
          f"the rank's start; fused phase launches {dry}  [{card}]")
    return {"entry": counts, "dryrun": dry}


def check_step_launches(n, device):
    """Runs that never resample: the captured run launches B1 once a step,
    and S's passes and B2 once a step gated shut by B1's trigger, and no
    other kernel of its own a step: the other kernels (the run's inputs,
    outputs and history) do not grow by one a step from T = 20 to T = 40."""
    sv = simulate_sv_1d(40, ALPHA, SIGMA, BETA, seed=7, device=device)
    f = FusedSIRFilter(SVModel(ALPHA, BETA), [[SIGMA**2]], Np=n, resample_thresh=0.0,
                       device=device)
    gen = torch.Generator(device=device).manual_seed(5)
    state0 = f.initialize(gen, [0.0], [[SIGMA**2 / (1 - ALPHA**2)]])
    for t_len in (20, 40):  # each length's capture
        f.run(gen, state0, sv.Y[:t_len, None])
    counts, gated_a_step = {}, ks.plan(1, n).passes + 1
    for t_len in (20, 40):
        ops = profile_device(lambda: f.run(gen, state0, sv.Y[:t_len, None]), top=None).top
        kernels = [(k, c) for _, c, k in ops if not k.startswith(("Memcpy", "Memset"))]
        if not kernels:
            print("step launches: not measured (profiler saw no device time)")
            return
        step_kernels = ("_fused_step_kernel", "systematic_starts", "merge_path_resample_kernel")
        b1 = sum(c for k, c in kernels if "_fused_step_kernel" in k)
        gated = sum(c for k, c in kernels if any(s in k for s in step_kernels[1:]))
        others = [(k[:60], c) for k, c in kernels if not any(s in k for s in step_kernels)]
        counts[t_len] = sum(c for _, c in others)
        _check(b1 == t_len, f"B1 launched {b1} times in {t_len} steps")
        _check(gated == gated_a_step * t_len,
               f"S and B2 launched {gated} times in {t_len} steps, want {gated_a_step} a step")
        print(f"no-resample run N={n} T={t_len}: B1 x{b1}, S and B2 (gated shut) x{gated}, "
              f"other kernels {others}")
    _check(counts[40] - counts[20] < 20,
           f"kernels other than B1, S and B2: {counts[20]} over 20 steps, {counts[40]} over 40")
    print(f"no-resample runs N={n}: B1 once a step, S and B2 gated shut, other kernels "
          f"{counts[20]} and {counts[40]} a run over T=20 and T=40 (none per step)")


# --- the exact path -----------------------------------------------------------
def check_exact(gen, device) -> None:
    """The run ends past 2^24 (the exact integer path) on the card equal the
    same call on the CPU bit for bit, at N = 2^25."""
    n = EXACT_N
    cases = (("lognormal sigma=2", torch.softmax(2.0 * torch.randn(n, generator=gen,
                                                                    device=device), 0)),
             ("point mass at N/3", _point_masses(n, device, n // 3)))
    for label, w in cases:
        u = torch.rand((), generator=gen, device=device)
        t_card = _child_run_ends_u(w, n, u)
        t_cpu = _child_run_ends_u(w.cpu(), n, u.cpu())
        _check(torch.equal(t_card.cpu(), t_cpu), f"exact run ends card == CPU ({label}, N={n})")
        _check(int(t_card[-1]) == n and bool((t_card[1:] >= t_card[:-1]).all()),
               f"exact run ends end at N and never descend ({label})")
        print(f"exact run ends N={n} {label}: card equal to CPU bit for bit")


def time_run_ends(gen, device, card) -> None:
    """The exact run ends at 2^25 beside the f32 ones at 2^24 (and the exact
    ones forced at 2^24), eager, CUDA events."""
    for label, n, exact in (("exact", EXACT_N, None), ("f32", 1 << 24, None),
                            ("exact forced", 1 << 24, True)):
        w = torch.softmax(2.0 * torch.randn(n, generator=gen, device=device), 0)
        u = torch.rand((), generator=gen, device=device)
        ms = _time_ms(lambda: _child_run_ends_u(w, n, u, exact=exact), reps=3)
        print(f"run ends, {label} path, N={n}: {ms:.4f} ms  [{card}]")


def run_exact_path(device, card):
    """FusedSIRFilter on the SV model at N = 2^25, T = 50: B1 every step, B2
    on exact starts at every resample step; B1 and B2 set to 0 just before
    and read just after."""
    sv = simulate_sv_1d(EXACT_T, ALPHA, SIGMA, BETA, seed=43, device=device)
    f = FusedSIRFilter(SVModel(ALPHA, BETA), [[SIGMA**2]], Np=EXACT_N, resample_thresh=0.5,
                       device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    state0 = f.initialize(gen, [0.0], [[SIGMA**2 / (1 - ALPHA**2)]])
    torch.cuda.synchronize()
    fused_step.launches = 0
    b2.resample_by_starts.launches = 0
    t0 = time.perf_counter()
    _, hist = f.run(gen, state0, sv.Y[:, None])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = {"B1": fused_step.launches, "B2": b2.resample_by_starts.launches}
    for k, v in hist.items():
        _check(bool(torch.isfinite(v.float()).all()), f"exact path: finite history[{k}]")
    rmse = torch.sqrt(torch.mean((hist["mean"][:, 0] - sv.X) ** 2)).item()
    n_res = int(hist["resampled"].sum())
    _check(rmse < 1.5, f"exact path: sv_rmse {rmse} < 1.5")
    _check(n_res >= 1, "exact path: at least one resample step")
    _check(counts["B1"] == EXACT_T, f"exact path: B1 launched {counts['B1']}, want {EXACT_T}")
    _check(counts["B2"] == n_res, f"exact path: B2 launched {counts['B2']}, want {n_res}")
    print(f"exact path: fused SV run N={EXACT_N} T={EXACT_T}: sv_rmse {rmse:.4f}, "
          f"{n_res} resample steps, launches {counts}, {wall_ms / EXACT_T:.4f} ms/step "
          f"(eager wall)  [{card}]")
    return counts


# --- the SNLG path -------------------------------------------------------------
def run_snlg_path(device, card):
    """The SNLG column at full width, checked against the JAX package's
    MSEs. B2's count is set to 0 just before each flow's timed run and read
    just after (``snlg.run_flow``); the path's count is their sum."""
    res = snlg.run_column(device, profile=("edh10000", "ledh200"))
    launches = sum(res[tag]["b2_launches"] for tag, _, _ in snlg.FLOWS)
    snlg.print_column(res, card)
    _gates("SNLG", snlg.gates(res))
    for tag, _, _ in snlg.FLOWS:
        r = res[tag]
        _check(r["b2_launches"] == r["resample_steps"] > 0,
               f"SNLG {tag}: B2 launched {r['b2_launches']} times, once a step with a "
               f"resample ({r['resample_steps']})")
    _operator_applies("SNLG ledh200", res["ledh200"], snlg.N_LAMBDA, snlg.T)
    print(f"SNLG path: B2 launched {launches} times in the flows' timed runs")
    return {"B2": launches}


# --- the skew-t, MAT and KPF paths --------------------------------------------
def _flow_launches(label, r):
    """B2 launched once a step with a resample, on a path that resampled."""
    _check(r["b2_launches"] == r["resample_steps"] > 0,
           f"{label}: B2 launched {r['b2_launches']} times, once a step with a resample "
           f"({r['resample_steps']})")


def _operator_applies(label, r, lambda_steps, steps):
    """LEDH applies its flow operator Aⁱ twice a λ-step of every step."""
    want = 2 * lambda_steps * steps
    _check(r["operator_applies"] == want,
           f"{label}: the flow operator applied {r['operator_applies']} times, twice a "
           f"λ-step ({want})")


def run_skewt_path(device, card):
    """The skew-t column at full width (d = 144, T = 10, 100 trials), checked
    against the JAX package on the same data; B2's count is set to 0 just
    before each flow's timed run and read just after (``snlg.run_flow``)."""
    res = skewt.run_column(device, profile=("edh10000", "ledh200"))
    skewt.print_column(res, card)
    _gates("skew-t", skewt.gates(res))
    for tag, _, _ in skewt.FLOWS:
        _flow_launches(f"skew-t {tag}", res[tag])
    _operator_applies("skew-t ledh200", res["ledh200"], skewt.N_LAMBDA, skewt.T)
    launches = sum(res[tag]["b2_launches"] for tag, _, _ in skewt.FLOWS)
    print(f"skew-t path: B2 launched {launches} times in the flows' timed runs; LEDH-200 "
          f"peak {res['ledh200']['peak_mib']:.0f} MiB allocated (all 100 trials in one "
          f"run_trials call)  [{card}]")
    return {"B2": launches}


def run_mat_path(device, card):
    """The MAT column at full width (4 targets, T = 40, N = 500, 16 seeds a
    flow), checked against the JAX package on the same data. B2's count is
    set to 0 just before each flow's timed run and read just after."""
    res = mat.run_column(device)
    mat.print_column(res, card)
    _gates("MAT", mat.gates(res))
    _flow_launches("MAT edh", res["edh"])
    _check(res["ledh"]["b2_launches"] == res["ledh"]["resampled"] == 0,
           "MAT ledh: never resamples, B2 never launched")
    launches = sum(res[tag]["b2_launches"] for tag in mat.FLOWS)
    print(f"MAT path: B2 launched {launches} times  [{card}]")
    check_mat_flow_ranks(res, device)
    return {"B2": launches}


def check_mat_flow_ranks(res, device):
    """A second witness of the flows' OMATs besides the quartile gate: EDH
    on a second set of 16 seeds, and each flow's OMATs against the JAX
    package's 16 by a two-sided rank test (all 32 of EDH's)."""
    second, _, _ = mat.flow_omats("edh", torch.Generator(device=device).manual_seed(1),
                                  mat.load_data(device))
    print(f"MAT edh, second 16 seeds: median OMAT {statistics.median(second):.4f}, quartiles "
          f"{' - '.join(f'{q:.4f}' for q in statistics.quantiles(second, n=4)[::2])}")
    for tag, omats in (("edh", res["edh"]["omats"] + second), ("ledh", res["ledh"]["omats"])):
        print(f"MAT {tag} OMAT by seed: {[round(o, 6) for o in omats]}")
        u, p = mat.rank_test(omats, mat.JAX_FLOW_OMATS[tag])
        print(f"MAT {tag}: {len(omats)} OMATs against the JAX package's 16, rank test U {u}, "
              f"two-sided p {p:.4f}")
        _check(p >= MAT_RANK_P, f"MAT {tag}: rank test p {p} >= {MAT_RANK_P}")


def run_kpf_path(device, card):
    """The kernel PF on Lorenz-96 at nx = 1000, Np = 20 against the JAX
    package's committed posteriors: the same pseudo-steps, s = 1 and a
    finite posterior as a user runs it; with the factor's jitter pinned at
    the JAX package's rung, the same pseudo-steps and a posterior within
    ``kpf.tolerance``; the localized analysis beating the forecast."""
    res = kpf.run_cases(device)
    kpf.print_cases(res, card)
    for name, r in res.items():
        p = r["pinned"]
        for tag, q in (("", r), (" pinned", p)):
            _check(q["steps"] == r["jax_steps"],
                   f"KPF {name}{tag}: {q['steps']} pseudo-steps, the JAX package's "
                   f"{r['jax_steps']}")
            _check(q["s"] == 1.0, f"KPF {name}{tag}: pseudo-time {q['s']} reached 1")
        _check(bool(torch.isfinite(r["posterior"]).all()), f"KPF {name}: finite posterior")
        kind, bound = kpf.tolerance(name)
        got = p["rms"] if kind == "rms" else p["max_abs"]
        _check(got <= bound, f"KPF {name} at the JAX package's jitter "
               f"{kpf.JAX_RUNG[name]:g}: posterior {kind} {got} <= {bound}")
    loc = res["localized"]
    _check(loc["rmse_analysis"] < loc["rmse_forecast"],
           f"KPF localized: analysis RMSE {loc['rmse_analysis']} below the forecast's "
           f"{loc['rmse_forecast']}")


def check_simulators(device, card):
    """The port's skew-t, MAT and Lorenz-96 simulators on the card (their
    gamma, Poisson and normal draws take the card's generator): the skew-t
    column's config against the JAX package's committed data by its
    moments, MAT's article start, walls and noiseless amplitudes, and
    Lorenz-96 at nx = 1000 finite with its √2 ensemble perturbation."""
    from particle_filters_tpu_torch.simulators import acoustic_tracking as at
    from particle_filters_tpu_torch.simulators import lorenz96 as l96
    from particle_filters_tpu_torch.simulators import sensor_network_skewt as sk

    X, Z, _, _ = skewt.load_data(device)
    r = sk.simulate_skewt_many(sk.SkewTGridConfig(d=skewt.D, alpha0=1.0, alpha1=1e-3, beta=8.0),
                               sk.SkewTDynConfig(alpha=skewt.AL, nu=8.0, gamma_scale=0.1,
                                                 seed=42),
                               sk.SkewTMeasConfig(m1=skewt.M1, m2=skewt.M2),
                               sk.SkewTSimConfig(T=skewt.T, n_trials=skewt.TRIALS),
                               device=device)
    var_ratio = (r.X.var() / X.var()).item()
    z_ratio = (r.Z.float().mean() / Z.mean()).item()
    _check(bool(torch.isfinite(r.X).all()) and r.Z.dtype == torch.int32
           and int(r.Z.min()) >= 0, "skew-t simulator: finite X, int32 counts >= 0")
    _check(0.85 <= var_ratio <= 1.15 and 0.85 <= z_ratio <= 1.15,
           f"skew-t simulator: var(X) {var_ratio:.3f} and mean(Z) {z_ratio:.3f} of the JAX "
           f"package's data, within 15 %")
    torch.testing.assert_close(r.Lambda, torch.exp(torch.clamp(r.X, -10, 10) / 3.0))
    ds = at.simulate_acoustic_dataset(at.MATScenarioConfig(n_steps=mat.T, seed=7),
                                      at.MATDynamicsConfig(), device=device)
    _check(torch.equal(ds.X[0], at.article_initial_states(4, device))
           and bool(((ds.P >= 0) & (ds.P <= 40)).all()),
           "MAT simulator: the article's start, every position inside the walls")
    torch.testing.assert_close(ds.Z, at.acoustic_measurement_model(ds.P, ds.S, 10.0, 0.1))
    lr = l96.simulate_lorenz96(nx=1000, Np=20, seed=42, device=device)
    spread = (lr.ensemble_traj[:, 0] - lr.truth_traj[0]).std().item()
    _check(bool(torch.isfinite(lr.ensemble_traj).all()) and abs(spread - 2**0.5) < 0.05,
           f"Lorenz-96 simulator: finite, ensemble perturbation std {spread:.4f} ~ sqrt(2)")
    print(f"simulators on the card: skew-t var(X) {var_ratio:.4f} and mean(Z) {z_ratio:.4f} "
          f"of the JAX package's data; MAT inside the walls; Lorenz-96 nx=1000 perturbation "
          f"std {spread:.4f}  [{card}]")


def check_determinism(n, device):
    """Two FusedSIRFilter runs and two ParticleFilter runs (the latter with
    the degeneracy panel) from one seed, N = ``n``, T = 200: bit-equal
    histories."""
    sv = simulate_sv_1d(T, ALPHA, SIGMA, BETA, seed=42, device=device)
    zs, var0 = sv.Y[:, None], SIGMA**2 / (1 - ALPHA**2)
    model = SVModel(ALPHA, BETA)
    makers = {
        "FusedSIRFilter": (lambda: FusedSIRFilter(model, [[SIGMA**2]], Np=n, device=device), {}),
        "ParticleFilter": (lambda: ParticleFilter(
            lambda x, u: model.g(x), None, Q=[[SIGMA**2]], R=None, Np=n,
            obs_loglik=model.obs_loglik, device=device), {"track_degeneracy": True}),
    }
    for label, (make, kw) in makers.items():
        hists = []
        for _ in range(2):
            gen = torch.Generator(device=device).manual_seed(DET_SEED)
            filt = make()
            _, hist = filt.run(gen, filt.initialize(gen, [0.0], [[var0]]), zs, **kw)
            hists.append(hist)
        a, b = hists
        _check(set(a) == set(b), f"determinism {label}: the same history keys")
        for k in a:
            _check(torch.equal(a[k], b[k]), f"determinism {label}: history[{k}] bit-equal")
        print(f"determinism N={n} T={T} {label}: two runs from seed {DET_SEED} bit-equal in "
              f"{sorted(a)} ({int(a['resampled'].sum())} resample steps)")


# --- the profiling path ------------------------------------------------------
def run_profiling_path(device, card):
    """The small-N decomposition, X1's variants and X2 against B2, with the
    probes' launch counts set to 0 just before and read just after."""
    probes = {"X1": x1.window_compare_sum, "X2": x2.span_compare_sum, "X3": x3.add_one}
    for wrapper in probes.values():
        wrapper.launches = 0
    m_lo, m_hi, reps = SMALL_N_SLOPE
    print(f"small-N step decomposition, slope m {m_lo} -> {m_hi}, best of {reps}  [{card}]")
    for k in (14, 16, 20):
        profile_small_n.profile_n(1 << k, device, m_lo, m_hi, reps)
    exp_kernel_var.run_all(device)
    exp_resample_dma.run_all(device)
    counts = {name: wrapper.launches for name, wrapper in probes.items()}
    print(f"profiling path launches {counts}  [{card}]")
    for name, count in counts.items():
        _check(count > 0, f"{name} launched on the profiling path ({count} times)")
    return counts


# --- timings -----------------------------------------------------------------
def _graph_ms(fn, reps: int = 16, samples: int = 5) -> float:
    """Device time per call without host overhead: ``reps`` calls captured
    in one CUDA graph, replayed; median over ``samples`` of event time / reps."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return _time_ms(graph.replay, reps=1, samples=samples) / reps


def _bound(nbytes: int, ops: float):
    """The least time the card could take (ms, ``h100_bench/roofline.py``)
    and what sets it: each input byte read once and each output byte
    written once, or the operations at the fp32 peak, whichever is longer."""
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / FP32_OPS_PER_S else "operations"
    return least_s(nbytes, ops) * 1e3, by


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _rotating(fn, sets):
    """``fn`` called on ``sets`` in turn: eight input sets keep a launch's
    inputs out of the 50 MB L2 where they are large."""
    it = iter(range(10**9))
    return lambda: fn(*sets[next(it) % len(sets)])


def _b1_timed(gen, n, device, programs=None, eps=None, shard=(0, 1)):
    """B1 at ``n`` (as rank ``shard[0]`` of ``shard[1]`` of a cloud of
    ``shard[1]·n``: its plain version then draws the whole cloud's normals
    and keeps its own, as the plain version of the sharded step does)."""
    model = SVModel(ALPHA, BETA)
    f, *_ = _b1_inputs(gen, model, [[SIGMA**2]], n, device, False)
    sets = [_b1_inputs(gen, model, [[SIGMA**2]], n, device, False)[1:] for _ in range(8)]
    work = StepWork(1, device, programs=programs)
    rank, ranks = shard

    def kern(x, lw, off_u, z):
        return fused_step(x, lw, off_u, z, f.Lq, f.params, model, seed=7, eps=eps,
                          work=work, shard=shard)

    def plain(x, lw, off_u, z):  # the plain step draws its normals too
        eps = torch.randn((1, ranks * n), device=device)[:, rank * n:(rank + 1) * n]
        return fused_step_reference(x, lw, off_u, z, eps, f.Lq, model, ranks * n)

    out = kern(*sets[0])
    nbytes = _nbytes(*sets[0], f.Lq, f.params, *out)
    # Philox and Box-Muller, the model, the weight and the partials: about
    # 128 operations a particle, counted generously; bytes bound it anyway.
    return kern, plain, None, sets, _bound(nbytes, 128 * n)


def time_b1_variants(gen, n, device, card) -> None:
    """B1's device time over its programs per SM (the persistent grid), and
    with injected normals (``READ_EPS``: the same pass without Philox and
    Box-Muller, reading 4 B more a particle), in turns."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    eps = torch.randn((1, n), generator=gen, device=device)
    variants = [(f"{k} programs/SM", k * sms, None) for k in (1, 2, 3, 4)]
    variants.append((f"READ_EPS, {PROGRAMS_PER_SM} programs/SM", PROGRAMS_PER_SM * sms, eps))
    fns = {}
    for label, programs, e in variants:
        kern, _, _, sets, bound = _b1_timed(gen, n, device, programs, e)
        fns[label] = _rotating(kern, sets)
    times = {label: [] for label in fns}
    for label in list(fns) + list(fns)[::-1]:
        times[label].append(_graph_ms(fns[label]))
    for label, ts in times.items():
        ms = sum(ts) / len(ts)
        print(f"B1 at N={n}, {label}: device {ms:.6f} ms ({bound[0] / ms:.3f} of the "
              f"{bound[0]:.6f} ms drawn-normals bound)  [{card}]")


def _b2_timed(gen, n, device, w=None):
    if w is None:
        w = torch.softmax(2.0 * torch.randn(n, generator=gen, device=device), 0)
    sets = []
    for _ in range(8):
        starts = _systematic_starts(gen, w, n)
        p = torch.randn((n, 1), generator=gen, device=device)
        counts = torch.diff(starts, append=starts.new_full((1,), n)).long()  # untimed
        sets.append((p, starts, counts))

    def library(p, starts, counts):
        return torch.repeat_interleave(p, counts, dim=0, output_size=n)

    p, starts, counts = sets[0]
    _check(torch.equal(library(*sets[0]), b2.resample_by_starts(p, starts)),
           "repeat_interleave == B2 (the library call computes B2's function)")
    nbytes = _nbytes(p, starts, p)  # p and starts in, the values out
    ops = 2 * (2 * n)  # a compare and a select per merge item (N starts, N outputs)
    return (lambda p, s, c: b2.resample_by_starts(p, s),
            lambda p, s, c: b2.resample_by_starts_reference(p, s), library, sets,
            _bound(nbytes, ops))


def time_b2_balance(gen, n, device, card) -> None:
    """B2's device time at a point mass beside lognormal sigma = 2, in turns:
    a load-balanced kernel takes about the same at both."""
    fns = {}
    for label, w in (("sigma=2", None), ("point mass at N/3", _point_masses(n, device, n // 3))):
        kern, _, library, sets, _ = _b2_timed(gen, n, device, w)
        fns[label] = (_rotating(kern, sets), _rotating(library, sets))
    times = {label: ([], []) for label in fns}
    for label in list(fns) + list(fns)[::-1]:
        times[label][0].append(_graph_ms(fns[label][0]))
        times[label][1].append(_graph_ms(fns[label][1]))
    ms = {label: sum(k) / len(k) for label, (k, _) in times.items()}
    for label, (k, lib) in times.items():
        print(f"B2 at N={n}, {label}: device {sum(k) / len(k):.6f} ms, repeat_interleave "
              f"{sum(lib) / len(lib):.6f} ms  [{card}]")
    ratio = ms["point mass at N/3"] / ms["sigma=2"]
    print(f"B2 point mass / sigma=2: {ratio:.3f}  [{card}]")


def time_b2_trials(gen, device, card):
    """B2 at the flows' shapes with trial-offset starts: device time, plain,
    ``repeat_interleave`` and the byte bound, in turns."""
    out = {}
    for trials, n, d in B2_TRIAL_SHAPES + (B2_SIR_SHAPE,):
        rows = trials * n
        sets = []
        for _ in range(4):
            starts = batched_starts(_trial_weights(gen, trials, n, device),
                                    torch.rand(trials, generator=gen, device=device))
            p = torch.randn((rows, d), generator=gen, device=device)
            counts = torch.diff(starts, append=starts.new_full((1,), rows)).long()
            sets.append((p, starts, counts))
        kern = _rotating(lambda p, s, c: b2.resample_by_starts(p, s), sets)
        plain = _rotating(lambda p, s, c: b2.resample_by_starts_reference(p, s), sets)
        lib = _rotating(lambda p, s, c: torch.repeat_interleave(p, c, dim=0, output_size=rows),
                        sets)
        t = [_graph_ms(f) for f in (kern, plain, lib, lib, plain, kern)]
        ms, plain_ms, lib_ms = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, (t[2] + t[3]) / 2
        p, starts, _ = sets[0]
        bound = _bound(_nbytes(p, starts, p), 2 * (2 * rows))
        out[(rows, d)] = (ms, plain_ms, lib_ms, bound)
        print(f"B2 at the flows' shape {trials} x {n} = {rows} rows, d={d}: device "
              f"{ms:.6f} ms, plain {plain_ms:.6f} ms, repeat_interleave {lib_ms:.6f} ms; bound "
              f"{bound[0]:.6f} ms ({bound[1]}) -> {bound[0] / ms:.3f} of it  [{card}]")
    return out


def time_starts(gen, device, card):
    """Kernel S (starts form) against the plain chain and its byte bound (a
    weight read and a start written a row) at ``S_TIMED``, by CUDA-graph
    replay in turns (kernel, plain, plain, kernel) over rotating inputs.
    Returns ``{(rows, n): (ms, plain_ms, bound)}``."""
    out = {}
    for rows, n in S_TIMED:
        sets = [(torch.softmax(2.0 * torch.randn((rows, n), generator=gen, device=device), 1),
                 torch.rand(rows, generator=gen, device=device))
                for _ in range(2 if n >= 1 << 24 else 4)]
        kern, plain = _rotating(ks.systematic_starts, sets), _rotating(ks.starts_reference, sets)
        t = [_graph_ms(f) for f in (kern, plain, plain, kern)]
        ms, plain_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        w, u = sets[0]
        bound = _bound(_nbytes(w, u, w), 0)  # weights and u in, int32 starts out
        out[(rows, n)] = (ms, plain_ms, bound)
        print(f"S at {rows} x {n}: device {ms:.6f} ms, plain chain {plain_ms:.6f} ms "
              f"({plain_ms / ms:.1f}x); bound {bound[0]:.6f} ms ({bound[1]}) -> "
              f"{bound[0] / ms:.3f} of it  [{card}]")
    return out


def _search_ops(n, w) -> int:
    """The least operations of a windowed compare-sum on sorted windows of
    ``w`` entries: a binary search of ceil(log2 w) compares and 2 more an
    output, and a scan of ``w`` adds a window."""
    return n * (math.ceil(math.log2(w)) + 2) + (n // x1.SUB) * w


def _x1_timed(gen, n, device):
    _, q, sg, _, _ = exp_kernel_var.VARIANTS[0]  # v0, the probe's subject
    sets = [exp_kernel_var.make_inputs(q, sg, n=n, device=device, seed=k) for k in range(8)]
    s_win, d_win = sets[0]
    out_bytes = s_win.shape[0] * sg * x1.SUB * 4
    return (x1.window_compare_sum, x1.window_compare_sum_reference, None, sets,
            _bound(_nbytes(s_win, d_win) + out_bytes, _search_ops(n, q * x1.SUB)))


def _x2_timed(gen, n, device):
    w = torch.softmax(torch.randn(n, generator=gen, device=device), 0)
    sets = []
    for _ in range(8):
        starts = _systematic_starts(gen, w, n)
        a0, _ = exp_resample_dma.rank_a0(starts, n, n // x2.SUB)
        p = torch.randn((n, 1), generator=gen, device=device)
        sets.append((*fine_chunks(starts, p, n // x2.SUB, x2.ROWS), a0))
    return (x2.span_compare_sum, x2.span_compare_sum_reference, None, sets,
            _bound(_nbytes(*sets[0]) + n * 4, _search_ops(n, x2.Q * x2.SUB)))


def time_probe_branches(gen, n, device, card) -> None:
    """X1 (v0) and X2 at N = ``n`` on their sorted windows (the search) and
    on the same windows with each window's entries (X2: each row's)
    shuffled, the same bytes through the walk: device time in turns
    (sorted, shuffled, shuffled, sorted), beside the byte bound."""
    for name, make in (("X1", _x1_timed), ("X2", _x2_timed)):
        kern, _, _, sets, bound = make(gen, n, device)
        shuffled = [(*_shuffled(gen, *s[:2]), *s[2:]) for s in sets]
        fns = {"sorted": _rotating(kern, sets), "shuffled": _rotating(kern, shuffled)}
        times = {label: [] for label in fns}
        for label in ("sorted", "shuffled", "shuffled", "sorted"):
            times[label].append(_graph_ms(fns[label]))
        ms = {label: sum(ts) / len(ts) for label, ts in times.items()}
        print(f"{name} at N={n}: device {ms['sorted']:.6f} ms on sorted windows (search), "
              f"{ms['shuffled']:.6f} ms shuffled (walk): {ms['shuffled'] / ms['sorted']:.2f}x; "
              f"bound {bound[0]:.6f} ms ({bound[1]}) -> {bound[0] / ms['sorted']:.3f} and "
              f"{bound[0] / ms['shuffled']:.3f} of it  [{card}]")


def _x3_timed(gen, n, device):
    x = torch.randn(x3.TILE, generator=gen, device=device)
    return (x3.add_one, x3.add_one_reference, lambda t: torch.add(t, 1), [(x,)],
            _bound(2 * _nbytes(x), x.numel()))


def time_kernels(gen, n, device, card):
    """Each kernel, its plain version and its library call at N = 2^20,
    in turns (kernel, plain, library, library, plain, kernel): device time
    from CUDA-graph replay, and the eager per-call time that includes the
    Python wrapper. Returns ``{name: (ms, plain_ms, library_ms, (bound_ms,
    bound_by))}``."""
    out = {}
    for name, make in (("B1", _b1_timed), ("B2", _b2_timed), ("X1", _x1_timed),
                       ("X2", _x2_timed), ("X3", _x3_timed)):
        kern, plain, library, sets, bound = make(gen, n, device)
        kern, plain = _rotating(kern, sets), _rotating(plain, sets)
        lib = None if library is None else _rotating(library, sets)
        k0, p0 = _graph_ms(kern), _graph_ms(plain)
        l_ms = None if lib is None else (_graph_ms(lib) + _graph_ms(lib)) / 2
        ms, plain_ms = (k0 + _graph_ms(kern)) / 2, (p0 + _graph_ms(plain)) / 2
        eager = [_time_ms(kern), _time_ms(plain), _time_ms(plain), _time_ms(kern)]
        out[name] = (ms, plain_ms, l_ms, bound)
        lib_txt = "none" if l_ms is None else f"{l_ms:.6f} ms"
        print(f"{name} at N={n}: device kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"library call {lib_txt}; bound {bound[0]:.6f} ms ({bound[1]}) -> "
              f"{bound[0] / ms:.3f} of it; eager per call kernel "
              f"{(eager[0] + eager[3]) / 2:.4f} ms, plain {(eager[1] + eager[2]) / 2:.4f} ms"
              f"  [{card}]")
    return out


def time_x3_pairs(gen, card, pairs: int = 7):
    """X3 and ``torch.add(x, 1)`` on its tile, one graph timing of each in
    turn, ``pairs`` times; prints and returns each one's median (ms), with
    the quartiles printed beside it."""
    x = torch.randn(x3.TILE, generator=gen, device="cuda")
    samples = {"X3": [], "torch.add": []}
    for i in range(pairs):
        order = (("X3", x3.add_one), ("torch.add", lambda t: torch.add(t, 1)))
        for label, fn in order if i % 2 == 0 else order[::-1]:
            samples[label].append(_graph_ms(lambda: fn(x)))
    medians = {}
    for label, ts in samples.items():
        q1, med, q3 = statistics.quantiles(ts, n=4)
        medians[label] = statistics.median(ts)
        print(f"{label} on its (8, 128) tile, {pairs} pairs in turn: median "
              f"{medians[label] * 1e3:.4f} us, quartiles {q1 * 1e3:.4f} - {q3 * 1e3:.4f} us"
              f"  [{card}]")
    return medians["X3"], medians["torch.add"]


def time_fused_run(n, card, fused_run) -> float:
    """Wall time of the whole fused run, and what the card spent it on;
    returns its ms/step."""
    filt, gen, state0, zs = fused_run
    run_ms = _time_ms(lambda: filt.run(gen, state0, zs), reps=1)
    print(f"fused SV run N={n} T={T}: {run_ms / T:.4f} ms/step, "
          f"{n * T / (run_ms * 1e-3):.4e} particle-steps/s  [{card}]")
    prof = profile_device(lambda: filt.run(gen, state0, zs), top=None)
    if not prof.top:
        print("fused run device breakdown: not measured (profiler saw no device time)")
        return run_ms / T
    print(f"fused run device busy {prof.busy_ms:.3f} ms of {run_ms:.3f} ms wall "
          f"({prof.busy_ms / run_ms:.3f}; unprofiled wall)  [{card}]")
    ported_ms = 0.0
    for label, kernel in (("B1", "_fused_step_kernel"), ("B2", "merge_path_resample_kernel")):
        hits = [r for r in prof.top if kernel in r[2]]
        ms, count = sum(r[0] for r in hits), sum(r[1] for r in hits)
        ported_ms += ms
        print(f"  {label} {kernel}: {ms:.3f} ms device time, x{count}")
    print(f"  torch ops around the kernels: {prof.busy_ms - ported_ms:.3f} ms device time")
    for ms, count, key in prof.top[:8]:
        print(f"  {ms:8.3f} ms  x{count:<5d} {key[:90]}")
    return run_ms / T


# --- the SPF, DPF, OT and run_chunked paths --------------------------------------
def _beta_gap(label, card_sol, cpu_sol):
    """max |β_card − β_cpu| and max relative |β'_card − β'_cpu|."""
    db = (card_sol[1].cpu() - cpu_sol[1]).abs().max().item()
    dd = ((card_sol[2].cpu() - cpu_sol[2]).abs() / cpu_sol[2].abs().clamp(min=1.0)).max().item()
    _check(db <= SPF_BETA_TOL and dd <= SPF_BETA_TOL,
           f"{label}: beta* card vs CPU {db:.3e}, beta' {dd:.3e} <= {SPF_BETA_TOL}")
    return db, dd


def run_spf_path(device, card):
    """The SPF columns: β* on the card against the CPU port (example 1's
    solve at n_grid 1001, from its optimal row, and example 2's first
    batched solve of its 20 runs at 301); example 1's rows (8 sets of 20
    runs) against the JAX package's 8 by a two-sample test; example 2 (the
    SPF rows and the SIR PF at N = 10^4 through B2) run by run against the
    JAX package's on the same trajectories by a paired test. B2's count is
    set to 0 just before the SIR PF's run and read just after."""
    ex1 = spf.run_example1(device)
    info = ex1["optimal"]["info"]
    db, dd = _beta_gap("SPF example 1", (None, info["beta"], info["betadot"]),
                       spf.solve_example1("cpu"))
    print(f"SPF example 1 beta* solve (n_grid {spf.STEPS1 + 1}, multisection, tabulated): "
          f"{ex1['optimal']['s'] - ex1['linear']['s']:.4f} s (the optimal row's less the "
          f"linear row's); card vs CPU beta {db:.3e}, beta' {dd:.3e}  [{card}]")
    d2 = spf.load_example2(device)
    x0 = spf.prior_estimates(spf.RUNS2, device)
    m_card = spf.example2_model(x0, d2["zs"][:, 0], device)
    m_cpu = spf.example2_model(x0.cpu(), d2["zs"][:, 0].cpu(), torch.device("cpu"))
    t0 = time.perf_counter()
    sol2 = spf.solve_beta_star_bisection(m_card.M0, m_card.Mh, mu=spf.MU2, n_grid=spf.STEPS2 + 1)
    torch.cuda.synchronize()
    solve2_s = time.perf_counter() - t0
    db2, dd2 = _beta_gap("SPF example 2", sol2, spf.solve_beta_star_bisection(
        m_cpu.M0, m_cpu.Mh, mu=spf.MU2, n_grid=spf.STEPS2 + 1))
    print(f"SPF example 2 beta* solve ({spf.RUNS2} runs batched, n_grid {spf.STEPS2 + 1}): "
          f"{solve2_s:.4f} s; card vs CPU beta {db2:.3e}, beta' {dd2:.3e}  [{card}]")
    ex2 = spf.run_example2(device, steps=SPF_EX2_STEPS)
    spf.print_columns(ex1, ex2, card)
    _gates("SPF example 1", spf.ex1_gates(ex1))
    for name, r in ex2.items():
        _check(r["finite"], f"SPF example 2 {name}: finite")
        tests = spf.ex2_against_jax(name, r)
        _check(len(tests) == len(spf.BLOCKS), f"SPF example 2 {name}: JAX references for "
               f"{r['steps']} steps")
        for block, (z, p) in tests.items():
            _check(p >= P_MIN, f"SPF example 2 {name} {block}: per-run RMSEs against the "
                   f"JAX package's, paired z {z}, p {p} >= {P_MIN}")
    sir = ex2["sir_pf"]
    _check(sir["b2_launches"] == sir["resample_steps"] > 0,
           f"SPF example 2 SIR PF: B2 launched {sir['b2_launches']} times, once a resample "
           f"step ({sir['resample_steps']})")
    return {"B2": sir["b2_launches"]}


def run_dpf_path(device, card):
    """The DPF columns: every row's RMSEs over 8 seeds against the JAX
    package's over 64 keys by a two-sample test; the trained RNN ``DPF_TRAIN_STEPS`` Adam
    steps, timed a step; the committed trained parameters' held-out NLL
    ``dpf.NLL_RATIO``× below baseline mode's. No kernel of ours runs here."""
    lin = dpf.run_linear(device, train_steps=DPF_TRAIN_STEPS)
    nl = dpf.run_nonlinear(device)
    held = dpf.run_heldout(device)
    dpf.print_columns(lin, nl, held, card)
    _gates("dpf_linear", dpf.gates("dpf_linear", lin))
    _gates("dpf_nonlinear", dpf.gates("dpf_nonlinear", nl))
    _check(held["ratio"] >= dpf.NLL_RATIO,
           f"held-out NLL: baseline / trained {held['ratio']} >= {dpf.NLL_RATIO}")


def run_ot_path(device, card):
    """Dense against blockwise Sinkhorn at N = 4096 on the card, then
    ``ot_large`` at N = 4096, 16384, 65536 with peak memory."""
    dense = ot_large.dense_vs_blockwise(device)
    res = ot_large.run(device)
    ot_large.print_rows(res, dense, card)
    _check(dense["max_abs_diff"] <= OT_DENSE_TOL,
           f"OT dense vs blockwise at N={dense['n']}: {dense['max_abs_diff']} <= "
           f"{OT_DENSE_TOL}")
    _gates("ot_large", ot_large.gates(res))
    return res


def _ot_tile_clouds(gen, n, d, device):
    """Two clouds of n particles in d dimensions with their log masses: a
    spread one (weights a softmax of normals), and one whose first weight
    is near 1 and the rest at the 1e-12 floor, with a particle 8 sigma out,
    whose row of the cost is far from every other."""
    x = 0.64 * torch.randn((n, d), generator=gen, device=device)
    w = torch.softmax(torch.randn((n,), generator=gen, device=device), 0)
    x2 = x.clone()
    x2[-1] = 8.0 * 0.64
    w2 = torch.full((n,), 1e-12, device=device)
    w2[0] = 1.0
    out = []
    for xx, ww in ((x, w), (x2, w2)):
        ww = torch.clamp(ww, min=1e-12)
        out.append((xx, torch.log(ww / (torch.sum(ww) + 1e-12)),
                    torch.full((n,), -math.log(n), device=device)))
    return out


def check_sinkhorn_tile(gen, n, d, device) -> dict:
    """The tile kernels against their plain version on both of
    :func:`_ot_tile_clouds`' clouds: the potentials and the dual changes
    after the loop within ``OT_TILE_POT_TOL``, the new particles within
    ``OT_TILE_PARTICLE_TOL`` of the input cloud's std, and
    ``sinkhorn_tile.launches`` raised by the launch plan a call. Returns
    the worst of each."""
    worst = {"potentials": 0.0, "particles": 0.0}
    for x, log_a, log_b in _ot_tile_clouds(gen, n, d, device):
        kw = dict(epsilon=OT_TILE_EPS, n_iters=OT_TILE_ITERS, damping=OT_TILE_DAMPING)
        before = ot_tile.sinkhorn_tile.launches
        f, g, hist = ot_tile.sinkhorn_tile(x, log_a, log_b, deltas=True, **kw)
        new_x = ot_tile.tile_projection(x, log_a, f, g, epsilon=OT_TILE_EPS)
        torch.cuda.synchronize()
        _check(ot_tile.sinkhorn_tile.launches == before + ot_tile.launches(OT_TILE_ITERS),
               f"Sinkhorn tile at {n} x {d}: {ot_tile.sinkhorn_tile.launches - before} launches, "
               f"the plan's {ot_tile.launches(OT_TILE_ITERS)}")
        rf, rg, rx, rhist = ot_tile.sinkhorn_tile_reference(x, log_a, log_b, **kw)
        pot = max(float((f - rf).abs().max()), float((g - rg).abs().max()),
                  float((hist - rhist).abs().max()))
        std = float(x.std()) if n > 1 else 1.0
        part = float((new_x - rx).abs().max()) / std
        _check(bool(torch.isfinite(new_x).all()), f"Sinkhorn tile at {n} x {d}: finite output")
        _check(pot <= OT_TILE_POT_TOL,
               f"Sinkhorn tile at {n} x {d}: potentials {pot} <= {OT_TILE_POT_TOL}")
        _check(part <= OT_TILE_PARTICLE_TOL,
               f"Sinkhorn tile at {n} x {d}: particles {part} <= {OT_TILE_PARTICLE_TOL} of std")
        worst = {"potentials": max(worst["potentials"], pot),
                 "particles": max(worst["particles"], part)}
    print(f"Sinkhorn tile at N={n}, d={d}: potentials within {worst['potentials']:.3e}, "
          f"particles within {worst['particles']:.3e} of std of the plain version")
    return worst


def _vjp_problem(gen, n, d, device):
    """The spread cloud of :func:`_ot_tile_clouds`, a normal cotangent of the
    new particles, and the history the forward saves for the VJP with the
    projection's output."""
    x, log_a, log_b = _ot_tile_clouds(gen, n, d, device)[0]
    cot = torch.randn((n, d), generator=gen, device=device)
    kw = dict(epsilon=OT_TILE_EPS, n_iters=OT_TILE_ITERS, damping=OT_TILE_DAMPING)
    saved = (log_a.new_empty((OT_TILE_ITERS + 1, 2, n)), log_a.new_empty((OT_TILE_ITERS, 2, n)))
    f, g, _ = ot_tile.sinkhorn_tile(x, log_a, log_b, saved=saved, **kw)
    new_x = ot_tile.tile_projection(x, log_a, f, g, epsilon=OT_TILE_EPS)
    return x, log_a, log_b, saved, new_x, cot


def check_sinkhorn_vjp(gen, n, d, device) -> float:
    """The VJP kernels against their plain version from one saved history:
    the gradients for the cloud and log a within ``OT_VJP_TOL`` of their
    largest entry, finite, and ``sinkhorn_tile.launches`` raised by the VJP's
    plan. Returns the worse gap."""
    x, log_a, log_b, saved, new_x, cot = _vjp_problem(gen, n, d, device)
    kw = dict(epsilon=OT_TILE_EPS, damping=OT_TILE_DAMPING)
    before = ot_tile.sinkhorn_tile.launches
    gx, gla = ot_tile.sinkhorn_tile_vjp(x, log_a, log_b, saved, new_x, cot, **kw)
    torch.cuda.synchronize()
    launched = ot_tile.sinkhorn_tile.launches - before
    _check(launched == ot_tile.vjp_launches(OT_TILE_ITERS),
           f"Sinkhorn VJP at {n} x {d}: {launched} launches, the plan's "
           f"{ot_tile.vjp_launches(OT_TILE_ITERS)}")
    px, pla = ot_tile.sinkhorn_tile_vjp_reference(x, log_a, log_b, saved, new_x, cot,
                                                  tile=256, **kw)
    _check(bool(torch.isfinite(gx).all()) and bool(torch.isfinite(gla).all()),
           f"Sinkhorn VJP at {n} x {d}: finite gradients")
    gaps = [float((a - b).abs().max() / b.abs().max()) for a, b in ((gx, px), (gla, pla))]
    _check(max(gaps) <= OT_VJP_TOL,
           f"Sinkhorn VJP at {n} x {d}: gradients {gaps} <= {OT_VJP_TOL} of the largest entry")
    print(f"Sinkhorn VJP at N={n}, d={d}: cloud's gradient within {gaps[0]:.3e}, log a's "
          f"within {gaps[1]:.3e} of the largest entry of the plain version")
    return max(gaps)


def _dpf_ot_sv(device, alpha, sigma, beta):
    """``DPF_OT`` on the SV model at N = ``DPF_OT_N`` with the parameters in
    its closures (numbers, or tensors to differentiate), and the
    observations."""
    from particle_filters_tpu_torch.models.dpf import DPF_OT

    sv = simulate_sv_1d(DPF_OT_T, ALPHA, SIGMA, 0.6, seed=5, device=device)

    def transition(g, x, t):
        return alpha * x + sigma * torch.randn(x.shape, generator=g, device=x.device)

    def loglik(x, y, t):
        return -0.5 * (y * y / (beta * beta) * torch.exp(-x[:, 0]) + x[:, 0]
                       + 2 * torch.log(torch.as_tensor(beta)))

    filt = DPF_OT(DPF_OT_N, 1, transition, loglik, epsilon=0.1, n_sinkhorn_iters=50,
                  damping=0.5, device=device)
    return filt, sv.Y[:, None]


def run_dpf_ot_path(device, card) -> tuple[int, int]:
    """``DPF_OT.run_filter`` on the SV model at N = ``DPF_OT_N`` for
    ``DPF_OT_T`` steps: every resample through the tile kernels (the counter
    raised by the plan a step), finite particles. Then the gradient of its
    log-evidence in (alpha, sigma, beta), the initial cloud's std
    sigma / sqrt(1 - alpha^2) included: with the counters zeroed just before
    ``torch.autograd.grad``, every backward resample through the VJP kernels
    (T - 1 of them: the last step's resample feeds no increment), 2 x 50
    VJP half-updates each, finite gradients. Returns the forward's and the
    backward's launches."""
    from particle_filters_tpu_torch.resampling.ot import sinkhorn_ot_resample

    gen = torch.Generator(device=device).manual_seed(5)
    filt, ys = _dpf_ot_sv(device, ALPHA, SIGMA, 0.6)
    before = ot_tile.sinkhorn_tile.launches
    t0 = time.perf_counter()
    ps, _, log_z = filt.run_filter(gen, ys, [0.0], [[0.64]], return_log_evidence=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = ot_tile.sinkhorn_tile.launches - before
    _check(launched == DPF_OT_T * ot_tile.launches(50),
           f"DPF_OT: {launched} tile launches over {DPF_OT_T} steps, the plan's "
           f"{DPF_OT_T * ot_tile.launches(50)}")
    _check(bool(torch.isfinite(ps).all()) and bool(torch.isfinite(log_z)),
           "DPF_OT: finite particles and log-evidence")
    print(f"DPF_OT N={DPF_OT_N} T={DPF_OT_T}: {launched} tile launches, {secs:.4f} s (host "
          f"clock, the first call included)  [{card}]")

    params = [torch.tensor(v, device=device, requires_grad=True) for v in (ALPHA, SIGMA, 0.6)]
    filt, ys = _dpf_ot_sv(device, *params)
    std0 = params[1] / torch.sqrt(1 - params[0] * params[0])
    _, _, log_z = filt.run_filter(gen.manual_seed(5), ys, [0.0], std0.reshape(1, 1),
                                  return_log_evidence=True)
    ot_tile.sinkhorn_tile.launches = 0
    sinkhorn_ot_resample.vjp_half_updates = 0
    t0 = time.perf_counter()
    grads = torch.stack(torch.autograd.grad(log_z, params))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    vjp, halves = ot_tile.sinkhorn_tile.launches, sinkhorn_ot_resample.vjp_half_updates
    steps = DPF_OT_T - 1
    _check(vjp == steps * ot_tile.vjp_launches(50),
           f"DPF_OT gradient: {vjp} VJP launches over {steps} backward steps, the plan's "
           f"{steps * ot_tile.vjp_launches(50)}")
    _check(halves == 2 * 50 * steps,
           f"DPF_OT gradient: {halves} VJP half-updates, 2 x 50 x {steps}")
    _check(bool(torch.isfinite(grads).all()) and bool(torch.isfinite(log_z)),
           "DPF_OT gradient: finite log-evidence and gradient")
    print(f"DPF_OT N={DPF_OT_N} T={DPF_OT_T} gradient: {vjp} VJP launches, {halves} VJP "
          f"half-updates, d log Z / d(alpha, sigma, beta) = {grads.tolist()}, {secs:.4f} s "
          f"(host clock, the backward alone)  [{card}]")
    return launched, vjp


def time_sinkhorn_tile(gen, device, card, n=8192):
    """The half-update and the projection at N = ``n``, d = 1, by CUDA-graph
    replay (the dual loop's 100 launches a call, over 100), beside the plain
    version's half-update and the exponentials' bound. Returns ``(ms,
    plain_ms, None, (bound_ms, "exps"))`` of a half-update."""
    x, log_a, log_b = _ot_tile_clouds(gen, n, 1, device)[0]
    kw = dict(epsilon=OT_TILE_EPS, damping=OT_TILE_DAMPING)
    f, g, _ = ot_tile.sinkhorn_tile(x, log_a, log_b, n_iters=OT_TILE_ITERS, **kw)
    half = [_graph_ms(lambda: ot_tile.sinkhorn_tile(x, log_a, log_b, n_iters=OT_TILE_ITERS,
                                                     **kw), reps=4) / (2 * OT_TILE_ITERS)
            for _ in range(2)]
    proj = _graph_ms(lambda: ot_tile.tile_projection(x, log_a, f, g, epsilon=OT_TILE_EPS))
    eps, k, xs = ot_tile.scales(OT_TILE_EPS)
    plain = _time_ms(lambda: ot_tile._half_update(x * xs, g, log_b, f, eps, k, OT_TILE_DAMPING,
                                                  ot_tile.TILE), reps=2, samples=3)
    bound = n * n / ot_tile.SFU_EXP_PER_S * 1e3
    ms = sum(half) / 2
    print(f"Sinkhorn tile at N={n}, d=1: half-update {ms:.6f} ms ({half[0]:.6f}, {half[1]:.6f}), "
          f"projection {proj:.6f} ms, plain half-update {plain:.6f} ms; bound {bound:.6f} ms "
          f"(exps) -> {bound / ms:.3f} of it, projection {bound / proj:.3f}  [{card}]")
    return ms, plain, None, (bound, "exps"), proj


def time_sinkhorn_vjp(gen, device, card, n=8192):
    """One resample's VJP (50 iterations and the projection, 4·50 + 2
    launches) at N = ``n``, d = 1, by CUDA-graph replay, beside the plain
    version's (torch, partner tiles of 256) and the exponentials' bound,
    N² × (2·50 + 1) at the SFU's rate. Returns ``(ms, plain_ms, None,
    (bound_ms, "exps"))``."""
    x, log_a, log_b, saved, new_x, cot = _vjp_problem(gen, n, 1, device)
    kw = dict(epsilon=OT_TILE_EPS, damping=OT_TILE_DAMPING)
    runs = [_graph_ms(lambda: ot_tile.sinkhorn_tile_vjp(x, log_a, log_b, saved, new_x, cot,
                                                         **kw), reps=2) for _ in range(2)]
    plain = _time_ms(lambda: ot_tile.sinkhorn_tile_vjp_reference(
        x, log_a, log_b, saved, new_x, cot, tile=256, **kw), reps=1, samples=1)
    bound = n * n * (2 * OT_TILE_ITERS + 1) / ot_tile.SFU_EXP_PER_S * 1e3
    ms = sum(runs) / 2
    print(f"Sinkhorn VJP at N={n}, d=1: a resample's VJP {ms:.6f} ms ({runs[0]:.6f}, "
          f"{runs[1]:.6f}; {ms / ot_tile.vjp_launches(OT_TILE_ITERS) * 1e3:.3f} us a pass), "
          f"plain {plain:.6f} ms; bound {bound:.6f} ms (exps) -> {bound / ms:.3f} of it  "
          f"[{card}]")
    return ms, plain, None, (bound, "exps")


def run_chunked_path(device, card):
    """``ParticleFilter.run_chunked`` on the SV model at N = 2^20: a run
    interrupted after ``CHUNK_STOP`` pieces and resumed from its checkpoint
    (with another generator object) equals ``run`` bit for bit. B2's count
    is set to 0 just before the two chunked calls and read just after."""
    sv = simulate_sv_1d(CHUNK_T, ALPHA, SIGMA, BETA, seed=7, device=device)
    zs = sv.Y[:, None]
    model = SVModel(ALPHA, BETA)
    pf = ParticleFilter(lambda x, u: model.g(x), None, Q=[[SIGMA**2]], R=None, Np=N,
                        resample_thresh=0.5, obs_loglik=model.obs_loglik, device=device)
    var0 = SIGMA**2 / (1 - ALPHA**2)
    st0 = pf.initialize(torch.Generator(device=device).manual_seed(3), [0.0], [[var0]])
    fin_m, hist_m = pf.run(torch.Generator(device=device).manual_seed(4), st0, zs)
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as ckpt:
        b2.resample_by_starts.launches = 0
        t0 = time.perf_counter()
        fin_p, _ = pf.run_chunked(torch.Generator(device=device).manual_seed(4), st0, zs,
                                  chunk_size=CHUNK_SIZE, ckpt_dir=ckpt,
                                  stop_after_chunks=CHUNK_STOP)
        fin_r, hist_r = pf.run_chunked(torch.Generator(device=device).manual_seed(123), st0, zs,
                                       chunk_size=CHUNK_SIZE, ckpt_dir=ckpt, resume=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = b2.resample_by_starts.launches
    _check(int(fin_p.t) == CHUNK_SIZE * CHUNK_STOP, "run_chunked: interrupted where asked")
    for f in ("particles", "log_weights", "mean", "cov", "t"):
        _check(torch.equal(getattr(fin_m, f), getattr(fin_r, f)),
               f"run_chunked resumed == run bit for bit (final {f})")
    _check(set(hist_m) == set(hist_r), "run_chunked: the history's keys")
    for k in hist_m:
        _check(torch.equal(hist_m[k], hist_r[k]),
               f"run_chunked resumed == run bit for bit (history {k})")
    n_res = int(hist_m["resampled"].sum())
    _check(launches == n_res > 0, f"run_chunked: B2 launched {launches}, want {n_res} > 0")
    print(f"run_chunked N={N} T={CHUNK_T} in pieces of {CHUNK_SIZE}, interrupted after "
          f"{CHUNK_STOP} and resumed: bit-equal to run (final state and all {len(hist_m)} "
          f"history keys), {n_res} resample steps, {secs:.3f} s with checkpoints  [{card}]")
    return {"B2": launches}


# --- the parallel path: the multi-device layer at world size 1 over NCCL ------
def time_b1_shard(gen, device, card):
    """B1 as rank 3 of 4 of a cloud of 2^20 (2^18 particles, its Philox
    counters offset), in turns with its plain version: ``(ms, plain_ms,
    None, bound)``."""
    kern, plain, _, sets, bound = _b1_timed(gen, N // 4, device, shard=(3, 4))
    kern, plain = _rotating(kern, sets), _rotating(plain, sets)
    t = [_graph_ms(f) for f in (kern, plain, plain, kern)]
    ms, plain_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"B1 as rank 3 of 4 at N={N // 4} (of {N}): device {ms:.6f} ms, plain {plain_ms:.6f} "
          f"ms; bound {bound[0]:.6f} ms ({bound[1]}) -> {bound[0] / ms:.3f} of it  [{card}]")
    return ms, plain_ms, None, bound


def time_b2_m_to_n(gen, device, card):
    """B2's M→n form at ``benchmarks/sharded.py``'s shapes: bit-equal to its
    plain version and to ``repeat_interleave`` over the window's child
    counts; device time of kernel, plain and that call in turns over four
    input sets, beside the bound of what the data needs. ``{label: (ms,
    plain_ms, library_ms, bound)}``."""
    cases = [sharded.b2_cases(gen, device) for _ in range(4)]
    out = {}
    for i, (label, values, starts, n, off) in enumerate(cases[0]):
        d = values.shape[1]
        sets = [(c[i][1], c[i][2], sharded.b2_work(c[i][2], n, off, d)[2]) for c in cases]
        got = b2.resample_by_starts(values, starts, n_out=n, offset=off)
        _check(torch.equal(got, b2.resample_by_starts_reference(values, starts, n, off)),
               f"B2 M->n == plain bit for bit ({label})")
        _check(torch.equal(got, torch.repeat_interleave(values, sets[0][2], dim=0,
                                                        output_size=n)),
               f"B2 M->n == repeat_interleave of the window's counts ({label})")
        kern = _rotating(lambda v, s, c: b2.resample_by_starts(v, s, n_out=n, offset=off),
                         sets)
        plain = _rotating(lambda v, s, c: b2.resample_by_starts_reference(v, s, n, off), sets)
        lib = _rotating(lambda v, s, c: torch.repeat_interleave(v, c, dim=0, output_size=n),
                        sets)
        t = [_graph_ms(f) for f in (kern, plain, lib, lib, plain, kern)]
        ms, plain_ms, lib_ms = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, (t[2] + t[3]) / 2
        nbytes, ops, _ = sharded.b2_work(starts, n, off, d)
        bound = _bound(nbytes, ops)
        out[label] = (ms, plain_ms, lib_ms, bound)
        print(f"B2 M->n {label}: M={values.shape[0]}, n={n}, d={d}, offset {off}: bit-equal to "
              f"plain; device {ms:.6f} ms, plain {plain_ms:.6f} ms, repeat_interleave "
              f"{lib_ms:.6f} ms; bound {bound[0]:.6f} ms ({bound[1]}) -> {bound[0] / ms:.3f} "
              f"of it  [{card}]")
    return out


def _sharded_fused_checks(sv, runs, counts, card):
    (fin1, h1, s1), (fin_a, ha, s_a), (_, hn, s_n) = (runs[k] for k in
                                                       ("single", "all_gather", "neighbor"))
    _check(torch.equal(fin1[0], fin_a[0]), "sharded all-gather: final particles bit-equal")
    for k in ("mean", "cov", "log_evidence", "resampled"):
        _check(torch.equal(h1[k], ha[k]), f"sharded all-gather: history[{k}] bit-equal")
    ulp = torch.abs(h1["ess"] - ha["ess"]) / torch.abs(torch.nextafter(
        h1["ess"], torch.full_like(h1["ess"], math.inf)) - h1["ess"])
    _check(bool((ulp <= 2).all()), f"sharded all-gather: ESS within 2 ulp ({ulp.max().item()})")
    _check(bool(hn["exchange_ok"].all()), "sharded neighbor: exchange_ok on every step")
    rmse, frac = _check_history(hn, sv, "sharded neighbor")
    tol = sharded.NEIGHBOR_TOL
    d_mean = (hn["mean"] - ha["mean"]).abs().max().item()
    d_ess = ((hn["ess"] - ha["ess"]).abs() / ha["ess"]).max().item()
    d_ll = (hn["log_evidence"] - ha["log_evidence"]).abs().max().item()
    _check(d_mean <= tol["mean"] and d_ess <= tol["ess_rel"] and d_ll <= tol["log_evidence"],
           f"sharded neighbor within {tol} of all-gather: mean {d_mean}, ess {d_ess}, "
           f"log evidence {d_ll}")
    n_res = int(ha["resampled"].sum()) + int(hn["resampled"].sum())
    _check(counts["B1"] == 2 * T, f"sharded runs: B1 launched {counts['B1']}, want {2 * T}")
    _check(counts["B2"] == n_res > 0, f"sharded runs: B2 launched {counts['B2']}, want {n_res}")
    print(f"sharded fused SV N={N} T={T}, one rank over NCCL: all-gather bit-equal to "
          f"FusedSIRFilter (particles, mean, cov, log evidence, resample steps; ESS within 2 "
          f"ulp); neighbor sv_rmse {rmse:.4f}, resample_frac {frac:.3f}, exchange_ok throughout, "
          f"max |mean - all-gather| {d_mean:.3e}, ESS rel {d_ess:.3e}, log evidence "
          f"{d_ll:.3e}; ms/step unsharded {s1 * 1e3:.4f}, all-gather {s_a * 1e3:.4f}, neighbor "
          f"{s_n * 1e3:.4f}; launches {counts}  [{card}]")


def run_parallel_path(gen, device, card):
    """The multi-device layer (``benchmarks/sharded.py``) in a one-card NCCL
    group opened from a FileStore and destroyed after: the sharded fused SV
    run in both modes against ``FusedSIRFilter`` (B1 and B2 counted: set to
    0 just before each sharded run, read just after), B1's offset form,
    B2's M→n form, the pooled exact run ends at 2^25, the sharded
    ParticleFilter in neighbour mode, the sharded EDH on SNLG d = 64 and
    the sharded DPF train step. Returns the sharded runs' launches; the
    kernels' new forms are timed and printed."""
    with process_group("nccl"):
        _check(dist.get_world_size() == 1 and dist.get_backend() == "nccl",
               "a one-rank NCCL group")
        sv, runs, counts = sharded.fused_runs(device)
        _sharded_fused_checks(sv, runs, counts, card)
        err_b1, fold_err = sharded.b1_offset(gen, device)
        _check(err_b1 == 0.0, f"B1 with global offsets: 4 launches of 2^18 == one of 2^20 "
                              f"(x' and lw'), max |diff| {err_b1}")
        _check(fold_err <= 1.0, f"the 4 launches' partials folded by fold_ranks within "
                                f"{sharded.FOLD_TOL} of one launch's row ({fold_err} of it)")
        print(f"B1 with global offsets: four launches over 2^18 bit-equal to one over {N} "
              f"(x' and lw', carried and uniform off_u); their partials folded by fold_ranks "
              f"over the NCCL group within {fold_err:.4f} of {sharded.FOLD_TOL} of one "
              f"launch's row")
        time_b1_shard(gen, device, card)
        time_b2_m_to_n(gen, device, card)
        for label, (pool_eq, cpu_eq) in sharded.exact_pool(gen, device).items():
            _check(pool_eq and cpu_eq, f"pooled exact run ends at 2^25 == exact_child_run_ends_u "
                                       f"on the card ({pool_eq}) and the CPU ({cpu_eq}), {label}")
        print(f"pooled exact run ends N={sharded.EXACT_N}: bit-identical to "
              f"exact_child_run_ends_u on the card and on the CPU (sigma=2, point mass)")
        sv, hg, hs, launches = sharded.general_pf(device)
        rmse, frac = _check_history(hs, sv, "sharded general neighbor")
        n_res = int(hs["resampled"].sum())
        _check(bool(hs["exchange_ok"].all()), "sharded general: exchange_ok throughout")
        _check(launches == n_res > 0, f"sharded general: B2 launched {launches}, want {n_res}")
        ll, ll_s = hg["log_evidence"].sum().item(), hs["log_evidence"].sum().item()
        _check(abs(ll_s - ll) <= 0.03 * abs(ll) + 3.0,
               f"sharded general log evidence {ll_s} vs unsharded {ll}")
        print(f"sharded ParticleFilter neighbor N={N} T={T}: sv_rmse {rmse:.4f}, resample_frac "
              f"{frac:.3f}, exchange_ok throughout, B2 {launches}, log evidence {ll_s:.3f} "
              f"(unsharded {ll:.3f})  [{card}]")
        print(f"collectives on one rank, host us a call: "
              f"{ {k: round(v, 1) for k, v in sharded.collective_us(device).items()} }  [{card}]")
        X, h1, hs, s1, ss = sharded.snlg_edh(device)
        X = torch.as_tensor(X, device=device)
        d_mean = (h1["mean"] - hs["mean"]).abs().max().item()
        mse1 = torch.mean((h1["mean"] - X) ** 2).item()
        mses = torch.mean((hs["mean"] - X) ** 2).item()
        tol = sharded.EDH_TOL
        _check(torch.equal(h1["resampled"], hs["resampled"]), "sharded EDH: same resample steps")
        _check(d_mean <= tol["mean"] and abs(mses - mse1) <= tol["mse_rel"] * mse1,
               f"sharded EDH within {tol} of the unsharded flow: mean {d_mean}, MSE {mses} vs "
               f"{mse1}")
        print(f"sharded EDH-{sharded.EDH_N} on SNLG d=64, T={sharded.EDH_T}, no process noise: "
              f"max |mean - unsharded| {d_mean:.3e}, MSE {mses:.6f} (unsharded {mse1:.6f}); "
              f"{ss:.3f} s sharded, {s1:.3f} s unsharded (means of two in turns)  [{card}]")
        dpf_out = sharded.dpf_step(device)
        (l1, g1, t1), (l2, g2, t2) = dpf_out["unsharded"], dpf_out["sharded"]
        _check(torch.allclose(l2, l1, rtol=1e-6, atol=0.0) and all(
            torch.allclose(g2[k], g1[k], rtol=1e-6, atol=1e-7) for k in g1),
            f"sharded DPF step == unsharded: loss {l2.item()} vs {l1.item()}, grads {g2} vs {g1}")
        print(f"sharded DPF train step (SV, N={sharded.DPF_N}, T={sharded.DPF_T}, "
              f"{sharded.DPF_B} sequences): loss {l2.item():.6f} and grads "
              f"{ {k: round(v.item(), 6) for k, v in g2.items()} } equal to the unsharded step's; "
              f"{t2:.3f} s sharded, {t1:.3f} s unsharded  [{card}]")
    return counts


# --- the sv_classic and nlngssm columns -----------------------------------------
def run_sv_columns(device, card):
    """``bench_sv_classic``'s column uncut (EKF and UKF on the log-squared
    observations; the SIR PF at N = 2000, T = 2000 over ``sv_classic.SEEDS``
    seeds) and ``bench_nlngssm_flows``' (EDH, LEDH, KPF at N = 500 over
    ``nlngssm.SEEDS`` seeds) cut to its first ``nlngssm.T_CUT`` steps,
    each held to the JAX package's committed values by its module's gates.
    B2's count is set to 0 just before the PF runs and read just after."""
    data = sv_classic.load_data(device)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results.json")
        record, gates, res = run_benchmarks.run_columns(["sv_classic"], device, out)["sv_classic"]
        with open(out) as f:
            written = json.load(f)
    sv_classic.print_column(res, data, card)
    _gates("sv_classic", gates)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks",
                           "results.json")) as f:
        jax_keys = {k for k in json.load(f)["results"]["sv_classic"]
                    if not k.startswith("reference")}
    _check(set(written["results"]["sv_classic"]) == set(record) == jax_keys,
           f"harness record keys {sorted(record)} == the JAX record's {sorted(jax_keys)}")
    _check([written[k] for k in ("backend", "device", "power_limit_w")]
           == ["cuda", *card_of(device)],
           f"harness card fields {[written[k] for k in ('backend', 'device', 'power_limit_w')]}")
    print(f"sv_classic through the harness: record keys as the JAX record's less reference*, "
          f"backend {written['backend']}, device {written['device']}, power limit "
          f"{written['power_limit_w']} W")
    r = res["pf"]
    _check(r["b2_launches"] == r["resample_steps"] > 0,
           f"sv_classic pf: B2 launched {r['b2_launches']}, want {r['resample_steps']} > 0")
    res_n = nlngssm.run_column(device, data, t=nlngssm.T_CUT)
    nlngssm.print_column(res_n, data, card)
    _gates(f"nlngssm (first {nlngssm.T_CUT} steps)", nlngssm.gates(res_n, data, cut=True))
    return {"B2": r["b2_launches"]}


# --- the north-star scripts and the notebook examples ---------------------------
def _gates(label, gates):
    for gate, (value, held) in gates.items():
        _check(held, f"{label} {gate}: {value}")


def run_north_star(device, card):
    """The bench twin (``benchmarks/bench.py``: the main path's workload,
    the best of 5 runs after a warm-up; its JSON on a line of its own) held
    to the main path's gates, and the scaling curve at N = 2^14 ... 2^24
    (``benchmarks/scaling_curve.py``, ``SCALING_REPS`` runs of each length)
    with finite histories at every N. Returns B1's and B2's launches (set
    to 0 just before, read just after) and the bench's ms/step."""
    t0 = time.perf_counter()
    fused_step.launches = 0
    b2.resample_by_starts.launches = 0
    record = bench.run(device)
    print(json.dumps(record))
    _gates("bench twin", bench.gates(record))
    _check(record["extras"]["fused_kernel_step"], "bench twin: B1 ran")
    rows = scaling_curve.curve(device, reps=SCALING_REPS)
    for r in rows:
        print(f"scaling {scaling_curve.format_row(r)}  [{card}]")
        _check(r["finite"], f"scaling curve N=2^{r['log2_n']}: finite histories")
    counts = {"B1": fused_step.launches, "B2": b2.resample_by_starts.launches}
    _check(counts["B1"] > 0 and counts["B2"] > 0, f"north star: B1 and B2 launched, {counts}")
    print(f"north_star phase {time.perf_counter() - t0:.1f} s  [{card}]")
    return counts, record["extras"]["ms_per_step"]


def run_examples_path(device, card):
    """The seven notebook examples that no column reproduces, each at its
    own size but for the cuts named at ``EX15_T``, their tables printed and
    held to their modules' gates; ex11's beta* also against the CPU port's
    from the same model. Returns B2's launches (the PF rows of ex14 and
    ex15; set to 0 just before, read just after)."""
    t_phase = time.perf_counter()
    b2.resample_by_starts.launches = 0
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    res = timed("ex15", lambda: ex15.run_all(device, seeds=EX15_SEEDS, t=EX15_T))
    ex15.print_tables(res, card)
    _gates("ex15", ex15.gates(res))
    data14 = ex14.load_data(device)
    res = timed("ex14", lambda: ex14.run_all(device, data14, seeds=EX14_PF_SEEDS,
                                             t=ex14.T_CUT))
    ex14.print_tables(res, data14, card)
    for row, (value, ref, held) in ex14.gates(res, data14).items():
        _check(held, f"ex14 {row}: {value} against the JAX package's {ref}")
    res = timed("ex01", lambda: ex01.run_all(device, seeds=ex01.SEEDS[:EX01_SEEDS]))
    ex01.print_tables(res, card)
    _gates("ex01", ex01.gates(res))
    res = timed("ex12", lambda: ex12.run_all(device))
    ex12.print_tables(res, card)
    _gates("ex12", ex12.gates(res))
    red64 = ex12.diagonal_f64(device, jitter=1e-5)
    _check(min(red64) >= ex12.F64_MIN_RED,
           f"ex12 diagonal kernel in float64 at jitter 1e-5: reductions {red64} >= "
           f"{ex12.F64_MIN_RED}")
    print(f"ex12 diagonal kernel, variance reduction (observed, unobserved): float64 at jitter "
          f"1e-5 (cuSOLVER f64) {100 * red64[0]:.2f} / {100 * red64[1]:.2f} %; float32 as a "
          f"user runs it (jitter {res['kpf']['diagonal']['rung']:g}) "
          f"{100 * res['reduction']['diagonal'][0]:.2f} / "
          f"{100 * res['reduction']['diagonal'][1]:.2f} %  [{card}]")
    resid = ex12.diagonal_factor_residuals(device)
    _check(resid[1e-5] > FACTOR_RESID_MAX >= resid[1e-4]
           and math.isclose(res["kpf"]["diagonal"]["rung"], 1e-4, rel_tol=1e-6),
           f"ex12 diagonal prior factor residuals {resid} (bound {FACTOR_RESID_MAX}), rung "
           f"{res['kpf']['diagonal']['rung']}: the ladder rejects 1e-5 and takes 1e-4")
    print(f"ex12 diagonal prior factor in float32 (cuSOLVER): residual {resid[1e-5]:.4f} at "
          f"jitter 1e-5 (rejected), {resid[1e-4]:.4f} at 1e-4 (taken); bound "
          f"{FACTOR_RESID_MAX}  [{card}]")
    res = timed("ex11", lambda: ex11.run_all(device))
    ex11.print_tables(res, card)
    _gates("ex11", ex11.gates(res))
    model = res["model"]
    beta_cpu = spf.solve_beta_star_bisection(model.M0.cpu(), model.Mh.cpu(), mu=ex11.MU,
                                             n_grid=ex11.N_STEPS + 1)[1]
    gap = (res["beta_opt"].cpu() - beta_cpu).abs().max().item()
    _check(gap <= EX11_BETA_TOL, f"ex11 beta* card vs CPU {gap} <= {EX11_BETA_TOL}")
    print(f"ex11 beta* card vs CPU (same M0, Mh): max |diff| {gap:.3e}")
    res = timed("ex08", lambda: ex08.run_all(device))
    ex08.print_tables(res, card)
    _gates("ex08", ex08.gates(res))
    res = timed("ex07", lambda: ex07.train(device))
    ex07.print_tables(res, card)
    _gates("ex07", ex07.gates(res))
    counts = {"B2": b2.resample_by_starts.launches}
    _check(counts["B2"] > 0, f"examples: B2 launched on the PF rows, {counts}")
    print(f"examples phase {time.perf_counter() - t_phase:.1f} s: "
          f"{ {k: round(v, 2) for k, v in secs.items()} }  [{card}]")
    return counts


def _build_all(gen) -> None:
    """One nvcc per CUDA source, all started together; then B1's Triton
    compiles (two models, drawn and injected normals)."""
    t0 = time.perf_counter()
    kernels = (b2._KERNEL, ks._KERNEL, x1._KERNEL, x2._KERNEL, x3._KERNEL, ot_tile._DUAL)
    with ThreadPoolExecutor(max_workers=4) as pool:
        for fut in [pool.submit(k.entry) for k in kernels]:
            fut.result()
    ot_tile._PROJECT.entry()  # in the library just built for the dual loop
    ot_tile._VJP.entry()
    print(f"nvcc build+load of B2, S, X1, X2, X3, OT, OT-VJP {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    device = torch.device("cuda")
    for model, Q in ((SVModel(ALPHA, BETA), [[SIGMA**2]]), (LinearObsFirstModel(A2, 0.1), Q2)):
        _, x, lw, off_u, z = _b1_inputs(gen, model, Q, 4096, device, False)
        f = FusedSIRFilter(model, Q, Np=4096, device=device)
        for eps in (None, torch.randn(x.shape, generator=gen, device=device)):
            fused_step(x, lw, off_u, z, f.Lq, f.params, model, seed=3, eps=eps)
    torch.cuda.synchronize()
    print(f"B1 Triton compile (2 models x 2 variants) {time.perf_counter() - t0:.2f} s")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; the port's kernels run only on a GPU.")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls off")
    _check(not torch.backends.cudnn.allow_tf32, "TF32 cuDNN off")
    _check(torch.cuda.device_count() == 1,
           f"one visible card, found {torch.cuda.device_count()}: set CUDA_VISIBLE_DEVICES=0")
    device = torch.device("cuda")
    card = _card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    gen = torch.Generator(device=device).manual_seed(2024)

    _build_all(gen)
    errs = {"B2": max([check_b2(gen, n, device) for n in (N, B2_RAGGED_N, EXACT_N)]
                      + [check_b2(gen, B2_SIR_SHAPE[1], device, dims=B2_SIR_SHAPE[2:])]
                      + [check_b2_trials(gen, t, n, d, device) for t, n, d in B2_TRIAL_SHAPES]),
            "B1": max(check_b1(gen, n, device) for n in (N, EXACT_N)), "X3": check_x3(device),
            "X1": check_x1(gen, N, device), "X2": check_x2(gen, N, device),
            "S": max(check_starts(gen, rows, n, device) for rows, n in S_SHAPES),
            "OT": max(check_sinkhorn_tile(gen, n, d, device)["particles"]
                      for n, d in OT_TILE_SHAPES),
            "OT-VJP": max(check_sinkhorn_vjp(gen, n, d, device) for n, d in OT_VJP_SHAPES)}
    errs["S"] = max([errs["S"]] + [check_starts_log(gen, rows, n, device)
                                   for rows, n in S_SHAPES])
    for rows, n in S_SHAPES:
        check_starts_linear_pinned(rows, n, device)
    for label in S_DEGENERATE:
        check_starts_degenerate(label, device)
    check_exact(gen, device)
    torch.cuda.synchronize()

    check_gates(gen, device)
    counts, fused_run = run_main_path(N, device)
    check_card_run(N, device)
    check_step_launches(N, device)
    entry_counts = run_entry_path(device, card)
    ks.systematic_starts.log_rows = 0
    exact_counts = run_exact_path(device, card)
    snlg_counts = run_snlg_path(device, card)
    skewt_counts = run_skewt_path(device, card)
    mat_counts = run_mat_path(device, card)
    # Past 2^24 and in the flows the starts take normalized linear weights.
    _check(ks.systematic_starts.log_rows == 0,
           f"the exact path and the flows read {ks.systematic_starts.log_rows} rows as "
           f"log-weights, want 0")
    run_kpf_path(device, card)
    check_simulators(device, card)
    spf_counts = run_spf_path(device, card)
    run_dpf_path(device, card)
    run_ot_path(device, card)
    counts["OT"], counts["OT-VJP"] = run_dpf_ot_path(device, card)
    chunked_counts = run_chunked_path(device, card)
    par_counts = run_parallel_path(gen, device, card)
    sv_counts = run_sv_columns(device, card)
    north_counts, bench_ms = run_north_star(device, card)
    ex_counts = run_examples_path(device, card)
    print(f"launches by path: main {counts}, entry {entry_counts}, exact {exact_counts}, SNLG {snlg_counts}, "
          f"skew-t {skewt_counts}, MAT {mat_counts}, SPF {spf_counts}, DPF {{}}, OT {{}}, "
          f"run_chunked {chunked_counts}, parallel {par_counts}, sv_classic {sv_counts}, "
          f"nlngssm {{}}, north_star {north_counts}, examples {ex_counts}")
    check_determinism(N, device)
    counts.update(run_profiling_path(device, card))
    times = time_kernels(gen, N, device, card)
    time_b1_variants(gen, N, device, card)
    time_b2_balance(gen, N, device, card)
    time_b2_trials(gen, device, card)
    time_probe_branches(gen, N, device, card)
    time_run_ends(gen, device, card)
    s_times = time_starts(gen, device, card)
    x3_ms, add_ms = time_x3_pairs(gen, card)
    times["X3"] = (x3_ms, times["X3"][1], add_ms, times["X3"][3])
    times["S"] = s_times[(1, N)][:2] + (None, s_times[(1, N)][2])
    times["OT"] = time_sinkhorn_tile(gen, device, card)[:4]
    times["OT-VJP"] = time_sinkhorn_vjp(gen, device, card)
    fused_ms = time_fused_run(N, card, fused_run)
    print(f"fused SV run N={N} T={T}: bench twin {bench_ms:.4f} ms/step (best of "
          f"{bench.RUNS}, host clock to a sync) against {fused_ms:.4f} (median of 5, CUDA "
          f"events): ratio {bench_ms / fused_ms:.3f}  [{card}]")

    rows = (
        ("B1", "B1 fused SIR propagate-and-weight step", "triton",
         "particle_filters_tpu_torch/ops/_fused_pf_triton.py",
         "particle_filters_tpu/ops/fused_pf.py:63"),
        ("B2", "B2 systematic resample values", "cuda",
         "particle_filters_tpu_torch/csrc/systematic_resample.cu",
         "particle_filters_tpu/ops/resample_pallas.py:99"),
        ("X1", "X1 windowed compare-and-sum (probe, v0)", "cuda",
         "particle_filters_tpu_torch/csrc/window_resample.cu",
         "benchmarks/exp_kernel_var.py:87"),
        ("X2", "X2 span-staged resample values (probe)", "cuda",
         "particle_filters_tpu_torch/csrc/span_resample.cu",
         "benchmarks/exp_resample_dma.py:48"),
        ("X3", "X3 launch floor (probe)", "cuda",
         "particle_filters_tpu_torch/csrc/launch_probe.cu",
         "benchmarks/profile_small_n.py:137"),
        ("S", "S systematic starts from the weights", "cuda",
         "particle_filters_tpu_torch/csrc/systematic_starts.cu",
         "no TPU kernel: replaces the torch starts chain"),
        ("OT", "Sinkhorn half-update tile (cost in registers), N = 8192", "cuda",
         "particle_filters_tpu_torch/csrc/sinkhorn_tile.cu",
         "no TPU kernel: replaces the dense torch Sinkhorn"),
        ("OT-VJP", "Sinkhorn VJP tile passes (plan recomputed in registers), one resample's "
         "backward, N = 8192", "cuda", "particle_filters_tpu_torch/csrc/sinkhorn_tile.cu",
         "no TPU kernel: replaces the dense torch Sinkhorn's autograd"),
    )
    kernels = []
    for key, name, route, source, replaces in rows:
        ms, plain_ms, library_ms, (bound_ms, bound_by) = times[key]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": counts[key], "max_abs_err": errs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
        })
    print(f"chip_smoke.py total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
