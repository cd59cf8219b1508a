"""The SNLG column: KF, KF at σ_z = 1, UKF, EDH-200, LEDH-200 and EDH-10000
on the linear-Gaussian sensor network, trials batched on the card — the
port's twin of ``benchmarks/run_benchmarks.py::bench_snlg``.

    python -m particle_filters_tpu_torch.benchmarks.snlg

Full width: d = 64 (an 8×8 grid), T = 50, 100 trials, α = 0.9, Σ from the
SE kernel (α₀ = 3, β = 20, α₁ = 0.01), σ_z = 2, and the σ_z = 1 KF row. The
data is ``bench_snlg``'s: one seed-123 numpy PCG64 stream, trial-major, the
σ_z = 2 block then the σ_z = 1 block (:func:`make_data`), so the MSEs compare
with the JAX package's (``benchmarks/results.json`` → ``results.snlg_d64``:
:data:`JAX_MSE`). The flows take 4 λ-steps and resample at ESS < N/2 (the
reference notebook's settings, as ``bench_snlg``), with an EKF tracker.

The KF and UKF run under ``torch.func.vmap`` over trials; the flows through
``run_trials`` (the pure step vmapped over trials, the triggered trials
resampled together in one launch of kernel B2 a step). Each filter runs once
at T = 2 to warm up, then once timed: wall seconds for all trials, ending in
a sync. Sizes are arguments, so the CPU tests run the column at a toy size.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from particle_filters_tpu_torch.core.linalg import mvn_logpdf_chol
from particle_filters_tpu_torch.core.structs import stack_states
from particle_filters_tpu_torch.models import (
    EDHConfig,
    EDHFlowPF,
    ExtendedKalmanFilter,
    GaussianTracker,
    LEDHConfig,
    LEDHFlowPF,
    UnscentedKalmanFilter,
    kalman_filter_general,
    make_ukf_state,
)
from particle_filters_tpu_torch.ops.resample import resample_by_starts
from particle_filters_tpu_torch.simulators.sensor_network_lg import make_grid_coords, se_kernel_cov
from particle_filters_tpu_torch.utils.timing import card_line, profile_device, sync

D, T, TRIALS, SZ, AL = 64, 50, 100, 2.0, 0.9
N_LAMBDA = 4  # the flows' λ-steps
# The JAX package's MSEs at this column (benchmarks/results.json, results.snlg_d64).
JAX_MSE = {"kf": 0.49578049778938293, "kf_sz1": 0.19176240265369415,
           "ukf": 0.49578049778938293, "edh200": 0.6473208069801331,
           "ledh200": 0.6485439538955688, "edh10000": 0.5348185300827026}
# Each row's MSE is held within this relative band of JAX_MSE: the Kalman
# rows are deterministic given the data, the flows sampled.
MSE_RTOL = {"kf": 1e-3, "kf_sz1": 1e-3, "ukf": 1e-3,
            "edh200": 0.05, "ledh200": 0.05, "edh10000": 0.05}
# (tag, filter, particles): bench_snlg's three flow rows.
FLOWS = (("edh200", "edh", 200), ("ledh200", "ledh", 200), ("edh10000", "edh", 10000))
PROFILE_STEPS = 5  # the steps of a profiled flow run


def make_data(trials: int = TRIALS, steps: int = T, d: int = D):
    """Σ (d, d) f32 and the (X, Z) blocks at σ_z = 2 then σ_z = 1, numpy f32,
    X (trials, steps + 1, d) with X[:, 0] = 0, Z (trials, steps, d): the
    seed-123 PCG64 stream of ``bench_snlg``."""
    Sigma = se_kernel_cov(make_grid_coords(d, device="cpu"), 3.0, 20.0, 0.01)
    L = np.linalg.cholesky(Sigma.numpy().astype(np.float64))
    rng = np.random.default_rng(123)

    def block(sz):
        X = np.zeros((trials, steps + 1, d))
        Z = np.zeros((trials, steps, d))
        for r in range(trials):
            x = np.zeros(d)
            for t in range(1, steps + 1):
                x = AL * x + L @ rng.standard_normal(d)
                X[r, t] = x
                Z[r, t - 1] = x + sz * rng.standard_normal(d)
        return X.astype(np.float32), Z.astype(np.float32)

    return Sigma.numpy(), block(SZ), block(1.0)


def _timed(fn, warm, device):
    """``warm()`` once, then ``fn()`` timed to a sync: (seconds, result)."""
    warm()
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def _kf(Z, Sigma, sz, device):
    d = Sigma.shape[0]
    I = torch.eye(d, device=device)
    return torch.func.vmap(lambda z: kalman_filter_general(
        z, AL * I, I, I, Sigma, sz**2 * I, x0=torch.zeros(d, device=device), P0=Sigma,
        device=device).x_filt)(Z)


def _ukf(Z, Sigma, device):
    d = Sigma.shape[0]
    ukf = UnscentedKalmanFilter(lambda x, u: AL * x, lambda x: x, Sigma,
                                SZ**2 * torch.eye(d, device=device), alpha=1.0, device=device)
    return torch.func.vmap(lambda z: ukf.run(
        make_ukf_state(torch.zeros(d, device=device), Sigma, device=device), z)[1])(Z)


def make_flow(kind: str, n_particles: int, Sigma, device, group=None):
    """bench_snlg's flow filter of ``kind`` ("edh" | "ledh") with an EKF
    tracker (on a rank of ``group`` when given), and its process-noise
    sampler."""
    d = Sigma.shape[0]
    I = torch.eye(d, device=device)
    R = SZ**2 * I
    LQ = torch.linalg.cholesky(Sigma + 1e-6 * I)
    LR = SZ * I
    tracker = GaussianTracker(ExtendedKalmanFilter(lambda x, u: AL * x, lambda x: x, Sigma, R,
                                                   device=device))
    args = (tracker, lambda x, u, v: AL * x + v, lambda x: x, lambda x: I,
            lambda xn, xo: mvn_logpdf_chol(xn, AL * xo, LQ),
            lambda z, x: mvn_logpdf_chol(z, x, LR), R)
    if kind == "edh":
        filt = EDHFlowPF(*args, EDHConfig(n_particles=n_particles, n_lambda_steps=N_LAMBDA),
                         device=device, group=group)
    else:
        filt = LEDHFlowPF(*args, LEDHConfig(n_particles=n_particles, n_lambda_steps=N_LAMBDA,
                                            resample_ess_ratio=0.5), device=device,
                          group=group)

    def noise(gen, n, nx):
        return torch.randn((n, nx), generator=gen, device=device) @ LQ.T

    return filt, noise


def run_flow(filt, noise, Z, Sigma, generator):
    """All trials of Z (B, T, d) through ``filt.run_trials`` from
    N(0, Σ) clouds: (history, B2 launches). B2's count is set to 0 just
    before ``run_trials`` and read just after; so is
    ``LEDHFlowPF.operator_applies``, which the caller reads."""
    d, B = Sigma.shape[0], Z.shape[0]
    zeros = torch.zeros(d, device=Z.device)
    states = stack_states([filt.init_from_gaussian(generator, zeros, Sigma) for _ in range(B)])
    tracks = stack_states([filt.tracker.init(zeros, Sigma)] * B)
    resample_by_starts.launches = LEDHFlowPF.operator_applies = 0
    _, _, hist = filt.run_trials(generator, states, tracks, Z, process_noise_sampler=noise)
    return hist, resample_by_starts.launches


def print_profile(label, fn, card="", top: int = 5):
    """``fn()`` once on the card under the profiler: its device busy share
    and top device ops, printed."""
    prof = profile_device(fn, top)
    print(f"profiled {label}: device busy {prof.busy_ms:.3f} ms of {prof.wall_ms:.3f} ms wall "
          f"({prof.busy_ms / prof.wall_ms:.3f})  [{card}]")
    for ms, calls, name in prof.top:
        print(f"  {ms:10.3f} ms  x{calls:<6d} {name[:90]}")


def run_column(device="cuda", trials: int = TRIALS, steps: int = T, d: int = D,
               flows=FLOWS, profile=()):
    """The column at the given sizes: ``{tag: {...}}`` with ``total_s``,
    ``ms_per_trial_step`` and ``mse`` for every filter, ``resampled`` (the
    trial-steps that resampled), ``resample_steps`` (steps with any) and
    ``b2_launches`` for the flows, ``operator_applies`` for LEDH
    (``LEDHFlowPF.operator_applies`` over the timed run), and for the tags
    in ``profile`` a ``PROFILE_STEPS``-step run under the profiler (on the
    card): its wall ms, the card's busy ms (the union of its device
    intervals) and ``top_ops``."""
    device = torch.device(device)
    Sigma_np, (X2, Z2), (X1, Z1) = make_data(trials, steps, d)
    Sigma = torch.as_tensor(Sigma_np, device=device)
    X2, Z2, X1, Z1 = (torch.as_tensor(a, device=device) for a in (X2, Z2, X1, Z1))
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}

    def record(tag, secs, means, X):
        out[tag] = {"total_s": secs, "ms_per_trial_step": secs / (trials * steps) * 1e3,
                    "mse": torch.mean((means - X[:, 1:]) ** 2).item()}

    for tag, sz, X, Z in (("kf", SZ, X2, Z2), ("kf_sz1", 1.0, X1, Z1)):
        secs, means = _timed(lambda: _kf(Z, Sigma, sz, device),
                             lambda: _kf(Z[:, :2], Sigma, sz, device), device)
        record(tag, secs, means, X)
    secs, means = _timed(lambda: _ukf(Z2, Sigma, device),
                         lambda: _ukf(Z2[:, :2], Sigma, device), device)
    record("ukf", secs, means, X2)
    for tag, kind, n in flows:
        filt, noise = make_flow(kind, n, Sigma, device)
        secs, (hist, launches) = _timed(lambda: run_flow(filt, noise, Z2, Sigma, gen),
                                        lambda: run_flow(filt, noise, Z2[:, :2], Sigma, gen),
                                        device)
        record(tag, secs, hist["mean"], X2)
        out[tag].update(resampled=int(hist["resampled"].sum()),
                        resample_steps=int(hist["resampled"].any(dim=0).sum()),
                        b2_launches=launches)
        if kind == "ledh":
            out[tag]["operator_applies"] = LEDHFlowPF.operator_applies
        if tag in profile:
            prof = profile_device(
                lambda: run_flow(filt, noise, Z2[:, :PROFILE_STEPS], Sigma, gen))
            out[tag].update(profile_steps=PROFILE_STEPS, profile_wall_ms=prof.wall_ms,
                            profile_device_ms=prof.busy_ms, top_ops=prof.top)
    return out


def gates(res) -> dict:
    """``{gate: (value, held)}``: each row's MSE within ``MSE_RTOL`` of the
    JAX package's."""
    return {f"{tag} MSE within {MSE_RTOL[tag]} of the JAX package's {JAX_MSE[tag]}": (
        r["mse"], abs(r["mse"] - JAX_MSE[tag]) <= MSE_RTOL[tag] * JAX_MSE[tag])
        for tag, r in res.items()}


def print_column(res, card: str, trials: int = TRIALS, steps: int = T) -> None:
    for tag, r in res.items():
        extra = ""
        if "b2_launches" in r:
            extra = (f", resampled {r['resampled']} of {trials * steps} trial-steps "
                     f"({r['resample_steps']} steps with any), B2 launches {r['b2_launches']}")
        if "operator_applies" in r:
            extra += f", operator applies {r['operator_applies']}"
        print(f"SNLG {tag:9s}: {r['total_s']:.4f} s for {trials} trials, "
              f"{r['ms_per_trial_step']:.4f} ms/trial-step, MSE {r['mse']:.5f} "
              f"(JAX {JAX_MSE[tag]:.5f}){extra}  [{card}]")
        if "top_ops" in r:
            print(f"  profiled {r['profile_steps']}-step run: device busy "
                  f"{r['profile_device_ms']:.3f} ms of {r['profile_wall_ms']:.3f} ms wall "
                  f"({r['profile_device_ms'] / r['profile_wall_ms']:.3f}); top device ops:")
        for ms, count, key in r.get("top_ops", []):
            print(f"    {ms:9.3f} ms  x{count:<6d} {key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("snlg needs a CUDA device.", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print_column(run_column("cuda", profile=("edh10000", "ledh200")), card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
