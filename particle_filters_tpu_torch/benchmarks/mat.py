"""The MAT column: EDH, LEDH, EKF and UKF on multi-target acoustic
tracking — the port's twin of ``benchmarks/run_benchmarks.py::bench_mat_flows``.

    python -m particle_filters_tpu_torch.benchmarks.mat

Full width: 4 targets, a joint CV state nx = 16, a 5×5 sensor grid, T = 40,
N = 500 particles. The data is ``bench_mat_flows``'s: the JAX package's
``simulate_acoustic_dataset(MATScenarioConfig(n_steps=40, seed=7))``, its
noisy observations ``zs = Z + 0.1·ε`` and jittered start ``x0`` (key 0),
written once on the CPU into ``data/mat_t40.npz``
(``tests/test_torch_mat.py`` regenerates it and holds it equal). The model:
F and Q block-diagonal over the targets, LQ = chol(Q + 1e-8 I), R = 0.01 I,
h the acoustic amplitudes of the targets' positions with its full Jacobian
from ``torch.func.jacfwd``, an EKF tracker (jitter 1e-5); EDH by Euler at
its default config (8 λ-steps, resampling at ESS < N/2), LEDH at its
default (``resample_ess_ratio = 0``: it never resamples); the EKF (jitter
1e-5) and UKF (alpha = 0.5, jitter 1e-5) rows. Accuracy is the average
OMAT over every 5th step.

The flows' OMATs are sensitive to numerics (the reference's LEDH moved from
8.02 to 4.95 under numerics alone), so each flow runs S = 16 seeds of the
same data as 16 trials of one ``run_trials`` call and the column reports
their median and quartiles, held against the JAX package's own quartiles
over 16 flow keys. B2 is counted per flow.
"""

from __future__ import annotations

import math
import pathlib
import statistics
import sys

import numpy as np
import torch

from particle_filters_tpu_torch.benchmarks.snlg import _timed
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
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_tpu_torch.models.extended_kalman_filter import _jacfwd
from particle_filters_tpu_torch.ops.resample import resample_by_starts
from particle_filters_tpu_torch.simulators.acoustic_tracking import (
    acoustic_measurement_model,
    article_process_noise_cov,
    build_cv_transition,
)
from particle_filters_tpu_torch.utils.timing import card_line, sync

DATA = pathlib.Path(__file__).resolve().parent / "data" / "mat_t40.npz"
C, NX, T, N = 4, 16, 40, 500
SEEDS = 16
PSI, D0 = 10.0, 0.1
OMAT_EVERY = 5
# The JAX package on the committed data, on the CPU, written by
# ``python tests/test_torch_mat.py``: the EKF's and UKF's average OMAT
# (deterministic given the data) and each flow's OMATs over flow keys 0-15,
# and their quartiles. TPU_OMAT is ``benchmarks/results.json`` →
# ``results.mat_flows`` (flow key 0), for reference.
JAX_OMAT = {"ekf": 8.23882982253344, "ukf": 10.840275703273411}
# The largest relative change of those two OMATs when the observations move
# by one ulp (four seeded ±1 patterns): the EKF's S = HPHᵀ + R is ill
# conditioned, so its f32 OMAT is only defined to ~2e-3.
JAX_ULP_SPREAD = {"ekf": 0.0023640985416418514, "ukf": 9.295032888386485e-05}
JAX_FLOW_OMATS = {
    "edh": [
        6.294279459426695, 6.030791884467783, 6.112058319604776, 6.487564171581063,
        6.111134075169415, 5.765574202264132, 5.977506837264571, 6.248103821378623,
        6.229115067229092, 6.114439096004797, 6.025606054009941, 6.1615552077717926,
        5.952092712798012, 6.061311526095229, 5.899502053012133, 5.8090688000190145],
    "ledh": [
        8.617105429371971, 8.970921819019896, 8.703500548219884, 8.816755234410788,
        14.580236460509028, 10.733554004377442, 9.805088596691007, 7.096229065952847,
        5.616503112484985, 9.630235019113027, 7.3080896508649325, 11.57366235515121,
        15.238494259758328, 6.918985055726938, 8.72987014712639, 10.37577731981625],
}
JAX_FLOW_QUARTILES = {tag: tuple(float(q) for q in np.percentile(v, [25, 50, 75]))
                      for tag, v in JAX_FLOW_OMATS.items()}
TPU_OMAT = {"edh": 7.536189448190656, "ledh": 4.946726765776827,
            "ekf": 11.36899105788106, "ukf": 10.929370502015786}
FLOWS = ("edh", "ledh")


def kalman_rtol(tag: str) -> float:
    """The relative band of the EKF's or UKF's OMAT around ``JAX_OMAT``:
    1e-3, or twice the JAX package's own one-ulp spread where that is wider."""
    return max(1e-3, 2.0 * JAX_ULP_SPREAD[tag])


def load_data(device, path=DATA):
    """The data as f32 tensors: P (T, C, 2) true positions, S (sensors, 2),
    zs (T, sensors) noisy observations, x0 (16,) the filters' start."""
    with np.load(str(path)) as f:
        return {k: torch.as_tensor(f[k], dtype=torch.float32, device=device)
                for k in ("P", "S", "zs", "x0")}


def model(sensors):
    """(F, Q, LQ, R, LR, h) of the joint 16-dimensional state."""
    device = sensors.device
    eye_c = torch.eye(C, device=device)
    F = torch.kron(eye_c, build_cv_transition(1.0, device))
    Q = torch.kron(eye_c, article_process_noise_cov(device))
    LQ = torch.linalg.cholesky(Q + 1e-8 * torch.eye(NX, device=device))
    nz = sensors.shape[0]
    R = 0.01 * torch.eye(nz, device=device)
    LR = 0.1 * torch.eye(nz, device=device)

    def h(x):
        pos = x.reshape(C, 4)[:, :2]
        return acoustic_measurement_model(pos[None], sensors, PSI, D0)[0]

    return F, Q, LQ, R, LR, h


def avg_omat(means, P) -> float:
    """The mean over every ``OMAT_EVERY``-th step of the OMAT of the
    estimated positions (means (T, 16)) against the truth P (T, C, 2)."""
    from particle_filters_tpu_torch.utils.diagnostics import omat

    est, tru = means.detach().cpu().double().numpy(), P.detach().cpu().double().numpy()
    return float(np.mean([omat(est[t].reshape(C, 4)[:, :2], tru[t])
                          for t in range(0, means.shape[0], OMAT_EVERY)]))


def make_flow(kind: str, n_particles: int, sensors):
    """bench_mat_flows's flow of ``kind`` ("edh" | "ledh") with an EKF
    tracker, and its process-noise sampler."""
    device = sensors.device
    F, Q, LQ, R, LR, h = model(sensors)
    tracker = GaussianTracker(ExtendedKalmanFilter(lambda x, u: F @ x, h, Q, R, jitter=1e-5,
                                                   device=device))
    args = (tracker, lambda x, u, v: F @ x + v, h, _jacfwd(h),
            lambda xn, xo: mvn_logpdf_chol(xn, F @ xo, LQ),
            lambda z, x: mvn_logpdf_chol(z, h(x), LR), R)
    if kind == "edh":
        filt = EDHFlowPF(*args, EDHConfig(n_particles=n_particles, flow_integrator="euler"),
                         device=device)
    else:
        filt = LEDHFlowPF(*args, LEDHConfig(n_particles=n_particles), device=device)

    def noise(gen, n, nx):
        return torch.randn((n, nx), generator=gen, device=device) @ LQ.T

    return filt, noise


def run_flow(filt, noise, zs, x0, seeds, generator):
    """``seeds`` runs of one data set (zs (T, nz)) as trials of one
    ``run_trials`` call, from N(x0, I) clouds: (history, B2 launches). B2's
    count is set to 0 just before ``run_trials`` and read just after."""
    eye = torch.eye(x0.shape[0], device=x0.device)
    states = stack_states([filt.init_from_gaussian(generator, x0, eye) for _ in range(seeds)])
    tracks = stack_states([filt.tracker.init(x0, eye)] * seeds)
    resample_by_starts.launches = 0
    _, _, hist = filt.run_trials(generator, states, tracks,
                                 zs[None].expand(seeds, *zs.shape).contiguous(),
                                 process_noise_sampler=noise)
    return hist, resample_by_starts.launches


def _kalman_means(kind, data):
    sensors, x0 = data["S"], data["x0"]
    F, Q, _, R, _, h = model(sensors)
    eye = torch.eye(NX, device=x0.device)
    if kind == "ekf":
        filt = ExtendedKalmanFilter(lambda x, u: F @ x, h, Q, R, jitter=1e-5, device=x0.device)
        return filt.run(make_ekf_state(x0, eye, device=x0.device), data["zs"])[1]
    filt = UnscentedKalmanFilter(lambda x, u: F @ x, h, Q, R, alpha=0.5, jitter=1e-5,
                                 device=x0.device)
    return filt.run(make_ukf_state(x0, eye, device=x0.device), data["zs"])[1]


def flow_omats(tag, generator, data, seeds: int = SEEDS, n_particles: int = N):
    """Flow ``tag``'s average OMAT for each of ``seeds`` seeds drawn from
    ``generator``, in one ``run_trials`` call: (OMATs, history, B2
    launches)."""
    filt, noise = make_flow(tag, n_particles, data["S"])
    hist, launches = run_flow(filt, noise, data["zs"], data["x0"], seeds, generator)
    return [avg_omat(hist["mean"][b], data["P"]) for b in range(seeds)], hist, launches


def rank_test(a, b):
    """The Mann-Whitney U of sample ``a`` against sample ``b`` and its
    two-sided p-value by the normal approximation (tied values take their
    mean rank): whether ``a`` sits above or below ``b``."""
    pooled = sorted([(v, 0) for v in a] + [(v, 1) for v in b])
    ranks, i = [0.0] * len(pooled), 0
    while i < len(pooled):
        j = i
        while j + 1 < len(pooled) and pooled[j + 1][0] == pooled[i][0]:
            j += 1
        for k in range(i, j + 1):
            ranks[k] = (i + j) / 2 + 1
        i = j + 1
    n1, n2 = len(a), len(b)
    u = sum(r for r, (_, side) in zip(ranks, pooled) if side == 0) - n1 * (n1 + 1) / 2
    z = (u - n1 * n2 / 2) / math.sqrt(n1 * n2 * (n1 + n2 + 1) / 12)
    return u, math.erfc(abs(z) / math.sqrt(2))


def run_column(device="cuda", data=None, seeds: int = SEEDS, n_particles: int = N,
               flows=FLOWS):
    """The column on ``data`` (the committed file when None): ``{tag: {...}}``
    with ``total_s`` and ``omat`` for the EKF and UKF, and for each flow
    ``omats`` (one average OMAT a seed), ``median``, ``q1``, ``q3``,
    ``total_s`` (all seeds), ``resampled`` (trial-steps), ``resample_steps``
    (steps with any), ``b2_launches`` and ``finite`` (the whole history)."""
    device = torch.device(device)
    data = load_data(device) if data is None else data
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for tag in ("ekf", "ukf"):
        cut = {**data, "zs": data["zs"][:2]}
        secs, means = _timed(lambda: _kalman_means(tag, data), lambda: _kalman_means(tag, cut),
                             device)
        out[tag] = {"total_s": secs, "omat": avg_omat(means, data["P"])}
    for tag in flows:
        filt, noise = make_flow(tag, n_particles, data["S"])
        run_flow(filt, noise, data["zs"][:1], data["x0"], seeds, gen)  # warm-up
        sync(device)
        secs, (hist, launches) = _timed(
            lambda: run_flow(filt, noise, data["zs"], data["x0"], seeds, gen), lambda: None,
            device)
        omats = [avg_omat(hist["mean"][b], data["P"]) for b in range(seeds)]
        q1, med, q3 = statistics.quantiles(omats, n=4) if seeds > 1 else omats * 3
        out[tag] = {"total_s": secs, "omats": omats, "median": statistics.median(omats),
                    "q1": q1, "q3": q3, "resampled": int(hist["resampled"].sum()),
                    "resample_steps": int(hist["resampled"].any(dim=0).sum()),
                    "b2_launches": launches,
                    "finite": all(bool(torch.isfinite(v.float()).all()) for v in hist.values())}
    return out


def gates(res) -> dict:
    """``{gate: (value, held)}``: the EKF's and UKF's OMAT within
    ``kalman_rtol`` of the JAX package's; each flow's history finite, its
    median OMAT inside the JAX package's quartiles, and below each Kalman
    row's where the JAX package's median is below that row's (where it is
    not, the comparison is listed as not made, value None, held)."""
    out = {}
    for tag in ("ekf", "ukf"):
        want, rtol = JAX_OMAT[tag], kalman_rtol(tag)
        out[f"{tag} OMAT within {rtol:.3g} of the JAX package's {want}"] = (
            res[tag]["omat"], abs(res[tag]["omat"] - want) <= rtol * want)
    for tag in FLOWS:
        r, (q1, jmed, q3) = res[tag], JAX_FLOW_QUARTILES[tag]
        out[f"{tag} finite history"] = (r["finite"], r["finite"])
        out[f"{tag} median OMAT inside the JAX package's quartiles [{q1}, {q3}]"] = (
            r["median"], q1 <= r["median"] <= q3)
        for kf in ("ekf", "ukf"):
            if jmed < JAX_OMAT[kf]:  # the table's finding, where the JAX package shows it
                out[f"{tag} median OMAT below the {kf}'s"] = (
                    r["median"], r["median"] < res[kf]["omat"])
            else:
                out[f"{tag} median OMAT below the {kf}'s: not compared, the JAX package's "
                    f"median {jmed:.4f} is not below its {kf} OMAT {JAX_OMAT[kf]:.4f}"] = (
                    None, True)
    return out


def print_column(res, card: str) -> None:
    for tag, r in res.items():
        if "omats" in r:
            jq = JAX_FLOW_QUARTILES.get(tag)
            ref = "" if jq is None else f" (JAX CPU quartiles {jq[0]:.4f} / {jq[1]:.4f} / {jq[2]:.4f})"
            print(f"MAT {tag:4s}: {r['total_s']:.4f} s for {len(r['omats'])} seeds, OMAT median "
                  f"{r['median']:.4f}, quartiles {r['q1']:.4f} - {r['q3']:.4f}{ref}, resampled "
                  f"{r['resampled']} trial-steps ({r['resample_steps']} steps with any), "
                  f"B2 launches {r['b2_launches']}  [{card}]")
        else:
            want = JAX_OMAT.get(tag)
            ref = "" if want is None else f" (JAX CPU {want:.5f})"
            print(f"MAT {tag:4s}: {r['total_s']:.4f} s, OMAT {r['omat']:.5f}{ref}  [{card}]")
    for gate, (value, _) in gates(res).items():
        if value is None:
            print(f"MAT {gate}")


def main() -> int:
    if not torch.cuda.is_available():
        print("mat needs a CUDA device.", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print_column(run_column("cuda"), card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
