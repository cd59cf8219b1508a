#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds both hand-written kernels from the sources in this checkout (B2 with
nvcc into build/torch_kernels/, B1 by Triton), holds each against its plain
PyTorch version on the card at N = 2^20, runs the SIR filter on the 1-D
stochastic-volatility model (alpha=0.95, sigma=0.2, beta=1; N = 2^20, T = 200,
systematic resampling when ESS < N/2) through ``FusedSIRFilter`` and through
the general ``ParticleFilter``, checks their results and that the main path
launched both kernels, and times the kernels against their plain versions.

Every phase raises on failure, so the exit code is non-zero. Without a CUDA
device it exits non-zero at once. The last three lines of standard output are
the kernels' JSON line, the card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import time

import torch

from particle_filters_tpu_torch.models import ParticleFilter
from particle_filters_tpu_torch.ops import resample as b2
from particle_filters_tpu_torch.ops.fused_pf import (
    FusedSIRFilter,
    LinearObsFirstModel,
    SVModel,
    _combine_partials,
    fused_step,
    fused_step_reference,
)
from particle_filters_tpu_torch.resampling.hard import _systematic_starts
from particle_filters_tpu_torch.simulators import simulate_sv_1d

N = 1 << 20
T = 200
ALPHA, SIGMA, BETA = 0.95, 0.2, 1.0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
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
def _b2_cases(gen, n, device):
    """(label, weights) at the regimes of the TPU kernel's three tiers."""
    z = torch.randn(n, generator=gen, device=device)
    for sigma in (0.5, 2.0, 6.0):
        yield f"lognormal sigma={sigma}", torch.softmax(sigma * z, 0)
    mass = torch.zeros(n, device=device)
    mass[n // 3] = 1.0
    yield "point mass", mass


def check_b2(gen, n, device) -> float:
    """B2 against its plain version: equal bit for bit (both copy values)."""
    max_err = 0.0
    for label, w in _b2_cases(gen, n, device):
        starts = _systematic_starts(gen, w, n)
        for d in (1, 3):
            p = torch.randn((n, d), generator=gen, device=device)
            out = b2.resample_by_starts(p, starts)
            ref = b2.resample_by_starts_reference(p, starts)
            max_err = max(max_err, (out - ref).abs().max().item())
            _check(torch.equal(out, ref), f"B2 == plain bit for bit ({label}, d={d})")
            print(f"B2 {label:22s} d={d}: equal to plain (N={n})")
    return max_err


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


def _moments(part, nx):
    log_z, ess, mean, exx = _combine_partials(part, nx)
    cov = exx.reshape(nx, nx) - torch.outer(mean, mean)
    return torch.cat([log_z[None], ess[None], mean, cov.reshape(-1)])


def check_b1(gen, n, device) -> float:
    """Injected ε: B1 against its plain version. Drawn ε: normal statistics."""
    max_err = 0.0
    for model, Q in ((SVModel(ALPHA, BETA), [[SIGMA**2]]), (LinearObsFirstModel(A2, 0.1), Q2)):
        nx = model.nx
        for uniform in (False, True):
            f, x, lw, off_u, z = _b1_inputs(gen, model, Q, n, device, uniform)
            eps = torch.randn((nx, n), generator=gen, device=device)
            xk, lwk, pk = fused_step(x, lw, off_u, z, f.Lq, f.params, model, seed=1, eps=eps)
            xr, lwr, pr = fused_step_reference(x, lw, off_u, z, eps, f.Lq, model)
            # Triton's exp/log and its reduction order differ from torch's.
            torch.testing.assert_close(xk, xr, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(lwk, lwr, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(_moments(pk, nx), _moments(pr, nx), rtol=1e-4, atol=1e-6)
            err = max((xk - xr).abs().max().item(), (lwk - lwr).abs().max().item())
            max_err = max(max_err, err)
            print(f"B1 nx={nx} uniform={uniform}: max |kernel - plain| = {err:.3e} (N={n})")

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
    fused_step.launches = 0
    b2.resample_by_starts.launches = 0
    _, hist = f.run(gen, state0, zs)
    counts = {"B1": fused_step.launches, "B2": b2.resample_by_starts.launches}
    rmse, frac = _check_history(hist, sv, "fused")
    n_res = int(hist["resampled"].sum())
    print(f"fused SV run N={n} T={T}: sv_rmse {rmse:.4f}, resample_frac {frac:.3f}, "
          f"launches {counts}")
    if device.type == "cuda":
        _check(counts["B1"] == T, f"B1 launched {counts['B1']} times, want {T}")
        _check(counts["B2"] == n_res > 0, f"B2 launched {counts['B2']} times, want {n_res} > 0")

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


def time_kernels(gen, n, device, card):
    """Each kernel and its plain version at N = 2^20, in turns (kernel,
    plain, plain, kernel): device time from CUDA-graph replay, and the eager
    per-call time that includes the Python wrapper. Eight input sets are
    cycled so that a launch finds its inputs out of the 50 MB L2."""
    sets = 8
    model = SVModel(ALPHA, BETA)
    f, *_ = _b1_inputs(gen, model, [[SIGMA**2]], n, device, False)
    b1_in = [_b1_inputs(gen, model, [[SIGMA**2]], n, device, False)[1:] for _ in range(sets)]
    it = iter(range(10**9))

    def b1_kernel():
        x, lw, off_u, z = b1_in[next(it) % sets]
        fused_step(x, lw, off_u, z, f.Lq, f.params, model, seed=7)

    def b1_plain():  # the plain step draws its normals too (default generator)
        x, lw, off_u, z = b1_in[next(it) % sets]
        eps = torch.randn(x.shape, device=device)
        fused_step_reference(x, lw, off_u, z, eps, f.Lq, model)

    w = torch.softmax(2.0 * torch.randn(n, generator=gen, device=device), 0)
    b2_in = [(torch.randn((n, 1), generator=gen, device=device), _systematic_starts(gen, w, n))
             for _ in range(sets)]

    def b2_kernel():
        b2.resample_by_starts(*b2_in[next(it) % sets])

    def b2_plain():
        b2.resample_by_starts_reference(*b2_in[next(it) % sets])

    out = {}
    for name, kern, plain, nbytes in (
        ("B1", b1_kernel, b1_plain, 4 * n * 4),  # x, lw in; x', lw' out
        ("B2", b2_kernel, b2_plain, 3 * n * 4),  # starts, p in; out
    ):
        dev = [_graph_ms(kern), _graph_ms(plain), _graph_ms(plain), _graph_ms(kern)]
        ms, plain_ms = (dev[0] + dev[3]) / 2, (dev[1] + dev[2]) / 2
        eager = [_time_ms(kern), _time_ms(plain), _time_ms(plain), _time_ms(kern)]
        share = nbytes / (ms * 1e-3) / HBM_BYTES_PER_S
        out[name] = (ms, plain_ms)
        print(f"{name} at N={n}: device kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
              f"eager per call kernel {(eager[0] + eager[3]) / 2:.4f} ms, "
              f"plain {(eager[1] + eager[2]) / 2:.4f} ms; {nbytes / 2**20:.0f} MiB "
              f"moved -> {share:.3f} of 3.35 TB/s  [{card}]")
    return out


def time_fused_run(n, card, fused_run) -> None:
    """Wall time of the whole fused run, and what the card spent it on."""
    filt, gen, state0, zs = fused_run
    run_ms = _time_ms(lambda: filt.run(gen, state0, zs), reps=1)
    print(f"fused SV run N={n} T={T}: {run_ms / T:.4f} ms/step, "
          f"{n * T / (run_ms * 1e-3):.4e} particle-steps/s  [{card}]")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        filt.run(gen, state0, zs)
        torch.cuda.synchronize()
    # Kernel records only: an operator's record repeats its kernels' time.
    rows = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        print("fused run device breakdown: not measured (profiler saw no device time)")
        return
    print(f"fused run device busy {busy_ms:.3f} ms of {run_ms:.3f} ms wall "
          f"({busy_ms / run_ms:.3f}; unprofiled wall)  [{card}]")
    ported_ms = 0.0
    for label, kernel in (("B1", "_fused_step_kernel"), ("B2", "resample_by_starts_kernel")):
        hits = [r for r in rows if kernel in r[2]]
        ms, count = sum(r[0] for r in hits) / 1e3, sum(r[1] for r in hits)
        ported_ms += ms
        print(f"  {label} {kernel}: {ms:.3f} ms device time, x{count}")
    print(f"  torch ops around the kernels: {busy_ms - ported_ms:.3f} ms device time")
    for us, count, key in sorted(rows, reverse=True)[:8]:
        print(f"  {us / 1e3:8.3f} ms  x{count:<5d} {key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device; the port's kernels run only on a GPU.")
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

    t0 = time.perf_counter()
    b2._library()
    print(f"B2 nvcc build+load {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for model, Q in ((SVModel(ALPHA, BETA), [[SIGMA**2]]), (LinearObsFirstModel(A2, 0.1), Q2)):
        _, x, lw, off_u, z = _b1_inputs(gen, model, Q, 4096, device, False)
        f = FusedSIRFilter(model, Q, Np=4096, device=device)
        for eps in (None, torch.randn(x.shape, generator=gen, device=device)):
            fused_step(x, lw, off_u, z, f.Lq, f.params, model, seed=3, eps=eps)
    torch.cuda.synchronize()
    print(f"B1 Triton compile (2 models x 2 variants) {time.perf_counter() - t0:.2f} s")

    b2_err = check_b2(gen, N, device)
    b1_err = check_b1(gen, N, device)
    torch.cuda.synchronize()

    counts, fused_run = run_main_path(N, device)
    times = time_kernels(gen, N, device, card)
    time_fused_run(N, card, fused_run)

    kernels = [
        {"name": "B1 fused SIR propagate-and-weight step", "route": "triton",
         "source": "particle_filters_tpu_torch/ops/_fused_pf_triton.py",
         "replaces": "particle_filters_tpu/ops/fused_pf.py:63",
         "launches": counts["B1"], "max_abs_err": b1_err,
         "ms": times["B1"][0], "plain_ms": times["B1"][1]},
        {"name": "B2 systematic resample values", "route": "cuda",
         "source": "particle_filters_tpu_torch/csrc/systematic_resample.cu",
         "replaces": "particle_filters_tpu/ops/resample_pallas.py:99",
         "launches": counts["B2"], "max_abs_err": b2_err,
         "ms": times["B2"][0], "plain_ms": times["B2"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
