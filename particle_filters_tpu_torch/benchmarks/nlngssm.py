"""``bench_nlngssm_flows``'s column on the port: EDH (RK4) and LEDH at
N = 500 with 10 λ-steps and a UKF tracker, and the kernel PF (one
analysis a step, at most 20 pseudo-steps), on the SV model (α 0.95, σ 0.2,
β 1) with the zero observation function and the true SV likelihood in the
weights, T = 1000 (the reference notebook's setup). With the zero
observation function the flows move nothing (H = 0: A = 0, b = 0), so EDH
and LEDH are a particle filter weighted by the SV likelihood, and the JAX
package's two rows coincide key for key.

    python -m particle_filters_tpu_torch.benchmarks.nlngssm

The data is the first 1000 steps of ``data/sv_t2000.npz`` (the JAX
package's seed-42 trajectory), which holds the JAX package's RMSEs of each
filter over 8 keys, over T = 1000 and over the first ``T_CUT`` steps of
the same runs. Gate: the port's RMSEs over ``SEEDS`` seeds against the JAX
package's by the Welch test of ``benchmarks/_stats.py`` (p ≥ 1e-3).
``chip_smoke.py`` runs the first ``T_CUT`` steps (its time limit); this
module runs all 1000.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from particle_filters_tpu_torch.benchmarks._stats import P_MIN, summary, welch_z
from particle_filters_tpu_torch.benchmarks.snlg import _sync, card_line
from particle_filters_tpu_torch.benchmarks.sv_classic import (
    ALPHA,
    BETA,
    SIGMA,
    load_data,
    sv_obs_loglik,
)
from particle_filters_tpu_torch.core.structs import stack_states
from particle_filters_tpu_torch.models import (
    EDHConfig,
    EDHFlowPF,
    GaussianTracker,
    KernelParticleFilter,
    KPFConfig,
    LEDHConfig,
    LEDHFlowPF,
    Model,
    UnscentedKalmanFilter,
)

T, N, N_LAMBDA, KPF_MAX_STEPS = 1000, 500, 10, 20
T_CUT = 100
SEEDS = 8
R_NOM = BETA**2 * math.exp(0.5 * SIGMA**2 / (1 - ALPHA**2))
VAR0 = SIGMA**2 / (1 - ALPHA**2)
NAMES = ("edh", "ledh", "kpf")


def _h(x):
    return 0.0 * x[:1]  # the zero observation function (shaped by x, for vmap)


def _jh(x):
    return 0.0 * x[None, :1]


def make_flow(name: str, n: int, device):
    """The notebook's EDH (RK4) or LEDH (ESS-triggered resampling) with a
    UKF tracker, and its process-noise sampler."""
    Q, R = [[SIGMA**2]], [[R_NOM]]
    tracker = GaussianTracker(UnscentedKalmanFilter(lambda x, u: ALPHA * x, _h, Q, R,
                                                    alpha=0.5, device=device))
    args = (tracker, lambda x, u, v: ALPHA * x + v, _h, _jh,
            lambda xn, xo: -0.5 * ((xn[0] - ALPHA * xo[0]) ** 2 / SIGMA**2),
            lambda z, x: sv_obs_loglik(x, z), R)
    if name == "edh":
        filt = EDHFlowPF(*args, EDHConfig(n_particles=n, n_lambda_steps=N_LAMBDA,
                                          flow_integrator="rk4"), device=device)
    else:
        filt = LEDHFlowPF(*args, LEDHConfig(n_particles=n, n_lambda_steps=N_LAMBDA,
                                            resample_ess_ratio=0.5), device=device)
    return filt, lambda gen, m, nx: SIGMA * torch.randn((m, nx), generator=gen, device=device)


def run_flow(name, zs, n, seeds, device):
    """``seeds`` independent runs of EDH or LEDH, batched as trials of one
    ``run_trials`` call from one generator: the posterior means (seeds, T)."""
    filt, noise = make_flow(name, n, device)
    gen = torch.Generator(device=device).manual_seed(0)
    states = stack_states([filt.init_from_gaussian(gen, torch.zeros(1), [[VAR0]])
                           for _ in range(seeds)])
    tracks = stack_states([filt.tracker.init(torch.zeros(1), [[VAR0]])] * seeds)
    zs = zs[None].expand(seeds, *zs.shape).contiguous()
    return filt.run_trials(gen, states, tracks, zs, process_noise_sampler=noise)[2]["mean"][..., 0]


def run_kpf(zs, n, seed, device):
    """The notebook's KPF protocol: propagate, then one analysis a step:
    the ensemble means (T,)."""
    kpf = KernelParticleFilter(Model(H=_h, JH=_jh, R=torch.tensor([[R_NOM]], device=device)),
                               KPFConfig(max_steps=KPF_MAX_STEPS))
    gen = torch.Generator(device=device).manual_seed(seed)
    X = math.sqrt(VAR0) * torch.randn((n, 1), generator=gen, device=device)
    means = []
    for z in zs:
        X = ALPHA * X + SIGMA * torch.randn(X.shape, generator=gen, device=device)
        X = kpf.analyze(X, z).particles
        means.append(X.mean())
    return torch.stack(means)


def run_column(device="cuda", data=None, t=T, n=N, seeds=SEEDS, names=NAMES):
    """``{name: {"rmses", "s"}, "t": t}`` over the first ``t`` steps:
    ``seeds`` runs of each filter (the flows' batched as trials of one
    call, ``s`` its seconds; the KPF's one after another, ``s`` the first
    run's seconds)."""
    device = torch.device(device)
    data = load_data(device) if data is None else data
    X, zs = data["X"][:t], data["Y"][:t, None]
    out = {"t": t}
    for name in names:
        if name == "kpf":
            means, secs = [], []
            for seed in range(seeds):
                _sync(device)
                t0 = time.perf_counter()
                means.append(run_kpf(zs, n, seed, device))
                _sync(device)
                secs.append(time.perf_counter() - t0)
            means = torch.stack(means)
        else:
            _sync(device)
            t0 = time.perf_counter()
            means = run_flow(name, zs, n, seeds, device)
            _sync(device)
            secs = [time.perf_counter() - t0]
        out[name] = {"rmses": torch.sqrt(torch.mean((means - X) ** 2, dim=1)).tolist(),
                     "s": secs[0]}
    return out


def gates(res, data, cut=False):
    """``{name: (Welch p, P_MIN, held)}`` against the JAX package's 8 keys
    over T (``cut``: over its runs' first ``T_CUT`` steps)."""
    out = {}
    for name in NAMES:
        if name in res:
            ref = [float(v) for v in data[f"jax_{name}_rmse" + ("_cut" if cut else "")]]
            _, p = welch_z(res[name]["rmses"], *summary(ref))
            out[name] = (p, P_MIN, p >= P_MIN)
    return out


def print_column(res, data, card: str) -> None:
    t = res["t"]
    g = gates(res, data, cut=t == T_CUT)
    for name in NAMES:
        if name not in res:
            continue
        mean, sd, n = summary(res[name]["rmses"])
        ref = data[f"jax_{name}_rmse" + ("_cut" if t == T_CUT else "")]
        jm, jsd, jn = summary([float(v) for v in ref])
        print(f"nlngssm {name} N={N} T={t}: RMSE {mean:.4f} ± {sd:.4f} over {n} seeds (JAX "
              f"package {jm:.4f} ± {jsd:.4f}, {jn} keys), Welch p {g[name][0]:.4f}; "
              f"{res[name]['s']:.3f} s ({'a run' if name == 'kpf' else f'{n} runs batched'})"
              f"  [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("nlngssm needs a CUDA device.", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = load_data("cuda")
    print_column(run_column("cuda", data), data, card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
