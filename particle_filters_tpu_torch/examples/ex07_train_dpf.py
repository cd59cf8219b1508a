"""Learning an SSM parameter by gradient descent THROUGH the soft-resampling
DPF: the port's twin of ``examples/07_train_dpf.py``.

    python -m particle_filters_tpu_torch.examples.ex07_train_dpf [--device cpu]

Data: B = 8 sequences of T = 30 steps of x' = a·x + 0.3·v, y = x + 0.4·w
with the true a = 0.85, from x₀ = 0. The filter: ``DifferentiableParticleFilter``
(N = 64, mixture α = 0.2, Gumbel temperature 0.5) with the transition
a·x + 0.3·v, the loss the mean squared error of its weighted means against
the states. ``STEPS`` steps of SGD (rate 0.25) on a from 0.3, the gradient
by ``torch.autograd`` where the JAX script takes ``jax.value_and_grad``.
Each step draws new filter noise (the initial cloud, the transition's
normals, the Gumbel draws) from the generator, or takes given draws
(``draws=``: ``init_eps`` (B, N, 1), ``noise`` (T, B, N, 1), ``gumbel``
(T, B, N, N)), so a test can pass the JAX package's.

Gates: the loss decreases (the mean of the last 10 steps' losses below the
first step's), and the final a within ``A_K`` = 5 standard deviations of
the mean of the JAX package's final a over 8 keys (``JAX_FINAL_A``, its data
and draws a key; ``python tests/test_torch_ex07.py`` prints them).
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from particle_filters_tpu_torch.models.dpf import DifferentiableParticleFilter
from particle_filters_tpu_torch.utils.timing import card_line, resolve_device, sync

TRUE_A, SQ, SR = 0.85, 0.3, 0.4
B, T, N = 8, 30, 64
STEPS, LR, A0 = 60, 0.25, 0.3
SOFT_ALPHA, GUMBEL_TEMPERATURE = 0.2, 0.5
# The JAX script's final a for PRNGKey(k), k = 0..7 (its data and its draws).
JAX_FINAL_A = (0.9300463795661926, 0.8736100196838379, 0.7471081018447876,
               0.8884446024894714, 0.8747581839561462, 0.8678776621818542,
               0.9359944462776184, 0.9392811059951782)
A_K = 5.0


def a_tolerance():
    """(centre, half-width) of the final a's gate: the JAX keys' mean and
    ``A_K`` standard deviations."""
    return statistics.fmean(JAX_FINAL_A), A_K * statistics.stdev(JAX_FINAL_A)


def simulate(generator, device):
    """(X (B, T, 1), Y (B, T, 1), truth (B, T+1, 1) with x₀ = 0)."""
    v = torch.randn((T, 2, B, 1), generator=generator, device=device)
    x, xs, ys = torch.zeros((B, 1), device=device), [], []
    for t in range(T):
        x = TRUE_A * x + SQ * v[t, 0]
        xs.append(x)
        ys.append(x + SR * v[t, 1])
    X, Y = torch.stack(xs, 1), torch.stack(ys, 1)
    return X, Y, torch.cat([torch.zeros((B, 1, 1), device=device), X], 1)


def _transition(generator, p, params):
    noise = params.get("noise")
    if noise is None:
        noise = torch.randn(p.shape, generator=generator, dtype=p.dtype, device=p.device)
    return params["a"] * p + SQ * noise


def _loglik(p, y, params):
    return torch.sum(-0.5 * (y[:, None, :] - p) ** 2 / SR**2, dim=-1)


def make_dpf(device) -> DifferentiableParticleFilter:
    return DifferentiableParticleFilter(N, 1, _transition, _loglik, soft_alpha=SOFT_ALPHA,
                                        gumbel_temperature=GUMBEL_TEMPERATURE, device=device)


def loss_fn(dpf, a, generator, Y, truth, draws=None):
    """The tracking loss of one filter run at ``a`` (a tensor that may
    require grad)."""
    draws = draws or {}
    p, lw = dpf.init_particles(generator, Y.shape[0], torch.zeros(1), torch.eye(1),
                               eps=draws.get("init_eps"))
    ps, lws = [p], [lw]
    for t in range(Y.shape[1]):
        params = {"a": a, "noise": None if "noise" not in draws else draws["noise"][t]}
        p, lw = dpf.step(generator, p, lw, Y[:, t], params,
                         gumbel=None if "gumbel" not in draws else draws["gumbel"][t])
        ps.append(p)
        lws.append(lw)
    w = torch.softmax(torch.stack(lws, 1), dim=-1)
    means = torch.einsum("btn,btnd->btd", w, torch.stack(ps, 1))
    return torch.mean((means[:, 1:] - truth[:, 1:]) ** 2)


def value_and_grad(dpf, a: float, generator, Y, truth, draws=None):
    """(loss, ∂loss/∂a) as Python floats."""
    a_t = torch.tensor(a, device=Y.device, requires_grad=True)
    loss = loss_fn(dpf, a_t, generator, Y, truth, draws)
    (g,) = torch.autograd.grad(loss, a_t)
    return loss.item(), g.item()


def train(device="cuda", generator=None, steps: int = STEPS, data=None, draws_for=None) -> dict:
    """SGD on a: ``{"a": [after each step], "loss": [each step's], "s"}``.
    ``data`` = (X, Y, truth) given or simulated; ``draws_for(step)`` gives a
    step's draws, or None to draw from the generator."""
    device = resolve_device(device)
    gen = generator or torch.Generator(device=device).manual_seed(0)
    _, Y, truth = simulate(gen, device) if data is None else data
    dpf = make_dpf(device)
    a, out = A0, {"a": [], "loss": []}
    sync(device)
    t0 = time.perf_counter()
    for step in range(steps):
        loss, g = value_and_grad(dpf, a, gen, Y, truth,
                                 None if draws_for is None else draws_for(step))
        a = float(torch.tensor(a - LR * g, dtype=torch.float32))  # f32, as the JAX script's a
        out["a"].append(a)
        out["loss"].append(loss)
    sync(device)
    out["s"] = time.perf_counter() - t0
    return out


def gates(res) -> dict:
    """``{gate: (value, held)}``."""
    centre, width = a_tolerance()
    first, last10 = res["loss"][0], statistics.fmean(res["loss"][-10:])
    a = res["a"][-1]
    return {"loss decreasing": ((first, last10), last10 < first),
            f"final a within {width:.4f} of {centre:.4f}": (a, abs(a - centre) <= width)}


def print_tables(res, card: str) -> None:
    print(f"ex07 true a = {TRUE_A}, initial guess a = {A0}")
    for step in range(0, len(res["a"]), 10):
        print(f"  step {step:3d}: loss {res['loss'][step]:.4f}  a = {res['a'][step]:.4f}")
    n = len(res["a"])
    print(f"ex07 learned a = {res['a'][-1]:.4f} (true {TRUE_A}; JAX package, 8 keys: "
          f"{statistics.fmean(JAX_FINAL_A):.4f} ± {statistics.stdev(JAX_FINAL_A):.4f}); "
          f"{res['s'] / n * 1e3:.3f} ms an SGD step (B={B}, T={T}, N={N})  [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = resolve_device(args.device)
    res = train(device)
    print_tables(res, card_line(device))
    return 0 if all(held for _, held in gates(res).values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
