"""Differentiable particle filters: soft, Sinkhorn-OT and RNN resampling
(PyTorch port of ``particle_filters_tpu/models/dpf.py``).

- :class:`DifferentiableParticleFilter`: batched (B, N, d) filtering with
  mixture + Gumbel-Softmax soft resampling and the diagnostics (ESS, weight
  entropy, particle diversity, assignment entropy, RMSE sequence).
- :class:`DPF_OT`: Sinkhorn-OT resampling, unbatched (N, d), linear-domain
  weights, convergence / sparsity / dual diagnostics, the log-evidence on
  request and program spans.
- :class:`DifferentiableParticleFilterRNN`: the learned GRU/LSTM resampler
  (``resampling.rnn.RNNResampler``, an ``nn.Module``) and its training-free
  baseline mode.

The time loops are Python loops; per-step diagnostics are stacked and
aggregated afterwards; autograd differentiates everything. Randomness comes
from a ``torch.Generator``: ``transition_fn(generator, x, params)`` draws
its own noise, and the initial cloud's normals and the Gumbel draws come
from the generator unless given (``init_eps=``; the steps' ``gumbel=``), so
a test can feed another package's draws. Classes take ``device`` (the card
unless ``"cpu"``); ``filter`` outputs keep the JAX shapes, (B, T+1, N, d)
and (B, T+1, N).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from particle_filters_tpu_torch.core.structs import as_f32
from particle_filters_tpu_torch.resampling.ot import sinkhorn_ot_resample
from particle_filters_tpu_torch.resampling.rnn import RNNResampler
from particle_filters_tpu_torch.resampling.soft import (
    assignment_entropy,
    gumbel_softmax,
    log_normalize_lastaxis,
)
from particle_filters_tpu_torch.utils.timing import span


# --------------------------- shared diagnostics ----------------------------


def compute_ess(log_weights: torch.Tensor) -> torch.Tensor:
    """ESS along the last axis."""
    logw_n, _ = log_normalize_lastaxis(log_weights)
    w = torch.exp(logw_n)
    return 1.0 / torch.clamp(torch.sum(w * w, dim=-1), min=1e-30)


def compute_weight_entropy(log_weights: torch.Tensor) -> torch.Tensor:
    """−Σ w log w along the last axis."""
    logw_n, _ = log_normalize_lastaxis(log_weights)
    w = torch.exp(logw_n)
    return -torch.sum(torch.where(w > 0, w * logw_n, torch.zeros_like(w)), dim=-1)


def compute_particle_diversity(particles: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean and std of the pairwise distances and the spread (trace of the
    covariance) of a (B, N, d) cloud → dict of (B,)."""
    B, N, _ = particles.shape
    diff = particles[:, :, None, :] - particles[:, None, :, :]
    dist = torch.sqrt(torch.clamp(torch.sum(diff**2, dim=-1), min=1e-30))
    masked = dist * (1.0 - torch.eye(N, dtype=particles.dtype, device=particles.device))
    centered = particles - torch.mean(particles, dim=1, keepdim=True)
    cov = torch.einsum("bni,bnj->bij", centered, centered) / N
    return {
        "mean_pairwise_dist": torch.sum(masked, dim=(1, 2)) / (N * (N - 1)),
        "std_pairwise_dist": torch.std(masked.reshape(B, N * N), dim=-1, unbiased=False),
        "particle_spread": torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1),
    }


def aggregate_diagnostics(stacked: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-step diagnostics (leading time axis) → mean/std/min/max."""
    out = {}
    for key, v in stacked.items():
        out[f"{key}_mean"] = torch.mean(v)
        out[f"{key}_std"] = torch.std(v, unbiased=False)
        out[f"{key}_min"] = torch.min(v)
        out[f"{key}_max"] = torch.max(v)
    return out


def _stack_diags(rows):
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def rmse_sequence(particles_seq, logw_seq, ground_truth) -> torch.Tensor:
    """Per-step RMSE of the weighted mean against the truth, averaged over
    the batch: (B, T+1, N, d), (B, T+1, N), (B, T+1, d) → (T+1,)."""
    logw_n, _ = log_normalize_lastaxis(logw_seq)
    means = torch.einsum("btn,btnd->btd", torch.exp(logw_n), particles_seq)
    sq = torch.sum((means - ground_truth) ** 2, dim=-1)
    return torch.sqrt(torch.mean(sq, dim=0))


def _run(step, p0, lw0, observations, return_diagnostics, ground_truth):
    """The batched filters' time loop: ``step(p, lw, y_t)`` for each of the
    (B, T, ·) observations; (B, T+1, N, d), (B, T+1, N)[, diagnostics]."""
    ps, lws, diags = [p0], [lw0], []
    for t in range(observations.shape[1]):
        out = step(ps[-1], lws[-1], observations[:, t])
        ps.append(out[0])
        lws.append(out[1])
        if return_diagnostics:
            diags.append(out[2])
    particles_seq, logw_seq = torch.stack(ps, dim=1), torch.stack(lws, dim=1)
    if not return_diagnostics:
        return particles_seq, logw_seq
    diagnostics = aggregate_diagnostics(_stack_diags(diags))
    if ground_truth is not None:
        rs = rmse_sequence(particles_seq, logw_seq, as_f32(ground_truth, particles_seq.device))
        diagnostics.update(rmse_sequence=rs, mean_rmse=torch.mean(rs), final_rmse=rs[-1])
    return particles_seq, logw_seq, diagnostics


def _init_particles(generator, batch_size, n, d, init_mean, init_cov_chol, device, eps=None):
    """Gaussian initial clouds (B, N, d) and uniform log-weights (B, N);
    ``eps`` are the standard normals, drawn when None."""
    init_mean = as_f32(init_mean, device)
    init_cov_chol = as_f32(init_cov_chol, device)
    if init_mean.ndim == 1:
        init_mean = init_mean[None, :].expand(batch_size, d)
    if init_cov_chol.ndim == 2:
        init_cov_chol = init_cov_chol[None].expand(batch_size, d, d)
    if eps is None:
        eps = torch.randn((batch_size, n, d), generator=generator, device=device)
    else:
        eps = as_f32(eps, device)
    particles = init_mean[:, None, :] + torch.einsum("bnd,bkd->bnk", eps, init_cov_chol)
    logw = torch.full((batch_size, n), -math.log(n), device=device)
    return particles, logw


# ------------------------------ soft variant -------------------------------


class DifferentiableParticleFilter:
    """Soft-resampling DPF, batched over B sequences.

    ``transition_fn(generator, x_prev, params) -> x_pred`` with x (B, N, d);
    ``log_likelihood_fn(x, y, params) -> (B, N)``.
    """

    def __init__(self, n_particles: int, state_dim: int, transition_fn: Callable,
                 log_likelihood_fn: Callable, soft_alpha: float = 0.1,
                 gumbel_temperature: float = 0.2, device="cuda") -> None:
        self.n_particles = int(n_particles)
        self.state_dim = int(state_dim)
        self.transition_fn = transition_fn
        self.log_likelihood_fn = log_likelihood_fn
        self.soft_alpha = float(soft_alpha)
        self.gumbel_temperature = float(gumbel_temperature)
        self.device = torch.device(device)

    def init_particles(self, generator, batch_size, init_mean, init_cov_chol, eps=None):
        return _init_particles(generator, batch_size, self.n_particles, self.state_dim,
                               init_mean, init_cov_chol, self.device, eps)

    def step(self, generator, particles, log_weights, observation, params=None,
             return_diagnostics: bool = False, gumbel=None):
        """Propagate → weight → soft resample. The transition draws first,
        then the (B, N, N) Gumbel draws (unless ``gumbel`` is given)."""
        params = params or {}
        B, N, _ = particles.shape
        diag = {}
        if return_diagnostics:
            diag["ess_before"] = compute_ess(log_weights)
            diag["entropy_before"] = compute_weight_entropy(log_weights)
            div = compute_particle_diversity(particles)
            diag.update({f"diversity_before_{k}": v for k, v in div.items()})

        pred = self.transition_fn(generator, particles, params)
        log_lik = self.log_likelihood_fn(pred, observation, params)
        logw, _ = log_normalize_lastaxis(log_weights + log_lik)
        w = torch.exp(logw)

        # mixture q = (1−α)w + α/N, Gumbel-Softmax assignment
        probs = (1.0 - self.soft_alpha) * w + self.soft_alpha / N
        tiled = torch.log(probs + 1e-20)[:, None, :].expand(B, N, N)
        assignment = gumbel_softmax(generator, tiled, self.gumbel_temperature, gumbel)
        new_particles = torch.einsum("bij,bjd->bid", assignment, pred)
        new_logw = torch.full((B, N), -math.log(N), dtype=particles.dtype,
                              device=particles.device)
        if not return_diagnostics:
            return new_particles, new_logw
        ent = assignment_entropy(assignment)
        div_after = compute_particle_diversity(new_particles)
        diag.update({
            "ess_after": compute_ess(new_logw),
            "entropy_after": compute_weight_entropy(new_logw),
            **{f"diversity_after_{k}": v for k, v in div_after.items()},
            "assignment_entropy_mean": torch.mean(ent),
            "assignment_entropy_std": torch.std(ent, unbiased=False),
            "max_weight_before": torch.amax(w, dim=-1),
        })
        return new_particles, new_logw, diag

    def filter(self, generator, observations, init_mean, init_cov_chol, params=None,
               return_diagnostics: bool = False, ground_truth=None, init_eps=None):
        """Filter a (B, T, obs_dim) batch of sequences. Returns
        (particles_seq (B, T+1, N, d), logw_seq (B, T+1, N)[, diagnostics])."""
        observations = as_f32(observations, self.device)
        p0, lw0 = self.init_particles(generator, observations.shape[0], init_mean,
                                      init_cov_chol, init_eps)
        return _run(lambda p, lw, y: self.step(generator, p, lw, y, params, return_diagnostics),
                    p0, lw0, observations, return_diagnostics, ground_truth)


# ------------------------------- OT variant --------------------------------


class DPF_OT:
    """Sinkhorn-OT DPF, unbatched (N, d) with linear-domain weights.

    ``transition_fn(generator, particles, t) -> particles`` (N, d);
    ``obs_loglik_fn(particles, y, t) -> (N,)``.

    ``run_filter(..., return_log_evidence=True)`` also returns the
    log-evidence Σₜ log Σᵢ wₜ₋₁,ᵢ exp ℓₜ,ᵢ (0-d), what a user fits the
    model's parameters by. Program spans (``utils/timing.py::span``):
    ``pf.ot.run`` around ``run_filter``, ``pf.ot.step`` around each step,
    and inside a step the resampler's ``pf.ot.sinkhorn`` (the dual loop) and
    ``pf.ot.project`` (the plan and the barycentric projection).
    """

    def __init__(self, n_particles: int, state_dim: int, transition_fn: Callable,
                 obs_loglik_fn: Callable, epsilon: float = 0.1, n_sinkhorn_iters: int = 50,
                 min_val: float = 1e-12, damping: float = 1.0, device="cuda") -> None:
        """``damping`` < 1 under-relaxes the dual updates; the JAX package's
        tuning sweep found undamped updates best on its LGSSM comparison
        (ε = 0.01, 50 iterations)."""
        self.n_particles = int(n_particles)
        self.state_dim = int(state_dim)
        self.transition_fn = transition_fn
        self.obs_loglik_fn = obs_loglik_fn
        self.epsilon = float(epsilon)
        self.n_sinkhorn_iters = int(n_sinkhorn_iters)
        self.min_val = float(min_val)
        self.damping = float(damping)
        self.device = torch.device(device)

    def init_particles(self, generator, mean0, cov0_chol, eps=None):
        mean0 = as_f32(mean0, self.device)
        L = as_f32(cov0_chol, self.device)
        if eps is None:
            eps = torch.randn((self.n_particles, self.state_dim), generator=generator,
                              device=self.device)
        else:
            eps = as_f32(eps, self.device)
        weights = torch.full((self.n_particles,), 1.0 / self.n_particles, device=self.device)
        return mean0 + eps @ L.T, weights

    def step(self, generator, particles, weights, y, t=0, return_diagnostics: bool = False):
        """Propagate → linear-domain weight update (with a max-shift guard
        outside the gradient) → Sinkhorn-OT resample."""
        return self._step(generator, particles, weights, y, t, return_diagnostics)[0]

    def _step(self, generator, particles, weights, y, t, return_diagnostics):
        """:meth:`step`'s outputs and the step's log-evidence increment
        log Σᵢ wᵢ exp ℓᵢ, max-shifted, from the weights before the resample."""
        with span("pf.ot.step"):
            pred = self.transition_fn(generator, particles, t)
            loglik = self.obs_loglik_fn(pred, y, t)
            top = torch.amax(loglik).detach()
            lin = weights * torch.exp(loglik - top)
            increment = top + torch.log(torch.sum(lin))
            w = torch.clamp(lin, min=self.min_val)
            w = w / torch.sum(w)
            out = sinkhorn_ot_resample(
                pred, w, epsilon=self.epsilon, n_iters=self.n_sinkhorn_iters,
                min_val=self.min_val, damping=self.damping,
                return_diagnostics=return_diagnostics,
            )
            if not return_diagnostics:
                return out, increment
            new_p, new_w, diag = out
            return (new_p, new_w, {
                "ot_distance": diag["ot_distance"],
                "transport_plan_sparsity": diag["transport_plan_sparsity"],
                "final_delta": diag["final_delta"],
                # aggregates to converged_mean, the rate of converged steps
                "converged": diag["converged"].to(torch.float32),
                "f_std": diag["dual_variables"]["f_std"],
                "g_std": diag["dual_variables"]["g_std"],
                "ess_before": 1.0 / torch.sum(w * w),
            }), increment

    def run_filter(self, generator, y_seq, mean0, cov0_chol,
                   return_diagnostics: bool = False, init_eps=None,
                   return_log_evidence: bool = False):
        """Filter a (T, obs_dim) sequence. Returns (particles_seq
        (T+1, N, d), weights_seq (T+1, N)[, diagnostics][, log_evidence]),
        the log-evidence 0-d: the sum of the steps' increments, each
        log Σᵢ wᵢ exp ℓᵢ from the weights before the step's resample. The
        whole call is the span ``pf.ot.run``; each step ``pf.ot.step``."""
        with span("pf.ot.run"):
            y_seq = as_f32(y_seq, self.device)
            p, w = self.init_particles(generator, mean0, cov0_chol, init_eps)
            ps, ws, diags = [p], [w], []
            log_z = torch.zeros((), device=self.device)
            for t in range(y_seq.shape[0]):
                out, increment = self._step(generator, p, w, y_seq[t], t, return_diagnostics)
                p, w = out[0], out[1]
                ps.append(p)
                ws.append(w)
                log_z = log_z + increment
                if return_diagnostics:
                    diags.append(out[2])
            outs = (torch.stack(ps), torch.stack(ws))
            if return_diagnostics:
                outs += (aggregate_diagnostics(_stack_diags(diags)),)
            return outs + (log_z,) if return_log_evidence else outs


# ------------------------------- RNN variant -------------------------------


class DifferentiableParticleFilterRNN:
    """Learned-resampler DPF, batched over B sequences.

    The resampler is an ``nn.Module`` (``self.resampler``); ``step`` and
    ``filter`` take it, or a pytree of its parameters in the JAX package's
    layout, as ``params`` (None: ``self.resampler``). Train it with
    autograd and a ``torch.optim`` optimizer over its ``parameters()``.
    """

    def __init__(self, n_particles: int, state_dim: int, transition_fn: Callable,
                 log_likelihood_fn: Callable, rnn_hidden_dim: int = 32,
                 rnn_num_layers: int = 1, rnn_type: str = "gru", temperature: float = 1.0,
                 use_weight_features: bool = True, use_particle_features: bool = True,
                 use_baseline_resampling: bool = False, use_weight_prior: bool = False,
                 device="cuda") -> None:
        self.n_particles = int(n_particles)
        self.state_dim = int(state_dim)
        self.transition_fn = transition_fn
        self.log_likelihood_fn = log_likelihood_fn
        self.device = torch.device(device)
        self.resampler = RNNResampler(
            n_particles, state_dim, hidden_dim=rnn_hidden_dim, num_layers=rnn_num_layers,
            rnn_type=rnn_type, temperature=temperature,
            use_weight_features=use_weight_features,
            use_particle_features=use_particle_features,
            use_baseline_resampling=use_baseline_resampling,
            use_weight_prior=use_weight_prior, device=device,
        )

    def init_resampler(self, generator) -> RNNResampler:
        """Draw the resampler's parameters afresh (near-zero output head:
        near-uniform initial assignments); returns the module."""
        return self.resampler.init(generator)

    def init_particles(self, generator, batch_size, init_mean, init_cov_chol, eps=None):
        return _init_particles(generator, batch_size, self.n_particles, self.state_dim,
                               init_mean, init_cov_chol, self.device, eps)

    def step(self, params, generator, particles, log_weights, observation,
             model_params=None, return_diagnostics: bool = False, gumbel=None):
        """Propagate → weight → learned resample of all B clouds at once."""
        model_params = model_params or {}
        pred = self.transition_fn(generator, particles, model_params)
        log_lik = self.log_likelihood_fn(pred, observation, model_params)
        logw, _ = log_normalize_lastaxis(log_weights + log_lik)
        out = self.resampler.apply(params, generator, pred, logw, return_diagnostics, gumbel)
        if not return_diagnostics:
            return out
        new_p, new_lw, aux = out
        return new_p, new_lw, {"ess_before": compute_ess(logw),
                               "assignment_entropy_mean": torch.mean(
                                   aux["assignment_entropy_mean"])}

    def filter(self, params, generator, observations, init_mean, init_cov_chol,
               model_params=None, return_diagnostics: bool = False, ground_truth=None,
               init_eps=None):
        """Filter a (B, T, obs_dim) batch. Returns (particles_seq
        (B, T+1, N, d), logw_seq (B, T+1, N)[, diagnostics])."""
        observations = as_f32(observations, self.device)
        p0, lw0 = self.init_particles(generator, observations.shape[0], init_mean,
                                      init_cov_chol, init_eps)
        return _run(lambda p, lw, y: self.step(params, generator, p, lw, y, model_params,
                                               return_diagnostics),
                    p0, lw0, observations, return_diagnostics, ground_truth)
