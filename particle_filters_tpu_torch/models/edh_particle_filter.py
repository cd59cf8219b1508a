"""EKF/UKF-assisted EDH (exact Daum-Huang) particle-flow particle filter
(PyTorch port of ``particle_filters_tpu/models/edh_particle_filter.py``).

Each step propagates the particles, integrates the affine flow
dη/dλ = A(λ)η + b(λ) over pseudo-time λ ∈ [0, 1] with S(λ) = λHPHᵀ + R,
A = −½PHᵀS⁻¹H, b = (I + 2λA)[(I + λA)PHᵀR⁻¹(z − e) + Aη̄] (Euler or RK4),
corrects the weights by the invertible-flow ratio
w ∝ w·p(x|x₋)p(z|x)/p(η₀|x₋) in the log domain, updates the tracker,
resamples when ESS < ratio·N, and records cond(S) per λ-step.

Per-particle callables (``g``, ``log_trans_pdf``, ``log_like_pdf``) run
under ``torch.func.vmap``; the λ-loop is a Python loop where the JAX package
scans. The ESS branch runs on the host, one sync a step, where the JAX
package uses ``lax.cond``.

One driver, :meth:`_FlowPF.run_trials`, runs B independent trials at once,
as the JAX package's callers ``jax.vmap`` a run: the pure part of a step
under ``torch.func.vmap`` over trials (so the jitter ladders pick their
rung per trial), the triggers read once a step, and the triggered trials
resampled together in ONE launch of kernel B2 on the card
(``resampling.hard.systematic_resample_values_batched``). ``step`` and
``run`` are its one-trial case.

With ``group`` (a ``torch.distributed`` process group, the counterpart of
the JAX package's ``axis_name``) the particles are split over the group's
ranks: the flow and the weight correction stay per rank (the tracker is
replicated), while the normalization, the trigger, the ESS, the moments and
the resample, which need collectives, run outside the ``vmap`` over
trials: the global log-normalizer, the global ESS read on the host (the
same bits on every rank), the all-gather systematic resample with B2
writing the rank's slice, or the neighbour exchange
(``parallel/distributed_resample.py``; the history's ``exchange_ok``, True
for a trial-step whose pool sufficed or that did not resample, as the JAX
package's ``ParticleFilter`` records it), and LEDH's condition number as
the max over the ranks' first particles. The
initial cloud is the one-device draw from the replicated generator, each
rank keeping its rows; the process noise comes from each rank's own
generator, seeded from one draw of the replicated one and the rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from particle_filters_tpu_torch.core import comm
from particle_filters_tpu_torch.core.linalg import (
    chol_solve,
    chol_with_jitter,
    cond_spd,
    cond_spd_power,
    symmetrize,
)
from particle_filters_tpu_torch.core.structs import (
    as_f32,
    index_state,
    stack_states,
    state_fields,
)
from particle_filters_tpu_torch.core.weights import (
    ess_from_logw,
    log_normalize,
    uniform_logw,
    weighted_mean_cov,
)
from particle_filters_tpu_torch.models.trackers import GaussianTracker, TrackerState
from particle_filters_tpu_torch.resampling.hard import systematic_resample_values_batched
from particle_filters_tpu_torch.utils.timing import span


@dataclasses.dataclass(frozen=True)
class EDHConfig:
    """The JAX package's ``EDHConfig``; randomness comes from the generator
    passed at call time."""

    n_particles: int = 512
    n_lambda_steps: int = 8
    resample_ess_ratio: float = 0.5
    flow_integrator: str = "rk4"  # "rk4" | "euler"
    cond_mode: str = "power"  # "power" (cond_spd_power) | "eigh" (cond_spd)


@dataclasses.dataclass(frozen=True)
class FlowPFState:
    """Flow-PF posterior."""

    particles: torch.Tensor  # (N, nx)
    weights: torch.Tensor  # (N,) normalized linear
    log_weights: torch.Tensor  # (N,)
    mean: torch.Tensor  # (nx,)
    cov: torch.Tensor  # (nx, nx)
    diagnostics: Dict[str, torch.Tensor]  # condition_numbers (n_lambda,), resampled


def _rk4_affine(x, A, b, dt):
    """One RK4 step of the affine field f(x) = A x + b, batched over the
    leading axes of x."""
    f = lambda v: v @ A.T + b  # noqa: E731
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def _lambda_grid(n_steps: int):
    """The JAX package's f32 λ grid min((k + 1)/n, 1), as Python floats."""
    dlam = 1.0 / n_steps
    lams = torch.clamp((torch.arange(n_steps, dtype=torch.float32) + 1) * dlam, max=1.0)
    return dlam, lams.tolist()


class _FlowPF:
    """What the EDH and LEDH flow filters share: construction, the initial
    cloud, the weight correction, and one driver for B trials at once with
    its host-side resample (one trial is B = 1). A subclass supplies
    ``_flow``."""

    def __init__(self, tracker: GaussianTracker, g: Callable, h: Callable,
                 jacobian_h: Callable, log_trans_pdf: Callable, log_like_pdf: Callable,
                 R, config, device="cuda", group=None, distributed_resample="all_gather",
                 neighbor_radius: int = 2) -> None:
        if distributed_resample not in ("all_gather", "neighbor"):
            raise ValueError("distributed_resample must be 'all_gather' or 'neighbor'.")
        self.device = torch.device(device)
        self.group = group
        self.distributed_resample = distributed_resample
        self.neighbor_radius = int(neighbor_radius)
        self.rank, self.ranks = (0, 1) if group is None else (comm.rank(group), comm.size(group))
        if config.n_particles % self.ranks:
            raise ValueError(f"n_particles={config.n_particles} must divide over "
                             f"{self.ranks} ranks.")
        self.tracker = tracker
        self.g = g
        self.h = h
        self.Jh = jacobian_h
        self.log_trans_pdf = log_trans_pdf
        self.log_like_pdf = log_like_pdf
        self.R = as_f32(R, self.device)
        self.cfg = config
        self.LR = chol_with_jitter(self.R, initial=1e-10)

    def init_from_gaussian(self, generator, mean0, cov0) -> FlowPFState:
        """Particles ~ N(mean0, cov0), uniform weights (with ``group``, this
        rank's rows of that cloud, and its global moments)."""
        mean0 = as_f32(mean0, self.device)
        L = chol_with_jitter(as_f32(cov0, self.device))
        n = self.cfg.n_particles
        eps = torch.randn((n, mean0.shape[0]), generator=generator, device=self.device)
        particles = mean0 + eps @ L.T
        logw = uniform_logw(n, device=self.device)
        mean, cov = weighted_mean_cov(particles, logw)
        if self.group is not None:
            rows = slice(self.rank * (n // self.ranks), (self.rank + 1) * (n // self.ranks))
            particles, logw = particles[rows], logw[rows]
        return FlowPFState(
            particles=particles, weights=torch.exp(logw), log_weights=logw, mean=mean,
            cov=cov,
            diagnostics={
                "condition_numbers": torch.zeros(self.cfg.n_lambda_steps, device=self.device),
                "resampled": torch.zeros((), dtype=torch.bool, device=self.device),
            },
        )

    # --- the pure part of a step (vmappable over trials) ---------------------
    def _advance(self, particles, log_weights, ts: TrackerState, z, v, u=None,
                 normalize=True, **flow_kw):
        """Tracker predict, propagation with the given noise ``v``, the flow,
        the weight correction and the tracker update: ``(x, logw, conds, ts)``
        before any resample (``logw`` not normalized unless ``normalize``)."""
        ts, _, P = self.tracker.predict(ts, u=u)
        P = symmetrize(P)
        eta0 = torch.func.vmap(lambda x, vi: self.g(x, u, vi))(particles, v)
        xk, theta_log, conds = self._flow(eta0, ts, P, z, u, **flow_kw)
        log_corr = torch.func.vmap(
            lambda x_new, x_old, e0: self.log_trans_pdf(x_new, x_old)
            + self.log_like_pdf(z, x_new)
            - self.log_trans_pdf(e0, x_old)
        )(xk, particles, eta0)
        if theta_log is not None:
            log_weights = log_weights + theta_log
        logw = log_weights + log_corr
        if normalize:
            logw, _ = log_normalize(logw)
        ts, _, _ = self.tracker.update(ts, z)
        return xk, logw, conds, ts

    def _trigger(self, logw):
        return ess_from_logw(logw) < self.cfg.resample_ess_ratio * logw.shape[-1]

    @staticmethod
    def _moments(particles, logw):
        mean, cov = weighted_mean_cov(particles, logw)
        return mean, symmetrize(cov)

    def _sharded_moments(self, p, lw):
        mc = [weighted_mean_cov(x, w, self.group) for x, w in zip(p, lw)]
        return torch.stack([m for m, _ in mc]), symmetrize(torch.stack([c for _, c in mc]))

    def _sharded_ess(self, lw):
        return torch.stack([ess_from_logw(w, self.group) for w in lw])

    def _noise(self, generator, sampler, n, nx):
        if sampler is None:
            return torch.zeros((n, nx), device=self.device)
        return as_f32(sampler(generator, n, nx), self.device)

    def _sharded_weights(self, lw, conds):
        """With a group, per trial: the global normalization, the trigger,
        and the condition numbers' max over the ranks."""
        lw = torch.stack([log_normalize(w, self.group)[0] for w in lw])
        n_total = lw.shape[-1] * self.ranks
        trig = torch.stack([ess_from_logw(w, self.group) < self.cfg.resample_ess_ratio * n_total
                            for w in lw])
        return lw, trig, comm.pmax(conds, self.group)

    def _sharded_resample(self, generator, p, lw, sel):
        """Each triggered trial's resample, its u drawn as the one-device
        path draws them (one call for all), B2 writing this rank's slice:
        ``(values, ok)``, ``ok`` (per triggered trial) False where a
        neighbour pool did not suffice."""
        from particle_filters_tpu_torch.parallel.distributed_resample import (
            all_gather_systematic_resample,
            neighbor_exchange_systematic_resample,
        )
        from particle_filters_tpu_torch.resampling.hard import _uniform

        u = _uniform(generator, (sel.numel(),), lw)
        vals, oks = [], []
        for k, b in enumerate(sel.tolist()):
            if self.distributed_resample == "neighbor":
                v, ok = neighbor_exchange_systematic_resample(
                    None, p[b], lw[b], group=self.group, radius=self.neighbor_radius, u=u[k])
            else:
                v, ok = all_gather_systematic_resample(None, p[b], lw[b], group=self.group,
                                                       u=u[k])[0], True
            vals.append(v)
            oks.append(ok)
        return torch.stack(vals), torch.tensor(oks, device=self.device)

    # --- one trial: the driver below at B = 1 ------------------------------
    def step(self, generator, state: FlowPFState, tracker_state: TrackerState, z, u=None,
             process_noise_sampler: Optional[Callable] = None, **flow_kw):
        """One step: ``(state, tracker_state)``. ``process_noise_sampler(
        generator, n, nx)`` returns the (n, nx) process noise (zero when
        None); ``generator`` also draws the resample's u."""
        z = as_f32(z, self.device)[None, None]
        st, ts, _ = self._run_trials(generator, stack_states([state]),
                                     stack_states([tracker_state]), z, u,
                                     process_noise_sampler, flow_kw)
        return index_state(st, 0), index_state(ts, 0)

    def run(self, generator, state0: FlowPFState, tracker_state0: TrackerState, zs,
            process_noise_sampler: Optional[Callable] = None, **flow_kw):
        """Filter a (T, nz) sequence: the final (state, tracker_state) and
        the stacked history (mean, cov, ess after any resample, resampled,
        condition_numbers), the JAX package's schema, and ``exchange_ok``
        (False on a step whose neighbour pool did not suffice, with a
        group in neighbour mode)."""
        zs = as_f32(zs, self.device)[None]
        st, ts, hist = self._run_trials(generator, stack_states([state0]),
                                        stack_states([tracker_state0]), zs, None,
                                        process_noise_sampler, flow_kw)
        return index_state(st, 0), index_state(ts, 0), {k: v[0] for k, v in hist.items()}

    # --- many trials at once ---------------------------------------------------
    def run_trials(self, generator, states: FlowPFState, tracker_states: TrackerState, zs,
                   process_noise_sampler: Optional[Callable] = None, **flow_kw):
        """B independent trials at once. ``states`` and ``tracker_states``
        carry a leading trial axis (``core.structs.stack_states``), ``zs``
        is (B, T, nz). Each step: the pure part under ``torch.func.vmap``
        over trials; one host read of the triggers; every triggered trial
        resampled in one launch of B2. The noise is
        ``process_noise_sampler(generator, B·n, nx)`` viewed as (B, n, nx).
        Returns the final states and tracker states (trial axis first) and
        the history with axes (B, T, ...)."""
        return self._run_trials(generator, states, tracker_states, as_f32(zs, self.device),
                                None, process_noise_sampler, flow_kw)

    def _run_trials(self, generator, states, tracker_states, zs, u, sampler, flow_kw):
        """:meth:`run_trials` with a control input ``u`` shared by every
        trial and step."""
        with span("pf.flow.run"):
            B, T = zs.shape[:2]
            p, lw = states.particles, states.log_weights
            n, nx = p.shape[1:]
            ts = state_fields(tracker_states)

            sharded = self.group is not None

            def advance(p, lw, ts, z, v):
                xk, logw, conds, ts = self._advance(p, lw, TrackerState(*ts), z, v, u,
                                                    normalize=not sharded, **flow_kw)
                return xk, logw, conds, state_fields(ts)

            advance = torch.func.vmap(advance)
            moments = torch.func.vmap(self._moments)
            ess = torch.func.vmap(ess_from_logw)
            if sharded:
                moments, ess = self._sharded_moments, self._sharded_ess
            noise_gen = None if sampler is None else comm.rank_stream(generator, self.group,
                                                                       self.device)
            rows = []
            for k in range(T):
                v = self._noise(noise_gen, sampler, B * n, nx).view(B, n, nx)
                with span("pf.flow.advance"):
                    p, lw, conds, ts = advance(p, lw, ts, zs[:, k], v)
                trig = torch.zeros(B, dtype=torch.bool, device=self.device)
                ok = torch.ones(B, dtype=torch.bool, device=self.device)
                if sharded:
                    lw, trig_g, conds = self._sharded_weights(lw, conds)
                if self.cfg.resample_ess_ratio > 0.0:
                    with span("pf.flow.trigger_read"):
                        trig = trig_g if sharded else torch.func.vmap(self._trigger)(lw)
                        sel = torch.nonzero(trig)[:, 0]  # the step's one host sync
                    if sel.numel():
                        with span("pf.flow.resample"):
                            if sharded:
                                vals, oks = self._sharded_resample(generator, p, lw, sel)
                                p, ok = p.index_copy(0, sel, vals), ok.index_copy(0, sel, oks)
                            else:
                                p = p.index_copy(0, sel, systematic_resample_values_batched(
                                    generator, p[sel], logw=lw[sel]))
                            lw = lw.index_fill(0, sel, -math.log(n * self.ranks))
                mean, cov = moments(p, lw)
                st = FlowPFState(particles=p, weights=torch.exp(lw), log_weights=lw,
                                 mean=mean, cov=cov,
                                 diagnostics={"condition_numbers": conds, "resampled": trig})
                rows.append({"mean": mean, "cov": cov, "ess": ess(lw), "resampled": trig,
                             "condition_numbers": conds, "exchange_ok": ok})
            hist = {k: torch.stack([r[k] for r in rows], dim=1) for k in rows[0]}
            return st, TrackerState(*ts), hist


class EDHFlowPF(_FlowPF):
    """EDH flow PF with global linearization at the mean path.

    ``g(x, u, v)``, ``h(x)``, ``jacobian_h(x)``, ``log_trans_pdf(x_k,
    x_km1)``, ``log_like_pdf(z, x)`` act on one particle; ``R`` is the
    observation covariance and ``tracker`` a
    :class:`~particle_filters_tpu_torch.models.trackers.GaussianTracker`.
    Tensors live on ``device`` (the card unless ``device="cpu"``); with
    ``group`` the filter runs on one rank of it (the module's note), its
    resample by ``distributed_resample`` (``"all_gather"`` | ``"neighbor"``,
    with ``neighbor_radius``), as ``ParticleFilter``'s.
    """

    def __init__(self, tracker, g, h, jacobian_h, log_trans_pdf, log_like_pdf, R,
                 config: Optional[EDHConfig] = None, device="cuda", group=None,
                 distributed_resample: str = "all_gather", neighbor_radius: int = 2) -> None:
        super().__init__(tracker, g, h, jacobian_h, log_trans_pdf, log_like_pdf, R,
                         config or EDHConfig(), device, group, distributed_resample,
                         neighbor_radius)

    def _flow_matrices(self, lam, etabar, P, z):
        """A(λ), b(λ) and cond(S) at the linearization point ``etabar``."""
        I = torch.eye(etabar.shape[0], device=etabar.device)
        H = self.Jh(etabar)
        e = self.h(etabar) - H @ etabar
        S = lam * (H @ P @ H.T) + self.R
        LS = chol_with_jitter(S, initial=1e-8)
        A = -0.5 * P @ H.T @ chol_solve(LS, H)
        R_inv_innov = chol_solve(self.LR, z - e)
        b = (I + 2.0 * lam * A) @ ((I + lam * A) @ (P @ H.T @ R_inv_innov) + A @ etabar)
        if self.cfg.cond_mode == "eigh":
            cond = cond_spd(S)
        else:
            cond = cond_spd_power(symmetrize(S), chol_l=LS)
        return A, b, cond

    def _flow(self, eta0, ts, P, z, u):
        nx = eta0.shape[-1]
        etabar = self.g(ts.past_mean, u, torch.zeros(nx, device=eta0.device))
        dlam, lams = _lambda_grid(max(1, int(self.cfg.n_lambda_steps)))
        euler = self.cfg.flow_integrator.lower() == "euler"
        eta, conds = eta0, []
        for lam in lams:
            A, b, cond = self._flow_matrices(lam, etabar, P, z)
            if euler:
                eta = eta + dlam * (eta @ A.T + b)
                etabar = etabar + dlam * (A @ etabar + b)
            else:
                eta = _rk4_affine(eta, A, b, dlam)
                etabar = _rk4_affine(etabar, A, b, dlam)
            conds.append(cond)
        return eta, None, torch.stack(conds)
