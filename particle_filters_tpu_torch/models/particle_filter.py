"""SIR (sequential importance resampling) particle filter (PyTorch port of
``particle_filters_tpu/models/particle_filter.py``).

The general path: per-particle ``g(x, u)`` and observation log-density run
under ``torch.func.vmap``; weights live in the log domain; the ESS trigger
``ess < thresh·N`` picks the resample branch on the host (one sync per
step, where the JAX package uses ``lax.cond``); systematic resampling of
the values goes through kernel B2 on a CUDA tensor
(``resampling.hard.systematic_resample_values``) and through its plain
version on a CPU tensor. ``run`` is a Python loop over the steps; with
``track_degeneracy`` it also records the degeneracy panel of
``utils.diagnostics``. ``run_chunked`` runs it in pieces with a checkpoint
between them (``utils.checkpoint``), the generator's state included, and
resumes from the last one.

With ``group`` (a ``torch.distributed`` process group, the counterpart of
the JAX package's ``axis_name``) the N = ``Np`` particles are split over
the group's ranks, n = N/S a rank: normalization, ESS and moments are
global (``core.weights`` with the group), the trigger is read from the
global ESS, the same bits on every rank, and the resample is the global
systematic one, by ``distributed_resample``: ``"all_gather"`` (the whole
cloud gathered, B2 writing the rank's slice) or ``"neighbor"`` (the ±
``neighbor_radius`` ranks' particles only, with an exact all-gather rescue
flagged ``exchange_ok = False``; see ``parallel/distributed_resample.py``).
Two random streams: the generator passed in is the replicated one (seeded
alike on every rank: it draws the resample's u, the same on every rank,
and one seed a call for the other stream), and each rank draws its initial
cloud and its propagation noise from a generator of its own, seeded from
that seed and the rank.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional

import torch

from particle_filters_tpu_torch.core import comm
from particle_filters_tpu_torch.core.linalg import chol_with_jitter
from particle_filters_tpu_torch.core.structs import PFState, as_f32
from particle_filters_tpu_torch.core.weights import (
    ess_from_logw,
    log_normalize,
    weighted_mean_cov,
)
from particle_filters_tpu_torch.resampling.hard import (
    resample_indices,
    systematic_resample_values,
)
from particle_filters_tpu_torch.utils.diagnostics import (
    max_weight,
    unique_fraction,
    weight_entropy,
    weight_gini,
)

_PANEL = ("entropy", "gini", "max_weight", "unique_frac")


class ParticleFilter:
    """SIR particle filter for

        x_k = g(x_{k−1}, u_{k−1}) + w,  w ~ N(0, Q)
        z_k = h(x_k) + v,               v ~ N(0, R)

    or a custom per-particle observation log-density ``obs_loglik(x, z)``.
    Randomness comes from the ``torch.Generator`` each method takes, which
    must live on ``device`` (the card unless ``device="cpu"``).
    """

    def __init__(
        self,
        g: Callable,
        h: Optional[Callable],
        Q,
        R,
        *,
        Np: int = 1000,
        resample_thresh: float = 0.5,
        resample_method: str = "systematic",
        regularize_after_resample: bool = False,
        obs_loglik: Optional[Callable] = None,
        group=None,
        distributed_resample: str = "all_gather",
        neighbor_radius: int = 2,
        device="cuda",
    ) -> None:
        """With ``group`` the filter runs on one rank of it: ``Np`` is the
        global count and must divide over the ranks; ``initialize`` and
        ``run`` hold this rank's n = Np/S particles."""
        if distributed_resample not in ("all_gather", "neighbor"):
            raise ValueError("distributed_resample must be 'all_gather' or 'neighbor'.")
        if distributed_resample == "neighbor" and resample_method != "systematic":
            raise ValueError(
                "neighbor-exchange resampling requires resample_method="
                "'systematic' (its ancestry is a contiguous inverse-CDF).")
        self.group = group
        self.n_shards = 1 if group is None else comm.size(group)
        if int(Np) % self.n_shards:
            raise ValueError(f"Np={Np} must divide over {self.n_shards} ranks.")
        self.distributed_resample = distributed_resample
        self.neighbor_radius = int(neighbor_radius)
        self.device = torch.device(device)
        self.g = g
        self.h = h
        self.Q = as_f32(Q, self.device)
        self.R = as_f32(R, self.device) if R is not None else None
        self.Np = int(Np)
        self.resample_thresh = float(resample_thresh)
        self.resample_method = str(resample_method)
        self.regularize_after_resample = bool(regularize_after_resample)

        self.nx = self.Q.shape[0]
        self.Lq = chol_with_jitter(self.Q, initial=1e-10)
        if obs_loglik is not None:
            self._obs_loglik = obs_loglik
        else:
            if h is None or self.R is None:
                raise ValueError("Provide either (h, R) or obs_loglik.")
            self.nz = self.R.shape[0]
            LR = chol_with_jitter(self.R, initial=1e-12)

            def gaussian_obs_loglik(x, z):
                diff = z - self.h(x)
                y = torch.linalg.solve_triangular(LR, diff[:, None], upper=False)[:, 0]
                # The Gaussian constant is dropped: it cancels in the
                # weight normalization.
                return -0.5 * torch.sum(y * y)

            self._obs_loglik = gaussian_obs_loglik

    # -------------------- initialization & diagnostics --------------------

    def initialize(self, generator, mean, cov) -> PFState:
        """Particles ~ N(mean, cov), uniform weights (this rank's slice,
        from its own stream, with ``group``)."""
        mean = as_f32(mean, self.device).reshape(-1)
        cov = torch.atleast_2d(as_f32(cov, self.device))
        Lc = chol_with_jitter(cov, initial=1e-10)
        n = self.Np // self.n_shards
        eps = torch.randn((n, mean.shape[0]), generator=self._local(generator),
                          device=self.device)
        return PFState(
            particles=eps @ Lc.T + mean,
            log_weights=self._uniform_logw(n),
            mean=mean,
            cov=cov,
            t=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def effective_sample_size(self, state: PFState) -> torch.Tensor:
        """Neff = 1/Σw² (global with ``group``)."""
        return ess_from_logw(state.log_weights, self.group)

    # ------------------------------ core ops ------------------------------

    def _local(self, generator):
        """This rank's stream (``core.comm.rank_stream``)."""
        return comm.rank_stream(generator, self.group, self.device)

    def _uniform_logw(self, n: int) -> torch.Tensor:
        """−log N_global on this rank's n particles."""
        return torch.full((n,), -math.log(n * self.n_shards), device=self.device)

    def _propagate(self, particles, eps, u=None):
        """vmapped g plus correlated noise ``eps @ Lqᵀ`` for given normals."""
        prop = torch.func.vmap(lambda x: self.g(x, u))(particles)
        return prop + eps @ self.Lq.T

    def predict(self, generator, state: PFState, u=None) -> torch.Tensor:
        """Propagate all particles: vmapped g + correlated Gaussian noise
        (from this rank's stream with ``group``)."""
        return self._predict(self._local(generator), state, u)

    def _predict(self, generator, state: PFState, u=None) -> torch.Tensor:
        p = state.particles
        eps = torch.randn(p.shape, generator=generator, dtype=p.dtype, device=p.device)
        return self._propagate(p, eps, u)

    def _loglik(self, particles, z):
        return torch.func.vmap(lambda x: self._obs_loglik(x, z))(particles)

    def _resample_values(self, generator, p, lw):
        """The resampled particles and their ancestry: the child-run starts
        kernel B2 copied by (systematic) or the ancestor indices."""
        if self.resample_method == "systematic":
            return systematic_resample_values(generator, p, logw=lw, return_starts=True)
        idx = resample_indices(self.resample_method, generator, logw=lw)
        return p[idx.long()], idx

    def _resample_sharded(self, generator, p, lw):
        """This rank's slice of the global resample: ``(values, ok)``."""
        from particle_filters_tpu_torch.parallel.distributed_resample import (
            all_gather_systematic_resample,
            neighbor_exchange_systematic_resample,
        )

        if self.distributed_resample == "neighbor":
            return neighbor_exchange_systematic_resample(
                generator, p, lw, group=self.group, radius=self.neighbor_radius)
        if self.resample_method == "systematic":
            return all_gather_systematic_resample(generator, p, lw, group=self.group)[0], True
        n, r = p.shape[0], comm.rank(self.group)
        idx = resample_indices(self.resample_method, generator,
                               logw=comm.all_gather_cat(lw, self.group))
        return comm.all_gather_cat(p, self.group)[idx[r * n:(r + 1) * n].long()], True

    def _maybe_resample(self, generator, particles, logw, local):
        """ESS-triggered resample; the branch runs on the host. Also returns
        the resample's ancestry (None on a step without one, and with
        ``group``) and whether a neighbour pool sufficed. ``local`` (this
        rank's stream) draws the jitter."""
        ess = ess_from_logw(logw, self.group)
        trigger = bool(ess < self.resample_thresh * particles.shape[0] * self.n_shards)
        ancestry, ok = None, True
        if trigger:
            if self.group is None:
                particles, ancestry = self._resample_values(generator, particles, logw)
            else:
                particles, ok = self._resample_sharded(generator, particles, logw)
            if self.regularize_after_resample:
                jitter = torch.randn(
                    particles.shape, generator=local, dtype=particles.dtype,
                    device=particles.device,
                )
                particles = particles + jitter @ (0.001 * self.Lq.T)
            logw = self._uniform_logw(particles.shape[0])
        return particles, logw, ess, trigger, ancestry, ok

    def update(self, generator, state: PFState, z, particles=None,
               return_diagnostics: bool = False):
        """Log-weight update + conditional resample + posterior moments.
        ``particles`` defaults to ``state.particles`` (call after
        ``predict``). With ``return_diagnostics`` returns ``(state, diag)``
        with ``ess``, ``resampled`` and ``exchange_ok`` (False where a
        neighbour pool did not suffice)."""
        new, diag, _ = self._update(generator, state, z, particles, local=self._local(generator))
        if return_diagnostics:
            return new, diag
        return new

    def _update(self, generator, state, z, particles=None, track_degeneracy=False,
                local=None):
        """The step after the prediction; ``local`` (this rank's stream,
        ``generator`` when None) draws the regularization jitter."""
        z = as_f32(z, self.device)
        if particles is None:
            particles = state.particles
        # log_z: the incremental marginal likelihood log p(z_t | z_{1:t-1})
        # up to the constant the Gaussian path drops.
        logw_pre, log_z = log_normalize(state.log_weights + self._loglik(particles, z),
                                        self.group)
        particles, logw, ess, trig, ancestry, ok = self._maybe_resample(
            generator, particles, logw_pre, generator if local is None else local)
        mean, cov = weighted_mean_cov(particles, logw, self.group)
        new = PFState(
            particles=particles, log_weights=logw, mean=mean, cov=cov,
            t=state.t + 1,
        )
        diag = {"ess": ess, "resampled": trig, "exchange_ok": ok}
        if track_degeneracy:
            diag.update(self._degeneracy(logw_pre, ancestry))
        return new, diag, log_z

    def _degeneracy(self, logw_pre, ancestry):
        """The panel of the pre-resample weights: normalized entropy, Gini,
        max weight, and the fraction of ancestors that survive the resample
        that ran (1.0 on a step without one), read from its ``ancestry``: an
        ancestor survives where its child run is not empty."""
        survive = torch.ones((), device=logw_pre.device)
        if ancestry is not None and self.resample_method == "systematic":
            ends = torch.cat([ancestry[1:], ancestry.new_full((1,), ancestry.shape[0])])
            survive = torch.mean((ends > ancestry).to(torch.float32))
        elif ancestry is not None:
            survive = unique_fraction(ancestry)
        return {"entropy": weight_entropy(logw_pre), "gini": weight_gini(logw_pre),
                "max_weight": max_weight(logw_pre), "unique_frac": survive}

    def step(self, generator, state: PFState, z, u=None,
             return_diagnostics: bool = False):
        """Predict then update. See ``update`` for ``return_diagnostics``."""
        local = self._local(generator)
        new, diag, _ = self._update(generator, state, z, self._predict(local, state, u),
                                    local=local)
        return (new, diag) if return_diagnostics else new

    def run(self, generator, state0: PFState, zs, us=None, *,
            track_degeneracy: bool = False):
        """Filter a whole (T, nz) sequence.

        Returns ``(final_state, history)`` with stacked per-step mean (T, nx),
        cov (T, nx, nx), ess (T,), resampled (T,), log_evidence (T,) and
        exchange_ok (T,). With ``track_degeneracy`` the history also carries
        (T,) ``entropy`` (normalized), ``gini`` and ``max_weight`` of the
        pre-resample weights, and ``unique_frac``, the fraction of ancestors
        that survive the step's resample (1.0 on steps without one). The
        panel draws nothing from ``generator``: the rest of the run is the
        same with it or without. It reads the local weight vector, so it is
        not defined with ``group``.
        """
        if track_degeneracy and self.group is not None:
            raise ValueError("track_degeneracy reads the local weight vector and is not "
                             "defined for sharded (group) runs.")
        zs = as_f32(zs, self.device)
        local = self._local(generator)
        state = state0
        keys = ("mean", "cov", "ess", "log_evidence") + (_PANEL if track_degeneracy else ())
        hist = {k: [] for k in keys}
        triggers, oks = [], []
        for t in range(zs.shape[0]):
            u = None if us is None else us[t]
            particles = self._predict(local, state, u)
            state, diag, log_z = self._update(generator, state, zs[t], particles,
                                              track_degeneracy, local)
            row = {"mean": state.mean, "cov": state.cov, "log_evidence": log_z, **diag}
            for k in keys:
                hist[k].append(row[k])
            triggers.append(diag["resampled"])
            oks.append(diag["exchange_ok"])
        out = {k: torch.stack(v) for k, v in hist.items()}
        out.update(resampled=torch.tensor(triggers, dtype=torch.bool, device=self.device),
                   exchange_ok=torch.tensor(oks, dtype=torch.bool, device=self.device))
        return state, out

    def run_chunked(self, generator, state0: PFState, zs, us=None, *, chunk_size: int,
                    ckpt_dir: Optional[str] = None, resume: bool = False,
                    stop_after_chunks: Optional[int] = None,
                    track_degeneracy: bool = False):
        """``run`` in ``chunk_size``-step pieces with a checkpoint between
        them, for long runs that must survive an interruption.

        ``run`` draws from ``generator`` in step order, so the pieces, run
        one after another from one generator, give the same trajectory,
        history and final state as one ``run``, bit for bit. A checkpoint
        therefore holds the generator's state (``get_state()``: on the card
        Philox's seed and offset) beside the filter state.

        - ``ckpt_dir``: after each piece the state and the generator's state
          go to ``ckpt_dir/state`` and the piece's history to
          ``ckpt_dir/hist``, under ``step_<c>``, c the pieces done.
        - ``resume=True``: continue from the last checkpoint in
          ``ckpt_dir`` (``generator`` takes its saved state), with the
          histories of the pieces done read back, so the history returned
          covers the whole sequence.
        - ``stop_after_chunks=j``: return after j more pieces (an
          interruption); the history is then partial.
        """
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive.")
        if stop_after_chunks is not None and stop_after_chunks < 1:
            raise ValueError("stop_after_chunks must be >= 1.")
        if resume and ckpt_dir is None:
            raise ValueError("resume=True requires ckpt_dir.")
        if zs.shape[0] == 0:
            raise ValueError("zs must contain at least one observation.")
        if ckpt_dir is not None and self.group is not None:
            raise ValueError("run_chunked checkpoints one device's state; with a group, "
                             "run the pieces without ckpt_dir.")
        from particle_filters_tpu_torch.utils.checkpoint import (
            latest_step,
            restore_checkpoint,
            save_checkpoint,
        )

        T = zs.shape[0]
        n_chunks = -(-T // chunk_size)
        state, hists, start = state0, [], 0
        if resume:
            done = latest_step(os.path.join(ckpt_dir, "state"))
            if done is not None:
                saved = restore_checkpoint(os.path.join(ckpt_dir, "state"),
                                           {"state": state0, "generator": None}, step=done)
                state = saved["state"]
                generator.set_state(saved["generator"])
                hists = [restore_checkpoint(os.path.join(ckpt_dir, "hist"), step=c)
                         for c in range(1, done + 1)]
                hists = [{k: v.to(self.device) for k, v in h.items()} for h in hists]
                start = done
        end = n_chunks if stop_after_chunks is None else min(n_chunks, start + stop_after_chunks)
        for c in range(start, end):
            lo, hi = c * chunk_size, min((c + 1) * chunk_size, T)
            state, hist = self.run(generator, state, zs[lo:hi],
                                   None if us is None else us[lo:hi],
                                   track_degeneracy=track_degeneracy)
            hists.append(hist)
            if ckpt_dir is not None:
                save_checkpoint(os.path.join(ckpt_dir, "state"),
                                {"state": state, "generator": generator.get_state()},
                                step=c + 1)
                save_checkpoint(os.path.join(ckpt_dir, "hist"), hist, step=c + 1)
        history = {k: torch.cat([h[k] for h in hists]) for k in hists[0]} if hists else {}
        return state, history
