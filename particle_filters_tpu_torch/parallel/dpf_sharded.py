"""Sharded differentiable-PF training (PyTorch port of
``particle_filters_tpu/parallel/dpf_sharded.py``): sequences over the
mesh's ``batch`` dim, particles over its ``particles`` dim.

On each rank: propagate and weight its particles; the log-normalizer's max
over the ranks (without a gradient, as in the JAX package) and its sum;
soft resampling over the global ancestor set (the cloud ``all_gather``ed,
the rank computing its rows of the (N, N) assignment); the posterior mean
summed over the ranks; the loss averaged over the batch dim; one SGD step.

Gradients through the collectives: a gathered tensor that each rank uses
in its own way gets, on each rank, the sum of all ranks' gradients for its
rows (``core.comm.all_gather_grad``: all-reduce, then the rank's slice);
the mean, used only by the loss that every rank computes alike, passes its
gradient through once (``core.comm.psum_to_replicated``). Each rank's
parameter gradient is then its share, and the shares summed over the
particle dim and averaged over the batch dim are the unsharded gradient.

The noise is drawn at the global shape and each rank keeps its rows: a
sequence's generator (seeded from one draw of the replicated generator and
the sequence's index) draws the initial and transition normals (N, d) and
the Gumbel noise (N, N) of every step, so any mesh runs the same filter;
that costs N·d + N² draws a step a rank, small at the DPF's N.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from particle_filters_tpu_torch.core import comm
from particle_filters_tpu_torch.resampling.soft import gumbel_softmax, sample_gumbel


def sharded_soft_resample(generator, particles, logw, *, n_particles: int,
                          soft_alpha: float = 0.5, temperature: float = 0.5, group,
                          gumbel=None):
    """Soft (Gumbel-softmax) resampling over the global ancestor set:
    ``(new_particles (n, d), uniform logw (n,))``.

    ``particles`` (n, d) and ``logw`` (n,), globally normalized, are this
    rank's; it computes its n rows of the global (N, N) assignment.
    ``gumbel`` (n, N) are its rows of the noise; when None the global
    (N, N) noise is drawn from ``generator`` (the same on every rank) and
    the rank keeps its rows, so every rank draws a distinct slice."""
    n = particles.shape[0]
    p_all = comm.all_gather_grad(particles, group)
    lw_all = comm.all_gather_grad(logw, group)
    probs = (1.0 - soft_alpha) * torch.exp(lw_all) + soft_alpha / n_particles
    tiled = torch.log(probs + 1e-20)[None, :].expand(n, n_particles)
    if gumbel is None:
        r = comm.rank(group)
        gumbel = sample_gumbel(generator, (n_particles, n_particles), p_all.dtype,
                               device=p_all.device)[r * n:(r + 1) * n]
    assign = gumbel_softmax(None, tiled, temperature, gumbel)
    return assign @ p_all, torch.full((n,), -math.log(n_particles), device=particles.device)


def make_sharded_dpf_train_step(
    mesh,
    *,
    n_particles: int,
    dim: int,
    transition_fn: Callable,  # (params, eps (n, d), particles (n, d)) -> particles
    obs_loglik_fn: Callable,  # (params, particles (n, d), y) -> (n,)
    init_fn: Callable,  # (params, eps (n, d)) -> particles (n, d)
    loss_fn: Callable,  # (step_means (T, d), truth (T, d)) -> scalar
    soft_alpha: float = 0.5,
    gumbel_temperature: float = 0.5,
    learning_rate: float = 0.05,
):
    """``train_step(params, generator, ys, xs) -> (loss, new_params)``.

    ``mesh`` is a ``DeviceMesh`` ``("batch", "particles")``, or None for the
    same step on one device without collectives; ``params`` a dict of
    tensors, ``ys``/``xs`` the (B, T, d_obs)/(B, T, d) batches (every rank
    passes the whole batch and runs its B/n_batch sequences);
    ``generator`` is replicated. The user functions take standard normals
    of this rank's particles (``dim`` = d) where the JAX package's take a
    key. Returns the loss (the mean over all B sequences) and the
    parameters after one SGD step."""
    g_part = None if mesh is None else mesh.get_group("particles")
    g_batch = None if mesh is None else mesh.get_group("batch")
    n_part, n_batch = comm.size(g_part), comm.size(g_batch)
    if n_particles % n_part != 0:
        raise ValueError("n_particles must divide the particles mesh axis.")
    n_local = n_particles // n_part
    r = comm.rank(g_part)
    rows = slice(r * n_local, (r + 1) * n_local)

    def seq_loss(params, gen, y_seq, x_seq):
        draw = lambda: torch.randn((n_particles, dim), generator=gen,  # noqa: E731
                                   device=gen.device)[rows]
        particles = init_fn(params, draw())
        logw = torch.full((n_local,), -math.log(n_particles), device=particles.device)
        means = []
        for y in y_seq:
            particles = transition_fn(params, draw(), particles)
            logw = logw + obs_loglik_fn(params, particles, y)
            m = comm.pmax(torch.max(logw).detach(), g_part)
            s = comm.all_gather_grad(torch.sum(torch.exp(logw - m))[None], g_part).sum()
            logw = logw - (m + torch.log(s))
            particles, logw = sharded_soft_resample(
                gen, particles, logw, n_particles=n_particles, soft_alpha=soft_alpha,
                temperature=gumbel_temperature, group=g_part)
            means.append(comm.psum_to_replicated(
                torch.sum(torch.exp(logw)[:, None] * particles, dim=0), g_part))
        return loss_fn(torch.stack(means), x_seq)

    def train_step(params, generator, ys, xs):
        B = ys.shape[0]
        if B % n_batch:
            raise ValueError(f"{B} sequences must divide over {n_batch} batch ranks.")
        base = int(torch.randint(0, 2**62, (1,), generator=generator,
                                 device=generator.device).item())
        b_local = B // n_batch
        b0 = comm.rank(g_batch) * b_local
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        losses = [seq_loss(leaves, torch.Generator(device=generator.device).manual_seed(
            base + b), ys[b], xs[b]) for b in range(b0, b0 + b_local)]
        loss = torch.stack(losses).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        new = {}
        for (k, p), g in zip(params.items(), grads):
            g = comm.psum(comm.psum(g, g_part), g_batch) / n_batch
            new[k] = (p - learning_rate * g).detach()
        return comm.psum(loss.detach(), g_batch) / n_batch, new

    return train_step
