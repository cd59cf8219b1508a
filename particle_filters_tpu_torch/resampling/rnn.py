"""Learned (RNN) differentiable resampling (PyTorch port of
``particle_filters_tpu/resampling/rnn.py``).

A GRU or LSTM scans the particle set (per-ancestor features: weight ⊕ state
⊕ one-hot target index), and a dense head maps the last hidden state to the
new particle's assignment logits over the ancestors; a softmax with
temperature, then the barycentric projection. ``use_baseline_resampling``
is the weight-proportional soft assignment plus 0.1·Gumbel noise.

The cells are written out by hand with the JAX package's equations: its GRU
forms tanh(x·Wh + (r⊙h)·Uh + bh) with one bias a gate, and its LSTM has one
bias with the forget gate's at 1; ``torch.nn.GRU``/``nn.LSTM`` compute other
functions. :class:`RNNResampler` is an ``nn.Module`` whose parameters carry
the JAX pytree's names (``cells.<layer>.<name>``, ``out_kernel``,
``out_bias``); :meth:`RNNResampler.params` gives them as that pytree.

The JAX package vmaps one scan over the N target indices. The N sequences
differ only in their one-hot column, so here all B·N of them run through
one scan of length N, with x_t·W formed as the shared part (weight and
state rows of W) plus W's one-hot row of the target.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from particle_filters_tpu_torch.resampling.soft import (
    assignment_entropy,
    log_normalize_lastaxis,
    sample_gumbel,
)

GRU_KEYS = ("Uh", "Ur", "Uz", "Wh", "Wr", "Wz", "bh", "br", "bz")
LSTM_KEYS = ("U", "W", "b")


def _glorot(generator, shape, device):
    lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
    u = torch.rand(shape, generator=generator, device=device)
    return u * (2.0 * lim) - lim


def gru_cell_init(generator, input_dim: int, hidden_dim: int, device) -> Dict[str, torch.Tensor]:
    """Glorot-uniform kernels, zero biases."""
    out = {}
    for gate in ("z", "r", "h"):
        out["W" + gate] = _glorot(generator, (input_dim, hidden_dim), device)
        out["U" + gate] = _glorot(generator, (hidden_dim, hidden_dim), device)
        out["b" + gate] = torch.zeros((hidden_dim,), device=device)
    return out


def _gru_step(p, xz, xr, xh, h):
    """One GRU step given the input projections x·Wz, x·Wr, x·Wh."""
    z = torch.sigmoid(xz + h @ p["Uz"] + p["bz"])
    r = torch.sigmoid(xr + h @ p["Ur"] + p["br"])
    h_tilde = torch.tanh(xh + (r * h) @ p["Uh"] + p["bh"])
    return (1.0 - z) * h + z * h_tilde


def gru_cell_apply(p, x, h):
    """The JAX package's GRU cell: ``(h_new, h_new)``."""
    h_new = _gru_step(p, x @ p["Wz"], x @ p["Wr"], x @ p["Wh"], h)
    return h_new, h_new


def lstm_cell_init(generator, input_dim: int, hidden_dim: int, device) -> Dict[str, torch.Tensor]:
    """Glorot-uniform kernels; one bias with the forget gate's at 1."""
    b = torch.zeros((4 * hidden_dim,), device=device)
    b[hidden_dim:2 * hidden_dim] = 1.0
    return {"W": _glorot(generator, (input_dim, 4 * hidden_dim), device),
            "U": _glorot(generator, (hidden_dim, 4 * hidden_dim), device), "b": b}


def _lstm_step(p, xw, h, c):
    """One LSTM step (gates i, f, g, o) given the input projection x·W."""
    i, f, g, o = torch.chunk(xw + h @ p["U"] + p["b"], 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell_apply(p, x, state):
    """The JAX package's LSTM cell: ``((h_new, c_new), h_new)``."""
    h, c = _lstm_step(p, x @ p["W"], *state)
    return (h, c), h


class RNNResampler(nn.Module):
    """Learned resampler. Constructor options are the JAX package's; the
    initial parameters are drawn from seed 0 on ``device``, :meth:`init`
    draws them again from a generator.

    ``apply(params, generator, particles, log_weights)`` resamples an
    (N, d) cloud, or a (B, N, d) batch, to ``(new_particles, uniform
    logw[, aux])``; ``params`` is this module (or None for it) or a pytree
    of the JAX package's layout (:meth:`params`).
    """

    def __init__(
        self,
        n_particles: int,
        state_dim: int,
        *,
        hidden_dim: int = 32,
        num_layers: int = 1,
        rnn_type: str = "gru",
        temperature: float = 1.0,
        use_weight_features: bool = True,
        use_particle_features: bool = True,
        use_baseline_resampling: bool = False,
        use_weight_prior: bool = False,
        output_init_scale: float = 0.001,
        device="cuda",
    ) -> None:
        """``use_weight_prior`` adds the normalized log-weights to the
        learned logits: assignment = softmax((head(h) + log w)/T), so the
        near-zero head starts at the weight-proportional baseline."""
        super().__init__()
        if rnn_type not in ("gru", "lstm"):
            raise ValueError(f"Unknown RNN type: {rnn_type}. Use 'lstm' or 'gru'")
        self.n_particles = int(n_particles)
        self.state_dim = int(state_dim)
        self.hidden_dim = int(hidden_dim)
        self.num_layers = int(num_layers)
        self.rnn_type = rnn_type
        self.temperature = float(temperature)
        self.use_weight_features = bool(use_weight_features)
        self.use_particle_features = bool(use_particle_features)
        self.use_baseline_resampling = bool(use_baseline_resampling)
        self.use_weight_prior = bool(use_weight_prior)
        self.output_init_scale = float(output_init_scale)
        self.n_feat = int(use_weight_features) + (self.state_dim if use_particle_features else 0)
        if self.n_feat == 0:
            raise ValueError("Must use at least one of weight_features or particle_features")
        self.input_dim = self.n_feat + self.n_particles  # + one-hot target index
        self.device = torch.device(device)
        generator = torch.Generator(device=self.device).manual_seed(0)
        cell_init = gru_cell_init if rnn_type == "gru" else lstm_cell_init
        self.cells = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v) for k, v in cell_init(
                generator, self.input_dim if layer == 0 else self.hidden_dim,
                self.hidden_dim, self.device).items()})
            for layer in range(self.num_layers))
        self.out_kernel = nn.Parameter(self.output_init_scale * torch.randn(
            (self.hidden_dim, self.n_particles), generator=generator, device=self.device))
        self.out_bias = nn.Parameter(torch.zeros((self.n_particles,), device=self.device))

    # ------------------------------ params ------------------------------

    @torch.no_grad()
    def init(self, generator) -> "RNNResampler":
        """Draw fresh parameters (glorot-uniform kernels; the output head
        normal at ``output_init_scale``, so initial assignments are near
        uniform); returns the module."""
        cell_init = gru_cell_init if self.rnn_type == "gru" else lstm_cell_init
        for layer, cell in enumerate(self.cells):
            in_dim = self.input_dim if layer == 0 else self.hidden_dim
            for k, v in cell_init(generator, in_dim, self.hidden_dim, self.device).items():
                cell[k].copy_(v)
        self.out_kernel.copy_(self.output_init_scale * torch.randn(
            self.out_kernel.shape, generator=generator, device=self.device))
        self.out_bias.zero_()
        return self

    def params(self) -> dict:
        """The parameters as the JAX package's pytree: ``{"cells": [dict a
        layer], "out_kernel", "out_bias"}`` (the module's own tensors)."""
        return {"cells": [dict(cell.items()) for cell in self.cells],
                "out_kernel": self.out_kernel, "out_bias": self.out_bias}

    def leaf_names(self):
        """The pytree's leaves in ``jax.tree_util.tree_flatten`` order
        (dict keys sorted): each layer's cell keys, then out_bias,
        out_kernel."""
        keys = GRU_KEYS if self.rnn_type == "gru" else LSTM_KEYS
        return ([f"cells.{i}.{k}" for i in range(self.num_layers) for k in keys]
                + ["out_bias", "out_kernel"])

    @torch.no_grad()
    def load_leaves(self, leaves) -> "RNNResampler":
        """Copy arrays given in :meth:`leaf_names` order into the module."""
        named = dict(self.named_parameters())
        names = self.leaf_names()
        if len(leaves) != len(names):
            raise ValueError(f"{len(leaves)} leaves given, the pytree has {len(names)}")
        for name, leaf in zip(names, leaves):
            p = named[name]
            leaf = torch.as_tensor(leaf, dtype=p.dtype)
            if tuple(leaf.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {tuple(leaf.shape)}, want {tuple(p.shape)}")
            p.copy_(leaf)
        return self

    def _tree(self, params):
        if params is None or params is self:
            return self.params()
        if isinstance(params, RNNResampler):
            return params.params()
        return params

    # ------------------------------ forward ------------------------------

    def _features(self, particles, log_weights):
        """(..., N, n_feat) per-ancestor features shared by every target:
        the normalized weight and the state (the one-hot column is added
        in :meth:`_run_cells`)."""
        feats = []
        if self.use_weight_features:
            logw_n, _ = log_normalize_lastaxis(log_weights)
            feats.append(torch.exp(logw_n)[..., None])
        if self.use_particle_features:
            feats.append(particles)
        return torch.cat(feats, dim=-1)

    def _run_cells(self, tree, feats):
        """All N target sequences of every batch row through the stacked
        cells in one scan of length N: (B, N, n_feat) → the last hidden
        state (B, N_target, H). The first layer's x_t·W is feat_t·W[:n_feat]
        (shared by the targets, formed for every t at once) plus W's one-hot
        row of the target, W[n_feat + target]."""
        gru = self.rnn_type == "gru"
        n, nf = feats.shape[1], self.n_feat
        x = None  # a later layer's input sequence: (B, N_target, N, H)
        for layer, p in enumerate(tree["cells"]):
            W = torch.cat([p["Wz"], p["Wr"], p["Wh"]], dim=1) if gru else p["W"]
            if layer == 0:
                shared, onehot = feats @ W[:nf], W[nf:]  # (B, N, G), (N_target, G)
            else:
                xw_all = x @ W  # (B, N_target, N, G)
            h = feats.new_zeros((feats.shape[0], n, self.hidden_dim))
            c = torch.zeros_like(h)
            outs = []
            last = layer + 1 == len(tree["cells"])
            for t in range(n):
                xw = shared[:, t, None, :] + onehot if layer == 0 else xw_all[:, :, t]
                if gru:
                    h = _gru_step(p, *torch.chunk(xw, 3, dim=-1), h)
                else:
                    h, c = _lstm_step(p, xw, h, c)
                if not last:
                    outs.append(h)
            if not last:
                x = torch.stack(outs, dim=2)
        return h

    def _baseline_assignment(self, generator, log_weights, gumbel=None):
        """Weight-proportional soft assignment + 0.1·Gumbel noise; ``gumbel``
        (..., N, N) is drawn (eps 1e-10) when None."""
        n = self.n_particles
        logw_n, _ = log_normalize_lastaxis(log_weights)
        log_probs = torch.log(torch.exp(logw_n) + 1e-10) / self.temperature
        tiled = log_probs.unsqueeze(-2).expand(log_probs.shape[:-1] + (n, n))
        if gumbel is None:
            gumbel = sample_gumbel(generator, tiled.shape, log_probs.dtype, eps=1e-10,
                                   device=log_probs.device)
        return torch.softmax(tiled + 0.1 * gumbel, dim=-1)

    def logits(self, params, particles, log_weights):
        """The learned assignment logits (..., N_target, N_ancestor), before
        the weight prior and the temperature."""
        tree = self._tree(params)
        lead = particles.shape[:-2]
        feats = self._features(particles, log_weights).reshape((-1, self.n_particles, self.n_feat))
        h = self._run_cells(tree, feats)
        out = h @ tree["out_kernel"] + tree["out_bias"]
        return out.reshape(lead + out.shape[1:])

    def apply(self, params, generator, particles, log_weights, return_aux: bool = False,
              gumbel=None):
        """Resample an (N, d) cloud or a (B, N, d) batch → (new_particles,
        uniform logw[, aux]). ``gumbel`` feeds baseline mode's draws."""
        n = self.n_particles
        if self.use_baseline_resampling:
            assignment = self._baseline_assignment(generator, log_weights, gumbel)
        else:
            logits = self.logits(params, particles, log_weights)
            if self.use_weight_prior:
                logw_n, _ = log_normalize_lastaxis(log_weights)
                logits = logits + torch.log(torch.exp(logw_n) + 1e-10).unsqueeze(-2)
            assignment = torch.softmax(logits / self.temperature, dim=-1)
        new_particles = assignment @ particles
        new_logw = torch.full_like(log_weights, -math.log(n))
        if not return_aux:
            return new_particles, new_logw
        ent = assignment_entropy(assignment)
        aux = {"assignment": assignment,
               "assignment_entropy_mean": torch.mean(ent, dim=-1),
               "assignment_entropy_std": torch.std(ent, dim=-1, unbiased=False)}
        return new_particles, new_logw, aux



def rnn_resample(resampler: RNNResampler, params, generator, particles, log_weights):
    """Functional wrapper around :meth:`RNNResampler.apply`."""
    return resampler.apply(params, generator, particles, log_weights)
