"""Turn the JAX package's states and constructor inputs, given as numpy
arrays, into this package's, so both packages can start from one state.

- A ``PFState`` (any object with the fields particles, log_weights, mean,
  cov, t) becomes this package's :class:`PFState`.
- A fused carry ``(particles_t, logw, off_u)`` becomes this package's:
  for nx = 1 the JAX (8, N/8) layout is read row-major into (N,); for
  nx > 1 particles stay (nx, N); log-weights become (N,).
- An ``EKFState``, ``UKFState``, ``TrackerState`` or ``FlowPFState`` becomes
  this package's class of that name, field by field (:func:`state_from_jax`
  picks it by the class's name).
- ``Q`` becomes the f32 ``(Q, Lq)`` pair both filters build, with
  ``Lq = cholesky(Q + 1e-10·I)`` taken in numpy as the JAX fused filter does.
- ``LGSSMParams``, an ``SNLGDataset``, a ``SkewTTrialResult``, a
  ``MATDataset``, a ``KPFState`` and a ``LinearGaussianBayes`` become this
  package's (counts stay int32, as the JAX simulators return them).
- The RNN resampler's parameter pytree, given as the JAX pytree or as the
  ``.npz`` of its leaves in ``jax.tree_util.tree_flatten`` order that
  ``examples/09_train_rnn_resampler.py`` writes, loads into an
  ``RNNResampler``; :func:`rnn_params_to_jax` gives the pytree back.

- :func:`sharded_state_from_jax` cuts a global ``PFState``,
  ``FlowPFState`` or fused carry to rank r's slice of S (the fused carry
  along its lanes: the (nx, N) layout's columns), so a sharded run starts
  from the JAX package's global cloud.

:func:`to_numpy` goes back: a state's fields as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from particle_filters_tpu_torch.core.structs import PFState, state_fields
from particle_filters_tpu_torch.models.edh_particle_filter import FlowPFState
from particle_filters_tpu_torch.models.extended_kalman_filter import EKFState
from particle_filters_tpu_torch.models.kernel_particle_filter import KPFState
from particle_filters_tpu_torch.models.stochastic_particle_filter import LinearGaussianBayes
from particle_filters_tpu_torch.models.trackers import TrackerState
from particle_filters_tpu_torch.models.unscented_kalman_filter import UKFState
from particle_filters_tpu_torch.ops.fused_pf import noise_factor
from particle_filters_tpu_torch.resampling.rnn import RNNResampler
from particle_filters_tpu_torch.simulators.acoustic_tracking import MATDataset
from particle_filters_tpu_torch.simulators.lgssm import LGSSMParams
from particle_filters_tpu_torch.simulators.sensor_network_lg import SNLGConfig, SNLGDataset
from particle_filters_tpu_torch.simulators.sensor_network_skewt import SkewTTrialResult


def _t(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=dtype), device=device)


def _leaf(a, device) -> torch.Tensor:
    """f32 for floating leaves, int32 for integer ones, bool kept."""
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return _t(a, device)
    return _t(a, device, np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32)


_STATES = {cls.__name__: cls for cls in (EKFState, UKFState, TrackerState, FlowPFState)}


def _fields_from(cls, state, device):
    """``cls`` built from ``state``'s fields of the same names."""
    fields = {}
    for f in dataclasses.fields(cls):
        v = getattr(state, f.name)
        fields[f.name] = ({k: _leaf(x, device) for k, x in v.items()}
                          if isinstance(v, dict) else _leaf(v, device))
    return cls(**fields)


def state_from_jax(state, *, device="cuda"):
    """A JAX state (numpy-convertible leaves) as this package's state on
    ``device`` (the card unless ``"cpu"``): a ``PFState`` or fused 3-tuple
    carry, or an ``EKFState``, ``UKFState``, ``TrackerState`` or
    ``FlowPFState``."""
    if isinstance(state, tuple):
        particles_t, logw, off_u = (np.asarray(a, np.float32) for a in state)
        # Log-weights ride (8, N/8) only for nx = 1, a (1, N) row otherwise.
        particles = particles_t.reshape(-1) if logw.shape[0] == 8 else particles_t
        return (
            _t(particles, device),
            _t(logw.reshape(-1), device),
            _t(off_u, device),
        )
    return _fields_from(_STATES.get(type(state).__name__, PFState), state, device)


def sharded_state_from_jax(state, rank: int, ranks: int, *, device="cuda"):
    """Rank ``rank``'s slice of ``ranks`` of a global JAX state, as
    :func:`state_from_jax` gives it: a ``PFState`` or ``FlowPFState`` cut
    along the particles (moments and diagnostics whole), a fused carry
    along the lanes (``off_u`` whole)."""
    full = state_from_jax(state, device=device)
    n = (full[1] if isinstance(full, tuple) else full.log_weights).shape[0]
    if n % ranks:
        raise ValueError(f"{n} particles must divide over {ranks} ranks.")
    rows = slice(rank * (n // ranks), (rank + 1) * (n // ranks))
    if isinstance(full, tuple):
        particles, logw, off_u = full
        return particles[..., rows].contiguous(), logw[rows].contiguous(), off_u
    cut = {"particles", "weights", "log_weights"}
    return dataclasses.replace(full, **{f.name: getattr(full, f.name)[rows].contiguous()
                                        for f in dataclasses.fields(full) if f.name in cut})


def to_numpy(state) -> dict:
    """A state's fields as numpy arrays (a dict field as a dict)."""
    names = [f.name for f in dataclasses.fields(state)]
    out = {}
    for name, v in zip(names, state_fields(state)):
        out[name] = ({k: x.detach().cpu().numpy() for k, x in v.items()}
                     if isinstance(v, dict) else v.detach().cpu().numpy())
    return out


def params_from_jax(Q, *, device="cuda"):
    """``(Q, Lq)`` as f32 tensors, with the JAX fused filter's
    ``Lq = cholesky(Q + 1e-10·I)``."""
    return _t(Q, device, np.float32), _t(noise_factor(Q), device)


def lgssm_params_from_jax(params, *, device="cuda") -> LGSSMParams:
    """A JAX ``LGSSMParams`` as this package's, f32 on ``device``."""
    return _fields_from(LGSSMParams, params, device)


def snlg_dataset_from_jax(ds, *, device="cuda") -> SNLGDataset:
    """A JAX ``SNLGDataset`` (with its config) as this package's."""
    cfg = None if ds.config is None else SNLGConfig(**dataclasses.asdict(ds.config))
    return SNLGDataset(
        X=_t(ds.X, device, np.float32), Z=_t(ds.Z, device, np.float32),
        coords=_t(ds.coords, device, np.float32), Sigma=_t(ds.Sigma, device, np.float32),
        config=cfg,
    )


def skewt_result_from_jax(res, *, device="cuda") -> SkewTTrialResult:
    """A JAX ``SkewTTrialResult`` as this package's: f32 arrays, Z int32,
    Λ where it was kept, the same meta."""
    lam = getattr(res, "Lambda", None)
    return SkewTTrialResult(
        X=_t(res.X, device, np.float32), Z=_t(res.Z, device, np.int32),
        Lambda=None if lam is None else _t(lam, device, np.float32),
        Sigma=_t(res.Sigma, device, np.float32), L=_t(res.L, device, np.float32),
        R=_t(res.R, device, np.float32), gamma=_t(res.gamma, device, np.float32),
        meta=res.meta,
    )


def mat_dataset_from_jax(ds, *, device="cuda") -> MATDataset:
    """A JAX ``MATDataset`` as this package's, f32 on ``device``."""
    return _fields_from(MATDataset, ds, device)


def kpf_state_from_jax(state, *, device="cuda") -> KPFState:
    """A JAX ``KPFState`` as this package's: f32 particles, weights, s and
    ds_history, int32 steps."""
    return _fields_from(KPFState, state, device)


def linear_gaussian_bayes_from_jax(model, *, device="cuda") -> LinearGaussianBayes:
    """A JAX ``LinearGaussianBayes`` as this package's, field by field, f32
    on ``device``."""
    return _fields_from(LinearGaussianBayes, model, device)


def rnn_params_from_jax(resampler: RNNResampler, params) -> RNNResampler:
    """Copy the JAX resampler's parameters into ``resampler`` (built with
    the same options) and return it. ``params`` is the JAX pytree
    (``{"cells": [...], "out_kernel", "out_bias"}``, leaves read by name)
    or the path of an ``.npz`` whose ``arr_i`` are its leaves in
    ``tree_flatten`` order (:meth:`RNNResampler.leaf_names`)."""
    if isinstance(params, (str, os.PathLike)):
        with np.load(params) as z:
            leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    else:
        leaves = []
        for name in resampler.leaf_names():
            node = params
            for part in name.split("."):
                node = node[int(part)] if part.isdigit() else node[part]
            leaves.append(np.array(node, np.float32))
    return resampler.load_leaves([np.array(a, np.float32) for a in leaves])


def rnn_params_to_jax(resampler: RNNResampler) -> dict:
    """The resampler's parameters as the JAX package's pytree of numpy
    arrays."""
    tree = resampler.params()
    return {"cells": [{k: v.detach().cpu().numpy() for k, v in cell.items()}
                      for cell in tree["cells"]],
            "out_kernel": tree["out_kernel"].detach().cpu().numpy(),
            "out_bias": tree["out_bias"].detach().cpu().numpy()}
