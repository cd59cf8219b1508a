"""Gaussian tracker protocol for the particle-flow filters (PyTorch port of
``particle_filters_tpu/models/trackers.py``).

The tracker is explicit state, a :class:`TrackerState` passed in and
returned by pure predict/update methods: a companion EKF or UKF that cannot
be aliased between two filters, and that ``torch.func.vmap`` batches.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from particle_filters_tpu_torch.core.structs import as_f32
from particle_filters_tpu_torch.models.extended_kalman_filter import (
    EKFState,
    ExtendedKalmanFilter,
)
from particle_filters_tpu_torch.models.unscented_kalman_filter import (
    UKFState,
    UnscentedKalmanFilter,
)


@dataclasses.dataclass(frozen=True)
class TrackerState:
    """Companion-filter posterior plus the previous posterior mean."""

    mean: torch.Tensor  # (nx,) current posterior/prior mean
    cov: torch.Tensor  # (nx, nx)
    past_mean: torch.Tensor  # (nx,) x̂_{k-1|k-1}
    t: torch.Tensor  # scalar int32


class GaussianTracker:
    """Functional EKF/UKF tracker: wraps an ``ExtendedKalmanFilter`` or
    ``UnscentedKalmanFilter`` with pure (state-in, state-out) methods."""

    def __init__(self, filt: Union[ExtendedKalmanFilter, UnscentedKalmanFilter]):
        self.filt = filt

    def init(self, mean0, cov0) -> TrackerState:
        device = self.filt.device
        mean0 = as_f32(mean0, device)
        return TrackerState(mean=mean0, cov=as_f32(cov0, device), past_mean=mean0,
                            t=torch.zeros((), dtype=torch.int32, device=device))

    def _fstate(self, ts: TrackerState):
        cls = EKFState if isinstance(self.filt, ExtendedKalmanFilter) else UKFState
        return cls(mean=ts.mean, cov=ts.cov, t=ts.t)

    def predict(self, ts: TrackerState, u=None) -> Tuple[TrackerState, torch.Tensor, torch.Tensor]:
        """(new_state, m_{k|k−1}, P_{k|k−1}); records past_mean."""
        pred = self.filt.predict(self._fstate(ts), u=u)
        new = TrackerState(mean=pred.mean, cov=pred.cov, past_mean=ts.mean, t=pred.t)
        return new, pred.mean, pred.cov

    def update(self, ts: TrackerState, z) -> Tuple[TrackerState, torch.Tensor, torch.Tensor]:
        """(new_state, m_{k|k}, P_{k|k})."""
        post = self.filt.update(self._fstate(ts), z)
        new = TrackerState(mean=post.mean, cov=post.cov, past_mean=ts.past_mean, t=post.t)
        return new, post.mean, post.cov


# Aliases matching the reference wrapper names.
EKFTracker = GaussianTracker
UKFTracker = GaussianTracker
