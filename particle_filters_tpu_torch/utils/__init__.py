"""Utilities of the port: filtering metrics (``diagnostics``) and
device-synchronised timing (``timing``)."""

from particle_filters_tpu_torch.utils.diagnostics import (
    coverage_95,
    degeneracy_report,
    mae,
    max_weight,
    mse,
    nees,
    omat,
    rmse,
    unique_fraction,
    weight_entropy,
    weight_gini,
)
from particle_filters_tpu_torch.utils.timing import Timer, timed

__all__ = [
    "Timer",
    "coverage_95",
    "degeneracy_report",
    "mae",
    "max_weight",
    "mse",
    "nees",
    "omat",
    "rmse",
    "timed",
    "unique_fraction",
    "weight_entropy",
    "weight_gini",
]
