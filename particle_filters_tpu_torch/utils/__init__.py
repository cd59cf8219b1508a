"""Utilities of the port: filtering metrics (``diagnostics``),
device-synchronised timing (``timing``) and checkpoints
(``checkpoint``)."""

from particle_filters_tpu_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
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
    "latest_step",
    "mae",
    "max_weight",
    "mse",
    "nees",
    "omat",
    "restore_checkpoint",
    "rmse",
    "save_checkpoint",
    "timed",
    "unique_fraction",
    "weight_entropy",
    "weight_gini",
]
