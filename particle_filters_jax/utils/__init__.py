"""Diagnostics, metrics, IO and timing utilities."""

from particle_filters_jax.utils.diagnostics import (
    coverage_95,
    degeneracy_report,
    max_weight,
    nees,
    omat,
    rmse,
    mae,
    mse,
    unique_fraction,
    weight_entropy,
    weight_gini,
)
from particle_filters_jax.utils.timing import Timer, time_best, timed

__all__ = [
    "coverage_95",
    "degeneracy_report",
    "max_weight",
    "nees",
    "omat",
    "rmse",
    "mae",
    "mse",
    "unique_fraction",
    "weight_entropy",
    "weight_gini",
    "Timer",
    "time_best",
    "timed",
]
