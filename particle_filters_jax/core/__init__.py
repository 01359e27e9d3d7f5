"""Core primitives: pytree dataclasses, log-weight ops, robust linear algebra."""

from particle_filters_jax.core.structs import pytree_dataclass, static_field
from particle_filters_jax.core.weights import (
    log_normalize,
    effective_sample_size,
    ess_from_logw,
    weighted_mean_cov,
    weight_entropy,
)
from particle_filters_jax.core.linalg import (
    chol_with_jitter,
    chol_solve,
    symmetrize,
    mvn_logpdf,
    mvn_logpdf_chol,
)

__all__ = [
    "pytree_dataclass",
    "static_field",
    "log_normalize",
    "effective_sample_size",
    "ess_from_logw",
    "weighted_mean_cov",
    "weight_entropy",
    "chol_with_jitter",
    "chol_solve",
    "symmetrize",
    "mvn_logpdf",
    "mvn_logpdf_chol",
]
