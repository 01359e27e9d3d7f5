"""Resampling schemes with one shared interface.

Hard (non-differentiable, index-producing): systematic, multinomial,
stratified, residual — ``(key, log_weights) -> ancestor indices``.
Differentiable (particle-transforming): soft (Gumbel mixture), OT (entropy-
regularized Sinkhorn), RNN (learned) — ``(key, particles, log_weights) ->
(new_particles, new_log_weights, aux)``.

The reference defines systematic/multinomial inside each filter
(``models/particle_filter.py:146-186``, ``models/EDH_particle_filter.py:37``,
``models/LEDH_particle_filter.py:25``) and the differentiable ones as three
TensorFlow modules; here they are one shared, jit/vmap/shard-able module.
"""

from particle_filters_jax.resampling.hard import (
    systematic_resample,
    multinomial_resample,
    stratified_resample,
    residual_resample,
    resample_indices,
)
from particle_filters_jax.resampling.soft import soft_resample
from particle_filters_jax.resampling.ot import sinkhorn_ot_resample, ot_resample
from particle_filters_jax.resampling.ot_blockwise import (
    ot_resample_blockwise,
    sinkhorn_ot_resample_blockwise,
)
from particle_filters_jax.resampling.rnn import RNNResampler, rnn_resample

__all__ = [
    "ot_resample_blockwise",
    "sinkhorn_ot_resample_blockwise",
    "systematic_resample",
    "multinomial_resample",
    "stratified_resample",
    "residual_resample",
    "resample_indices",
    "soft_resample",
    "sinkhorn_ot_resample",
    "ot_resample",
    "RNNResampler",
    "rnn_resample",
]
