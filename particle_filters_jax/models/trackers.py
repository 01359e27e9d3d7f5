"""Gaussian tracker protocol for the particle-flow filters.

The reference threads a *stateful, shared* EKF/UKF companion through the
flows (``GaussianTracker`` protocol, ``models/EDH_particle_filter.py:12-19``,
wrappers :77-134 — re-duplicated in ``LEDH_particle_filter.py`` and in
tests). That mutability even produces an aliasing bug when one tracker is
shared between two filters (``test_filters_mat_simulator.py:415-423``).

Design: the tracker is an explicit pytree ``TrackerState``
threaded through ``lax.scan`` — pure predict/update; impossible to alias.
"""

from __future__ import annotations

from typing import Tuple, Union

import jax
import jax.numpy as jnp

from particle_filters_jax.core.structs import pytree_dataclass
from particle_filters_jax.models.extended_kalman_filter import (
    EKFState,
    ExtendedKalmanFilter,
)
from particle_filters_jax.models.unscented_kalman_filter import (
    UKFState,
    UnscentedKalmanFilter,
)


@pytree_dataclass
class TrackerState:
    """Companion-filter posterior plus the previous posterior mean
    (``get_past_mean``, reference ``EDH_particle_filter.py:101``)."""

    mean: jax.Array  # (nx,) current posterior/prior mean
    cov: jax.Array  # (nx, nx)
    past_mean: jax.Array  # (nx,) \hat{x}_{k-1|k-1}
    t: jax.Array  # scalar int32


class GaussianTracker:
    """Functional EKF/UKF tracker: wraps an ``ExtendedKalmanFilter`` or
    ``UnscentedKalmanFilter`` with pure (state-in, state-out) methods."""

    def __init__(self, filt: Union[ExtendedKalmanFilter, UnscentedKalmanFilter]):
        self.filt = filt

    def init(self, mean0, cov0) -> TrackerState:
        mean0 = jnp.asarray(mean0)
        return TrackerState(
            mean=mean0,
            cov=jnp.asarray(cov0),
            past_mean=mean0,
            t=jnp.asarray(0, jnp.int32),
        )

    def _fstate(self, ts: TrackerState):
        if isinstance(self.filt, ExtendedKalmanFilter):
            return EKFState(mean=ts.mean, cov=ts.cov, t=ts.t)
        return UKFState(mean=ts.mean, cov=ts.cov, t=ts.t)

    def predict(self, ts: TrackerState, u=None) -> Tuple[TrackerState, jax.Array, jax.Array]:
        """(new_state, m_{k|k−1}, P_{k|k−1}); records past_mean."""
        pred = self.filt.predict(self._fstate(ts), u=u)
        new = TrackerState(
            mean=pred.mean, cov=pred.cov, past_mean=ts.mean, t=pred.t
        )
        return new, pred.mean, pred.cov

    def update(self, ts: TrackerState, z) -> Tuple[TrackerState, jax.Array, jax.Array]:
        """(new_state, m_{k|k}, P_{k|k})."""
        post = self.filt.update(self._fstate(ts), z)
        new = TrackerState(
            mean=post.mean, cov=post.cov, past_mean=ts.past_mean, t=post.t
        )
        return new, post.mean, post.cov


# Aliases matching the reference wrapper names.
EKFTracker = GaussianTracker
UKFTracker = GaussianTracker
