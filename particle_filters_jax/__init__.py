"""particle_filters_jax — a sequential Monte Carlo engine in JAX.

A ground-up, accelerator-first rebuild of the capabilities of the
``liyiyang-amber/Particle_filters`` filtering zoo:

- ``simulators/``: six state-space-model generators (LGSSM, 1-D stochastic
  volatility, Lorenz-96, linear-Gaussian & skew-t spatial sensor networks,
  multi-target acoustic tracking) as pure ``lax.scan`` step functions.
- ``models/``: the filter ladder — KF / EKF / UKF, SIR particle filter,
  EDH / LEDH deterministic particle flows, kernel particle flow (KPF),
  stochastic particle flow (SPF), and differentiable particle filters with
  soft / optimal-transport / RNN resampling — as vmapped per-particle
  propagate/weight kernels with log-domain weight arithmetic.
- ``resampling/``: shared resampler interface (systematic, multinomial,
  stratified, residual; differentiable soft/OT/RNN).
- ``ops/``: Pallas kernels for NVIDIA GPUs (Triton route): the
  systematic-resample gather and the fused SIR step, each with a plain-jnp
  twin that every other backend runs.
- ``parallel/``: particle-axis sharding over a ``jax.sharding.Mesh`` with
  psum-based log-normalizers / ESS, so ensembles of 1e6+ particles scale
  across chips.
- ``utils/``: diagnostics (ESS, NEES, RMSE, coverage, OMAT), npz/json IO
  compatible with the reference's dataset layouts.

Everything is functional: filter state lives in pytree dataclasses, time
recursion is ``lax.scan``, per-particle math is ``vmap``, and randomness is
explicit ``jax.random`` keys.
"""

__version__ = "0.1.0"

from particle_filters_jax.core import structs, weights, linalg  # noqa: F401
from particle_filters_jax import (  # noqa: F401
    models,
    ops,
    parallel,
    resampling,
    simulators,
    utils,
)
