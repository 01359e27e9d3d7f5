"""Log-domain particle-weight arithmetic.

The reference keeps weights in the log domain with max-subtraction
normalization (reference ``models/particle_filter.py:261-263``,
``models/EDH_particle_filter.py:287-298``) and defines ESS = 1/Σw²
in three separate places (``models/particle_filter.py:134``,
``models/EDH_particle_filter.py:52``, ``models/DPF_soft_resampling.py:84``).
Here they live once, vectorized, and work both on a single shard and across a
device mesh (pass ``axis_name`` inside ``shard_map``/``pmap`` to psum the
partial sums across devices).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _maybe_psum(x, axis_name):
    return x if axis_name is None else lax.psum(x, axis_name)


def _maybe_pmax(x, axis_name):
    return x if axis_name is None else lax.pmax(x, axis_name)


def log_normalize(logw: jax.Array, axis_name: str | None = None):
    """Normalize log-weights stably: returns ``(logw_norm, log_z)``.

    ``logw_norm`` satisfies ``logsumexp(logw_norm) == 0``; ``log_z`` is the
    log-normalizer ``logsumexp(logw)`` (the incremental evidence term).
    With ``axis_name`` the max/sum reductions are global across the mesh
    axis, so each shard holds its slice of globally-normalized weights.
    """
    m = _maybe_pmax(jnp.max(logw), axis_name)
    # Guard fully-degenerate input (all -inf): clamp the max and floor the
    # sum so log_z stays finite and logw_norm stays -inf (not NaN).
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    s = _maybe_psum(jnp.sum(jnp.exp(logw - m)), axis_name)
    log_z = m + jnp.log(jnp.maximum(s, 1e-30))
    return logw - log_z, log_z


def ess_from_logw(logw: jax.Array, axis_name: str | None = None) -> jax.Array:
    """Effective sample size 1/Σwᵢ² from (possibly unnormalized) log-weights."""
    logw_n, _ = log_normalize(logw, axis_name)
    w = jnp.exp(logw_n)
    return 1.0 / jnp.maximum(_maybe_psum(jnp.sum(w * w), axis_name), 1e-30)


def effective_sample_size(w: jax.Array, axis_name: str | None = None) -> jax.Array:
    """ESS = (Σw)²/Σw² for linear-domain weights (need not be normalized)."""
    s1 = _maybe_psum(jnp.sum(w), axis_name)
    s2 = _maybe_psum(jnp.sum(w * w), axis_name)
    return (s1 * s1) / jnp.maximum(s2, 1e-30)


def weight_entropy(logw: jax.Array, axis_name: str | None = None) -> jax.Array:
    """Shannon entropy −Σ wᵢ log wᵢ of normalized weights (in nats).

    Mirrors the diagnostic at reference ``models/DPF_soft_resampling.py:106``.
    """
    logw_n, _ = log_normalize(logw, axis_name)
    w = jnp.exp(logw_n)
    return -_maybe_psum(jnp.sum(jnp.where(w > 0, w * logw_n, 0.0)), axis_name)


def weighted_mean_cov(
    particles: jax.Array,
    logw: jax.Array,
    axis_name: str | None = None,
):
    """Weighted mean and covariance of an (N, d) particle cloud.

    Equivalent of the reference's ``np.average`` + ``np.cov(aweights=w)``
    (``models/particle_filter.py:266-267``) but with the *population*
    normalization (divide by Σw = 1, no Bessel-style correction) — the
    estimator of the filtering covariance, matching
    ``_weighted_stats`` at reference ``models/EDH_particle_filter.py:320``.
    """
    logw_n, _ = log_normalize(logw, axis_name)
    w = jnp.exp(logw_n)  # (N,)
    mean = _maybe_psum(jnp.einsum("n,nd->d", w, particles), axis_name)
    centered = particles - mean
    cov = _maybe_psum(
        jnp.einsum("n,ni,nj->ij", w, centered, centered), axis_name
    )
    return mean, cov


def weighted_mean(
    particles: jax.Array, logw: jax.Array, axis_name: str | None = None
) -> jax.Array:
    logw_n, _ = log_normalize(logw, axis_name)
    return _maybe_psum(
        jnp.einsum("n,nd->d", jnp.exp(logw_n), particles), axis_name
    )


def uniform_logw(n: int, dtype=jnp.float32) -> jax.Array:
    """Normalized uniform log-weights: full(−log N)."""
    return jnp.full((n,), -jnp.log(jnp.asarray(n, dtype=dtype)), dtype=dtype)
