"""Soft (Gumbel-mixture) differentiable resampling.

Parity with reference ``models/DPF_soft_resampling.py``: mixture proposal
q = (1−α)w + α/N (:309-314), per-new-particle Gumbel-Softmax over ancestors
(:176-212, :324-330), barycentric projection x'ᵢ = Σⱼ aᵢⱼ xⱼ (:334), uniform
output weights, and the assignment-entropy diagnostics (:352-364).

Fully differentiable under ``jax.grad`` (reparameterized Gumbel noise); one
einsum for the projection. Operates on the last two axes, so it
vmaps over any batch structure.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp



def sample_gumbel(key: jax.Array, shape, dtype=jnp.float32, eps: float = 1e-20):
    """i.i.d. Gumbel(0, 1) (reference ``_sample_gumbel`` :176)."""
    u = jax.random.uniform(key, shape, dtype, minval=eps, maxval=1.0 - eps)
    return -jnp.log(-jnp.log(u))


def gumbel_softmax(key: jax.Array, log_probs: jax.Array, temperature: float):
    """Gumbel-Softmax relaxation along the last axis (reference :194)."""
    g = sample_gumbel(key, log_probs.shape, log_probs.dtype)
    return jax.nn.softmax((log_probs + g) / temperature, axis=-1)


def soft_resample(
    key: jax.Array,
    particles: jax.Array,
    log_weights: jax.Array,
    *,
    alpha: float = 0.5,
    temperature: float = 0.5,
    return_aux: bool = False,
):
    """Soft resampling: ``(key, particles (..., N, d), logw (..., N)) →
    (new_particles, uniform logw[, aux])``.

    ``alpha`` mixes toward uniform (α=0: pure weights; α=1: pure uniform);
    ``temperature`` controls the Gumbel-Softmax hardness.
    """
    n = particles.shape[-2]
    logw_n, _ = log_normalize_lastaxis(log_weights)
    w = jnp.exp(logw_n)
    probs = (1.0 - alpha) * w + alpha / n
    log_probs = jnp.log(probs + 1e-20)  # (..., N)

    # Every new particle shares the base distribution; independent Gumbel
    # noise per (new, ancestor) pair (reference :324-330).
    tiled = jnp.broadcast_to(
        log_probs[..., None, :], log_probs.shape[:-1] + (n, n)
    )
    assignment = gumbel_softmax(key, tiled, temperature)  # (..., N, N)

    new_particles = jnp.einsum(
        "...ij,...jd->...id", assignment, particles
    )
    new_logw = jnp.broadcast_to(
        -jnp.log(jnp.asarray(n, log_weights.dtype)), log_weights.shape
    )
    if not return_aux:
        return new_particles, new_logw
    assign_entropy = -jnp.sum(
        assignment * jnp.log(assignment + 1e-10), axis=-1
    )  # (..., N)
    aux = {
        "assignment": assignment,
        "assignment_entropy_mean": jnp.mean(assign_entropy),
        "assignment_entropy_std": jnp.std(assign_entropy),
        "max_weight_before": jnp.max(w, axis=-1),
    }
    return new_particles, new_logw, aux


def log_normalize_lastaxis(logw: jax.Array):
    """Stable log-normalize along the last axis (batched variant of
    ``core.weights.log_normalize``)."""
    m = jnp.max(logw, axis=-1, keepdims=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    log_z = m + jnp.log(jnp.sum(jnp.exp(logw - m), axis=-1, keepdims=True))
    return logw - log_z, log_z[..., 0]
