"""Entropy-regularized optimal-transport (Sinkhorn) differentiable resampling.

Parity with reference ``models/DPF_OT_resampling.py``: squared-Euclidean cost
(:8-33), damped dual c-transform updates f ← ½(f + τ_ε(b, g, C_row))
(:36-68, :151-164), transport plan P = a bᵀ ⊙ exp((f⊕g−C)/ε) (:184-194),
barycentric projection x'ⱼ = (Pᵀx)/bⱼ (:200-201), uniform output weights,
plus OT-distance / sparsity / dual diagnostics (:206-231).

Difference from the reference: the reference runs the two c-transforms as per-row /
per-column Python ``TensorArray`` loops — O(n_iters·N·N) with interpreter
overhead and its 3.55 s/step at N=50 (BASELINE.md). Here each half-update is one
batched logsumexp over the full cost matrix (f⊕g via broadcast),
and the iteration is a ``lax.scan`` — differentiable by unrolling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from particle_filters_jax.core.weights import uniform_logw
from particle_filters_jax.resampling.soft import log_normalize_lastaxis


def pairwise_squared_distances(x: jax.Array, y: jax.Array) -> jax.Array:
    """C[i, j] = ‖x_i − y_j‖² via the (x² + y² − 2xy) expansion (one matmul —
    a matmul); clamped at 0 (reference :8-33)."""
    x_sq = jnp.sum(x * x, axis=-1, keepdims=True)  # (N, 1)
    y_sq = jnp.sum(y * y, axis=-1, keepdims=True)  # (M, 1)
    xy = x @ y.T
    return jnp.maximum(x_sq - 2.0 * xy + y_sq.T, 0.0)


def sinkhorn_ot_resample(
    particles: jax.Array,
    weights: jax.Array,
    *,
    epsilon: float = 0.1,
    n_iters: int = 50,
    min_val: float = 1e-12,
    tol: float = 1e-6,
    damping: float = 0.5,
    return_diagnostics: bool = False,
):
    """Sinkhorn-OT resample of an (N, d) cloud with linear weights (N,).

    Returns ``(new_particles, new_weights)`` with uniform ``new_weights``,
    optionally plus a diagnostics dict. Differentiable end to end: the dual
    iteration is an unrolled ``lax.scan`` with damped c-transform updates
    (no data-dependent early exit under jit; convergence is *reported* via
    the final dual deltas instead — reference :169-181 early-breaks, which
    would force a host sync here).
    """
    n = particles.shape[0]
    dtype = particles.dtype

    w = jnp.maximum(weights, min_val)
    a = w / (jnp.sum(w) + min_val)  # source mass
    log_a = jnp.log(a)
    log_b = jnp.full((n,), -jnp.log(jnp.asarray(n, dtype)), dtype)  # uniform

    C = pairwise_squared_distances(particles, particles)

    def tau_f(g):
        # τ_i = −ε logsumexp_j (log b_j + (g_j − C_ij)/ε)
        return -epsilon * jax.scipy.special.logsumexp(
            log_b[None, :] + (g[None, :] - C) / epsilon, axis=1
        )

    def tau_g(f):
        return -epsilon * jax.scipy.special.logsumexp(
            log_a[:, None] + (f[:, None] - C) / epsilon, axis=0
        )

    def body(carry, _):
        f, g = carry
        f_new = (1.0 - damping) * f + damping * tau_f(g)
        g_new = (1.0 - damping) * g + damping * tau_g(f_new)
        delta = jnp.maximum(
            jnp.max(jnp.abs(f_new - f)), jnp.max(jnp.abs(g_new - g))
        )
        return (f_new, g_new), delta

    (f, g), deltas = lax.scan(
        body, (jnp.zeros((n,), dtype), jnp.zeros((n,), dtype)), None, length=n_iters
    )

    # Transport plan and barycentric projection (reference :184-201).
    log_P = log_a[:, None] + log_b[None, :] + (f[:, None] + g[None, :] - C) / epsilon
    P = jnp.exp(log_P)
    new_particles = (P.T @ particles) * n  # ÷ b_j with b_j = 1/N
    new_weights = jnp.exp(log_b)

    if not return_diagnostics:
        return new_particles, new_weights

    ot_distance = jnp.sum(P * C)
    sparsity = jnp.mean((P > 1e-6).astype(dtype))
    diagnostics = {
        "final_delta": deltas[-1],
        "converged": deltas[-1] < tol,
        "convergence_history": deltas,
        "ot_distance": ot_distance,
        "transport_plan_sparsity": sparsity,
        "dual_variables": {
            "f_mean": jnp.mean(f),
            "f_std": jnp.std(f),
            "g_mean": jnp.mean(g),
            "g_std": jnp.std(g),
        },
        "epsilon": epsilon,
    }
    return new_particles, new_weights, diagnostics


def ot_resample(
    key: jax.Array,
    particles: jax.Array,
    log_weights: jax.Array,
    *,
    epsilon: float = 0.1,
    n_iters: int = 50,
    damping: float = 0.5,
    return_aux: bool = False,
):
    """Shared-resampler-interface wrapper: ``(key, particles, logw) →
    (new_particles, uniform logw[, aux])``. The key is unused (OT resampling
    is deterministic given the cloud) but kept for interface uniformity."""
    del key
    logw_n, _ = log_normalize_lastaxis(log_weights)
    out = sinkhorn_ot_resample(
        particles,
        jnp.exp(logw_n),
        epsilon=epsilon,
        n_iters=n_iters,
        damping=damping,
        return_diagnostics=return_aux,
    )
    n = particles.shape[-2]
    new_logw = uniform_logw(n, log_weights.dtype)
    if return_aux:
        new_particles, _, diag = out
        return new_particles, new_logw, diag
    new_particles, _ = out
    return new_particles, new_logw
