"""Kernel particle filter (particle flow in RKHS).

Capability parity with reference ``models/kernel_particle_filter.py``:
Gaspari-Cohn covariance localization (:10-82), diagonal matrix-valued or
scalar RBF kernels with divergence terms (:85-207), Gaussian-prior score
∇log p(x|y) = JHᵀR⁻¹(y − Hx) − B⁻¹(x − x₀) (:304-317), and the adaptive
pseudo-time flow

    f_s(x) = B · mean_m[ K(x, xₘ) ∇log p(xₘ|y) + ∇ₓ·K(x, xₘ) ]

with per-particle Mahalanobis move clamping (:390-444).

Design:
- all kernels/divergences evaluate for ALL query-ensemble pairs at once —
  (Np, Np, n) broadcast tensors and matmuls instead of the reference's
  per-particle Python loop (:404-434);
- the pseudo-time loop is a ``lax.while_loop`` with a fixed-shape carry;
- the update is simultaneous (Jacobi) — which, on close reading, is also
  the REFERENCE's semantics: its per-particle loop writes into
  ``X_new = X.copy()`` (:403) while evaluating every velocity at
  ``xi = X[idx]`` (:406) against the frozen ensemble with scores ``G``
  recomputed once per sweep (:388/:444), so no particle sees another's
  update within a sweep and ``random_order`` merely permutes independent
  writes (a semantic no-op). ``tests/unit/test_kpf_update_order.py``
  pins this: a NumPy sweep of the reference equations matches
  ``analyze()`` to 2e-4 for both orderings, while a TRUE in-place
  Gauss-Seidel oracle on an adversarial bimodal case lands ~1.2
  Mahalanobis units away — an actually-serial update would be a
  different algorithm, so parity requires Jacobi.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from particle_filters_jax.core.linalg import chol_with_jitter, with_f32_matmuls
from particle_filters_jax.core.structs import pytree_dataclass, static_field


# ------------------- Gaspari–Cohn localization (reference :10-82) ----------


def gaspari_cohn(r: jax.Array) -> jax.Array:
    """Gaspari-Cohn compact-support correlation taper (reference :10-48).

    ``r`` is distance / cutoff-radius; returns values in [0, 1], zero for
    r > 2. Branchless piecewise evaluation.
    """
    r = jnp.asarray(r)
    r_safe = jnp.maximum(r, 1e-12)  # guard the 1/r term
    p1 = 1 - 5 * r**2 / 3 + 5 * r**3 / 8 + r**4 / 2 - r**5 / 4
    p2 = (
        4
        - 5 * r
        + 5 * r**2 / 3
        + 5 * r**3 / 8
        - r**4 / 2
        + r**5 / 12
        - 2 / (3 * r_safe)
    )
    out = jnp.where((r >= 0) & (r <= 1), p1, 0.0)
    return jnp.where((r > 1) & (r <= 2), p2, out)


def build_localization_matrix(
    n: int, radius: float, metric: Optional[jax.Array] = None
) -> jax.Array:
    """(n, n) Gaspari-Cohn localization matrix (reference :52-82);
    ``radius=inf`` disables localization."""
    if np.isinf(radius):
        return jnp.ones((n, n))
    if metric is None:
        idx = jnp.arange(n)
        D = jnp.abs(idx[:, None] - idx[None, :]).astype(jnp.float32)
    else:
        D = jnp.asarray(metric, jnp.float32)
        if D.shape != (n, n):
            raise ValueError("metric must be (n, n).")
    return gaspari_cohn(D / float(radius))


# --------------------------- kernels (reference :85-207) -------------------


def rbf_1d(d: jax.Array, ell) -> Tuple[jax.Array, jax.Array]:
    """K(d) = exp(−½(d/ℓ)²) and dK/dx (reference :85-105)."""
    s2 = (d / ell) ** 2
    K = jnp.exp(-0.5 * s2)
    return K, -(d / ell**2) * K


def scalar_kernel_full_matrix(x, ensemble, lengthscale):
    """Isotropic scalar kernel vs the whole ensemble (reference :108-158):
    returns (k (Np,), grad_k (Np, n), divK (n,))."""
    x = jnp.asarray(x)
    X = jnp.asarray(ensemble)
    D = x[None, :] - X
    r_sq = jnp.sum(D**2, axis=1)
    k = jnp.exp(-0.5 * r_sq / lengthscale**2)
    grad_k = -(k[:, None] / lengthscale**2) * D
    divK = jnp.full((x.shape[0],), jnp.sum(grad_k))
    return k, grad_k, divK


def matrix_kernel_and_divergence(x, ensemble, lengthscales):
    """Diagonal matrix-valued kernel vs the whole ensemble (reference
    :161-207): returns (K_blocks (Np, n), divK (n,))."""
    D = jnp.asarray(x)[None, :] - jnp.asarray(ensemble)
    K, dK = rbf_1d(D, jnp.asarray(lengthscales)[None, :])
    return K, jnp.sum(dK, axis=0)


# ------------------------- model & config (reference :210-242) -------------


@pytree_dataclass
class Model:
    """Observation model: H(x) → (m,), its Jacobian JH(x) → (m, n), noise R
    (reference ``Model`` :210)."""

    H: Callable = static_field(default=None)
    JH: Callable = static_field(default=None)
    R: jax.Array = None


@pytree_dataclass
class KPFConfig:
    """Reference ``KPFConfig`` (:230-242); ``random_order`` is accepted for
    API parity but the update is always simultaneous (Jacobi) — which is
    what the reference's loop computes too (writes into a copy against a
    frozen ensemble, so its shuffle cannot change the result; see module
    docstring and ``tests/unit/test_kpf_update_order.py``)."""

    ds_init: float = static_field(default=0.2)
    ds_min: float = static_field(default=1e-3)
    c_move_max: float = static_field(default=2.0)
    min_steps: int = static_field(default=5)
    max_steps: int = static_field(default=100)
    kernel_type: str = static_field(default="diagonal")  # "diagonal"|"scalar"
    lengthscale_mode: str = static_field(default="std")  # "std"|"fixed"
    fixed_lengthscale: float = static_field(default=1.0)
    reg: float = static_field(default=1e-6)
    localization_radius: float = static_field(default=np.inf)
    random_order: bool = static_field(default=True)
    # While-free pseudo-time loop: a masked fori_loop of exactly max_steps
    # iterations instead of the adaptive lax.while_loop. Identical result
    # (converged iterations recompute and discard). It was written for a
    # backend that faulted on a while_loop nested under extra vmap/scan
    # levels; whether any backend still needs it is ROADMAP C4.
    bounded_loop: bool = static_field(default=False)


@pytree_dataclass
class KPFState:
    """Flow result (reference ``KPFState`` :245-252)."""

    particles: jax.Array  # (Np, n)
    weights: jax.Array  # (Np,)
    s: jax.Array  # pseudo-time reached (scalar)
    steps: jax.Array  # scalar int32
    ds_history: jax.Array  # (max_steps,) step sizes (0 where unused)


# ----------------------------- the filter ---------------------------------


class KernelParticleFilter:
    """Matrix-kernel particle flow filter (reference :256-446)."""

    def __init__(self, model: Model, config: Optional[KPFConfig] = None):
        self.model = model
        self.cfg = config or KPFConfig()

    # ------------------------------ helpers ------------------------------

    @staticmethod
    def mean_and_cov(X: jax.Array, reg: float = 0.0):
        """Sample mean / covariance with ridge (reference :275-283; note the
        reference uses the N−1 normalization here, unlike the SIR PF)."""
        mu = jnp.mean(X, axis=0)
        A = X - mu
        B = (A.T @ A) / max(1, X.shape[0] - 1)
        if reg > 0:
            B = B + reg * jnp.eye(B.shape[1], dtype=B.dtype)
        return mu, B

    def _prior_stats(self, X: jax.Array):
        x0, B = self.mean_and_cov(X, reg=self.cfg.reg)
        L = build_localization_matrix(
            B.shape[0], self.cfg.localization_radius
        ).astype(B.dtype)
        return x0, B * L

    def _lengthscales(self, X: jax.Array) -> jax.Array:
        if self.cfg.lengthscale_mode == "fixed":
            return jnp.full((X.shape[1],), self.cfg.fixed_lengthscale, X.dtype)
        return jnp.std(X, axis=0) + 1e-12

    def _scores(self, X, x0, B_inv, y):
        """∇log p(x|y) for all particles (reference ``_score`` :304-317,
        vmapped)."""
        LR = chol_with_jitter(jnp.asarray(self.model.R), initial=1e-10)

        def score_one(x):
            r = y - self.model.H(x)
            z = jax.scipy.linalg.cho_solve((LR, True), r)
            return self.model.JH(x).T @ z - B_inv @ (x - x0)

        return jax.vmap(score_one)(X)

    # ------------------------------ analyze ------------------------------

    @with_f32_matmuls
    def analyze(
        self,
        X,
        y,
        lengthscales: Optional[jax.Array] = None,
        key: Optional[jax.Array] = None,
    ) -> KPFState:
        """Move the prior ensemble X (Np, n) to the posterior by integrating
        the kernel flow in pseudo-time s ∈ [0, 1] (reference :324-446).

        ``key`` is accepted for API parity with the reference's rng-shuffled
        evaluation order; the update here is simultaneous so it is unused.
        """
        del key
        X = jnp.asarray(X)
        y = jnp.asarray(y)
        Np, n = X.shape
        cfg = self.cfg

        x0, B = self._prior_stats(X)
        B_reg = B + cfg.reg * jnp.eye(n, dtype=B.dtype)
        LB = chol_with_jitter(B_reg)
        B_inv = jax.scipy.linalg.cho_solve((LB, True), jnp.eye(n, dtype=B.dtype))

        use_scalar = cfg.kernel_type == "scalar"
        if use_scalar:
            if lengthscales is not None:
                ell = jnp.asarray(lengthscales).reshape(-1)[0]
            elif cfg.lengthscale_mode == "fixed":
                ell = jnp.asarray(cfg.fixed_lengthscale, X.dtype)
            else:
                ell = jnp.mean(jnp.std(X, axis=0))
        else:
            ell = (
                jnp.asarray(lengthscales)
                if lengthscales is not None
                else self._lengthscales(X)
            )

        def velocity(Xc, G):
            """f_s at every particle simultaneously (replaces the per-index
            loop at reference :404-434)."""
            D = Xc[:, None, :] - Xc[None, :, :]  # (Np, Np, n) x_i − x_m
            if use_scalar:
                r_sq = jnp.sum(D**2, axis=-1)  # (Np, Np)
                k = jnp.exp(-0.5 * r_sq / ell**2)
                G_sum = jnp.sum(G, axis=1)  # (Np,)
                term1 = jnp.mean(k * G_sum[None, :], axis=1)[:, None] * jnp.ones(
                    (1, n), X.dtype
                )
                grad_k = -(k[:, :, None] / ell**2) * D  # (Np, Np, n)
                term2 = jnp.sum(grad_k, axis=(1, 2))[:, None] * jnp.ones(
                    (1, n), X.dtype
                ) / Np
            else:
                K = jnp.exp(-0.5 * (D / ell[None, None, :]) ** 2)
                dK = -(D / ell[None, None, :] ** 2) * K
                term1 = jnp.mean(K * G[None, :, :], axis=1)  # (Np, n)
                term2 = jnp.sum(dK, axis=1) / Np  # (Np, n)
            return (term1 + term2) @ B.T  # (Np, n)

        def clamp_moves(V, ds):
            """Per-particle Mahalanobis move cap (reference :428-434)."""
            dx = ds * V
            move = jnp.sqrt(jnp.einsum("pi,ij,pj->p", dx, B_inv, dx))
            scale = jnp.where(
                move > cfg.c_move_max,
                cfg.c_move_max / jnp.maximum(move, 1e-12),
                1.0,
            )
            return dx * scale[:, None]

        def cond_fn(carry):
            Xc, G, s, steps, ds, hist = carry
            return jnp.logical_or(
                jnp.logical_and(s < 1.0, steps < cfg.max_steps),
                steps < cfg.min_steps,
            )

        def body_fn(carry):
            Xc, G, s, steps, ds, hist = carry
            ds_eff = jnp.where(s + ds > 1.0, 1.0 - s, ds)
            # steps past s=1 forced by min_steps use a tiny positive step
            ds_eff = jnp.maximum(ds_eff, 0.0)
            hist = hist.at[steps].set(ds_eff)
            V = velocity(Xc, G)
            X_new = Xc + clamp_moves(V, ds_eff)
            G_new = self._scores(X_new, x0, B_inv, y)
            return (X_new, G_new, s + ds_eff, steps + 1, ds, hist)

        G0 = self._scores(X, x0, B_inv, y)
        init = (
            X,
            G0,
            jnp.asarray(0.0, X.dtype),
            jnp.asarray(0, jnp.int32),
            jnp.asarray(cfg.ds_init, X.dtype),
            jnp.zeros((cfg.max_steps,), X.dtype),
        )
        if cfg.bounded_loop:
            # Masked fori_loop over the static iteration bound: the body
            # runs max_steps times; once cond_fn would be False the carry
            # freezes (leaf-wise select), so the result matches the
            # while_loop bit for bit while keeping the graph while-free
            # (KPFConfig.bounded_loop).
            def bounded_body(_, carry):
                active = cond_fn(carry)
                new = body_fn(carry)
                return jax.tree.map(
                    lambda n, o: jnp.where(active, n, o), new, carry
                )

            Xf, _, s, steps, _, hist = lax.fori_loop(
                0, max(cfg.max_steps, cfg.min_steps), bounded_body, init
            )
        else:
            Xf, _, s, steps, _, hist = lax.while_loop(cond_fn, body_fn, init)

        return KPFState(
            particles=Xf,
            weights=jnp.full((Np,), 1.0 / Np, X.dtype),
            s=s,
            steps=steps,
            ds_history=hist,
        )
