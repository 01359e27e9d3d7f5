"""Stochastic particle flow (SPF) with generalized homotopy.

Capability parity with reference ``models/Stochastic_particle_filter.py``:
``LinearGaussianBayes`` (:12 — precisions/Hessians, score functions, analytic
Kalman posterior), spectral condition number κ₂ and its β-derivative via
eigendecomposition + eigenvector perturbation (:123-167), the "optimal"
β(λ) schedule solving β'' = µ·dκ₂/dβ with RK4 shooting + bracket expansion
+ bisection (:171-294), and the Euler-Maruyama SDE propagation with drift
K₁∇log p + K₂∇log h and diffusion Q ∈ {scaled identity, M⁻¹} (:300-411).

Design: the shooting integration is a ``lax.scan`` (one eigh per
grid point), bracket expansion and bisection are ``lax.while_loop`` /
``fori_loop`` (fully jittable — the reference shells out to host NumPy),
and the per-particle Euler-Maruyama loop (:397-404) is batched matrix
algebra over the whole cloud.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from particle_filters_jax.core.linalg import chol_with_jitter, symmetrize, with_f32_matmuls
from particle_filters_jax.core.structs import pytree_dataclass


@pytree_dataclass
class LinearGaussianBayes:
    """Single-update linear-Gaussian model: prior x ~ N(m0, P0), likelihood
    z|x ~ N(Hx, R) (reference :12-121). Build with :meth:`create` so the
    derived precision/Hessian fields are precomputed once."""

    m0: jax.Array  # (n,)
    P0: jax.Array  # (n, n)
    H: jax.Array  # (d, n)
    R: jax.Array  # (d, d)
    z: jax.Array  # (d,)
    P0_inv: jax.Array
    R_inv: jax.Array
    Hess_log_p0: jax.Array  # −P0⁻¹
    Hess_log_h: jax.Array  # −HᵀR⁻¹H
    M0: jax.Array  # P0⁻¹
    Mh: jax.Array  # HᵀR⁻¹H

    @classmethod
    def create(cls, m0, P0, H, R, z) -> "LinearGaussianBayes":
        m0 = jnp.asarray(m0).reshape(-1)
        z = jnp.asarray(z).reshape(-1)
        P0 = jnp.asarray(P0)
        H = jnp.asarray(H)
        R = jnp.asarray(R)
        n, d = m0.shape[0], z.shape[0]
        if P0.shape != (n, n) or H.shape != (d, n) or R.shape != (d, d):
            raise ValueError("Inconsistent shapes for LinearGaussianBayes.")
        P0_inv = chol_solve_eye(P0)
        R_inv = chol_solve_eye(R)
        Mh = symmetrize(H.T @ R_inv @ H)
        return cls(
            m0=m0,
            P0=P0,
            H=H,
            R=R,
            z=z,
            P0_inv=P0_inv,
            R_inv=R_inv,
            Hess_log_p0=-P0_inv,
            Hess_log_h=-Mh,
            M0=symmetrize(P0_inv),
            Mh=Mh,
        )

    @property
    def n(self) -> int:
        return self.m0.shape[0]

    @property
    def d(self) -> int:
        return self.z.shape[0]

    def grad_log_p0(self, x: jax.Array) -> jax.Array:
        """∇log p₀ = −P0⁻¹(x − m0); batched over leading axes (:76)."""
        return -(x - self.m0) @ self.P0_inv.T

    def grad_log_h(self, x: jax.Array) -> jax.Array:
        """∇log h = HᵀR⁻¹(z − Hx); batched over leading axes (:91)."""
        return (self.z - x @ self.H.T) @ (self.R_inv @ self.H)

    def kalman_posterior(self) -> Tuple[jax.Array, jax.Array]:
        """Exact posterior (m, P) for validation (:106)."""
        S = self.H @ self.P0 @ self.H.T + self.R
        K = self.P0 @ self.H.T @ chol_solve_eye(S)
        m_post = self.m0 + K @ (self.z - self.H @ self.m0)
        P_post = (jnp.eye(self.n, dtype=self.P0.dtype) - K @ self.H) @ self.P0
        return m_post, symmetrize(P_post)


def chol_solve_eye(a: jax.Array) -> jax.Array:
    """A⁻¹ via jittered Cholesky."""
    L = chol_with_jitter(a, initial=1e-12)
    return jax.scipy.linalg.cho_solve(
        (L, True), jnp.eye(a.shape[0], dtype=a.dtype)
    )


def kappa2_and_derivative(
    M: jax.Array, dM_dbeta: jax.Array, eps: float = 1e-12
) -> Tuple[jax.Array, jax.Array]:
    """Spectral condition number κ₂(M) and dκ₂/dβ via first-order
    eigenvalue perturbation (reference :123-167)."""
    M = symmetrize(M)
    dM = symmetrize(dM_dbeta)
    n = M.shape[0]
    w, V = jnp.linalg.eigh(M + eps * jnp.eye(n, dtype=M.dtype))
    lam_min = jnp.maximum(jnp.abs(w[0]), eps)
    lam_max = jnp.maximum(jnp.abs(w[-1]), eps)
    vmin, vmax = V[:, 0], V[:, -1]
    dlam_min = vmin @ dM @ vmin
    dlam_max = vmax @ dM @ vmax
    kappa = lam_max / lam_min
    dkappa = dlam_max / lam_min - (lam_max * dlam_min) / lam_min**2
    return kappa, dkappa


@with_f32_matmuls
def solve_beta_star_bisection(
    M0: jax.Array,
    Mh: jax.Array,
    mu: float,
    n_grid: int = 501,
    s_lo: float = -5.0,
    s_hi: float = 5.0,
    max_bracket_expand: int = 30,
    max_bisect_iter: int = 60,
    rhs_mode: str = "tabulated",
    n_beta_tab: int = 2048,
    bounded: bool = False,
    solver: str = "multisection",
    multisect_width: int = 64,
    multisect_rounds: int = 5,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Optimal β(λ): shoot β'' = µ·dκ₂/dβ with β(0)=0 to hit β(1)=1
    (reference :171-294). Fully traceable: RK4 shooting is a scan, bracket
    expansion a while_loop (or a bounded fori_loop, below), bisection a
    fori_loop.

    ``rhs_mode`` selects how dκ₂/dβ is evaluated along the shooting
    trajectory:

    - ``"tabulated"`` (default): ONE batched eigh over a dense β grid on
      the clip interval [−0.5, 1.5] tabulates λ_min/λ_max of M(β) and
      their β-derivatives; the shooting RK4 stages linearly interpolate
      THOSE (smooth, |dλ| ≤ ‖Mh‖₂) and form dκ₂/dβ's rational expression
      exactly (~20 scalar ops each). The reference evaluates an eigh at
      EVERY shooting stage (:225-254 × :123-167 ≈ 1.3e5 sequential n×n
      eigh per solve). Interpolating the
      eigenvalues rather than dκ₂/dβ itself keeps the table exact near
      the 1/λ_min² blow-up that ill-conditioned priors put next to the
      shooting domain (see the inline note).
    - ``"exact"``: the reference's per-stage eigh (bit-compatible with the
      r3 behavior; used by equivalence tests).

    ``solver`` selects the root find for the shooting slope s = β'(0):

    - ``"multisection"`` (default): batched bracketing — every round
      evaluates a whole vector of candidate slopes in ONE vmapped
      shooting scan (round 0: the full doubling ladder; rounds 1..k: a
      ``multisect_width``-point split of the bracket). ~6 sequential
      scans instead of ~85, which is the whole cost when each RK4 stage
      is bound by launch overhead. While-free by construction, so
      it composes with outer vmap/scan (no ``bounded`` needed).
    - ``"bisection"``: the reference's sequential bracket + bisection
      (:261-287), one shooting scan per F-evaluation. Same root to f32
      resolution (pinned by ``tests/unit/test_spf.py``).

    ``bounded=True`` (bisection only) replaces the bracket-expansion
    ``lax.while_loop`` with a masked ``fori_loop`` of exactly
    ``max_bracket_expand`` iterations (converged iterations recompute and
    discard). It was written for a backend that faulted on a while_loop
    nested inside vmap/scan layers (whether any backend still needs it is
    ROADMAP C4), at the cost of always paying the worst-case bracket
    work. The two variants produce identical
    schedules (``tests/unit/test_spf.py`` pins it).
    """
    M0 = symmetrize(jnp.asarray(M0))
    Mh = symmetrize(jnp.asarray(Mh))
    dtype = M0.dtype
    lam = jnp.linspace(0.0, 1.0, n_grid, dtype=dtype)
    h = lam[1] - lam[0]

    b_lo, b_hi = -0.5, 1.5  # the clip interval of the rhs (reference :149)
    if rhs_mode == "tabulated":
        # Tabulate the EIGEN-QUANTITIES, not dκ₂/dβ itself: λ_min/λ_max of
        # M(β) and their β-derivatives are smooth and Lipschitz (|dλ| ≤
        # ‖Mh‖₂), so linear interpolation is accurate everywhere — whereas
        # dκ₂/dβ = dλ_max/λ_min − λ_max·dλ_min/λ_min² blows up like
        # 1/(β−β₀)² where M(β) approaches singular, and interpolating IT
        # directly is catastrophically wrong near β₀ (ill-conditioned
        # priors put β₀ within Δβ of the shooting domain: spf example 1's
        # P0=diag(1000,2) has β₀ ≈ −7e-4, where the naive dκ table skewed
        # β′(0) 24→157 and tripled the posterior RMSE). The rational
        # expression is formed EXACTLY from the interpolated eigenvalues at
        # every stage, so the 1/λ_min² structure is analytic, not sampled.
        tab = jnp.linspace(b_lo, b_hi, n_beta_tab, dtype=dtype)
        eye = jnp.eye(M0.shape[0], dtype=dtype)

        def _eig_parts(b):
            w, V = jnp.linalg.eigh(symmetrize(M0 + b * Mh) + 1e-12 * eye)
            lam_min = jnp.maximum(jnp.abs(w[0]), 1e-12)
            lam_max = jnp.maximum(jnp.abs(w[-1]), 1e-12)
            return (
                lam_min,
                lam_max,
                V[:, 0] @ Mh @ V[:, 0],
                V[:, -1] @ Mh @ V[:, -1],
            )

        parts_tab = jax.vmap(_eig_parts)(tab)  # 4 × (n_beta_tab,)
        packed_tab = jnp.stack(parts_tab, axis=-1)  # (n_beta_tab, 4)
        inv_db = jnp.asarray((n_beta_tab - 1) / (b_hi - b_lo), dtype)

        def rhs(beta):
            pos = (jnp.clip(beta, b_lo, b_hi) - b_lo) * inv_db
            i0 = jnp.clip(pos.astype(jnp.int32), 0, n_beta_tab - 2)
            frac = pos - i0.astype(dtype)
            if jnp.ndim(beta) == 0:
                # scalar stage (bisection / final trajectory): two
                # dynamic-slice lookups per table
                lam_min, lam_max, dlam_min, dlam_max = (
                    p[i0] * (1.0 - frac) + p[i0 + 1] * frac
                    for p in parts_tab
                )
            else:
                # batched stage (multisection): a (B, 2048) one-hot
                # compare + one matmul stands in for the 8·B-element
                # table gather
                idx = jnp.arange(n_beta_tab, dtype=jnp.int32)[None, :]
                i0c = i0[:, None]
                w = jnp.where(
                    idx == i0c, (1.0 - frac)[:, None], 0.0
                ) + jnp.where(idx == i0c + 1, frac[:, None], 0.0)
                lam_min, lam_max, dlam_min, dlam_max = jnp.moveaxis(
                    w @ packed_tab, -1, 0
                )
            dk = dlam_max / lam_min - (lam_max * dlam_min) / lam_min**2
            return mu * dk

    elif rhs_mode == "exact":

        def rhs(beta):
            beta = jnp.clip(beta, b_lo, b_hi)
            if jnp.ndim(beta) == 0:
                _, dk = kappa2_and_derivative(M0 + beta * Mh, Mh)
            else:  # batched stage (multisection)
                _, dk = jax.vmap(
                    lambda b: kappa2_and_derivative(M0 + b * Mh, Mh)
                )(beta)
            return mu * dk

    else:
        raise ValueError("rhs_mode must be 'tabulated' or 'exact'.")

    def rk4_body(carry, _):
        y1, y2 = carry
        k11, k12 = y2, rhs(y1)
        k21, k22 = y2 + 0.5 * h * k12, rhs(y1 + 0.5 * h * k11)
        k31, k32 = y2 + 0.5 * h * k22, rhs(y1 + 0.5 * h * k21)
        k41, k42 = y2 + h * k32, rhs(y1 + h * k31)
        y1n = y1 + (h / 6.0) * (k11 + 2 * k21 + 2 * k31 + k41)
        y2n = y2 + (h / 6.0) * (k12 + 2 * k22 + 2 * k32 + k42)
        return (y1n, y2n), (y1n, y2n)

    def integrate(s0):
        """Shoot from β(0)=0 with slope(s) ``s0`` — scalar or a (B,) batch
        of candidate slopes (the scan carry broadcasts; rhs is
        shape-polymorphic)."""
        s0 = jnp.asarray(s0, dtype)
        (bf, _), (betas, betadots) = lax.scan(
            rk4_body,
            (jnp.zeros_like(s0), s0),
            None,
            length=n_grid - 1,
        )
        beta = jnp.concatenate([jnp.zeros_like(s0)[None], betas])
        betadot = jnp.concatenate([s0[None], betadots])
        return beta, betadot

    def F(s0):
        beta, _ = integrate(s0)
        return beta[-1] - 1.0

    if solver == "multisection":
        # While-free batched root find: ONE vmapped shooting scan per
        # round instead of one scan per bracket/bisection F-evaluation
        # (~6 sequential scans vs ~85 — when each RK4 stage is bound by
        # launch overhead, wall time scales with the NUMBER of sequential
        # scans, not the batch width). Round 0 evaluates the bisection path's
        # whole doubling ladder s_lo·2^k / s_hi·2^k at once; each later
        # round splits the bracket into ``multisect_width−1`` cells and
        # keeps the first sign change, shrinking the bracket ~63× per
        # round (5 rounds ≈ 63⁵ ≈ 1e9 ≫ f32 resolution — equivalence
        # with bisection is pinned by tests/unit/test_spf.py at 1e-4 on
        # β). No while_loop anywhere, so this composes with outer
        # vmap/scan without the ``bounded`` variant.
        ks = jnp.arange(max_bracket_expand + 1, dtype=dtype)
        cand = jnp.sort(
            jnp.concatenate(
                [jnp.asarray(s_lo, dtype) * 2.0**ks,
                 jnp.asarray(s_hi, dtype) * 2.0**ks]
            )
        )

        def _first_change(S, FS):
            change = jnp.sign(FS[:-1]) != jnp.sign(FS[1:])
            j = jnp.argmax(change)  # first True (0 if none: degenerate)
            return S[j], S[j + 1]

        lo, hi = _first_change(cand, F(cand))

        def _round(_, c):
            lo, hi = c
            grid = lo + (hi - lo) * jnp.linspace(
                0.0, 1.0, multisect_width, dtype=dtype
            )
            return _first_change(grid, F(grid))

        lo, hi = lax.fori_loop(0, multisect_rounds, _round, (lo, hi))
        s_star = 0.5 * (lo + hi)
        beta, betadot = integrate(s_star)
        beta = jnp.clip(beta.at[0].set(0.0).at[-1].set(1.0), 0.0, 1.0)
        return lam, beta, betadot
    elif solver != "bisection":
        raise ValueError("solver must be 'multisection' or 'bisection'.")

    # Bracket expansion (reference :261-271)
    brk_init = (
        jnp.asarray(s_lo, dtype),
        jnp.asarray(s_hi, dtype),
        F(jnp.asarray(s_lo, dtype)),
        F(jnp.asarray(s_hi, dtype)),
    )
    if bounded:
        # Masked fori_loop: exactly max_bracket_expand iterations; once the
        # bracket holds a sign change the carry freezes (the speculative F
        # evals are computed and discarded — the price of a while-free
        # graph).
        def brk_body_bounded(_, c):
            s_lo_, s_hi_, f_lo_, f_hi_ = c
            done = jnp.sign(f_lo_) != jnp.sign(f_hi_)
            s_lo2 = jnp.where(done, s_lo_, s_lo_ * 2.0)
            s_hi2 = jnp.where(done, s_hi_, s_hi_ * 2.0)
            f_lo2 = jnp.where(done, f_lo_, F(s_lo2))
            f_hi2 = jnp.where(done, f_hi_, F(s_hi2))
            return (s_lo2, s_hi2, f_lo2, f_hi2)

        s_lo_, s_hi_, f_lo_, f_hi_ = lax.fori_loop(
            0, max_bracket_expand, brk_body_bounded, brk_init
        )
    else:

        def brk_cond(c):
            s_lo_, s_hi_, f_lo_, f_hi_, it = c
            return jnp.logical_and(
                jnp.sign(f_lo_) == jnp.sign(f_hi_), it < max_bracket_expand
            )

        def brk_body(c):
            s_lo_, s_hi_, _, _, it = c
            s_lo2, s_hi2 = s_lo_ * 2.0, s_hi_ * 2.0
            return (s_lo2, s_hi2, F(s_lo2), F(s_hi2), it + 1)

        s_lo_, s_hi_, f_lo_, f_hi_, _ = lax.while_loop(
            brk_cond, brk_body, brk_init + (0,)
        )

    # Bisection (reference :277-287)
    def bis_body(_, c):
        s_lo_, s_hi_, f_lo_ = c
        s_mid = 0.5 * (s_lo_ + s_hi_)
        f_mid = F(s_mid)
        same = jnp.sign(f_mid) == jnp.sign(f_lo_)
        s_lo2 = jnp.where(same, s_mid, s_lo_)
        f_lo2 = jnp.where(same, f_mid, f_lo_)
        s_hi2 = jnp.where(same, s_hi_, s_mid)
        return (s_lo2, s_hi2, f_lo2)

    s_lo_, s_hi_, _ = lax.fori_loop(
        0, max_bisect_iter, bis_body, (s_lo_, s_hi_, f_lo_)
    )
    s_star = 0.5 * (s_lo_ + s_hi_)
    beta, betadot = integrate(s_star)
    # Enforce endpoints and clip (reference :291-294)
    beta = jnp.clip(beta.at[0].set(0.0).at[-1].set(1.0), 0.0, 1.0)
    return lam, beta, betadot


@with_f32_matmuls
def run_generalized_spf(
    model: LinearGaussianBayes,
    N: int = 2000,
    n_steps: int = 300,
    beta_mode: str = "optimal",
    mu: float = 1e-2,
    Q_mode: str = "inv_M",
    q_scale: float = 1e-2,
    seed: int = 0,
    key: Optional[jax.Array] = None,
    beta_rhs_mode: str = "tabulated",
    beta_bounded: bool = False,
    beta_solver: str = "multisection",
) -> Tuple[jax.Array, jax.Array, Dict[str, jax.Array]]:
    """Generalized SPF: temper the prior into the posterior by integrating
    the homotopy SDE dX = [K₁∇log p + K₂∇log h] dλ + √Q dW over λ ∈ [0, 1]
    (reference ``run_generalized_spf`` :300-411).

    ``beta_rhs_mode`` / ``beta_bounded`` / ``beta_solver`` forward to
    :func:`solve_beta_star_bisection` (tabulated-vs-exact dκ₂/dβ;
    multisection-vs-bisection root find; bounded while-free bracket).

    Returns (final particles (N, n), mean estimate (n,), info dict with the
    λ/β/β' grids).
    """
    if key is None:
        key = jax.random.PRNGKey(seed)
    n = model.n
    dtype = model.P0.dtype

    k_init, k_noise = jax.random.split(key)
    L0 = chol_with_jitter(model.P0)
    X0 = model.m0 + jax.random.normal(k_init, (N, n), dtype) @ L0.T

    if beta_mode == "linear":
        lam_grid = jnp.linspace(0.0, 1.0, n_steps + 1, dtype=dtype)
        beta_grid = lam_grid
        betadot_grid = jnp.ones_like(lam_grid)
    elif beta_mode == "optimal":
        lam_grid, beta_grid, betadot_grid = solve_beta_star_bisection(
            model.M0, model.Mh, mu=mu, n_grid=n_steps + 1,
            rhs_mode=beta_rhs_mode, bounded=beta_bounded,
            solver=beta_solver,
        )
    else:
        raise ValueError("beta_mode must be 'linear' or 'optimal'.")

    dlam = 1.0 / n_steps
    H0 = model.Hess_log_p0
    Hh = model.Hess_log_h
    I = jnp.eye(n, dtype=dtype)
    if Q_mode not in ("scaled_identity", "inv_M"):
        raise ValueError("Q_mode must be 'scaled_identity' or 'inv_M'.")

    noise = jax.random.normal(k_noise, (n_steps, N, n), dtype)

    def step(X, inputs):
        beta, beta_p, Z = inputs
        S = symmetrize(H0 + beta * Hh)
        # S is negative definite (−M with M SPD): factor −S.
        M = -S
        LM = chol_with_jitter(M, initial=1e-12)
        Minv = jax.scipy.linalg.cho_solve((LM, True), I)
        Sinv = -Minv
        if Q_mode == "scaled_identity":
            Q = (q_scale**2) * I
            LQ = q_scale * I
        else:  # inv_M: Q = M⁻¹ (SPD)
            Q = Minv
            LQ = chol_with_jitter(Q, initial=1e-12)
        K2 = -beta_p * Sinv
        K1 = 0.5 * Q + 0.5 * beta_p * (Sinv @ Hh @ Sinv)

        # Batched scores and drift (the reference's per-particle loop :397)
        G_h = model.grad_log_h(X)  # (N, n)
        G_p = model.grad_log_p0(X) + beta * G_h
        f = G_p @ K1.T + G_h @ K2.T
        X_new = X + dlam * f + jnp.sqrt(dlam) * (Z @ LQ.T)
        return X_new, None

    X, _ = lax.scan(
        step, X0, (beta_grid[:-1], betadot_grid[:-1], noise)
    )
    info = {"lam": lam_grid, "beta": beta_grid, "betadot": betadot_grid}
    return X, jnp.mean(X, axis=0), info
