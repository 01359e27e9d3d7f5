"""Unscented Kalman Filter (2nx+1 sigma points, additive noise).

Capability parity with reference ``models/unscented_kalman_filter.py``:
``UKFState`` (:19), scaled-sigma-point weights (λ, γ, Wm, Wc — :96-104),
symmetrized jittered-Cholesky sigma points (:107-118), Cholesky-solve gain
(:183-186), posterior symmetrization (:190).

Differences from the reference: sigma points are built as one broadcast
(mean ± γ·Lᵀ rows) and propagated through ``g``/``h`` with a single ``vmap``
(the reference loops per sigma point, :144, :165); predicted moments are
einsum contractions.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from particle_filters_jax.core.linalg import chol_solve, chol_with_jitter, symmetrize
from particle_filters_jax.core.linalg import with_f32_matmuls
from particle_filters_jax.core.structs import pytree_dataclass


@pytree_dataclass
class UKFState:
    """Posterior (mean, cov) at discrete time t (reference ``UKFState`` :19)."""

    mean: jax.Array  # (nx,)
    cov: jax.Array  # (nx, nx)
    t: jax.Array  # scalar int32


def make_ukf_state(mean, cov, t: int = 0) -> UKFState:
    return UKFState(
        mean=jnp.asarray(mean), cov=jnp.asarray(cov), t=jnp.asarray(t, jnp.int32)
    )


class UnscentedKalmanFilter:
    """UKF for additive Gaussian noise:

        x_k = g(x_{k−1}, u_{k−1}) + w,  w ~ N(0, Q)
        z_k = h(x_k) + v,               v ~ N(0, R)

    using 2·nx+1 scaled sigma points. Parameters (alpha, beta, kappa, jitter)
    match the reference's constructor (:70-104).

    float32 note: the UT mean/cov weights scale as O(1/α²); each propagated
    sigma point carries rounding error eps·|x|, so the reconstructed moments
    carry error ≈ eps·|x|/α². At the reference's α=1e-3 default this is ~10%
    of |x| in float32 (fine in the reference's float64 NumPy). In float32
    use α ≳ 0.05 — for a linear/mildly-nonlinear model the UT is α-independent,
    so this costs nothing (see the deviation-form ``_ut_mean``).
    """

    def __init__(
        self,
        g: Callable,
        h: Callable,
        Q,
        R,
        *,
        alpha: float = 1e-3,
        beta: float = 2.0,
        kappa: float = 0.0,
        jitter: float = 0.0,
    ) -> None:
        self.g = g
        self.h = h
        self.Q = jnp.asarray(Q)
        self.R = jnp.asarray(R)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.kappa = float(kappa)
        self.jitter = float(jitter)

        self.nx = int(self.Q.shape[0])
        if self.Q.shape != (self.nx, self.nx):
            raise ValueError("Q must be (nx, nx).")
        self.nz = int(self.R.shape[0])
        if self.R.shape != (self.nz, self.nz):
            raise ValueError("R must be (nz, nz).")

        # Unscented transform weights (reference :96-104)
        self._lambda = self.alpha**2 * (self.nx + self.kappa) - self.nx
        self._gamma = float(np.sqrt(self.nx + self._lambda))
        n_sigma = 2 * self.nx + 1
        wm = np.full(n_sigma, 1.0 / (2.0 * (self.nx + self._lambda)))
        wc = wm.copy()
        wm[0] = self._lambda / (self.nx + self._lambda)
        wc[0] = wm[0] + (1.0 - self.alpha**2 + self.beta)
        self.Wm = jnp.asarray(wm, self.Q.dtype)
        self.Wc = jnp.asarray(wc, self.Q.dtype)

    # ------------------------------ helpers ------------------------------

    def _sigma_points(self, mean: jax.Array, cov: jax.Array) -> jax.Array:
        """(2nx+1, nx) sigma points: [μ; μ ± γ·(L columns)] (reference :107)."""
        L = chol_with_jitter(symmetrize(cov), jitter=self.jitter)
        offsets = self._gamma * L.T  # row i = γ·L[:, i]
        return jnp.concatenate(
            [mean[None, :], mean[None, :] + offsets, mean[None, :] - offsets], axis=0
        )

    def _ut_mean(self, Y: jax.Array) -> jax.Array:
        """Unscented mean in deviation form: ȳ = Y₀ + w₁ Σᵢ(Yᵢ − Y₀).

        Mathematically identical to ``Wm @ Y`` (ΣWm = 1, Wm[1:] all equal)
        but float32-safe: at small alpha the direct weights are O(±1/α²) and
        the reference's float64 ``np.sum(Wm[:,None]·Y)`` (:147) would lose
        ~6 digits to cancellation here. The ±γL deviation pairs cancel to
        O(γ²·curvature) before scaling, so no large weights ever meet.
        """
        dev = Y[1:] - Y[0]
        return Y[0] + self.Wm[1] * jnp.sum(dev, axis=0)

    # ------------------------------ core ops ------------------------------

    @with_f32_matmuls
    def predict(self, state: UKFState, u=None) -> UKFState:
        """Unscented transform through g (reference :129); vmapped."""
        X = self._sigma_points(state.mean, state.cov)
        X_prop = jax.vmap(lambda xi: self.g(xi, u))(X)
        x_pred = self._ut_mean(X_prop)
        DX = X_prop - x_pred
        P_pred = self.Q + jnp.einsum("i,ij,ik->jk", self.Wc, DX, DX)
        return UKFState(mean=x_pred, cov=P_pred, t=state.t + 1)

    @with_f32_matmuls
    def update(self, pred: UKFState, z) -> UKFState:
        """Unscented transform through h + Kalman update (reference :154)."""
        z = jnp.asarray(z)
        X = self._sigma_points(pred.mean, pred.cov)
        Z = jax.vmap(self.h)(X)
        z_pred = self._ut_mean(Z)
        DZ = Z - z_pred
        S = symmetrize(self.R + jnp.einsum("i,ij,ik->jk", self.Wc, DZ, DZ))
        DX = X - pred.mean
        Pxz = jnp.einsum("i,ij,ik->jk", self.Wc, DX, DZ)

        L = chol_with_jitter(S, jitter=self.jitter)
        K = chol_solve(L, Pxz.T).T

        x_post = pred.mean + K @ (z - z_pred)
        P_post = symmetrize(pred.cov - K @ S @ K.T)
        return UKFState(mean=x_post, cov=P_post, t=pred.t)

    def step(self, state: UKFState, z, u=None) -> UKFState:
        """Predict then update (reference :194)."""
        return self.update(self.predict(state, u=u), z)

    def run(self, state0: UKFState, zs: jax.Array, us: Optional[jax.Array] = None):
        """Filter a (T, nz) observation sequence in one ``lax.scan``."""
        if us is None:
            def body(s, z):
                s = self.step(s, z)
                return s, (s.mean, s.cov)

            final, (means, covs) = lax.scan(body, state0, zs)
        else:
            def body(s, zu):
                z, u = zu
                s = self.step(s, z, u=u)
                return s, (s.mean, s.cov)

            final, (means, covs) = lax.scan(body, state0, (zs, us))
        return final, means, covs
