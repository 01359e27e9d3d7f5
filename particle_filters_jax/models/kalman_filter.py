"""General (time-varying) Kalman filter as a single ``lax.scan``.

Capability parity with reference ``models/kalman_filter.py:79``
(``kalman_filter_general``): same model

    x_k = Φ_{k−1} x_{k−1} + B_{k−1} u_{k−1} + Γ_{k−1} w_{k−1},  w ~ N(0, Q)
    y_k = H_k x_k + v_k,                                        v ~ N(0, R)

same outputs (priors, posteriors, gains, innovations, S, total loglik),
standard or Joseph-stabilized covariance update, Cholesky-solve gain, jitter
on S. The reference's N-step Python loop (:183-240) becomes one scan whose
carry is (m, P, loglik); time-varying parameters are stacked leading-axis
arrays instead of Python lists (``_as_sequence``, reference :45) — XLA then
fuses the whole filter into one program.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

from particle_filters_jax.core.linalg import chol_solve, chol_with_jitter, with_f32_matmuls, _LOG_2PI
from particle_filters_jax.core.structs import pytree_dataclass


@pytree_dataclass
class KFResults:
    """Outputs of the general Kalman filter (reference ``KFResults`` :11)."""

    x_pred: jax.Array  # (N, nx)
    P_pred: jax.Array  # (N, nx, nx)
    x_filt: jax.Array  # (N, nx)
    P_filt: jax.Array  # (N, nx, nx)
    K: jax.Array  # (N, nx, ny)
    innov: jax.Array  # (N, ny)
    S: jax.Array  # (N, ny, ny)
    loglik: jax.Array  # scalar


def _as_stacked(M, N: int, name: str, ndim: int = 2) -> jax.Array:
    """Broadcast a time-invariant matrix to a (N, ...) stack, or validate an
    already-stacked (N, ...) input. JAX analog of reference ``_as_sequence``
    (:45) — a leading time axis instead of a Python list."""
    M = jnp.asarray(M)
    if M.ndim == ndim:
        return jnp.broadcast_to(M, (N,) + M.shape)
    if M.ndim == ndim + 1:
        if M.shape[0] != N:
            raise ValueError(f"{name} must have leading length N={N} (got {M.shape[0]}).")
        return M
    raise ValueError(f"{name} must have {ndim} or {ndim + 1} dims, got {M.ndim}.")


@with_f32_matmuls
def kalman_filter_general(
    Y: jax.Array,
    Phi,
    H,
    Gamma,
    Q,
    R,
    *,
    B=None,
    U: Optional[jax.Array] = None,
    x0: jax.Array,
    P0: jax.Array,
    use_joseph: bool = False,
    jitter: float = 1e-9,
) -> KFResults:
    """Run the general Kalman filter over an observation sequence Y (N, ny).

    Signature and semantics parity with reference ``kalman_filter_general``
    (``models/kalman_filter.py:79``): predict (:193-194), jittered innovation
    covariance (:202-205), gain by Cholesky solve (:217-218), Joseph or
    standard update (:224-227), exact Gaussian log-likelihood (:229-234).
    """
    Y = jnp.asarray(Y)
    if Y.ndim != 2:
        raise ValueError("Y must be 2D with shape (N, ny).")
    N, ny = Y.shape
    x0 = jnp.asarray(x0).reshape(-1)
    nx = x0.shape[0]
    P0 = jnp.asarray(P0)
    dtype = P0.dtype

    Phi_s = _as_stacked(Phi, N, "Phi")
    H_s = _as_stacked(H, N, "H")
    Gamma_s = _as_stacked(Gamma, N, "Gamma")
    Q_s = _as_stacked(Q, N, "Q")
    R_s = _as_stacked(R, N, "R")

    if B is None:
        B_s = jnp.zeros((N, nx, 1), dtype)
        nu_dim = 1
    else:
        B_s = _as_stacked(B, N, "B")
        nu_dim = B_s.shape[-1]
    if U is None:
        U_arr = jnp.zeros((N, nu_dim), dtype)
    else:
        U_arr = jnp.asarray(U)
        if U_arr.shape != (N, nu_dim):
            raise ValueError("U must have shape (N, n_u) matching B_k.")

    I = jnp.eye(nx, dtype=dtype)
    jit_eye = jitter * jnp.eye(ny, dtype=dtype)

    def step(carry, inputs):
        m, P, loglik = carry
        y_k, Phi_k, H_k, Gam_k, Q_k, R_k, B_k, u_k = inputs

        # Prediction (time update)
        m_minus = Phi_k @ m + B_k @ u_k
        P_minus = Phi_k @ P @ Phi_k.T + Gam_k @ Q_k @ Gam_k.T

        # Innovation
        nu_k = y_k - H_k @ m_minus
        S_k = H_k @ P_minus @ H_k.T + R_k + jit_eye
        L = chol_with_jitter(S_k)

        # K = (P⁻ Hᵀ) S⁻¹ via two triangular solves
        PHt = P_minus @ H_k.T
        K_k = chol_solve(L, PHt.T).T

        m_plus = m_minus + K_k @ nu_k
        if use_joseph:
            ImKH = I - K_k @ H_k
            P_plus = ImKH @ P_minus @ ImKH.T + K_k @ R_k @ K_k.T
        else:
            P_plus = P_minus - K_k @ (H_k @ P_minus)

        # Exact Gaussian log-likelihood increment
        alpha = chol_solve(L, nu_k)
        quad = nu_k @ alpha
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diag(L)))
        loglik = loglik + (-0.5) * (quad + logdet + ny * _LOG_2PI)

        out = (m_minus, P_minus, m_plus, P_plus, K_k, nu_k, S_k)
        return (m_plus, P_plus, loglik), out

    init = (x0.astype(dtype), P0, jnp.zeros((), dtype))
    (_, _, loglik), outs = lax.scan(
        step, init, (Y, Phi_s, H_s, Gamma_s, Q_s, R_s, B_s, U_arr)
    )
    x_pred, P_pred, x_filt, P_filt, K_all, innov, S_all = outs
    return KFResults(
        x_pred=x_pred,
        P_pred=P_pred,
        x_filt=x_filt,
        P_filt=P_filt,
        K=K_all,
        innov=innov,
        S=S_all,
        loglik=loglik,
    )
