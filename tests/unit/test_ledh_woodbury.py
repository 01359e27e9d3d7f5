"""The LEDH Woodbury flow reformulation is exact.

``LEDHFlowPF._per_particle_flow`` computes Aⁱ via
Wⁱ − WⁱKⁱ⁻¹Wⁱ (two nx×nx Choleskys) instead of factoring the nz×nz
innovation Sⁱ, and the flow log-determinant as an SPD determinant ratio
instead of an LU slogdet. This test checks both against the direct
formulas at float64 on random MAT-scale problems (tolerances allow the
flow's deliberate 1e-8 diagonal jitter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models import (
    ExtendedKalmanFilter,
    GaussianTracker,
    LEDHConfig,
    LEDHFlowPF,
)


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _random_problem(key, nx, nz):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    A = jax.random.normal(k1, (nx, nx), jnp.float64) / jnp.sqrt(nx)
    P = A @ A.T + 0.5 * jnp.eye(nx)
    H = jax.random.normal(k2, (nz, nx), jnp.float64)
    B = jax.random.normal(k3, (nz, nz), jnp.float64) / jnp.sqrt(nz)
    R = B @ B.T + 0.1 * jnp.eye(nz)
    eta = jax.random.normal(k4, (nx,), jnp.float64)
    return P, H, R, eta


@pytest.mark.parametrize("nx,nz", [(16, 25), (4, 25), (16, 3)])
def test_flow_matches_direct_s_factorization(key, x64, nx, nz):
    P, H, R, eta = _random_problem(key, nx, nz)
    z = jax.random.normal(jax.random.fold_in(key, 9), (nz,), jnp.float64)
    eta0 = eta + 0.1
    I = jnp.eye(nx, dtype=jnp.float64)
    lam, dlam = 0.375, 0.125

    # filter with a LINEAR h so Jh is the fixed H above
    h = lambda x: H @ x
    jh = lambda x: H
    ekf = ExtendedKalmanFilter(lambda x, u: x, h, P, R)
    ledh = LEDHFlowPF(
        GaussianTracker(ekf), lambda x, u, v: x, h, jh,
        lambda a, b: 0.0, lambda a, b: 0.0, R, LEDHConfig(n_particles=4),
    )
    P_inv = jnp.linalg.inv(P)
    eta_new, etabar_new, logdet = ledh._per_particle_flow(
        lam, dlam, eta, eta, eta0, P, P_inv, z, I
    )

    # direct formulas (reference LEDH_particle_filter.py:140-179 semantics)
    S = lam * (H @ P @ H.T) + R
    A_direct = -0.5 * P @ H.T @ jnp.linalg.solve(S, H)
    e = h(eta) - H @ eta
    b_direct = (I + 2 * lam * A_direct) @ (
        (I + lam * A_direct) @ (P @ H.T @ jnp.linalg.solve(R, z - e))
        + A_direct @ eta0
    )
    eta_direct = eta + dlam * (A_direct @ eta + b_direct)
    _, logdet_direct = jnp.linalg.slogdet(I + dlam * A_direct)

    np.testing.assert_allclose(
        np.asarray(eta_new), np.asarray(eta_direct), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(etabar_new), np.asarray(eta_direct), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        float(logdet), float(logdet_direct), rtol=1e-6, atol=1e-7
    )


def test_logdet_ratio_at_first_lambda_step(key, x64):
    """Edge of the SPD-ratio identity: lam == dlam (first grid point),
    where the numerator coefficient 1 - dlam/2lam = 1/2."""
    nx, nz = 8, 12
    P, H, R, eta = _random_problem(key, nx, nz)
    z = jnp.zeros((nz,), jnp.float64)
    I = jnp.eye(nx, dtype=jnp.float64)
    lam = dlam = 0.125

    h = lambda x: H @ x
    ekf = ExtendedKalmanFilter(lambda x, u: x, h, P, R)
    ledh = LEDHFlowPF(
        GaussianTracker(ekf), lambda x, u, v: x, h, lambda x: H,
        lambda a, b: 0.0, lambda a, b: 0.0, R, LEDHConfig(n_particles=4),
    )
    _, _, logdet = ledh._per_particle_flow(
        lam, dlam, eta, eta, eta, P, jnp.linalg.inv(P), z, I
    )
    S = lam * (H @ P @ H.T) + R
    A_direct = -0.5 * P @ H.T @ jnp.linalg.solve(S, H)
    _, expected = jnp.linalg.slogdet(I + dlam * A_direct)
    np.testing.assert_allclose(float(logdet), float(expected), rtol=1e-6)
