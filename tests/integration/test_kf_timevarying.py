"""Time-varying-parameter Kalman filter, end to end.

Counterpart of the reference's
``tests/integration_tests/test_kf_timevarying_end2end.py``: a slowly
drifting Phi_k with per-step Q/R/Gamma stacks. The reference passes Python
lists of matrices; here the time-varying parameters are (N, ...) stacked
arrays consumed by one ``lax.scan`` (``kalman_filter_general``).
"""

import numpy as np
import pytest

from particle_filters_jax.models.kalman_filter import kalman_filter_general


@pytest.mark.integration
def test_timevarying_parameters_end2end():
    N, nx, ny = 200, 2, 1
    k = np.arange(N)
    a = 0.85 + 0.1 * np.sin(2 * np.pi * k / N)
    Phis = np.zeros((N, nx, nx), np.float32)
    Phis[:, 0, 0] = a
    Phis[:, 0, 1] = 0.1
    Phis[:, 1, 1] = 0.7
    H = np.array([[1.0, 0.0]], np.float32)
    Q = np.diag([0.05, 0.02]).astype(np.float32)
    R = np.array([[0.10]], np.float32)
    Y = np.zeros((N, ny), np.float32)  # synthetic zeros just to test path

    res = kalman_filter_general(
        Y, Phis, H, np.eye(nx, dtype=np.float32), Q, R,
        x0=np.zeros(nx, np.float32), P0=np.eye(nx, dtype=np.float32),
    )
    assert np.isfinite(float(res.loglik))
    assert res.x_filt.shape == (N, nx)
    assert np.all(np.isfinite(np.asarray(res.x_filt)))


@pytest.mark.integration
def test_timevarying_tracks_drifting_system():
    """Stronger than the reference: simulate THROUGH the drifting system and
    check the time-varying KF beats a mismatched time-invariant KF."""
    N, nx = 300, 2
    rng = np.random.default_rng(7)
    k = np.arange(N)
    a = 0.6 + 0.35 * np.sin(2 * np.pi * k / N)
    Phis = np.zeros((N, nx, nx), np.float32)
    Phis[:, 0, 0] = a
    Phis[:, 0, 1] = 0.2
    Phis[:, 1, 1] = 0.7
    H = np.eye(nx, dtype=np.float32)
    Q = np.diag([0.05, 0.02]).astype(np.float32)
    R = (0.1 * np.eye(nx)).astype(np.float32)
    Lq = np.linalg.cholesky(Q)
    Lr = np.linalg.cholesky(R)

    X = np.zeros((N, nx), np.float32)
    x = rng.standard_normal(nx).astype(np.float32)
    for t in range(N):
        x = Phis[t] @ x + Lq @ rng.standard_normal(nx).astype(np.float32)
        X[t] = x
    Y = X + (Lr @ rng.standard_normal((nx, N)).astype(np.float32)).T

    res_tv = kalman_filter_general(
        Y, Phis, H, np.eye(nx, dtype=np.float32), Q, R,
        x0=np.zeros(nx, np.float32), P0=np.eye(nx, dtype=np.float32),
    )
    Phi_bad = np.array([[0.95, 0.2], [0.0, 0.7]], np.float32)
    res_ti = kalman_filter_general(
        Y, Phi_bad, H, np.eye(nx, dtype=np.float32), Q, R,
        x0=np.zeros(nx, np.float32), P0=np.eye(nx, dtype=np.float32),
    )
    rmse_tv = float(np.sqrt(np.mean((np.asarray(res_tv.x_filt) - X) ** 2)))
    rmse_ti = float(np.sqrt(np.mean((np.asarray(res_ti.x_filt) - X) ** 2)))
    assert rmse_tv < 0.5
    assert rmse_tv <= rmse_ti + 1e-6
    # exact model also wins on log-likelihood
    assert float(res_tv.loglik) > float(res_ti.loglik)


@pytest.mark.integration
def test_timevarying_observation_matrix():
    """Per-step H_k stack: alternating which coordinate is observed."""
    N, nx = 100, 2
    Hs = np.zeros((N, 1, nx), np.float32)
    Hs[0::2, 0, 0] = 1.0
    Hs[1::2, 0, 1] = 1.0
    Phi = np.array([[0.9, 0.1], [0.0, 0.8]], np.float32)
    Q = np.diag([0.05, 0.02]).astype(np.float32)
    R = np.array([[0.1]], np.float32)
    Y = np.zeros((N, 1), np.float32)
    res = kalman_filter_general(
        Y, Phi, Hs, np.eye(nx, dtype=np.float32), Q, R,
        x0=np.zeros(nx, np.float32), P0=np.eye(nx, dtype=np.float32),
    )
    assert np.isfinite(float(res.loglik))
    assert np.all(np.isfinite(np.asarray(res.P_filt)))
