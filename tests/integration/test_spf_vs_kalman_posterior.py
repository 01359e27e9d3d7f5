"""SPF golden ladder: convergence to the exact Kalman posterior.

Counterpart of the reference's 15-scenario suite
(``tests/integration_tests/test_spf_vs_kalman_posterior.py:34-451``):
posterior mean/cov convergence (2-D and 1-D), linear-vs-optimal β modes,
Q-mode comparison, particle/step scaling, seed consistency,
high-dimensional / informative / uninformative / multivariate /
correlated-prior scenarios, µ-sweeps, and Mahalanobis particle coverage.

Model constants match the reference scenarios exactly (they are the
specification); the SPF itself is the scan/while_loop implementation in
``models/stochastic_particle_filter.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.stochastic_particle_filter import (
    LinearGaussianBayes,
    run_generalized_spf,
)


@pytest.fixture(scope="module")
def simple_2d_model():
    return LinearGaussianBayes.create(
        m0=np.array([1.0, 2.0]),
        P0=np.array([[2.0, 0.5], [0.5, 1.0]]),
        H=np.array([[1.0, 0.5]]),
        R=np.array([[0.5]]),
        z=np.array([3.0]),
    )


@pytest.fixture(scope="module")
def simple_1d_model():
    return LinearGaussianBayes.create(
        m0=np.array([5.0]),
        P0=np.array([[2.0]]),
        H=np.array([[1.0]]),
        R=np.array([[1.0]]),
        z=np.array([7.0]),
    )


def _spf(model, **kw):
    kw.setdefault("N", 5000)
    kw.setdefault("n_steps", 300)
    kw.setdefault("Q_mode", "inv_M")
    kw.setdefault("seed", 42)
    X, x_hat, info = run_generalized_spf(model, **kw)
    return np.asarray(X), np.asarray(x_hat), info


@pytest.mark.integration
def test_spf_converges_to_kalman_posterior_mean(simple_2d_model):
    m_k, _ = simple_2d_model.kalman_posterior()
    _, x_hat, _ = _spf(simple_2d_model, beta_mode="optimal", mu=1e-2)
    np.testing.assert_allclose(x_hat, np.asarray(m_k), rtol=0.1, atol=0.1)


@pytest.mark.integration
def test_spf_converges_to_kalman_posterior_covariance(simple_2d_model):
    _, P_k = simple_2d_model.kalman_posterior()
    X, _, _ = _spf(simple_2d_model, beta_mode="optimal", mu=1e-2)
    P_spf = np.cov(X.T)
    np.testing.assert_allclose(P_spf, np.asarray(P_k), rtol=0.3, atol=0.3)


@pytest.mark.integration
def test_spf_1d_convergence(simple_1d_model):
    m_k, P_k = simple_1d_model.kalman_posterior()
    X, x_hat, _ = _spf(simple_1d_model, beta_mode="optimal", mu=1e-2)
    np.testing.assert_allclose(x_hat[0], float(m_k[0]), rtol=0.05, atol=0.05)
    np.testing.assert_allclose(
        np.var(X[:, 0]), float(P_k[0, 0]), rtol=0.2, atol=0.2
    )


@pytest.mark.integration
def test_spf_linear_vs_optimal_mode(simple_2d_model):
    m_k, _ = simple_2d_model.kalman_posterior()
    _, x_lin, _ = _spf(simple_2d_model, N=3000, n_steps=200, beta_mode="linear")
    _, x_opt, _ = _spf(
        simple_2d_model, N=3000, n_steps=200, beta_mode="optimal", mu=1e-2
    )
    np.testing.assert_allclose(x_lin, np.asarray(m_k), rtol=0.15, atol=0.15)
    np.testing.assert_allclose(x_opt, np.asarray(m_k), rtol=0.15, atol=0.15)


@pytest.mark.integration
def test_spf_q_mode_comparison(simple_2d_model):
    m_k, _ = simple_2d_model.kalman_posterior()
    _, x_si, _ = _spf(
        simple_2d_model, N=3000, n_steps=200, beta_mode="linear",
        Q_mode="scaled_identity", q_scale=1e-2,
    )
    _, x_im, _ = _spf(
        simple_2d_model, N=3000, n_steps=200, beta_mode="linear",
        Q_mode="inv_M",
    )
    np.testing.assert_allclose(x_si, np.asarray(m_k), rtol=0.15, atol=0.15)
    np.testing.assert_allclose(x_im, np.asarray(m_k), rtol=0.15, atol=0.15)


@pytest.mark.integration
def test_spf_increasing_particles_improves_accuracy(simple_2d_model):
    m_k, _ = simple_2d_model.kalman_posterior()
    errors = []
    for N in (500, 1000, 2000, 5000):
        _, x_hat, _ = _spf(simple_2d_model, N=N, n_steps=200, beta_mode="linear")
        errors.append(np.linalg.norm(x_hat - np.asarray(m_k)))
    assert errors[-1] < errors[0] * 1.5


@pytest.mark.integration
def test_spf_increasing_steps_improves_accuracy(simple_2d_model):
    m_k, _ = simple_2d_model.kalman_posterior()
    errors = []
    for n_steps in (50, 100, 200, 400):
        _, x_hat, _ = _spf(
            simple_2d_model, N=2000, n_steps=n_steps, beta_mode="linear"
        )
        errors.append(np.linalg.norm(x_hat - np.asarray(m_k)))
    assert errors[-1] < 0.2


@pytest.mark.integration
def test_spf_consistency_across_runs(simple_2d_model):
    results = [
        _spf(simple_2d_model, N=2000, n_steps=200, beta_mode="linear",
             seed=seed)[1]
        for seed in range(5)
    ]
    results = np.array(results)
    assert np.all(results.std(axis=0) < 0.3)
    m_k, _ = simple_2d_model.kalman_posterior()
    np.testing.assert_allclose(
        results.mean(axis=0), np.asarray(m_k), rtol=0.1, atol=0.1
    )


@pytest.mark.integration
def test_spf_high_dimensional_model():
    n, d = 5, 3
    rs = np.random.RandomState(42)
    model = LinearGaussianBayes.create(
        m0=np.zeros(n),
        P0=np.eye(n) * 2.0,
        H=rs.randn(d, n) * 0.5,
        R=np.eye(d) * 1.0,
        z=np.random.RandomState(42).randn(d),
    )
    m_k, _ = model.kalman_posterior()
    _, x_hat, _ = _spf(model, beta_mode="linear")
    np.testing.assert_allclose(x_hat, np.asarray(m_k), rtol=0.2, atol=0.2)


@pytest.mark.integration
def test_spf_informative_observation():
    model = LinearGaussianBayes.create(
        m0=np.array([0.0, 0.0]),
        P0=np.eye(2) * 5.0,
        H=np.array([[1.0, 0.0]]),
        R=np.array([[0.1]]),
        z=np.array([10.0]),
    )
    m_k, _ = model.kalman_posterior()
    _, x_hat, _ = _spf(model, beta_mode="optimal", mu=1e-2)
    np.testing.assert_allclose(x_hat, np.asarray(m_k), rtol=0.15, atol=0.15)


@pytest.mark.integration
def test_spf_uninformative_observation():
    model = LinearGaussianBayes.create(
        m0=np.array([5.0, 3.0]),
        P0=np.eye(2) * 1.0,
        H=np.array([[1.0, 0.5]]),
        R=np.array([[100.0]]),
        z=np.array([10.0]),
    )
    m_k, _ = model.kalman_posterior()
    _, x_hat, _ = _spf(model, beta_mode="optimal", mu=1e-2)
    np.testing.assert_allclose(x_hat, np.asarray(m_k), rtol=0.15, atol=0.15)


@pytest.mark.integration
def test_spf_multivariate_observation():
    model = LinearGaussianBayes.create(
        m0=np.array([1.0, 2.0, 3.0]),
        P0=np.eye(3) * 2.0,
        H=np.array([[1.0, 0.5, 0.0], [0.0, 1.0, 0.5]]),
        R=np.eye(2) * 0.5,
        z=np.array([2.5, 3.5]),
    )
    m_k, _ = model.kalman_posterior()
    _, x_hat, _ = _spf(model, beta_mode="linear")
    np.testing.assert_allclose(x_hat, np.asarray(m_k), rtol=0.15, atol=0.15)


@pytest.mark.integration
def test_spf_correlated_prior():
    P0 = np.array([
        [2.0, 1.5, 0.5],
        [1.5, 3.0, 1.0],
        [0.5, 1.0, 1.5],
    ])
    model = LinearGaussianBayes.create(
        m0=np.array([1.0, 2.0, 1.5]),
        P0=P0,
        H=np.array([[1.0, 0.5, 0.3]]),
        R=np.array([[0.8]]),
        z=np.array([3.0]),
    )
    m_k, _ = model.kalman_posterior()
    _, x_hat, _ = _spf(model, beta_mode="optimal", mu=1e-2)
    np.testing.assert_allclose(x_hat, np.asarray(m_k), rtol=0.15, atol=0.15)


@pytest.mark.integration
@pytest.mark.slow
def test_spf_different_mu_convergence(simple_2d_model):
    m_k, _ = simple_2d_model.kalman_posterior()
    for mu in (1e-3, 1e-2, 5e-2):
        _, x_hat, _ = _spf(
            simple_2d_model, N=3000, beta_mode="optimal", mu=mu
        )
        np.testing.assert_allclose(x_hat, np.asarray(m_k), rtol=0.2, atol=0.2)


@pytest.mark.integration
def test_spf_particle_coverage():
    model = LinearGaussianBayes.create(
        m0=np.array([0.0, 0.0]),
        P0=np.eye(2) * 2.0,
        H=np.array([[1.0, 0.5]]),
        R=np.array([[0.5]]),
        z=np.array([1.0]),
    )
    m_k, P_k = model.kalman_posterior()
    X, _, _ = _spf(model, beta_mode="linear")
    diff = X - np.asarray(m_k)[None, :]
    P_inv = np.linalg.inv(np.asarray(P_k))
    mahal_sq = np.sum(diff @ P_inv * diff, axis=1)
    # chi-square(2) 99.7% quantile ~ 13.8: >=90% of particles inside
    assert np.mean(mahal_sq < 13.8) > 0.90
