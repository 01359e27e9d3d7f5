"""Kernel particle filter vs the LGSSM simulator.

Counterpart of the reference's
``tests/integration_tests/test_kpf_vs_simulator_lgssm.py:10-313``:
diagonal-kernel tracking, scalar-kernel tracking, convergence over time,
ensemble consistency (finite, no collapse), and pseudo-time completion
(s reaches 1). The analyze step is jitted once and reused; forecasts use
explicit jax.random keys instead of a shared numpy rng.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.kernel_particle_filter import (
    KernelParticleFilter,
    KPFConfig,
    Model,
)
from particle_filters_jax.simulators import simulate_lgssm

A = np.array([[0.9, 0.2], [0.0, 0.7]], np.float32)
B = np.diag([np.sqrt(0.05), np.sqrt(0.02)]).astype(np.float32)
SIGMA = np.eye(2, dtype=np.float32)
Q = B @ B.T
LQ = np.linalg.cholesky(Q).astype(np.float32)


def _setup(ny, n_steps, seed=42, burn_in=50, **cfg_kw):
    C = np.eye(2, dtype=np.float32)[:ny]
    D = (np.sqrt(0.10) * np.eye(ny)).astype(np.float32)
    data = simulate_lgssm(A, B, C, D, SIGMA, n_steps, seed=seed, burn_in=burn_in)
    Cj = jnp.asarray(C)
    model = Model(H=lambda x: Cj @ x, JH=lambda x: Cj, R=jnp.asarray(D @ D.T))
    kpf = KernelParticleFilter(model, KPFConfig(**cfg_kw))
    return data, kpf


def _run(kpf, data, T, Np=200, key_seed=0):
    """analyze -> forecast loop (the reference's per-notebook driver)."""
    key = jax.random.PRNGKey(key_seed)
    ensemble = jax.random.multivariate_normal(
        key, jnp.zeros(2), jnp.asarray(SIGMA), (Np,), dtype=jnp.float32
    )
    step = jax.jit(lambda X, y: kpf.analyze(X, y))
    states, rmses = [], []
    for t in range(T):
        st = step(ensemble, data.Y[t])
        states.append(st)
        mean_est = np.asarray(jnp.mean(st.particles, axis=0))
        rmses.append(float(np.sqrt(np.mean((mean_est - data.X[t]) ** 2))))
        key, kn = jax.random.split(key)
        noise = jax.random.normal(kn, (Np, 2), jnp.float32) @ jnp.asarray(LQ).T
        ensemble = st.particles @ jnp.asarray(A).T + noise
    return states, np.array(rmses)


@pytest.mark.integration
def test_kpf_linear_gaussian_system():
    data, kpf = _setup(ny=2, n_steps=100, kernel_type="diagonal",
                       lengthscale_mode="std", max_steps=50)
    _, rmses = _run(kpf, data, T=20)
    assert np.mean(rmses) < 2.0


@pytest.mark.integration
def test_kpf_lgssm_scalar_kernel():
    data, kpf = _setup(ny=1, n_steps=50, burn_in=20, kernel_type="scalar",
                       lengthscale_mode="std", max_steps=40)
    _, rmses = _run(kpf, data, T=10, Np=150)
    assert np.mean(rmses) < 2.0


@pytest.mark.integration
def test_kpf_lgssm_convergence():
    data, kpf = _setup(ny=2, n_steps=100, kernel_type="diagonal", max_steps=50)
    _, rmses = _run(kpf, data, T=40)
    # both halves reasonable (reference allows randomness in which is lower)
    assert np.mean(rmses[:20]) < 3.0
    assert np.mean(rmses[20:]) < 3.0


@pytest.mark.integration
def test_kpf_lgssm_ensemble_consistency():
    data, kpf = _setup(ny=2, n_steps=50, burn_in=20, kernel_type="diagonal",
                       max_steps=50)
    states, _ = _run(kpf, data, T=20)
    for st in states:
        p = np.asarray(st.particles)
        assert np.all(np.isfinite(p))
        assert np.all(np.isfinite(np.asarray(st.weights)))
        assert np.all(np.std(p, axis=0) > 1e-6)  # no collapse


@pytest.mark.integration
def test_kpf_lgssm_pseudo_time_completion():
    data, kpf = _setup(ny=1, n_steps=30, burn_in=20, kernel_type="diagonal",
                       max_steps=60, min_steps=5)
    states, _ = _run(kpf, data, T=10, Np=150)
    for st in states:
        assert float(st.s) >= 1.0 - 1e-4, f"pseudo-time stalled at {float(st.s)}"
        assert int(st.steps) <= 60
