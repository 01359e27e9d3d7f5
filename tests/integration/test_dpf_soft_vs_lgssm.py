"""DPF (soft resampling) vs the LGSSM simulator.

Counterpart of the reference's
``tests/integration_tests/test_dpf_soft_vs_simulator_lgssm.py:104-430``:
1-D and 2-D tracking, diagnostics, ground-truth RMSE, particle diversity,
soft-alpha and Gumbel-temperature sensitivity. Randomness is explicit
(transition_fn takes a key) and the time loop is a lax.scan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.dpf import DifferentiableParticleFilter
from particle_filters_jax.simulators import simulate_lgssm

pytestmark = pytest.mark.integration


def _make_fns(A, B, C, D):
    A, B, C, D = (jnp.asarray(m, jnp.float32) for m in (A, B, C, D))
    R = D @ D.T

    def transition_fn(key, x, params):
        noise = jax.random.normal(key, x.shape, x.dtype)
        return jnp.einsum("ij,bnj->bni", A, x) + jnp.einsum(
            "ij,bnj->bni", B, noise
        )

    if R.shape[0] == 1:
        var = R[0, 0]

        def log_lik_fn(x, y, params):
            y_pred = jnp.einsum("ij,bnj->bni", C, x)
            diff = y[:, None, :] - y_pred
            return -0.5 * jnp.sum(diff**2, axis=-1) / var - 0.5 * jnp.log(
                2.0 * jnp.pi * var
            )
    else:
        R_inv = jnp.linalg.inv(R)
        _, logdet = jnp.linalg.slogdet(R)

        def log_lik_fn(x, y, params):
            y_pred = jnp.einsum("ij,bnj->bni", C, x)
            diff = y[:, None, :] - y_pred
            mahal = jnp.einsum("bni,ij,bnj->bn", diff, R_inv, diff)
            ny = y.shape[-1]
            return -0.5 * (mahal + ny * jnp.log(2.0 * jnp.pi) + logdet)

    return transition_fn, log_lik_fn


@pytest.fixture(scope="module")
def lg1d():
    A, B, C, D = [[0.9]], [[0.5]], [[1.0]], [[0.7]]
    Sigma = [[1.0]]
    data = simulate_lgssm(
        np.array(A), np.array(B), np.array(C), np.array(D),
        np.array(Sigma), 100, seed=42,
    )
    t_fn, ll_fn = _make_fns(A, B, C, D)
    return dict(data=data, t_fn=t_fn, ll_fn=ll_fn, nx=1,
                sigma_chol=np.eye(1, dtype=np.float32))


@pytest.fixture(scope="module")
def lg2d():
    A = [[0.9, 0.2], [0.0, 0.7]]
    B = np.diag([0.3, 0.2])
    C = np.eye(2)
    D = np.diag([0.5, 0.5])
    data = simulate_lgssm(
        np.array(A), B, C, D, np.eye(2), 50, seed=123
    )
    t_fn, ll_fn = _make_fns(A, B, C, D)
    return dict(data=data, t_fn=t_fn, ll_fn=ll_fn, nx=2,
                sigma_chol=np.eye(2, dtype=np.float32))


def _posterior_means(particles_seq, logw_seq):
    w = jnp.exp(logw_seq - jax.scipy.special.logsumexp(
        logw_seq, axis=-1, keepdims=True))
    return np.asarray(
        jnp.einsum("btn,btnd->btd", w, particles_seq)
    )[0]


class TestDPFSoftLGSSM1D:
    def test_dpf_tracks_lgssm_1d(self, key, lg1d):
        dpf = DifferentiableParticleFilter(
            100, lg1d["nx"], lg1d["t_fn"], lg1d["ll_fn"],
            soft_alpha=0.2, gumbel_temperature=0.3,
        )
        ps, lws = dpf.filter(
            key, lg1d["data"].Y[None], np.zeros(1, np.float32),
            lg1d["sigma_chol"],
        )
        means = _posterior_means(ps, lws)
        rmse = float(np.sqrt(np.mean((means[1:] - lg1d["data"].X) ** 2)))
        assert rmse < 1.5, f"RMSE too high: {rmse}"

    def test_dpf_with_diagnostics(self, key, lg1d):
        dpf = DifferentiableParticleFilter(
            80, 1, lg1d["t_fn"], lg1d["ll_fn"],
            soft_alpha=0.2, gumbel_temperature=0.3,
        )
        _, _, diag = dpf.filter(
            key, lg1d["data"].Y[None, :20], np.zeros(1, np.float32),
            lg1d["sigma_chol"], return_diagnostics=True,
        )
        assert "ess_before_mean" in diag
        assert "ess_after_mean" in diag
        assert float(diag["ess_after_mean"]) > 50  # uniform after resample

    def test_dpf_comparison_with_ground_truth(self, key, lg1d):
        dpf = DifferentiableParticleFilter(
            150, 1, lg1d["t_fn"], lg1d["ll_fn"],
            soft_alpha=0.15, gumbel_temperature=0.25,
        )
        X = lg1d["data"].X
        gt = np.concatenate(
            [np.zeros((1, 1, 1), np.float32), X[None]], axis=1
        )
        _, _, diag = dpf.filter(
            key, lg1d["data"].Y[None], np.zeros(1, np.float32),
            lg1d["sigma_chol"], return_diagnostics=True, ground_truth=gt,
        )
        assert "rmse_sequence" in diag and "mean_rmse" in diag
        assert float(diag["mean_rmse"]) < 1.5


class TestDPFSoftLGSSM2D:
    def test_dpf_tracks_lgssm_2d(self, key, lg2d):
        dpf = DifferentiableParticleFilter(
            120, 2, lg2d["t_fn"], lg2d["ll_fn"],
            soft_alpha=0.2, gumbel_temperature=0.3,
        )
        ps, lws = dpf.filter(
            key, lg2d["data"].Y[None], np.zeros(2, np.float32),
            lg2d["sigma_chol"],
        )
        means = _posterior_means(ps, lws)
        X = lg2d["data"].X
        for dim in range(2):
            rmse = float(np.sqrt(np.mean((means[1:, dim] - X[:, dim]) ** 2)))
            assert rmse < 1.5, f"dim {dim} RMSE too high: {rmse}"

    def test_dpf_particle_diversity(self, key, lg2d):
        dpf = DifferentiableParticleFilter(
            100, 2, lg2d["t_fn"], lg2d["ll_fn"],
            soft_alpha=0.3, gumbel_temperature=0.4,
        )
        _, _, diag = dpf.filter(
            key, lg2d["data"].Y[None, :20], np.zeros(2, np.float32),
            lg2d["sigma_chol"], return_diagnostics=True,
        )
        assert float(diag["diversity_after_mean_pairwise_dist_mean"]) > 0.01


class TestDPFSoftParameterSensitivity:
    def test_soft_alpha_effect(self, key, lg1d):
        def run(alpha):
            dpf = DifferentiableParticleFilter(
                80, 1, lg1d["t_fn"], lg1d["ll_fn"],
                soft_alpha=alpha, gumbel_temperature=0.3,
            )
            _, _, diag = dpf.filter(
                key, lg1d["data"].Y[None, :30], np.zeros(1, np.float32),
                lg1d["sigma_chol"], return_diagnostics=True,
            )
            return float(diag["entropy_after_mean"])

        # higher mixture alpha must not materially reduce entropy
        assert run(0.5) >= run(0.05) * 0.95

    def test_gumbel_temperature_effect(self, key, lg1d):
        for temp in (0.1, 0.5, 1.0):
            dpf = DifferentiableParticleFilter(
                80, 1, lg1d["t_fn"], lg1d["ll_fn"],
                soft_alpha=0.2, gumbel_temperature=temp,
            )
            ps, _ = dpf.filter(
                key, lg1d["data"].Y[None, :30], np.zeros(1, np.float32),
                lg1d["sigma_chol"],
            )
            assert ps.shape[1] == 31
            assert np.all(np.isfinite(np.asarray(ps)))
