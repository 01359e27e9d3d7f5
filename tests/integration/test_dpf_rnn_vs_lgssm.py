"""DPF (learned RNN resampling) vs a 1-D LGSSM.

Counterpart of the reference's
``tests/integration_tests/test_dpf_rnn_vs_simulator_lgssm.py:79-450``:
tracking, ESS monitoring, baseline mode, feature configurations
(weights-only / particles-only), LSTM and GRU architectures, assignment
matrix properties (row-stochastic, near-uniform at init), assignment
diversity, and stability with extreme observations.

The resampler parameters are an explicit pytree (the reference mutates
tf.Variables); here every test passes params through ``filter``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.dpf import DifferentiableParticleFilterRNN
from particle_filters_jax.simulators import simulate_lgssm

pytestmark = pytest.mark.integration

A, Bn, Cm, Dn = 0.9, 0.5, 1.0, 0.7


def transition_fn(key, x, params):
    return A * x + Bn * jax.random.normal(key, x.shape, x.dtype)


def log_lik_fn(x, y, params):
    diff = y[:, None, :] - Cm * x
    return -0.5 * jnp.sum(diff**2, axis=-1) / (Dn**2)


@pytest.fixture(scope="module")
def lg_data():
    return simulate_lgssm(
        np.array([[A]]), np.array([[Bn]]), np.array([[Cm]]),
        np.array([[Dn]]), np.eye(1), 60, seed=42,
    )


def _make_dpf(**kw):
    kw.setdefault("n_particles", 50)
    kw.setdefault("rnn_hidden_dim", 16)
    return DifferentiableParticleFilterRNN(
        kw.pop("n_particles"), 1, transition_fn, log_lik_fn, **kw
    )


def _run(dpf, key, Y, T=30, diagnostics=False):
    params = dpf.init_resampler(jax.random.fold_in(key, 99))
    return dpf.filter(
        params, key, Y[None, :T], np.zeros(1, np.float32),
        np.eye(1, dtype=np.float32), return_diagnostics=diagnostics,
    )


def _rmse(ps, lws, X, T):
    w = jnp.exp(lws - jax.scipy.special.logsumexp(lws, axis=-1, keepdims=True))
    means = np.asarray(jnp.einsum("btn,btnd->btd", w, ps))[0]
    return float(np.sqrt(np.mean((means[1:, 0] - X[:T, 0]) ** 2)))


class TestDPFRNNvsLGSSM:
    def test_dpf_rnn_tracks_1d_system(self, key, lg_data):
        dpf = _make_dpf()
        ps, lws = _run(dpf, key, lg_data.Y)
        assert _rmse(ps, lws, lg_data.X, 30) < 1.5

    def test_dpf_rnn_with_ess_monitoring(self, key, lg_data):
        dpf = _make_dpf()
        ps, lws, diag = _run(dpf, key, lg_data.Y, T=20, diagnostics=True)
        assert "ess_before_mean" in diag
        assert float(diag["ess_before_mean"]) > 1.0
        assert float(diag["ess_before_mean"]) <= 50.0

    def test_dpf_rnn_baseline_mode(self, key, lg_data):
        dpf = _make_dpf(use_baseline_resampling=True)
        ps, lws = _run(dpf, key, lg_data.Y)
        assert np.all(np.isfinite(np.asarray(ps)))
        assert _rmse(ps, lws, lg_data.X, 30) < 1.5

    def test_weights_only_features(self, key, lg_data):
        dpf = _make_dpf(use_weight_features=True, use_particle_features=False)
        ps, _ = _run(dpf, key, lg_data.Y, T=15)
        assert np.all(np.isfinite(np.asarray(ps)))

    def test_particles_only_features(self, key, lg_data):
        dpf = _make_dpf(use_weight_features=False, use_particle_features=True)
        ps, _ = _run(dpf, key, lg_data.Y, T=15)
        assert np.all(np.isfinite(np.asarray(ps)))

    def test_lstm_architecture(self, key, lg_data):
        dpf = _make_dpf(rnn_type="lstm")
        ps, _ = _run(dpf, key, lg_data.Y, T=15)
        assert np.all(np.isfinite(np.asarray(ps)))

    def test_gru_architecture(self, key, lg_data):
        dpf = _make_dpf(rnn_type="gru")
        ps, _ = _run(dpf, key, lg_data.Y, T=15)
        assert np.all(np.isfinite(np.asarray(ps)))

    def test_assignment_matrix_properties(self, key):
        """Fresh (near-zero head) resampler: rows sum to 1 and are
        near-uniform (reference :338-376)."""
        dpf = _make_dpf(n_particles=20)
        params = dpf.init_resampler(key)
        particles = jax.random.normal(jax.random.fold_in(key, 1), (20, 1))
        logw = jax.random.normal(jax.random.fold_in(key, 2), (20,))
        _, _, aux = dpf.resampler.apply(
            params, jax.random.fold_in(key, 3), particles, logw, True
        )
        assign = np.asarray(aux["assignment"])
        np.testing.assert_allclose(assign.sum(axis=-1), 1.0, atol=1e-5)
        # near-zero output head => near-uniform rows
        np.testing.assert_allclose(assign, 1.0 / 20, atol=0.02)

    def test_assignment_diversity_with_rnn(self, key, lg_data):
        """Assignment entropy stays positive — the resampler does not
        collapse to one ancestor (reference :377-420)."""
        dpf = _make_dpf(n_particles=30)
        _, _, diag = _run(dpf, key, lg_data.Y, T=15, diagnostics=True)
        assert float(diag["assignment_entropy_mean_mean"]) > 0.1

    def test_stability_with_extreme_observations(self, key, lg_data):
        dpf = _make_dpf()
        Y = np.array(lg_data.Y[:20])
        Y[10] = 25.0  # extreme outlier
        params = dpf.init_resampler(jax.random.fold_in(key, 99))
        ps, lws = dpf.filter(
            params, key, Y[None], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32),
        )
        assert np.all(np.isfinite(np.asarray(ps)))
        assert np.all(np.isfinite(np.asarray(lws)))
