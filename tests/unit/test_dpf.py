"""Differentiable particle filter tests (soft / OT / RNN).

Reproduces the reference archetypes: DPF variants track a linear-Gaussian
SSM (``test_dpf_ot_vs_simulator_lgssm.py``), hyperparameter behavior,
degenerate-weight stability, end-to-end gradients (SURVEY.md §4 adds
jax.grad checks), and diagnostics plumbing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models import (
    DPF_OT,
    DifferentiableParticleFilter,
    DifferentiableParticleFilterRNN,
)

A_COEF, SIGMA_Q, SIGMA_R = 0.9, 0.3, 0.5


def transition(key, x, params):
    a = params.get("a", A_COEF)
    sigma_q = params.get("sigma_q", SIGMA_Q)
    return a * x + sigma_q * jax.random.normal(key, x.shape, x.dtype)


def log_likelihood(x, y, params):
    sigma_r = params.get("sigma_r", SIGMA_R)
    diff = y[:, None, :] - x  # (B, N, d)
    return jnp.sum(
        -0.5 * (diff**2) / sigma_r**2 - 0.5 * jnp.log(2 * jnp.pi * sigma_r**2),
        axis=-1,
    )


@pytest.fixture(scope="module")
def lg_data(key):
    """Simulate B=3 sequences of the 1-D linear-Gaussian SSM."""
    B, T = 3, 25
    ks = jax.random.split(key, T + 1)
    x = 0.5 * jax.random.normal(ks[0], (B, 1))
    xs, ys = [], []
    for t in range(T):
        k1, k2 = jax.random.split(ks[t + 1])
        x = A_COEF * x + SIGMA_Q * jax.random.normal(k1, x.shape)
        y = x + SIGMA_R * jax.random.normal(k2, x.shape)
        xs.append(x)
        ys.append(y)
    X = jnp.stack(xs, axis=1)  # (B, T, 1)
    Y = jnp.stack(ys, axis=1)
    truth = jnp.concatenate([jnp.zeros((B, 1, 1)), X], axis=1)  # (B, T+1, 1)
    return X, Y, truth


class TestDPFSoft:
    def test_filter_shapes(self, key, lg_data):
        X, Y, truth = lg_data
        dpf = DifferentiableParticleFilter(50, 1, transition, log_likelihood)
        ps, lws = dpf.filter(key, Y, jnp.zeros(1), jnp.eye(1))
        B, T = Y.shape[0], Y.shape[1]
        assert ps.shape == (B, T + 1, 50, 1)
        assert lws.shape == (B, T + 1, 50)

    def test_tracks_linear_gaussian(self, key, lg_data):
        """Weighted-mean RMSE comparable to the reference's DPF numbers
        (0.33-0.50 at N=50, BASELINE.md)."""
        X, Y, truth = lg_data
        dpf = DifferentiableParticleFilter(
            100, 1, transition, log_likelihood, soft_alpha=0.1,
            gumbel_temperature=0.2,
        )
        ps, lws, diag = dpf.filter(
            key, Y, jnp.zeros(1), jnp.eye(1), return_diagnostics=True,
            ground_truth=truth,
        )
        assert float(diag["mean_rmse"]) < 0.8
        assert np.isfinite(float(diag["ess_before_mean"]))

    def test_diagnostics_keys(self, key, lg_data):
        X, Y, truth = lg_data
        dpf = DifferentiableParticleFilter(30, 1, transition, log_likelihood)
        _, _, diag = dpf.filter(
            key, Y[:, :5], jnp.zeros(1), jnp.eye(1), return_diagnostics=True
        )
        for k in (
            "ess_before_mean",
            "entropy_after_mean",
            "assignment_entropy_mean_mean",
            "diversity_before_particle_spread_mean",
            "max_weight_before_max",
        ):
            assert k in diag, k

    def test_end_to_end_gradient(self, key, lg_data):
        """jax.grad flows through the whole filter into model parameters
        (the raison d'être of soft resampling)."""
        X, Y, truth = lg_data

        def loss(a):
            dpf = DifferentiableParticleFilter(
                30, 1, transition, log_likelihood, gumbel_temperature=0.5
            )
            ps, lws = dpf.filter(
                key, Y[:, :10], jnp.zeros(1), jnp.eye(1), params={"a": a}
            )
            w = jax.nn.softmax(lws, axis=-1)
            means = jnp.einsum("btn,btnd->btd", w, ps)
            return jnp.mean((means[:, 1:] - truth[:, 1:11]) ** 2)

        g = jax.grad(loss)(jnp.asarray(0.5))
        assert np.isfinite(float(g)) and abs(float(g)) > 0

    def test_alpha_extremes_stable(self, key, lg_data):
        X, Y, _ = lg_data
        for alpha in (0.0, 1.0):
            dpf = DifferentiableParticleFilter(
                20, 1, transition, log_likelihood, soft_alpha=alpha
            )
            ps, lws = dpf.filter(key, Y[:, :5], jnp.zeros(1), jnp.eye(1))
            assert np.all(np.isfinite(np.asarray(ps)))


class TestDPFOT:
    @staticmethod
    def _make(n=30, **kw):
        def trans(key, p, t):
            return A_COEF * p + SIGMA_Q * jax.random.normal(key, p.shape, p.dtype)

        def obs_ll(p, y, t):
            return jnp.sum(-0.5 * (y - p) ** 2 / SIGMA_R**2, axis=-1)

        return DPF_OT(n, 1, trans, obs_ll, **kw)

    def test_run_filter_shapes(self, key, lg_data):
        X, Y, _ = lg_data
        dpf = self._make(30)
        ps, ws = dpf.run_filter(key, Y[0], jnp.zeros(1), jnp.eye(1))
        T = Y.shape[1]
        assert ps.shape == (T + 1, 30, 1)
        assert ws.shape == (T + 1, 30)
        np.testing.assert_allclose(
            np.asarray(jnp.sum(ws, axis=-1)), 1.0, atol=1e-4
        )

    def test_tracks_sequence(self, key, lg_data):
        X, Y, _ = lg_data
        dpf = self._make(50, epsilon=0.1, n_sinkhorn_iters=30)
        ps, ws = dpf.run_filter(key, Y[0], jnp.zeros(1), jnp.eye(1))
        means = jnp.einsum("tn,tnd->td", ws, ps)
        rmse = float(jnp.sqrt(jnp.mean((means[1:] - X[0]) ** 2)))
        assert rmse < 0.8

    def test_diagnostics(self, key, lg_data):
        X, Y, _ = lg_data
        dpf = self._make(20)
        _, _, diag = dpf.run_filter(
            key, Y[0, :5], jnp.zeros(1), jnp.eye(1), return_diagnostics=True
        )
        assert "ot_distance_mean" in diag
        assert "transport_plan_sparsity_mean" in diag
        assert np.isfinite(float(diag["final_delta_mean"]))

    def test_degenerate_weights_stable(self, key):
        """Extreme observations must not produce NaNs (reference
        ``test_dpf_ot_vs_simulator_lgssm.py:451-508``)."""
        dpf = self._make(20)
        y_seq = jnp.full((5, 1), 50.0)  # wildly unlikely observations
        ps, ws = dpf.run_filter(key, y_seq, jnp.zeros(1), jnp.eye(1))
        assert np.all(np.isfinite(np.asarray(ps)))
        assert np.all(np.isfinite(np.asarray(ws)))

    def test_gradient_through_sinkhorn(self, key, lg_data):
        X, Y, _ = lg_data

        def loss(scale):
            def trans(k, p, t):
                return scale * p + SIGMA_Q * jax.random.normal(k, p.shape, p.dtype)

            def obs_ll(p, y, t):
                return jnp.sum(-0.5 * (y - p) ** 2 / SIGMA_R**2, axis=-1)

            dpf = DPF_OT(15, 1, trans, obs_ll, n_sinkhorn_iters=10)
            ps, ws = dpf.run_filter(key, Y[0, :6], jnp.zeros(1), jnp.eye(1))
            means = jnp.einsum("tn,tnd->td", ws, ps)
            return jnp.mean((means[1:] - X[0, :6]) ** 2)

        g = jax.grad(loss)(jnp.asarray(0.5))
        assert np.isfinite(float(g))


class TestDPFRNN:
    def test_filter_shapes_and_uniform_weights(self, key, lg_data):
        X, Y, _ = lg_data
        dpf = DifferentiableParticleFilterRNN(
            20, 1, transition, log_likelihood, rnn_hidden_dim=8
        )
        params = dpf.init_resampler(key)
        ps, lws = dpf.filter(params, key, Y[:, :8], jnp.zeros(1), jnp.eye(1))
        assert ps.shape == (Y.shape[0], 9, 20, 1)
        np.testing.assert_allclose(
            np.asarray(jnp.exp(lws[:, -1])).sum(-1), 1.0, atol=1e-4
        )

    def test_baseline_mode_tracks(self, key, lg_data):
        """Training-free baseline (weight-proportional assignments) tracks
        the LGSSM (reference ``use_baseline_resampling`` :217)."""
        X, Y, truth = lg_data
        dpf = DifferentiableParticleFilterRNN(
            50, 1, transition, log_likelihood,
            use_baseline_resampling=True, temperature=0.5,
        )
        params = dpf.init_resampler(key)
        ps, lws, diag = dpf.filter(
            params, key, Y, jnp.zeros(1), jnp.eye(1),
            return_diagnostics=True, ground_truth=truth,
        )
        assert float(diag["mean_rmse"]) < 0.9

    def test_resampler_params_trainable(self, key, lg_data):
        X, Y, truth = lg_data
        dpf = DifferentiableParticleFilterRNN(
            10, 1, transition, log_likelihood, rnn_hidden_dim=4
        )
        params = dpf.init_resampler(key)

        def loss(params):
            ps, lws = dpf.filter(
                params, key, Y[:1, :4], jnp.zeros(1), jnp.eye(1)
            )
            w = jax.nn.softmax(lws, axis=-1)
            means = jnp.einsum("btn,btnd->btd", w, ps)
            return jnp.mean((means[:, 1:] - truth[:1, 1:5]) ** 2)

        g = jax.grad(loss)(params)
        leaves = jax.tree_util.tree_leaves(g)
        assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
        assert any(float(jnp.max(jnp.abs(l))) > 0 for l in leaves)

    def test_lstm_type(self, key, lg_data):
        X, Y, _ = lg_data
        dpf = DifferentiableParticleFilterRNN(
            10, 1, transition, log_likelihood, rnn_type="lstm", rnn_hidden_dim=4
        )
        params = dpf.init_resampler(key)
        ps, _ = dpf.filter(params, key, Y[:1, :3], jnp.zeros(1), jnp.eye(1))
        assert np.all(np.isfinite(np.asarray(ps)))


class TestPairwiseDistances:
    """Reference ``test_dpf_ot_shapes_and_api.py`` pairwise-distance block."""

    def test_shape_symmetry_diagonal(self, key):
        from particle_filters_jax.resampling.ot import pairwise_squared_distances

        x = jax.random.normal(key, (12, 3))
        C = pairwise_squared_distances(x, x)
        assert C.shape == (12, 12)
        np.testing.assert_allclose(np.asarray(C), np.asarray(C).T, atol=1e-5)
        np.testing.assert_allclose(np.diag(np.asarray(C)), 0.0, atol=1e-5)
        assert float(C.min()) >= -1e-6

    def test_matches_direct_computation(self, key):
        from particle_filters_jax.resampling.ot import pairwise_squared_distances

        x = jax.random.normal(key, (6, 2))
        y = jax.random.normal(jax.random.fold_in(key, 1), (4, 2))
        C = np.asarray(pairwise_squared_distances(x, y))
        xn, yn = np.asarray(x), np.asarray(y)
        direct = ((xn[:, None, :] - yn[None, :, :]) ** 2).sum(-1)
        np.testing.assert_allclose(C, direct, rtol=1e-4, atol=1e-5)


class TestDPFShapesAPI:
    """Remaining reference shapes/API archetypes across the three variants
    (``test_dpf_soft_shapes_and_api.py``, ``test_dpf_ot_shapes_and_api.py``,
    ``test_dpf_rnn_shapes_and_api.py``)."""

    def test_soft_init_particles(self, key):
        dpf = DifferentiableParticleFilter(20, 2, transition, log_likelihood)
        p, lw = dpf.init_particles(key, 3, jnp.zeros(2), jnp.eye(2))
        assert p.shape == (3, 20, 2)
        assert lw.shape == (3, 20)
        np.testing.assert_allclose(
            np.asarray(jnp.exp(jax.scipy.special.logsumexp(lw, axis=-1))),
            1.0, atol=1e-4,
        )

    def test_soft_init_gaussian_moments(self, key):
        dpf = DifferentiableParticleFilter(4000, 2, transition, log_likelihood)
        mean = jnp.array([1.0, -2.0])
        chol = jnp.linalg.cholesky(jnp.array([[2.0, 0.3], [0.3, 0.5]]))
        p, _ = dpf.init_particles(key, 1, mean, chol)
        emp_mean = np.asarray(jnp.mean(p[0], axis=0))
        np.testing.assert_allclose(emp_mean, np.asarray(mean), atol=0.1)
        emp_cov = np.cov(np.asarray(p[0]).T)
        np.testing.assert_allclose(emp_cov, np.asarray(chol @ chol.T), atol=0.25)

    def test_ot_init_uniform_weights(self, key):
        dpf = TestDPFOT._make(25)
        p, w = dpf.init_particles(key, jnp.zeros(1), jnp.eye(1))
        assert p.shape == (25, 1)
        np.testing.assert_allclose(np.asarray(w), 1.0 / 25, rtol=1e-5)

    def test_ot_step_uniform_output_weights(self, key, lg_data):
        X, Y, _ = lg_data
        dpf = TestDPFOT._make(20)
        p, w = dpf.init_particles(key, jnp.zeros(1), jnp.eye(1))
        p2, w2 = dpf.step(jax.random.fold_in(key, 1), p, w, Y[0, 0])
        assert p2.shape == (20, 1)
        np.testing.assert_allclose(np.asarray(w2), 1.0 / 20, rtol=1e-4)

    def test_ot_single_step_sequence(self, key, lg_data):
        X, Y, _ = lg_data
        dpf = TestDPFOT._make(15)
        ps, ws = dpf.run_filter(key, Y[0, :1], jnp.zeros(1), jnp.eye(1))
        assert ps.shape == (2, 15, 1)  # init + one step

    def test_soft_seed_reproducible(self, key, lg_data):
        X, Y, _ = lg_data
        dpf = DifferentiableParticleFilter(20, 1, transition, log_likelihood)
        ps1, lw1 = dpf.filter(key, Y, jnp.zeros(1), jnp.eye(1))
        ps2, lw2 = dpf.filter(key, Y, jnp.zeros(1), jnp.eye(1))
        np.testing.assert_array_equal(np.asarray(ps1), np.asarray(ps2))

    def test_soft_different_keys_differ(self, key, lg_data):
        X, Y, _ = lg_data
        dpf = DifferentiableParticleFilter(20, 1, transition, log_likelihood)
        ps1, _ = dpf.filter(key, Y, jnp.zeros(1), jnp.eye(1))
        ps2, _ = dpf.filter(jax.random.fold_in(key, 1), Y, jnp.zeros(1), jnp.eye(1))
        assert not np.allclose(np.asarray(ps1), np.asarray(ps2))

    def test_soft_temperature_effect(self, key, lg_data):
        """Lower Gumbel temperature ⇒ harder assignments ⇒ lower assignment
        entropy (reference soft hyperparameter sweep)."""
        X, Y, _ = lg_data
        ents = {}
        for temp in (0.05, 2.0):
            dpf = DifferentiableParticleFilter(
                30, 1, transition, log_likelihood, gumbel_temperature=temp
            )
            _, _, diag = dpf.filter(
                key, Y, jnp.zeros(1), jnp.eye(1), return_diagnostics=True
            )
            ents[temp] = float(diag["assignment_entropy_mean_mean"])
        assert ents[0.05] < ents[2.0]

    def test_ot_epsilon_effect_on_plan_sparsity(self, key):
        """Smaller ε concentrates the transport plan (reference
        ``test_sinkhorn_epsilon_effect``)."""
        from particle_filters_jax.resampling.ot import sinkhorn_ot_resample

        p = jax.random.normal(key, (24, 2))
        w = jax.nn.softmax(jax.random.normal(jax.random.fold_in(key, 1), (24,)))
        sparsity = {}
        for eps in (0.05, 5.0):
            _, _, diag = sinkhorn_ot_resample(
                p, w, epsilon=eps, n_iters=60, return_diagnostics=True
            )
            sparsity[eps] = float(diag["transport_plan_sparsity"])
        assert sparsity[0.05] < sparsity[5.0]

    def test_ot_diagnostics_keys(self, key):
        from particle_filters_jax.resampling.ot import sinkhorn_ot_resample

        p = jax.random.normal(key, (16, 2))
        w = jnp.full((16,), 1.0 / 16)
        _, _, diag = sinkhorn_ot_resample(p, w, return_diagnostics=True)
        for k in ("final_delta", "converged", "ot_distance",
                  "transport_plan_sparsity", "dual_variables"):
            assert k in diag, k

    def test_rnn_init_resampler_pytree(self, key):
        dpf = DifferentiableParticleFilterRNN(10, 1, transition, log_likelihood)
        params = dpf.init_resampler(key)
        leaves = jax.tree_util.tree_leaves(params)
        assert len(leaves) > 0
        assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)

    def test_rnn_seed_reproducible(self, key, lg_data):
        X, Y, _ = lg_data
        dpf = DifferentiableParticleFilterRNN(
            12, 1, transition, log_likelihood, use_baseline_resampling=True
        )
        params = dpf.init_resampler(key)
        ps1, _ = dpf.filter(params, key, Y, jnp.zeros(1), jnp.eye(1))
        ps2, _ = dpf.filter(params, key, Y, jnp.zeros(1), jnp.eye(1))
        np.testing.assert_array_equal(np.asarray(ps1), np.asarray(ps2))
