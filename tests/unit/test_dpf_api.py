"""DPF soft/OT/RNN shapes-and-API suite — counterpart of the reference
``tests/unit_tests/models/test_dpf_{soft,ot,rnn}_shapes_and_api.py``
(15 + 24 + 20 tests), beyond the tracking/gradient tests in
``tests/unit/test_dpf.py`` and the integration suites.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.dpf import (
    DPF_OT,
    DifferentiableParticleFilter,
    DifferentiableParticleFilterRNN,
    compute_ess,
    compute_particle_diversity,
    compute_weight_entropy,
)

ALPHA = 0.9
SIG = 0.3


def _trans_batched(key, x, params=None):
    return ALPHA * x + SIG * jax.random.normal(key, x.shape)


def _loglik_batched(x, y, params=None):
    # x (B, N, d); y (B, obs_dim) broadcast over the particle axis
    return -0.5 * jnp.sum((x - y[:, None, :]) ** 2, axis=-1)


def _trans_ot(key, x, t):
    return ALPHA * x + SIG * jax.random.normal(key, x.shape)


def _loglik_ot(x, y, t):
    return -0.5 * jnp.sum((x - y) ** 2, axis=-1)


@pytest.fixture(scope="module")
def soft():
    return DifferentiableParticleFilter(
        n_particles=24, state_dim=2,
        transition_fn=_trans_batched, log_likelihood_fn=_loglik_batched,
    )


@pytest.fixture(scope="module")
def ot():
    return DPF_OT(
        n_particles=24, state_dim=2,
        transition_fn=_trans_ot, obs_loglik_fn=_loglik_ot,
    )


@pytest.fixture(scope="module")
def rnn():
    return DifferentiableParticleFilterRNN(
        n_particles=16, state_dim=2,
        transition_fn=_trans_batched, log_likelihood_fn=_loglik_batched,
        rnn_hidden_dim=8,
    )


class TestSoftAPI:
    def test_constructor_defaults(self, soft):
        assert soft.soft_alpha == 0.1 and soft.gumbel_temperature == 0.2

    def test_init_particles_shapes(self, soft, key):
        p, lw = soft.init_particles(key, 3, jnp.zeros(2), jnp.eye(2))
        assert p.shape == (3, 24, 2) and lw.shape == (3, 24)

    def test_init_weights_uniform(self, soft, key):
        _, lw = soft.init_particles(key, 2, jnp.zeros(2), jnp.eye(2))
        np.testing.assert_allclose(np.asarray(lw), -np.log(24), rtol=1e-5)

    def test_init_respects_mean_chol(self, soft, key):
        m = jnp.array([5.0, -5.0])
        L = 0.01 * jnp.eye(2)
        p, _ = soft.init_particles(key, 1, m, L)
        np.testing.assert_allclose(np.asarray(p).mean(axis=(0, 1)), m, atol=0.02)

    def test_step_shapes(self, soft, key):
        p, lw = soft.init_particles(key, 2, jnp.zeros(2), jnp.eye(2))
        p2, lw2 = soft.step(key, p, lw, jnp.zeros((2, 2)))
        assert p2.shape == p.shape and lw2.shape == lw.shape

    def test_step_uniform_output_weights(self, soft, key):
        # soft resampling ends with uniform weights (barycentric projection)
        p, lw = soft.init_particles(key, 1, jnp.zeros(2), jnp.eye(2))
        _, lw2 = soft.step(key, p, lw, jnp.zeros((1, 2)))
        np.testing.assert_allclose(np.asarray(lw2), -np.log(24), atol=1e-4)

    def test_step_diagnostics_keys(self, soft, key):
        p, lw = soft.init_particles(key, 1, jnp.zeros(2), jnp.eye(2))
        _, _, diag = soft.step(key, p, lw, jnp.zeros((1, 2)),
                               return_diagnostics=True)
        for k in ("ess_before", "ess_after", "entropy_before", "entropy_after",
                  "assignment_entropy_mean", "max_weight_before"):
            assert k in diag

    def test_filter_shapes(self, soft, key):
        ys = jnp.zeros((1, 5, 2))  # (B, T, obs_dim)
        ps, lws = soft.filter(key, ys, jnp.zeros(2), jnp.eye(2))
        assert ps.shape == (1, 6, 24, 2)  # T+1 including init
        assert lws.shape == (1, 6, 24)

    def test_filter_seed_reproducible(self, soft, key):
        ys = jnp.zeros((1, 4, 2))
        a, _ = soft.filter(key, ys, jnp.zeros(2), jnp.eye(2))
        b, _ = soft.filter(key, ys, jnp.zeros(2), jnp.eye(2))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_batch_axis_finite(self, soft, key):
        ys = jnp.zeros((3, 4, 2))
        ps, lws = soft.filter(key, ys, jnp.zeros(2), jnp.eye(2))
        assert ps.shape == (3, 5, 24, 2)
        assert np.isfinite(np.asarray(ps)).all()

    @pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
    def test_alpha_range_runs(self, key, alpha):
        f = DifferentiableParticleFilter(
            8, 2, _trans_batched, _loglik_batched, soft_alpha=alpha
        )
        p, lw = f.init_particles(key, 1, jnp.zeros(2), jnp.eye(2))
        p2, lw2 = f.step(key, p, lw, jnp.zeros((1, 2)))
        assert np.isfinite(np.asarray(p2)).all()


class TestOTAPI:
    def test_constructor_defaults(self, ot):
        assert ot.epsilon == 0.1 and ot.n_sinkhorn_iters == 50
        assert ot.damping == 1.0

    def test_init_particles_shapes(self, ot, key):
        p, w = ot.init_particles(key, jnp.zeros(2), jnp.eye(2))
        assert p.shape == (24, 2) and w.shape == (24,)

    def test_init_weights_linear_uniform(self, ot, key):
        _, w = ot.init_particles(key, jnp.zeros(2), jnp.eye(2))
        np.testing.assert_allclose(np.asarray(w), 1.0 / 24, rtol=1e-6)

    def test_step_shapes_and_uniform_weights(self, ot, key):
        p, w = ot.init_particles(key, jnp.zeros(2), jnp.eye(2))
        p2, w2 = ot.step(key, p, w, jnp.zeros(2))
        assert p2.shape == (24, 2)
        np.testing.assert_allclose(np.asarray(w2), 1.0 / 24, atol=1e-5)

    def test_step_diagnostics(self, ot, key):
        p, w = ot.init_particles(key, jnp.zeros(2), jnp.eye(2))
        _, _, diag = ot.step(key, p, w, jnp.zeros(2), return_diagnostics=True)
        assert "ot_distance" in diag or "plan_entropy" in diag or len(diag) > 0

    def test_run_filter_shapes(self, ot, key):
        ys = jnp.zeros((6, 2))
        ps, ws = ot.run_filter(key, ys, jnp.zeros(2), jnp.eye(2))
        assert ps.shape == (7, 24, 2) and ws.shape == (7, 24)

    def test_run_filter_reproducible(self, ot, key):
        ys = jnp.zeros((4, 2))
        a, _ = ot.run_filter(key, ys, jnp.zeros(2), jnp.eye(2))
        b, _ = ot.run_filter(key, ys, jnp.zeros(2), jnp.eye(2))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.parametrize("eps", [1e-3, 1e-2, 1.0])
    def test_epsilon_range_stable(self, key, eps):
        f = DPF_OT(12, 2, _trans_ot, _loglik_ot, epsilon=eps)
        p, w = f.init_particles(key, jnp.zeros(2), jnp.eye(2))
        p2, _ = f.step(key, p, w, jnp.ones(2))
        assert np.isfinite(np.asarray(p2)).all()

    @pytest.mark.parametrize("iters", [1, 10, 100])
    def test_sinkhorn_iteration_budgets(self, key, iters):
        f = DPF_OT(12, 2, _trans_ot, _loglik_ot, n_sinkhorn_iters=iters)
        p, w = f.init_particles(key, jnp.zeros(2), jnp.eye(2))
        p2, _ = f.step(key, p, w, jnp.ones(2))
        assert np.isfinite(np.asarray(p2)).all()

    def test_barycentric_projection_within_hull(self, ot, key):
        # OT resampled particles are convex combinations of the predicted
        # cloud: they stay inside its bounding box
        p, w = ot.init_particles(key, jnp.zeros(2), jnp.eye(2))
        pred = _trans_ot(key, p, 0)  # replicate the step's propagation
        p2, _ = ot.step(key, p, w, jnp.zeros(2))
        lo, hi = np.asarray(pred).min(0) - 1e-4, np.asarray(pred).max(0) + 1e-4
        assert (np.asarray(p2) >= lo).all() and (np.asarray(p2) <= hi).all()

    def test_degenerate_weights_finite(self, ot, key):
        p, _ = ot.init_particles(key, jnp.zeros(2), jnp.eye(2))
        w = jnp.zeros(24).at[0].set(1.0)  # fully degenerate
        p2, w2 = ot.step(key, p, w, jnp.zeros(2))
        assert np.isfinite(np.asarray(p2)).all()


class TestRNNAPI:
    def test_resampler_param_pytree(self, rnn, key):
        params = rnn.init_resampler(key)
        leaves = jax.tree_util.tree_leaves(params)
        assert len(leaves) > 0
        assert all(jnp.issubdtype(l.dtype, jnp.floating) for l in leaves)

    def test_head_near_zero_init(self, rnn, key):
        # near-zero output head ⇒ near-uniform initial assignments
        params = rnn.init_resampler(key)
        flat = jnp.concatenate(
            [l.ravel() for l in jax.tree_util.tree_leaves(params)]
        )
        assert float(jnp.abs(flat).max()) < 1.0

    def test_init_particles_shapes(self, rnn, key):
        p, lw = rnn.init_particles(key, 2, jnp.zeros(2), jnp.eye(2))
        assert p.shape == (2, 16, 2) and lw.shape == (2, 16)

    def test_step_shapes(self, rnn, key):
        params = rnn.init_resampler(key)
        p, lw = rnn.init_particles(key, 1, jnp.zeros(2), jnp.eye(2))
        p2, lw2 = rnn.step(params, key, p, lw, jnp.zeros((1, 2)))
        assert p2.shape == p.shape and lw2.shape == lw.shape

    def test_filter_shapes(self, rnn, key):
        params = rnn.init_resampler(key)
        ys = jnp.zeros((1, 4, 2))
        ps, lws = rnn.filter(params, key, ys, jnp.zeros(2), jnp.eye(2))
        assert ps.shape == (1, 5, 16, 2) and lws.shape == (1, 5, 16)

    def test_filter_reproducible(self, rnn, key):
        params = rnn.init_resampler(key)
        ys = jnp.zeros((1, 3, 2))
        a, _ = rnn.filter(params, key, ys, jnp.zeros(2), jnp.eye(2))
        b, _ = rnn.filter(params, key, ys, jnp.zeros(2), jnp.eye(2))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    @pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
    def test_cell_types(self, key, rnn_type):
        f = DifferentiableParticleFilterRNN(
            8, 2, _trans_batched, _loglik_batched,
            rnn_hidden_dim=4, rnn_type=rnn_type,
        )
        params = f.init_resampler(key)
        p, lw = f.init_particles(key, 1, jnp.zeros(2), jnp.eye(2))
        p2, _ = f.step(params, key, p, lw, jnp.zeros((1, 2)))
        assert np.isfinite(np.asarray(p2)).all()

    def test_baseline_mode_needs_no_params_structure(self, key):
        f = DifferentiableParticleFilterRNN(
            8, 2, _trans_batched, _loglik_batched,
            rnn_hidden_dim=4, use_baseline_resampling=True,
        )
        params = f.init_resampler(key)
        p, lw = f.init_particles(key, 1, jnp.zeros(2), jnp.eye(2))
        p2, lw2 = f.step(params, key, p, lw, jnp.zeros((1, 2)))
        np.testing.assert_allclose(np.asarray(lw2), -np.log(8), atol=1e-4)


class TestDiagnosticHelpers:
    def test_ess_uniform_is_n(self):
        lw = jnp.full((3, 10), -np.log(10))
        np.testing.assert_allclose(np.asarray(compute_ess(lw)), 10.0, rtol=1e-5)

    def test_ess_degenerate_is_one(self):
        lw = jnp.log(jnp.zeros((1, 10)).at[0, 3].set(1.0) + 1e-30)
        np.testing.assert_allclose(np.asarray(compute_ess(lw)), 1.0, rtol=1e-3)

    def test_weight_entropy_uniform_max(self):
        lw = jnp.full((1, 16), -np.log(16))
        np.testing.assert_allclose(
            np.asarray(compute_weight_entropy(lw)), np.log(16), rtol=1e-5
        )

    def test_diversity_identical_particles_zero(self):
        p = jnp.ones((1, 8, 2))
        div = compute_particle_diversity(p)
        vals = jax.tree_util.tree_leaves(div)
        assert all(float(jnp.max(jnp.abs(v))) < 1e-6 for v in vals)
