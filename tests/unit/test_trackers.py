"""GaussianTracker (EKF/UKF companion) unit tests.

Reproduces the reference's tracker-wrapper archetypes
(``tests/unit_tests/models/test_ekf_tracker_wrapper.py`` and
``test_ukf_tracker_wrapper.py``, 49 tests): creation, past-mean threading,
predict/update cycles, uncertainty monotonicity, API consistency — adapted
to the functional state-in/state-out design (``models/trackers.py``), where
the reference's "mutation" assertions become "new state differs, inputs
untouched".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models import (
    EKFTracker,
    ExtendedKalmanFilter,
    GaussianTracker,
    UKFTracker,
    UnscentedKalmanFilter,
)

ALPHA, SIGMA, BETA = 0.9, 0.5, 1.0


def _sv_filters():
    """The reference fixtures' simple SV working system
    (``test_ekf_tracker_wrapper.py:20-58`` semantics)."""
    g = lambda x, u: ALPHA * x
    h = lambda x: BETA * jnp.exp(0.5 * x)
    Q = jnp.array([[SIGMA**2]])
    R = jnp.array([[0.1]])
    ekf = ExtendedKalmanFilter(g, h, Q, R)
    ukf = UnscentedKalmanFilter(g, h, Q, R, alpha=0.5)
    return ekf, ukf


@pytest.fixture(scope="module", params=["ekf", "ukf"])
def tracker(request):
    ekf, ukf = _sv_filters()
    return GaussianTracker(ekf if request.param == "ekf" else ukf)


M0 = jnp.array([0.2])
P0 = jnp.array([[1.5]])


class TestCreation:
    def test_init_state_fields(self, tracker):
        ts = tracker.init(M0, P0)
        np.testing.assert_allclose(np.asarray(ts.mean), np.asarray(M0))
        np.testing.assert_allclose(np.asarray(ts.cov), np.asarray(P0))
        assert int(ts.t) == 0

    def test_past_mean_initialized_to_mean(self, tracker):
        ts = tracker.init(M0, P0)
        np.testing.assert_allclose(np.asarray(ts.past_mean), np.asarray(M0))

    def test_different_dimensions(self):
        for nx in (1, 3, 7):
            A = 0.9 * jnp.eye(nx)
            ekf = ExtendedKalmanFilter(
                lambda x, u, A=A: A @ x, lambda x: x, jnp.eye(nx), jnp.eye(nx)
            )
            ts = GaussianTracker(ekf).init(jnp.zeros(nx), jnp.eye(nx))
            assert ts.mean.shape == (nx,)
            assert ts.cov.shape == (nx, nx)

    def test_alias_names(self):
        # Reference exposes EKFTracker/UKFTracker wrappers; both alias the
        # one functional class here (docstring models/trackers.py:1-11).
        assert EKFTracker is GaussianTracker
        assert UKFTracker is GaussianTracker


class TestPredict:
    def test_returns_state_mean_cov(self, tracker):
        ts = tracker.init(M0, P0)
        ts1, m, P = tracker.predict(ts)
        assert m.shape == (1,)
        assert P.shape == (1, 1)
        np.testing.assert_allclose(np.asarray(ts1.mean), np.asarray(m))

    def test_propagates_mean_linearly(self, tracker):
        ts = tracker.init(M0, P0)
        _, m, _ = tracker.predict(ts)
        np.testing.assert_allclose(
            np.asarray(m), ALPHA * np.asarray(M0), rtol=1e-5, atol=1e-5
        )

    def test_adds_process_uncertainty(self, tracker):
        ts = tracker.init(M0, P0)
        _, _, P = tracker.predict(ts)
        # P⁻ = α²P0 + σ² > α²P0
        assert float(P[0, 0]) > ALPHA**2 * float(P0[0, 0]) - 1e-6

    def test_records_past_mean(self, tracker):
        ts = tracker.init(M0, P0)
        ts1, _, _ = tracker.predict(ts)
        np.testing.assert_allclose(np.asarray(ts1.past_mean), np.asarray(M0))

    def test_input_state_untouched(self, tracker):
        """Functional analog of the reference's mutation checks: the input
        pytree is never modified."""
        ts = tracker.init(M0, P0)
        mean_before = np.asarray(ts.mean).copy()
        tracker.predict(ts)
        np.testing.assert_array_equal(np.asarray(ts.mean), mean_before)
        assert int(ts.t) == 0

    def test_multiple_predicts_grow_uncertainty(self, tracker):
        ts = tracker.init(M0, jnp.array([[0.01]]))
        covs = []
        for _ in range(4):
            ts, _, P = tracker.predict(ts)
            covs.append(float(P[0, 0]))
        assert covs == sorted(covs)  # monotone toward stationary variance


class TestUpdate:
    def test_returns_state_mean_cov(self, tracker):
        ts = tracker.init(M0, P0)
        ts, _, _ = tracker.predict(ts)
        ts2, m, P = tracker.update(ts, jnp.array([1.1]))
        assert m.shape == (1,)
        assert np.all(np.isfinite(np.asarray(m)))
        np.testing.assert_allclose(np.asarray(ts2.cov), np.asarray(P))

    def test_reduces_uncertainty(self, tracker):
        ts = tracker.init(M0, P0)
        ts, _, P_prior = tracker.predict(ts)
        _, _, P_post = tracker.update(ts, jnp.array([1.1]))
        assert float(P_post[0, 0]) < float(P_prior[0, 0])

    def test_without_predict_works(self, tracker):
        ts = tracker.init(M0, P0)
        ts2, m, P = tracker.update(ts, jnp.array([1.0]))
        assert np.all(np.isfinite(np.asarray(m)))
        assert np.all(np.isfinite(np.asarray(P)))

    def test_preserves_past_mean(self, tracker):
        ts = tracker.init(M0, P0)
        ts, _, _ = tracker.predict(ts)
        past = np.asarray(ts.past_mean).copy()
        ts2, _, _ = tracker.update(ts, jnp.array([1.1]))
        np.testing.assert_array_equal(np.asarray(ts2.past_mean), past)


class TestPastMean:
    def test_multiple_cycles_track_previous_posterior(self, tracker):
        """past_mean after cycle k equals the posterior mean of cycle k−1
        (reference ``test_get_past_mean_multiple_cycles``)."""
        ts = tracker.init(M0, P0)
        post_means = [np.asarray(M0)]
        for k in range(3):
            ts, _, _ = tracker.predict(ts)
            np.testing.assert_allclose(
                np.asarray(ts.past_mean), post_means[-1], rtol=1e-6
            )
            ts, m, _ = tracker.update(ts, jnp.array([1.0 + 0.1 * k]))
            post_means.append(np.asarray(m))


class TestCycles:
    def test_predict_update_cycle_finite_psd(self, tracker):
        ts = tracker.init(M0, P0)
        for k in range(5):
            ts, _, _ = tracker.predict(ts)
            ts, m, P = tracker.update(ts, jnp.array([0.8 + 0.05 * k]))
            assert np.all(np.isfinite(np.asarray(m)))
            assert float(P[0, 0]) > 0
        assert int(ts.t) == 5

    def test_matches_direct_filter_usage(self):
        """The tracker is a thin shim: threading TrackerState must give the
        same numbers as driving the wrapped filter directly (reference
        ``test_tracker_matches_direct_ekf_usage``)."""
        from particle_filters_jax.models import make_ekf_state

        ekf, _ = _sv_filters()
        tracker = GaussianTracker(ekf)
        ts = tracker.init(M0, P0)
        fs = make_ekf_state(M0, P0)
        for k in range(3):
            z = jnp.array([1.0 + 0.2 * k])
            ts, _, _ = tracker.predict(ts)
            ts, m_t, P_t = tracker.update(ts, z)
            fs = ekf.predict(fs)
            fs = ekf.update(fs, z)
            np.testing.assert_allclose(np.asarray(m_t), np.asarray(fs.mean), rtol=1e-6)
            np.testing.assert_allclose(np.asarray(P_t), np.asarray(fs.cov), rtol=1e-6)

    def test_jittable(self, tracker):
        @jax.jit
        def cycle(ts, z):
            ts, _, _ = tracker.predict(ts)
            ts, m, P = tracker.update(ts, z)
            return ts, m, P

        ts = tracker.init(M0, P0)
        ts, m, P = cycle(ts, jnp.array([1.0]))
        assert np.all(np.isfinite(np.asarray(m)))


class TestEdgeCases:
    def test_zero_initial_covariance(self, tracker):
        ts = tracker.init(M0, jnp.zeros((1, 1)))
        ts, _, P = tracker.predict(ts)
        assert float(P[0, 0]) >= SIGMA**2 - 1e-6  # process noise floor

    def test_large_state_values(self, tracker):
        ts = tracker.init(jnp.array([4.0]), P0)
        ts, m, P = tracker.predict(ts)
        assert np.all(np.isfinite(np.asarray(m)))
        assert np.all(np.isfinite(np.asarray(P)))

    def test_state_independence(self, tracker):
        """Two TrackerStates from one tracker object never interfere — the
        functional design makes the reference's aliasing bug
        (``test_filters_mat_simulator.py:415-423``) impossible."""
        ts_a = tracker.init(M0, P0)
        ts_b = tracker.init(jnp.array([2.0]), 4.0 * P0)
        ts_a2, m_a, _ = tracker.predict(ts_a)
        ts_b2, m_b, _ = tracker.predict(ts_b)
        np.testing.assert_allclose(
            np.asarray(m_a), ALPHA * np.asarray(M0), rtol=1e-5, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(m_b), ALPHA * 2.0, rtol=1e-5, atol=1e-5
        )
        # re-predicting the original states still gives the same answers
        _, m_a3, _ = tracker.predict(ts_a)
        np.testing.assert_allclose(np.asarray(m_a3), np.asarray(m_a))

    def test_ekf_ukf_api_consistency(self):
        ekf, ukf = _sv_filters()
        t_ekf, t_ukf = GaussianTracker(ekf), GaussianTracker(ukf)
        for tr in (t_ekf, t_ukf):
            ts = tr.init(M0, P0)
            ts, m, P = tr.predict(ts)
            ts, m2, P2 = tr.update(ts, jnp.array([1.0]))
            assert m.shape == m2.shape == (1,)
            assert P.shape == P2.shape == (1, 1)
