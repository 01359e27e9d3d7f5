"""DPF (Sinkhorn-OT resampling) vs 1-D tracking systems.

Counterpart of the reference's
``tests/integration_tests/test_dpf_ot_vs_simulator_lgssm.py:54-508``:
simple-1D tracking, diagnostics, ground truth, LGSSM tracking, convergence
monitoring, epsilon range/effect, Sinkhorn iteration-count effects, and
numerical stability (degenerate weights, extreme observations).

Deviation: the reference early-exits the Sinkhorn loop on a host-side
tolerance check; under jit the iteration count is fixed and convergence is
*reported* (``converged`` / ``final_delta`` diagnostics) instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.dpf import DPF_OT
from particle_filters_jax.simulators import simulate_lgssm

pytestmark = pytest.mark.integration


def simple_transition_fn(key, particles, t):
    return particles + 0.1 * jax.random.normal(key, particles.shape)


def simple_obs_loglik_fn(particles, y_t, t):
    diff = particles - y_t[None, :]
    return -0.5 * jnp.sum(diff**2, axis=1) / (0.2**2)


@pytest.fixture(scope="module")
def simple_1d_data():
    T, d = 50, 1
    rng = np.random.default_rng(42)
    x = np.zeros((T, d), np.float32)
    y = np.zeros((T, d), np.float32)
    for t in range(1, T):
        x[t] = x[t - 1] + 0.1 * rng.standard_normal(d)
        y[t] = x[t] + 0.2 * rng.standard_normal(d)
    return {"x": x, "y": y, "T": T, "d": d}


def _make_ot(d, N=50, eps=0.1, iters=60):
    return DPF_OT(
        N, d, simple_transition_fn, simple_obs_loglik_fn,
        epsilon=eps, n_sinkhorn_iters=iters,
    )


def _posterior_means(ps, ws):
    return np.asarray(jnp.einsum("tn,tnd->td", ws, ps))


class TestDPFOTSimple1D:
    def test_dpf_ot_tracks_1d_system(self, key, simple_1d_data):
        data = simple_1d_data
        dpf = _make_ot(data["d"])
        ps, ws = dpf.run_filter(
            key, data["y"][:30], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32),
        )
        means = _posterior_means(ps, ws)
        rmse = float(np.sqrt(np.mean((means[6:] - data["x"][5:30]) ** 2)))
        assert rmse < 0.8

    def test_dpf_ot_with_diagnostics(self, key, simple_1d_data):
        data = simple_1d_data
        dpf = _make_ot(data["d"], N=40)
        _, _, diag = dpf.run_filter(
            key, data["y"][:15], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32), return_diagnostics=True,
        )
        assert "ot_distance_mean" in diag
        assert "final_delta_mean" in diag
        assert "converged_mean" in diag  # reference: converged_rate
        assert 0.0 <= float(diag["converged_mean"]) <= 1.0

    def test_dpf_ot_with_ground_truth(self, key, simple_1d_data):
        data = simple_1d_data
        dpf = _make_ot(data["d"], N=60)
        ps, ws = dpf.run_filter(
            key, data["y"][:30], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32),
        )
        means = _posterior_means(ps, ws)
        # error vs truth should beat the raw-observation error after warmup
        err_filter = np.mean(np.abs(means[6:] - data["x"][5:30]))
        err_obs = np.mean(np.abs(data["y"][5:30] - data["x"][5:30]))
        assert err_filter < err_obs * 1.5


class TestDPFOTLGSSM1D:
    @pytest.fixture(scope="class")
    def lg_setup(self):
        A, B, C, D = [[0.9]], [[0.5]], [[1.0]], [[0.7]]
        data = simulate_lgssm(
            np.array(A), np.array(B), np.array(C), np.array(D),
            np.eye(1), 100, seed=42,
        )

        def t_fn(key, particles, t):
            return 0.9 * particles + 0.5 * jax.random.normal(
                key, particles.shape
            )

        def ll_fn(particles, y_t, t):
            diff = particles - y_t[None, :]
            return -0.5 * jnp.sum(diff**2, axis=1) / 0.49

        return data, t_fn, ll_fn

    def test_dpf_ot_tracks_lgssm_1d(self, key, lg_setup):
        data, t_fn, ll_fn = lg_setup
        dpf = DPF_OT(80, 1, t_fn, ll_fn, epsilon=0.1, n_sinkhorn_iters=60)
        ps, ws = dpf.run_filter(
            key, data.Y, np.zeros(1, np.float32), np.eye(1, dtype=np.float32)
        )
        means = _posterior_means(ps, ws)
        rmse = float(np.sqrt(np.mean((means[1:] - data.X) ** 2)))
        assert rmse < 1.5

    def test_dpf_ot_convergence_monitoring(self, key, lg_setup):
        data, t_fn, ll_fn = lg_setup
        dpf = DPF_OT(50, 1, t_fn, ll_fn, epsilon=0.1, n_sinkhorn_iters=80)
        _, _, diag = dpf.run_filter(
            key, data.Y[:20], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32), return_diagnostics=True,
        )
        # dual deltas shrink to near-zero with enough iterations
        assert float(diag["final_delta_max"]) < 1e-2


class TestDPFOTEpsilonEffects:
    def test_epsilon_range(self, key, simple_1d_data):
        data = simple_1d_data
        for eps in (0.01, 0.1, 0.5):
            dpf = _make_ot(data["d"], N=50, eps=eps, iters=60)
            ps, ws = dpf.run_filter(
                key, data["y"][:30], np.zeros(1, np.float32),
                np.eye(1, dtype=np.float32),
            )
            means = _posterior_means(ps, ws)
            rmse = float(np.sqrt(np.mean((means[6:] - data["x"][5:30]) ** 2)))
            assert rmse < 0.8, f"eps={eps}: rmse={rmse}"

    def test_epsilon_effect_on_ot_distance(self, key, simple_1d_data):
        data = simple_1d_data
        dists = []
        for eps in (0.05, 0.2, 0.5):
            dpf = _make_ot(data["d"], N=40, eps=eps, iters=50)
            _, _, diag = dpf.run_filter(
                key, data["y"][:15], np.zeros(1, np.float32),
                np.eye(1, dtype=np.float32), return_diagnostics=True,
            )
            dists.append(float(diag["ot_distance_mean"]))
        assert not all(np.isclose(d, dists[0]) for d in dists)


class TestDPFOTSinkhornIterations:
    def test_iteration_count_effect(self, key, simple_1d_data):
        data = simple_1d_data
        for n_iters in (10, 30, 60):
            dpf = _make_ot(data["d"], N=40, iters=n_iters)
            ps, _ = dpf.run_filter(
                key, data["y"][:15], np.zeros(1, np.float32),
                np.eye(1, dtype=np.float32),
            )
            assert ps.shape[0] == 16  # T+1

    def test_more_iterations_tighter_duals(self, key, simple_1d_data):
        """Fixed-length analog of the reference's early-convergence check:
        more Sinkhorn iterations → smaller final dual delta."""
        data = simple_1d_data
        deltas = []
        for n_iters in (5, 100):
            dpf = _make_ot(data["d"], N=30, iters=n_iters)
            _, _, diag = dpf.run_filter(
                key, data["y"][:10], np.zeros(1, np.float32),
                np.eye(1, dtype=np.float32), return_diagnostics=True,
            )
            deltas.append(float(diag["final_delta_mean"]))
        assert deltas[1] < deltas[0]


class TestDPFOTNumericalStability:
    def test_stability_with_degenerate_weights(self, key, simple_1d_data):
        data = simple_1d_data
        dpf = _make_ot(data["d"], N=40, iters=50)
        ps, ws = dpf.run_filter(
            key, data["y"][:20], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32),
        )
        assert np.all(np.isfinite(np.asarray(ps)))
        assert np.all(np.isfinite(np.asarray(ws)))

    def test_stability_with_extreme_observations(self, key, simple_1d_data):
        data = simple_1d_data
        y_ext = data["y"][:15].copy()
        y_ext[7] = 10.0  # extreme outlier
        dpf = _make_ot(data["d"], N=40, iters=50)
        ps, ws = dpf.run_filter(
            key, y_ext, np.zeros(1, np.float32), np.eye(1, dtype=np.float32)
        )
        assert np.all(np.isfinite(np.asarray(ps)))
        assert np.all(np.isfinite(np.asarray(ws)))
