"""All three DPF variants on the stochastic-volatility model.

Counterpart of the reference's
``tests/integration_tests/test_dpf_vs_sv_simulator.py:181-672``: soft
(tracking, diagnostics, alpha sensitivity), RNN (tracking, baseline-vs-rnn,
feature configs), OT (tracking, diagnostics, epsilon sensitivity, Sinkhorn
convergence), and the cross-variant comparison (:565-636) plus the
particle-count effect.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.dpf import (
    DPF_OT,
    DifferentiableParticleFilter,
    DifferentiableParticleFilterRNN,
)
from particle_filters_jax.simulators import simulate_sv_1d

pytestmark = pytest.mark.integration

ALPHA, SIGMA, BETA = 0.9, 0.2, 1.0


# ---------------- batched (B, N, d) model fns (soft / RNN) ----------------

def sv_transition(key, x, params):
    return ALPHA * x + SIGMA * jax.random.normal(key, x.shape, x.dtype)


def sv_loglik(x, y, params):
    var = BETA**2 * jnp.exp(x[..., 0])
    return -0.5 * (y[:, None, 0] ** 2 / var + jnp.log(var))


# ---------------- unbatched (N, d) model fns (OT) ----------------

def sv_transition_flat(key, particles, t):
    return ALPHA * particles + SIGMA * jax.random.normal(
        key, particles.shape
    )


def sv_loglik_flat(particles, y, t):
    var = BETA**2 * jnp.exp(particles[:, 0])
    return -0.5 * (y[0] ** 2 / var + jnp.log(var))


@pytest.fixture(scope="module")
def sv_short(sv_data):
    return sv_data.Y[:40, None], sv_data.X[:40]


def _soft_rmse(ps, lws, X):
    w = jnp.exp(lws - jax.scipy.special.logsumexp(lws, axis=-1, keepdims=True))
    means = np.asarray(jnp.einsum("btn,btnd->btd", w, ps))[0]
    return float(np.sqrt(np.mean((means[1:, 0] - X) ** 2)))


class TestDPFSoftSV:
    def test_dpf_soft_tracks_sv(self, key, sv_short):
        Y, X = sv_short
        dpf = DifferentiableParticleFilter(
            100, 1, sv_transition, sv_loglik,
            soft_alpha=0.2, gumbel_temperature=0.3,
        )
        ps, lws = dpf.filter(
            key, Y[None], np.zeros(1, np.float32), np.eye(1, dtype=np.float32)
        )
        assert _soft_rmse(ps, lws, X) < 2.0

    def test_dpf_soft_with_diagnostics(self, key, sv_short):
        Y, _ = sv_short
        dpf = DifferentiableParticleFilter(
            80, 1, sv_transition, sv_loglik,
            soft_alpha=0.2, gumbel_temperature=0.3,
        )
        _, _, diag = dpf.filter(
            key, Y[None, :20], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32), return_diagnostics=True,
        )
        assert float(diag["ess_after_mean"]) > 40  # uniform post-resample
        assert np.isfinite(float(diag["entropy_before_mean"]))

    def test_dpf_soft_alpha_sensitivity(self, key, sv_short):
        Y, X = sv_short
        for alpha in (0.05, 0.2, 0.5):
            dpf = DifferentiableParticleFilter(
                80, 1, sv_transition, sv_loglik,
                soft_alpha=alpha, gumbel_temperature=0.3,
            )
            ps, lws = dpf.filter(
                key, Y[None], np.zeros(1, np.float32),
                np.eye(1, dtype=np.float32),
            )
            assert _soft_rmse(ps, lws, X) < 3.0, f"alpha={alpha}"


class TestDPFRNNSV:
    def test_dpf_rnn_tracks_sv(self, key, sv_short):
        Y, X = sv_short
        dpf = DifferentiableParticleFilterRNN(
            50, 1, sv_transition, sv_loglik, rnn_hidden_dim=16
        )
        params = dpf.init_resampler(jax.random.fold_in(key, 1))
        ps, lws = dpf.filter(
            params, key, Y[None], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32),
        )
        assert _soft_rmse(ps, lws, X) < 2.5

    def test_dpf_rnn_baseline_vs_rnn_mode(self, key, sv_short):
        Y, X = sv_short
        rmses = {}
        for baseline in (True, False):
            dpf = DifferentiableParticleFilterRNN(
                50, 1, sv_transition, sv_loglik, rnn_hidden_dim=16,
                use_baseline_resampling=baseline,
            )
            params = dpf.init_resampler(jax.random.fold_in(key, 1))
            ps, lws = dpf.filter(
                params, key, Y[None], np.zeros(1, np.float32),
                np.eye(1, dtype=np.float32),
            )
            rmses[baseline] = _soft_rmse(ps, lws, X)
        # both modes produce usable estimates (reference :339-372)
        assert rmses[True] < 2.5
        assert rmses[False] < 3.5

    def test_dpf_rnn_feature_configurations(self, key, sv_short):
        Y, _ = sv_short
        for wf, pf_ in ((True, True), (True, False), (False, True)):
            dpf = DifferentiableParticleFilterRNN(
                40, 1, sv_transition, sv_loglik, rnn_hidden_dim=16,
                use_weight_features=wf, use_particle_features=pf_,
            )
            params = dpf.init_resampler(jax.random.fold_in(key, 1))
            ps, _ = dpf.filter(
                params, key, Y[None, :15], np.zeros(1, np.float32),
                np.eye(1, dtype=np.float32),
            )
            assert np.all(np.isfinite(np.asarray(ps)))


class TestDPFOTSV:
    def test_dpf_ot_tracks_sv(self, key, sv_short):
        Y, X = sv_short
        dpf = DPF_OT(60, 1, sv_transition_flat, sv_loglik_flat,
                     epsilon=0.1, n_sinkhorn_iters=60)
        ps, ws = dpf.run_filter(
            key, Y, np.zeros(1, np.float32), np.eye(1, dtype=np.float32)
        )
        means = np.asarray(jnp.einsum("tn,tnd->td", ws, ps))
        rmse = float(np.sqrt(np.mean((means[1:, 0] - X) ** 2)))
        assert rmse < 2.0

    def test_dpf_ot_with_diagnostics(self, key, sv_short):
        Y, _ = sv_short
        dpf = DPF_OT(40, 1, sv_transition_flat, sv_loglik_flat,
                     epsilon=0.1, n_sinkhorn_iters=50)
        _, _, diag = dpf.run_filter(
            key, Y[:15], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32), return_diagnostics=True,
        )
        assert np.isfinite(float(diag["ot_distance_mean"]))
        assert np.isfinite(float(diag["transport_plan_sparsity_mean"]))

    def test_dpf_ot_epsilon_sensitivity(self, key, sv_short):
        Y, X = sv_short
        for eps in (0.05, 0.1, 0.5):
            dpf = DPF_OT(40, 1, sv_transition_flat, sv_loglik_flat,
                         epsilon=eps, n_sinkhorn_iters=50)
            ps, ws = dpf.run_filter(
                key, Y, np.zeros(1, np.float32), np.eye(1, dtype=np.float32)
            )
            means = np.asarray(jnp.einsum("tn,tnd->td", ws, ps))
            rmse = float(np.sqrt(np.mean((means[1:, 0] - X) ** 2)))
            assert rmse < 3.0, f"eps={eps}: rmse={rmse}"

    def test_dpf_ot_sinkhorn_convergence(self, key, sv_short):
        Y, _ = sv_short
        dpf = DPF_OT(40, 1, sv_transition_flat, sv_loglik_flat,
                     epsilon=0.1, n_sinkhorn_iters=80)
        _, _, diag = dpf.run_filter(
            key, Y[:15], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32), return_diagnostics=True,
        )
        assert float(diag["final_delta_mean"]) < 1e-2


class TestDPFComparativeSV:
    def test_all_dpfs_track_sv(self, key, sv_data):
        """Cross-variant comparison (reference :565-636): all three DPFs
        track the same medium SV sequence within loose bounds, and no
        variant is wildly off relative to the others."""
        Y, X = sv_data.Y[:60, None], sv_data.X[:60]
        rmses = {}

        soft = DifferentiableParticleFilter(
            80, 1, sv_transition, sv_loglik,
            soft_alpha=0.2, gumbel_temperature=0.3,
        )
        ps, lws = soft.filter(
            key, Y[None], np.zeros(1, np.float32), np.eye(1, dtype=np.float32)
        )
        rmses["soft"] = _soft_rmse(ps, lws, X)

        rnn = DifferentiableParticleFilterRNN(
            50, 1, sv_transition, sv_loglik, rnn_hidden_dim=16,
            use_baseline_resampling=True,
        )
        params = rnn.init_resampler(jax.random.fold_in(key, 1))
        ps, lws = rnn.filter(
            params, key, Y[None], np.zeros(1, np.float32),
            np.eye(1, dtype=np.float32),
        )
        rmses["rnn"] = _soft_rmse(ps, lws, X)

        ot = DPF_OT(60, 1, sv_transition_flat, sv_loglik_flat,
                    epsilon=0.1, n_sinkhorn_iters=60)
        ps, ws = ot.run_filter(
            key, Y, np.zeros(1, np.float32), np.eye(1, dtype=np.float32)
        )
        means = np.asarray(jnp.einsum("tn,tnd->td", ws, ps))
        rmses["ot"] = float(np.sqrt(np.mean((means[1:, 0] - X) ** 2)))

        for name, rmse in rmses.items():
            assert rmse < 2.5, f"{name}: {rmse}"
        worst, best = max(rmses.values()), min(rmses.values())
        assert worst < 3.0 * best + 0.5

    def test_dpf_particle_count_effect(self, key, sv_short):
        """More particles should not make soft-DPF tracking much worse."""
        Y, X = sv_short
        rmses = []
        for n in (30, 120):
            dpf = DifferentiableParticleFilter(
                n, 1, sv_transition, sv_loglik,
                soft_alpha=0.2, gumbel_temperature=0.3,
            )
            ps, lws = dpf.filter(
                key, Y[None], np.zeros(1, np.float32),
                np.eye(1, dtype=np.float32),
            )
            rmses.append(_soft_rmse(ps, lws, X))
        assert rmses[1] < rmses[0] * 1.5 + 0.1
