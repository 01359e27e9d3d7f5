"""Finite-difference vs autodiff gradient checks for the DPF path.

SURVEY.md §4 calls for FD-vs-AD checks on the differentiable-resampling
path (the reference relies on TF GradientTape and never validates its
gradients numerically). With a FIXED PRNG key every DPF loss is a
deterministic function of its parameters, so central differences are a
valid oracle for ``jax.grad``.

All checks run in float64 (enabled per-test) — float32 central differences
carry ~1e-4 relative noise, which would mask real gradient bugs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models.dpf import DPF_OT, DifferentiableParticleFilter
from particle_filters_jax.resampling.ot import sinkhorn_ot_resample
from particle_filters_jax.resampling.soft import soft_resample


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def central_diff(f, theta, h=1e-5):
    return (f(theta + h) - f(theta - h)) / (2.0 * h)


class TestSoftDPFGradCheck:
    def test_fd_matches_ad_through_filter(self, key, x64):
        """d loss / d alpha through the full soft-DPF filter."""
        T, N = 8, 24
        rng = np.random.default_rng(3)
        xs = np.cumsum(0.3 * rng.standard_normal((T, 1)), axis=0)
        ys = (xs + 0.2 * rng.standard_normal((T, 1))).astype(np.float64)

        def transition_fn(k, x, params):
            return params["alpha"] * x + 0.3 * jax.random.normal(
                k, x.shape, x.dtype
            )

        def log_lik_fn(x, y, params):
            return -0.5 * jnp.sum(
                (y[:, None, :] - x) ** 2, axis=-1
            ) / 0.04

        dpf = DifferentiableParticleFilter(
            N, 1, transition_fn, log_lik_fn,
            soft_alpha=0.3, gumbel_temperature=0.5,
        )

        def loss(alpha):
            ps, lws = dpf.filter(
                key, ys[None], jnp.zeros(1, jnp.float64),
                jnp.eye(1, dtype=jnp.float64),
                params={"alpha": alpha},
            )
            w = jnp.exp(
                lws - jax.scipy.special.logsumexp(lws, axis=-1, keepdims=True)
            )
            means = jnp.einsum("btn,btnd->btd", w, ps)
            return jnp.mean((means[:, 1:] - xs[None]) ** 2)

        g_ad = float(jax.grad(loss)(jnp.asarray(0.8)))
        g_fd = float(central_diff(loss, jnp.asarray(0.8)))
        assert np.isfinite(g_ad) and abs(g_ad) > 1e-8
        np.testing.assert_allclose(g_ad, g_fd, rtol=2e-3, atol=1e-7)

    def test_fd_matches_ad_wrt_logweights(self, key, x64):
        """d/d logw of a soft-resample functional (direct resampler check)."""
        N = 16
        particles = jax.random.normal(key, (1, N, 2), jnp.float64)
        logw0 = jax.random.normal(jax.random.fold_in(key, 1), (1, N),
                                  jnp.float64)

        def f(s):
            new_p, _ = soft_resample(
                jax.random.fold_in(key, 2), particles, logw0 * s,
                alpha=0.2, temperature=0.7,
            )
            return jnp.sum(new_p**2)

        g_ad = float(jax.grad(f)(jnp.asarray(1.0)))
        g_fd = float(central_diff(f, jnp.asarray(1.0)))
        np.testing.assert_allclose(g_ad, g_fd, rtol=2e-3, atol=1e-7)


class TestOTGradCheck:
    def test_fd_matches_ad_through_sinkhorn(self, key, x64):
        """d/d scale of a functional of the Sinkhorn-resampled cloud: the
        gradient flows through the unrolled dual iterations."""
        N = 12
        particles = jax.random.normal(key, (N, 2), jnp.float64)
        w = jax.nn.softmax(jax.random.normal(jax.random.fold_in(key, 1), (N,),
                                             jnp.float64))

        def f(s):
            new_p, _ = sinkhorn_ot_resample(
                particles * s, w, epsilon=0.3, n_iters=40
            )
            return jnp.sum(jnp.tanh(new_p))

        g_ad = float(jax.grad(f)(jnp.asarray(1.0)))
        g_fd = float(central_diff(f, jnp.asarray(1.0)))
        assert np.isfinite(g_ad) and abs(g_ad) > 1e-8
        np.testing.assert_allclose(g_ad, g_fd, rtol=2e-3, atol=1e-7)

    def test_fd_matches_ad_through_ot_filter(self, key, x64):
        """d loss / d alpha through the full OT-DPF filter."""
        T, N = 5, 16
        rng = np.random.default_rng(9)
        xs = np.cumsum(0.2 * rng.standard_normal((T, 1)), axis=0)
        ys = (xs + 0.2 * rng.standard_normal((T, 1))).astype(np.float64)

        def loss(alpha):
            dpf = DPF_OT(
                N, 1,
                lambda k, p, t: alpha * p
                + 0.3 * jax.random.normal(k, p.shape, p.dtype),
                lambda p, y, t: -0.5 * jnp.sum(
                    (p - y[None, :]) ** 2, axis=1
                ) / 0.04,
                epsilon=0.3, n_sinkhorn_iters=30,
            )
            ps, ws = dpf.run_filter(
                key, ys, jnp.zeros(1, jnp.float64),
                jnp.eye(1, dtype=jnp.float64),
            )
            means = jnp.einsum("tn,tnd->td", ws, ps)
            return jnp.mean((means[1:] - xs) ** 2)

        g_ad = float(jax.grad(loss)(jnp.asarray(0.9)))
        g_fd = float(central_diff(loss, jnp.asarray(0.9)))
        assert np.isfinite(g_ad) and abs(g_ad) > 1e-10
        np.testing.assert_allclose(g_ad, g_fd, rtol=5e-3, atol=1e-7)
