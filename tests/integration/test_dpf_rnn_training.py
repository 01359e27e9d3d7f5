"""End-to-end training of the RNN resampler (optax through jax.grad).

The reference trains its Keras resampler (``DPF_RNN_resampling.py:82-167``)
but never validates the result; here a short optax loop must produce a
resampler that (a) massively improves posterior calibration (Gaussian NLL)
over the training-free baseline and (b) holds the LGSSM RMSE floor. The
full-budget run lives in ``examples/09_train_rnn_resampler.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from particle_filters_jax.models.dpf import DifferentiableParticleFilterRNN

pytestmark = [pytest.mark.integration, pytest.mark.slow]

A_C, SQ, SR = 0.9, 0.5, 0.7
N, T, BATCH = 16, 15, 4


def _simulate(key, batch):
    k0, ks = jax.random.split(key)
    x0 = jax.random.normal(k0, (batch, 1))

    def body(x, k):
        k1, k2 = jax.random.split(k)
        x = A_C * x + SQ * jax.random.normal(k1, x.shape)
        return x, (x, x + SR * jax.random.normal(k2, x.shape))

    _, (xs, ys) = jax.lax.scan(body, x0, jax.random.split(ks, T))
    return xs.swapaxes(0, 1), ys.swapaxes(0, 1)


def _transition(key, p, params):
    return A_C * p + SQ * jax.random.normal(key, p.shape, p.dtype)


def _loglik(p, y, params):
    return -0.5 * jnp.sum((y[:, None, :] - p) ** 2, axis=-1) / SR**2


def _moments(dpf, params, key, ys):
    ps, lws = dpf.filter(params, key, ys, jnp.zeros(1), jnp.eye(1))
    w = jnp.exp(lws - jax.scipy.special.logsumexp(lws, axis=-1, keepdims=True))
    means = jnp.einsum("btn,btnd->btd", w, ps)
    var = jnp.sum(w * (ps[..., 0] - means[..., 0][..., None]) ** 2, axis=-1)
    return means[:, 1:], var[:, 1:]


def _nll(dpf, params, key, ys, xs):
    means, var = _moments(dpf, params, key, ys)
    var = var + 1e-4
    return jnp.mean(
        0.5 * jnp.log(var) + 0.5 * (means[..., 0] - xs[..., 0]) ** 2 / var
    )


def _rmse(dpf, params, key, ys, xs):
    means, _ = _moments(dpf, params, key, ys)
    return jnp.sqrt(jnp.mean((means - xs) ** 2))


def test_training_improves_calibration_and_holds_rmse_floor(key):
    dpf = DifferentiableParticleFilterRNN(
        N, 1, _transition, _loglik, rnn_type="gru", rnn_hidden_dim=16,
        temperature=0.5, use_weight_prior=True,
    )
    params = dpf.init_resampler(key)
    opt = optax.adam(5e-3)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(params, opt_state, k):
        k_data, k_filt = jax.random.split(k)
        xs, ys = _simulate(k_data, BATCH)
        loss, grads = jax.value_and_grad(
            lambda p: _nll(dpf, p, k_filt, ys, xs)
        )(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for step in range(100):
        params, opt_state, loss = train_step(
            params, opt_state, jax.random.fold_in(key, step)
        )
        losses.append(float(loss))

    # training reduced the objective
    assert np.mean(losses[-10:]) < np.mean(losses[:10])

    # held-out: trained calibration beats baseline mode by >= 5x
    k_hold = jax.random.PRNGKey(321)
    xs_h, ys_h = _simulate(k_hold, 16)
    k_eval = jax.random.fold_in(k_hold, 1)
    nll_trained = float(_nll(dpf, params, k_eval, ys_h, xs_h))

    dpf_base = DifferentiableParticleFilterRNN(
        N, 1, _transition, _loglik, rnn_type="gru", rnn_hidden_dim=16,
        temperature=0.5, use_weight_prior=True, use_baseline_resampling=True,
    )
    nll_baseline = float(_nll(dpf_base, params, k_eval, ys_h, xs_h))
    assert nll_trained < nll_baseline / 5.0, (
        f"trained NLL {nll_trained:.2f} vs baseline {nll_baseline:.2f}"
    )

    # ...while holding the RMSE floor (statistical tie)
    rmse_trained = float(_rmse(dpf, params, k_eval, ys_h, xs_h))
    rmse_baseline = float(_rmse(dpf_base, params, k_eval, ys_h, xs_h))
    assert rmse_trained <= rmse_baseline + 0.15


def test_weight_prior_reproduces_baseline_at_init(key):
    """With use_weight_prior the fresh (near-zero head) learned resampler
    is the deterministic counterpart of baseline mode: assignments are
    weight-proportional rows."""
    dpf = DifferentiableParticleFilterRNN(
        12, 1, _transition, _loglik, rnn_hidden_dim=8,
        temperature=1.0, use_weight_prior=True,
    )
    params = dpf.init_resampler(key)
    particles = jax.random.normal(jax.random.fold_in(key, 1), (12, 1))
    logw = jax.random.normal(jax.random.fold_in(key, 2), (12,))
    _, _, aux = dpf.resampler.apply(
        params, jax.random.fold_in(key, 3), particles, logw, True
    )
    w = np.asarray(jax.nn.softmax(logw))
    assign = np.asarray(aux["assignment"])
    # every row ~ the normalized weights (head contributes ~0.001 logits)
    np.testing.assert_allclose(assign, np.tile(w, (12, 1)), atol=0.01)
