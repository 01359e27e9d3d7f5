#!/usr/bin/env python
"""Train the RNN resampler end-to-end and compare against baseline mode.

The reference trains its Keras LSTM/GRU resampler through the filter
(``models/DPF_RNN_resampling.py:82-167``) but its comparison tables only
ever report the untrained/baseline resampler. Here the resampler
parameters are an explicit pytree, so training is a plain optax loop over
``jax.grad`` of a filtering loss, with fresh simulated LGSSM minibatches
every step and a held-out evaluation (8 eval keys) at the end.

Two training objectives, two honest findings:

- ``rmse`` (posterior-mean error, the reference's notion of quality): on a
  linear-Gaussian SSM every weight-proportional resampler sits at the same
  RMSE floor (0.5196-0.5198 here across 8 eval keys — the posterior mean is
  insensitive to resampler detail once weights are respected), so training
  holds the floor rather than beating it; there is no RMSE signal to learn.
  (``use_weight_prior=True`` starts the head AT the baseline.)
- ``nll`` (Gaussian negative log-likelihood of the truth under the
  posterior mean/variance): baseline-mode clouds are badly over-confident
  (collapsed); the trained head learns calibrated spread and wins by
  ~50-100x. This is where a learned resampler genuinely earns its keep.

Usage: python examples/09_train_rnn_resampler.py [--steps 500]
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from particle_filters_jax.models.dpf import DifferentiableParticleFilterRNN

A_C, SQ, SR = 0.9, 0.5, 0.7  # the DPF LGSSM comparison system
N, T, BATCH = 16, 25, 8


def simulate_batch(key, batch, t_steps):
    """(B, T, 1) states and observations; x0 ~ N(0, 1)."""
    k0, ks = jax.random.split(key)
    x0 = jax.random.normal(k0, (batch, 1))

    def body(x, k):
        k1, k2 = jax.random.split(k)
        x = A_C * x + SQ * jax.random.normal(k1, x.shape)
        y = x + SR * jax.random.normal(k2, x.shape)
        return x, (x, y)

    _, (xs, ys) = jax.lax.scan(body, x0, jax.random.split(ks, t_steps))
    return xs.swapaxes(0, 1), ys.swapaxes(0, 1)  # (B, T, 1) each


def transition_fn(key, p, params):
    return A_C * p + SQ * jax.random.normal(key, p.shape, p.dtype)


def log_lik_fn(p, y, params):
    return -0.5 * jnp.sum((y[:, None, :] - p) ** 2, axis=-1) / SR**2


def make_filter(**kw):
    # use_weight_prior=True: the near-zero head starts AT the
    # weight-proportional baseline and training learns corrections on top.
    kw.setdefault("use_weight_prior", True)
    return DifferentiableParticleFilterRNN(
        N, 1, transition_fn, log_lik_fn,
        rnn_type="gru", rnn_hidden_dim=16, temperature=0.5, **kw,
    )


def filter_moments(dpf, params, key, ys):
    """Posterior means (B, T, 1) and variances (B, T) per step (t=1..T)."""
    ps, lws = dpf.filter(params, key, ys, jnp.zeros(1), jnp.eye(1))
    w = jnp.exp(lws - jax.scipy.special.logsumexp(lws, axis=-1, keepdims=True))
    means = jnp.einsum("btn,btnd->btd", w, ps)  # (B, T+1, 1)
    dev = ps[..., 0] - means[..., 0][..., None]  # (B, T+1, N)
    var = jnp.sum(w * dev**2, axis=-1)  # (B, T+1)
    return means[:, 1:], var[:, 1:]


def filter_rmse(dpf, params, key, ys, xs):
    means, _ = filter_moments(dpf, params, key, ys)
    return jnp.sqrt(jnp.mean((means - xs) ** 2))


def filter_nll(dpf, params, key, ys, xs):
    """Gaussian NLL of the truth under the per-step posterior (mean, var):
    rewards calibrated SPREAD, which RMSE-of-mean cannot see."""
    means, var = filter_moments(dpf, params, key, ys)
    var = var + 1e-4
    sq = (means[..., 0] - xs[..., 0]) ** 2
    return jnp.mean(0.5 * jnp.log(var) + 0.5 * sq / var)


def train(dpf, loss_fn, key, steps, lr):
    """Adam with cosine decay + validation-based checkpoint selection: a
    fixed validation batch scores the parameters every 25 steps and the
    best checkpoint is returned (stochastic-gradient wander around a flat
    optimum would otherwise cost the final iterate a hair of quality)."""
    params = dpf.init_resampler(key)
    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.1))
    opt_state = opt.init(params)

    k_val = jax.random.fold_in(key, 10_000)
    xs_v, ys_v = simulate_batch(k_val, 16, T)
    val_score = jax.jit(
        lambda p: loss_fn(dpf, p, jax.random.fold_in(k_val, 1), ys_v, xs_v)
    )

    @jax.jit
    def train_step(params, opt_state, key):
        k_data, k_filt = jax.random.split(key)
        xs, ys = simulate_batch(k_data, BATCH, T)
        loss, grads = jax.value_and_grad(
            lambda p: loss_fn(dpf, p, k_filt, ys, xs)
        )(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    best_params, best_val = params, float(val_score(params))
    for step in range(steps):
        params, opt_state, loss = train_step(
            params, opt_state, jax.random.fold_in(key, step)
        )
        if step % 25 == 0 or step == steps - 1:
            v = float(val_score(params))
            if v < best_val:
                best_params, best_val = params, v
        if step % 100 == 0 or step == steps - 1:
            print(f"  step {step:4d}: loss {float(loss):.4f} "
                  f"(best val {best_val:.4f})", flush=True)
    return best_params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args()

    key = jax.random.PRNGKey(0)
    dpf = make_filter()

    print("training (objective: rmse)")
    params_rmse = train(dpf, filter_rmse, key, args.steps, args.lr)
    print("training (objective: nll)")
    params_nll = train(dpf, filter_nll, jax.random.fold_in(key, 1),
                       args.steps, args.lr)

    # ---- held-out evaluation over 8 eval keys ---------------------------
    k_hold = jax.random.PRNGKey(777)
    xs_h, ys_h = simulate_batch(k_hold, 32, T)
    eval_keys = jax.random.split(jax.random.fold_in(k_hold, 1), 8)

    def eval_mean(dpf_obj, p):
        rmse = jax.jit(jax.vmap(
            lambda k: filter_rmse(dpf_obj, p, k, ys_h, xs_h)
        ))(eval_keys)
        nll = jax.jit(jax.vmap(
            lambda k: filter_nll(dpf_obj, p, k, ys_h, xs_h)
        ))(eval_keys)
        return float(jnp.mean(rmse)), float(jnp.mean(nll))

    rows = {}
    rows["rnn (trained, rmse obj)"] = eval_mean(dpf, params_rmse)
    rows["rnn (trained, nll obj)"] = eval_mean(dpf, params_nll)
    rows["rnn (untrained)"] = eval_mean(dpf, dpf.init_resampler(key))
    dpf_base = make_filter(use_baseline_resampling=True)
    rows["baseline mode"] = eval_mean(dpf_base, params_rmse)

    print(f"\nheld-out over 8 eval keys (32 sequences, T={T}):")
    for name, (rmse, nll) in rows.items():
        print(f"  {name:<26}: RMSE {rmse:.4f}  NLL {nll:9.4f}")
    # On a linear-Gaussian SSM every proportional-resampler variant sits at
    # the same RMSE floor (the posterior mean is insensitive to resampler
    # detail once weights are respected) — so the honest RMSE claim is a
    # statistical tie, and the trained resampler's win is calibration.
    rmse_ok = (
        rows["rnn (trained, rmse obj)"][0]
        <= rows["baseline mode"][0] + 0.005
    )
    nll_ok = rows["rnn (trained, nll obj)"][1] < rows["baseline mode"][1] / 10
    print(f"  trained (rmse obj) matches baseline RMSE floor: {rmse_ok}")
    print(f"  trained (nll obj) beats baseline on NLL by >=10x: {nll_ok}")

    out = os.path.join(os.path.dirname(__file__), "rnn_training_results.json")
    with open(out, "w") as f:
        json.dump(
            dict(
                steps=args.steps, lr=args.lr,
                heldout={k: dict(rmse=v[0], nll=v[1])
                         for k, v in rows.items()},
                rmse_matches_baseline_floor=bool(rmse_ok),
                nll_beats_baseline_10x=bool(nll_ok),
            ),
            f, indent=2,
        )
    print(f"wrote {out}")

    flat, _ = jax.tree_util.tree_flatten(params_nll)
    np.savez(
        os.path.join(os.path.dirname(__file__), "rnn_resampler_params.npz"),
        *[np.asarray(x) for x in flat],
    )


if __name__ == "__main__":
    main()
