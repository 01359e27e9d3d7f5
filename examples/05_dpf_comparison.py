#!/usr/bin/env python
"""Differentiable PF resampling comparison: soft vs OT vs RNN.

Script equivalent of reference ``notebooks/DPF_resampling_comparison_linear.ipynb``
(N=50, T=20, 3 runs; reference RMSE 0.3653/0.3336/0.5018, step time
8 ms / 3.55 s / 4.2 ms on CPU/TF-eager).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import time

import jax
import jax.numpy as jnp
import numpy as np

from particle_filters_jax.models import (
    DPF_OT,
    DifferentiableParticleFilter,
    DifferentiableParticleFilterRNN,
)

A_C, SQ, SR = 0.9, 0.3, 0.5
N, T, RUNS = 50, 20, 3


def simulate(key):
    x = jnp.zeros((1, 1))
    xs, ys = [], []
    for t in range(T):
        k1, k2 = jax.random.split(jax.random.fold_in(key, t))
        x = A_C * x + SQ * jax.random.normal(k1, x.shape)
        xs.append(x)
        ys.append(x + SR * jax.random.normal(k2, x.shape))
    X, Y = jnp.stack(xs, 1), jnp.stack(ys, 1)
    truth = jnp.concatenate([jnp.zeros((1, 1, 1)), X], 1)
    return X, Y, truth


def trans(k, p, params):
    return A_C * p + SQ * jax.random.normal(k, p.shape, p.dtype)


def loglik(p, y, params):
    return jnp.sum(-0.5 * (y[:, None, :] - p) ** 2 / SR**2, axis=-1)


def trans1(k, p, t):
    return A_C * p + SQ * jax.random.normal(k, p.shape, p.dtype)


def obsll1(p, y, t):
    return jnp.sum(-0.5 * (y - p) ** 2 / SR**2, axis=-1)


results = {}
for run in range(RUNS):
    key = jax.random.PRNGKey(run)
    X, Y, truth = simulate(key)

    dpf = DifferentiableParticleFilter(N, 1, trans, loglik)
    f = jax.jit(lambda k: dpf.filter(k, Y, jnp.zeros(1), jnp.eye(1),
                                     return_diagnostics=True, ground_truth=truth))
    out = f(key); jax.block_until_ready(out[0])
    t0 = time.perf_counter(); out = f(key); jax.block_until_ready(out[0])
    results.setdefault("soft", []).append(
        (float(out[2]["mean_rmse"]), (time.perf_counter() - t0) / T * 1e3)
    )

    dpf_ot = DPF_OT(N, 1, trans1, obsll1, epsilon=0.1, n_sinkhorn_iters=50)
    f = jax.jit(lambda k: dpf_ot.run_filter(k, Y[0], jnp.zeros(1), jnp.eye(1)))
    out = f(key); jax.block_until_ready(out[0])
    t0 = time.perf_counter(); ps, ws = f(key); jax.block_until_ready(ps)
    means = jnp.einsum("tn,tnd->td", ws, ps)
    results.setdefault("ot", []).append(
        (float(jnp.sqrt(jnp.mean((means[1:] - X[0]) ** 2))),
         (time.perf_counter() - t0) / T * 1e3)
    )

    dpf_rnn = DifferentiableParticleFilterRNN(
        N, 1, trans, loglik, use_baseline_resampling=True, temperature=0.5
    )
    params = dpf_rnn.init_resampler(key)
    f = jax.jit(lambda k: dpf_rnn.filter(params, k, Y, jnp.zeros(1), jnp.eye(1),
                                         return_diagnostics=True, ground_truth=truth))
    out = f(key); jax.block_until_ready(out[0])
    t0 = time.perf_counter(); out = f(key); jax.block_until_ready(out[0])
    results.setdefault("rnn", []).append(
        (float(out[2]["mean_rmse"]), (time.perf_counter() - t0) / T * 1e3)
    )

ref = {"soft": (0.3653, 8.0), "ot": (0.3336, 3550.0), "rnn": (0.5018, 4.2)}
print(f"{'variant':8s} {'RMSE':>8s} {'ms/step':>9s}   (reference RMSE / ms-step)")
for name, vals in results.items():
    r = np.mean([v[0] for v in vals])
    t = np.mean([v[1] for v in vals])
    print(f"{name:8s} {r:8.4f} {t:9.3f}   ({ref[name][0]} / {ref[name][1]})")
