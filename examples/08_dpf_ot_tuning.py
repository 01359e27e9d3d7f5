#!/usr/bin/env python
"""DPF-OT parameter tuning: epsilon / damping / Sinkhorn-iteration sweep.

Reproduces the reference's ``DPF_OT_parameter_tuning.ipynb``: sweep the
entropic regularization ``epsilon``, the dual damping, and the iteration
budget of the Sinkhorn resampler on the linear-LGSSM comparison config
(N=50, T=20 — ``DPF_resampling_comparison_linear.ipynb``), scoring each
setting by mean posterior RMSE over seeds.

Design: epsilon and damping are TRACED scalars, so the whole
(eps x damping) grid evaluates under one jit per iteration count, vmapped
over both the grid and the Monte-Carlo seeds — the reference re-runs its
eager TF filter per cell. Run time is seconds, not hours.

Usage: python examples/08_dpf_ot_tuning.py [--seeds 10]
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from particle_filters_jax.resampling.ot import sinkhorn_ot_resample

A_C, SQ, SR = 0.9, 0.3, 0.5  # linear comparison config
N, T = 50, 20


def simulate(key):
    """(T, 1) states and observations of the 1-D LGSSM."""
    def body(x, k):
        k1, k2 = jax.random.split(k)
        x = A_C * x + SQ * jax.random.normal(k1, x.shape)
        y = x + SR * jax.random.normal(k2, x.shape)
        return x, (x, y)

    _, (xs, ys) = jax.lax.scan(body, jnp.zeros(1), jax.random.split(key, T))
    return xs, ys


def run_filter(key, ys, eps, damping, n_iters):
    """OT-DPF with traced epsilon/damping; returns posterior-mean RMSE."""
    k_init, k_scan = jax.random.split(key)
    particles = jax.random.normal(k_init, (N, 1))
    weights = jnp.full((N,), 1.0 / N)

    def step(carry, inp):
        p, w = carry
        k, y = inp
        p = A_C * p + SQ * jax.random.normal(k, p.shape)
        loglik = -0.5 * jnp.sum((p - y[None, :]) ** 2, axis=1) / SR**2
        loglik = loglik - jax.lax.stop_gradient(jnp.max(loglik))
        w = jnp.maximum(w * jnp.exp(loglik), 1e-12)
        w = w / jnp.sum(w)
        p, w = sinkhorn_ot_resample(
            p, w, epsilon=eps, n_iters=n_iters, damping=damping
        )
        return (p, w), jnp.sum(w[:, None] * p, axis=0)

    _, means = jax.lax.scan(
        step, (particles, weights), (jax.random.split(k_scan, T), ys)
    )
    return means


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args()

    eps_grid = jnp.asarray([0.01, 0.02, 0.05, 0.1, 0.2, 0.5])
    damp_grid = jnp.asarray([0.5, 1.0])
    iters_grid = [25, 50, 100]

    keys = jax.random.split(jax.random.PRNGKey(0), args.seeds)
    data = jax.vmap(simulate)(keys)  # xs (S, T, 1), ys (S, T, 1)
    xs, ys = data

    results = []
    for n_iters in iters_grid:
        def score(eps, damping):
            def one(key, x, y):
                means = run_filter(key, y, eps, damping, n_iters)
                return jnp.sqrt(jnp.mean((means - x) ** 2))

            return jnp.mean(jax.vmap(one)(keys, xs, ys))

        grid = jax.jit(
            jax.vmap(
                jax.vmap(score, in_axes=(None, 0)), in_axes=(0, None)
            )
        )(eps_grid, damp_grid)
        grid = np.asarray(jax.block_until_ready(grid))
        for i, eps in enumerate(np.asarray(eps_grid)):
            for j, dmp in enumerate(np.asarray(damp_grid)):
                results.append(
                    dict(epsilon=float(eps), damping=float(dmp),
                         n_iters=n_iters, rmse=float(grid[i, j]))
                )
        print(f"n_iters={n_iters}:")
        for i, eps in enumerate(np.asarray(eps_grid)):
            row = "  ".join(f"{grid[i, j]:.4f}" for j in range(len(damp_grid)))
            print(f"  eps={float(eps):<5}: {row}  (damping {list(np.asarray(damp_grid))})")

    best = min(results, key=lambda r: r["rmse"])
    print(f"\nBest: {best}")
    out = os.path.join(os.path.dirname(__file__), "ot_tuning_results.json")
    with open(out, "w") as f:
        json.dump({"grid": results, "best": best,
                   "config": dict(N=N, T=T, seeds=args.seeds)}, f, indent=2)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
