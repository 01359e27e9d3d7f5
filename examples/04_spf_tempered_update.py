#!/usr/bin/env python
"""Stochastic particle flow: tempered Bayes update vs the exact posterior.

Script equivalent of reference ``notebooks/SPF_results_reproduction_example1.ipynb``
(20 MC runs; linear-β RMSE ≈ 6.3 there on a harder scenario).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import jax
import jax.numpy as jnp
import numpy as np

from particle_filters_jax.models import LinearGaussianBayes, run_generalized_spf

model = LinearGaussianBayes.create(
    m0=jnp.array([5.0, -3.0]),
    P0=4.0 * jnp.eye(2),
    H=jnp.eye(2),
    R=0.5 * jnp.eye(2),
    z=jnp.array([1.0, 1.0]),
)
m_post, P_post = model.kalman_posterior()
print("exact posterior mean:", np.asarray(m_post).round(3))

for mode in ("linear", "optimal"):
    errs = []
    for seed in range(10):
        X, x_hat, info = run_generalized_spf(
            model, N=2000, n_steps=200, beta_mode=mode, seed=seed
        )
        errs.append(float(jnp.linalg.norm(x_hat - m_post)))
    print(
        f"beta={mode:8s}: mean-estimate error {np.mean(errs):.4f} ± {np.std(errs):.4f} "
        f"(10 MC runs), beta(1)={float(info['beta'][-1]):.3f}"
    )
