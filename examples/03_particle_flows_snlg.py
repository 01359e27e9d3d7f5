#!/usr/bin/env python
"""KF / UKF / EDH / LEDH on the linear-Gaussian sensor network.

Script equivalent of reference ``notebooks/PF_PF_results_reproduction_snlg.ipynb``
(reported MSEs at d=64, σ_z=2: KF 0.4958, UKF 0.4958, EDH-200 0.6510).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import jax
import jax.numpy as jnp
import numpy as np

from particle_filters_jax.core.linalg import mvn_logpdf_chol
from particle_filters_jax.models import (
    EDHConfig,
    EDHFlowPF,
    ExtendedKalmanFilter,
    GaussianTracker,
    LEDHConfig,
    LEDHFlowPF,
    UnscentedKalmanFilter,
    kalman_filter_general,
    make_ukf_state,
)
from particle_filters_jax.simulators import SNLGConfig, simulate_snlg_dataset

D, T, SZ, AL = 64, 50, 2.0, 0.9
ds = simulate_snlg_dataset(SNLGConfig(d=D, T=T, trials=1, sigmas=(SZ,), seed=123))
X, Z = ds.X[0, 0], ds.Z[0, 0]
I = jnp.eye(D)
Sigma = jnp.asarray(ds.Sigma)
R = SZ**2 * I

res = kalman_filter_general(Z, AL * I, I, I, Sigma, R, x0=jnp.zeros(D), P0=Sigma)
print(f"KF   MSE: {float(jnp.mean((res.x_filt - X[1:])**2)):.4f}  (ref 0.4958)")

ukf = UnscentedKalmanFilter(lambda x, u: AL * x, lambda x: x, Sigma, R, alpha=1.0)
_, mu, _ = ukf.run(make_ukf_state(jnp.zeros(D), Sigma), Z)
print(f"UKF  MSE: {float(jnp.mean((mu - X[1:])**2)):.4f}  (ref 0.4958)")

LQ = jnp.linalg.cholesky(Sigma + 1e-6 * I)
g = lambda x, u, v: AL * x + v
h = lambda x: x
jh = lambda x: I
lt = lambda xn, xo: mvn_logpdf_chol(xn, AL * xo, LQ)
ll = lambda z, x: mvn_logpdf_chol(z, x, SZ * I)
ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T
key = jax.random.PRNGKey(0)

# The notebook's SNLG overrides of the shared config defaults: 4 lambda
# steps and ESS/N < 0.5 resampling for both flows (EDH keeps default RK4).
for name, cls, cfg, ref in [
    ("EDH-200", EDHFlowPF,
     EDHConfig(n_particles=200, n_lambda_steps=4), 0.6510),
    ("LEDH-200", LEDHFlowPF,
     LEDHConfig(n_particles=200, n_lambda_steps=4, resample_ess_ratio=0.5),
     0.6512),
]:
    ekf = ExtendedKalmanFilter(lambda x, u: AL * x, h, Sigma, R)
    tracker = GaussianTracker(ekf)
    filt = cls(tracker, g, h, jh, lt, ll, R, cfg)
    st = filt.init_from_gaussian(key, jnp.zeros(D), Sigma)
    ts = tracker.init(jnp.zeros(D), Sigma)
    _, _, hist = jax.jit(
        lambda k, s, t: filt.run(k, s, t, Z, process_noise_sampler=ns)
    )(key, st, ts)
    print(f"{name} MSE: {float(jnp.mean((hist['mean'] - X[1:])**2)):.4f}  (ref {ref})")
