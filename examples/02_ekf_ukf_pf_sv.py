#!/usr/bin/env python
"""EKF vs UKF vs SIR-PF on the stochastic-volatility model.

Script equivalent of reference ``notebooks/EKF_UKF_PF_comparison.ipynb``
(reported there: RMSE 9.735 / 7.705 / 3.450; runtimes 0.123 / 0.327 / 10.24
ms per step on CPU).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import time

import jax
import jax.numpy as jnp
import numpy as np

from particle_filters_jax.models import (
    ExtendedKalmanFilter,
    ParticleFilter,
    UnscentedKalmanFilter,
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_jax.simulators import simulate_sv_1d
from particle_filters_jax.utils import rmse

T, ALPHA, SIGMA, BETA = 2000, 0.95, 0.2, 1.0
sv = simulate_sv_1d(T, ALPHA, SIGMA, BETA, seed=42)

# Gaussianized observation for EKF/UKF: log y² ≈ x + log β² + E[log W²]
y_log = jnp.log(sv.Y**2 + 1e-8)[:, None]
g = lambda x, u: ALPHA * x
h = lambda x: x + jnp.log(BETA**2) - 1.2704
Q = jnp.array([[SIGMA**2]])
R_log = jnp.array([[np.pi**2 / 2]])


def timed(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out


ekf = ExtendedKalmanFilter(g, h, Q, R_log)
t_e, (_, m_e, _) = timed(
    jax.jit(lambda z: ekf.run(make_ekf_state(jnp.zeros(1), jnp.eye(1)), z)), y_log
)
ukf = UnscentedKalmanFilter(g, h, Q, R_log, alpha=1.0)
t_u, (_, m_u, _) = timed(
    jax.jit(lambda z: ukf.run(make_ukf_state(jnp.zeros(1), jnp.eye(1)), z)), y_log
)


def obs_ll(x, z):
    var = BETA**2 * jnp.exp(x[0])
    return -0.5 * (z[0] ** 2 / var + jnp.log(var))


pf = ParticleFilter(g, None, Q, None, Np=2000, obs_loglik=obs_ll)
st = pf.initialize(
    jax.random.PRNGKey(0), jnp.zeros(1),
    jnp.array([[SIGMA**2 / (1 - ALPHA**2)]]),
)
t_p, (_, hist) = timed(
    jax.jit(lambda k, s: pf.run(k, s, sv.Y[:, None])), jax.random.PRNGKey(1), st
)

print(f"{'filter':8s} {'RMSE':>8s} {'ms/step':>9s}   (reference RMSE / ms-step)")
print(f"{'EKF':8s} {float(rmse(m_e[:,0], sv.X)):8.3f} {t_e/T*1e3:9.4f}   (9.735 / 0.123)")
print(f"{'UKF':8s} {float(rmse(m_u[:,0], sv.X)):8.3f} {t_u/T*1e3:9.4f}   (7.705 / 0.327)")
print(f"{'SIR PF':8s} {float(rmse(hist['mean'][:,0], sv.X)):8.3f} {t_p/T*1e3:9.4f}   (3.450 / 10.24)")

# --- log-variance observation variant (reference notebook cell 23:
# RMSE ≈ 1.254 with ≈95% coverage for all filters on its data) -----------
from scipy.stats import chi2

lo, hi = chi2.ppf(0.025, df=1), chi2.ppf(0.975, df=1)
kf_like = ExtendedKalmanFilter(g, h, Q, R_log)
_, m_lv, P_lv = kf_like.run(make_ekf_state(jnp.zeros(1), jnp.eye(1)), y_log)
nees_lv = (m_lv[:, 0] - sv.X) ** 2 / P_lv[:, 0, 0]
cover = float(jnp.mean(((nees_lv >= lo) & (nees_lv <= hi)).astype(jnp.float32)))
print(f"\nlog-variance-obs variant: RMSE {float(rmse(m_lv[:,0], sv.X)):.3f}, "
      f"95% coverage {cover*100:.1f}%  (reference: ≈1.254 / ≈95%)")
