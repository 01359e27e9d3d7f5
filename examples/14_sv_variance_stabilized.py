#!/usr/bin/env python
"""Variance-stabilized (log-squared) observation transform on the SV model.

Script equivalent of reference ``notebooks/EKF_UKF_VS_experiments.ipynb`` and
``notebooks/PF_VS_experiments.ipynb``: on the same n = 2000 stochastic-
volatility realization (alpha = 0.91, sigma = 1.0, beta = 0.5, seed = 123),
run each filter twice —

  * standard form: the raw multiplicative observation y_t = beta e^{x_t/2} w_t
    (EKF/UKF linearize it; the PF uses the exact heteroscedastic Gaussian
    likelihood), and
  * VS form: z_t = log y_t^2 = x_t + log beta^2 + eps_t with
    eps_t = log w_t^2, E[eps] = psi(1/2) − log(1/2) ≈ −1.2704,
    Var[eps] = psi'(1/2) = pi^2/2 — which makes the observation model LINEAR
    in x_t (the notebooks' key insight), at the cost of a non-Gaussian eps.

Reports RMSE, 95% NEES coverage, and for the PFs mean/min Neff and resample
rate — the comparison table of ``PF_VS_experiments.ipynb`` (cell "Detailed
Performance Comparison").
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


import time

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import chi2

from particle_filters_jax.models import (
    ExtendedKalmanFilter,
    ParticleFilter,
    UnscentedKalmanFilter,
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_jax.simulators import simulate_sv_1d
from particle_filters_jax.utils import rmse

N_STEPS, ALPHA, SIGMA, BETA = 2000, 0.91, 1.0, 0.5
MU_EPS = -1.2703628454614782  # E[log W^2], W ~ N(0,1)
VAR_EPS = np.pi**2 / 2.0  # Var[log W^2]

sv = simulate_sv_1d(N_STEPS, ALPHA, SIGMA, BETA, seed=123)
ys = sv.Y[:, None]
zs = jnp.log(sv.Y**2 + 1e-300)[:, None]  # VS transform

g = lambda x, u: ALPHA * x
Q = jnp.array([[SIGMA**2]])
P0 = jnp.array([[SIGMA**2 / (1 - ALPHA**2)]])
lo, hi = chi2.ppf(0.025, df=1), chi2.ppf(0.975, df=1)


def timed(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out


def report_gaussian(name, ms, Ps, ref=""):
    nees = (ms[:, 0] - sv.X) ** 2 / Ps[:, 0, 0]
    cov = float(jnp.mean(((nees >= lo) & (nees <= hi)).astype(jnp.float32)))
    print(
        f"{name:16s} RMSE {float(rmse(ms[:, 0], sv.X)):7.4f}   "
        f"coverage {cov * 100:5.1f}%{ref}"
    )


# ---- EKF: standard (linearize the raw observation) vs VS ------------------
# Standard: h(x) = E|y| ∝ beta e^{x/2} is what the notebook linearizes; its
# Jacobian comes from AD here.
h_std = lambda x: BETA * jnp.exp(0.5 * x)
R_std = jnp.array([[BETA**2]])  # noise scale of the raw observation
ekf_std = ExtendedKalmanFilter(g, h_std, Q, R_std)
_, (_, m, P) = timed(
    jax.jit(lambda z: ekf_std.run(make_ekf_state(jnp.zeros(1), P0), z)),
    jnp.abs(ys),
)
report_gaussian("EKF standard", m, P)

h_vs = lambda x: x + jnp.log(BETA**2) + MU_EPS
R_vs = jnp.array([[VAR_EPS]])
ekf_vs = ExtendedKalmanFilter(g, h_vs, Q, R_vs)
_, (_, m, P) = timed(
    jax.jit(lambda z: ekf_vs.run(make_ekf_state(jnp.zeros(1), P0), z)), zs
)
report_gaussian("EKF log-var", m, P, "   (notebook: VS dramatically beats standard)")

# ---- UKF: same pair ---------------------------------------------------------
ukf_std = UnscentedKalmanFilter(g, h_std, Q, R_std, alpha=1.0)
_, (_, m, P) = timed(
    jax.jit(lambda z: ukf_std.run(make_ukf_state(jnp.zeros(1), P0), z)),
    jnp.abs(ys),
)
report_gaussian("UKF standard", m, P)

ukf_vs = UnscentedKalmanFilter(g, h_vs, Q, R_vs, alpha=1.0)
_, (_, m, P) = timed(
    jax.jit(lambda z: ukf_vs.run(make_ukf_state(jnp.zeros(1), P0), z)), zs
)
report_gaussian("UKF log-var", m, P)

# ---- PF: exact heteroscedastic likelihood vs log-squared likelihood --------
NP = 1000


def ll_std(x, z):
    var = BETA**2 * jnp.exp(x[0])
    return -0.5 * (z[0] ** 2 / var + jnp.log(var))


def ll_logsq(x, z):
    # eps = z − x − log beta^2 is log-chi²(1):
    #   p(eps) = 1/sqrt(2 pi) exp(eps/2 − e^eps/2)
    e = z[0] - x[0] - jnp.log(BETA**2)
    return 0.5 * e - 0.5 * jnp.exp(e)


for name, ll, obs in (("PF standard", ll_std, ys), ("PF log-sq", ll_logsq, zs)):
    pf = ParticleFilter(g, None, Q, None, Np=NP, obs_loglik=ll, resample_thresh=0.5)
    st = pf.initialize(jax.random.PRNGKey(0), jnp.zeros(1), P0)
    t, (_, hist) = timed(
        jax.jit(lambda k, s, o: pf.run(k, s, o, track_degeneracy=True)),
        jax.random.PRNGKey(1),
        st,
        obs,
    )
    nees = (hist["mean"][:, 0] - sv.X) ** 2 / hist["cov"][:, 0, 0]
    cov = float(jnp.mean(((nees >= lo) & (nees <= hi)).astype(jnp.float32)))
    print(
        f"{name:16s} RMSE {float(rmse(hist['mean'][:, 0], sv.X)):7.4f}   "
        f"coverage {cov * 100:5.1f}%   Neff mean/min "
        f"{float(hist['ess'].mean()):6.1f}/{float(hist['ess'].min()):6.1f}   "
        f"resample {float(hist['resampled'].mean()) * 100:4.1f}%   "
        f"{t / N_STEPS * 1e3:.3f} ms/step"
    )
