#!/usr/bin/env python
"""EKF / UKF / EDH / LEDH on the skew-t sensor network with Poisson counts.

Script equivalent of reference ``notebooks/PF_PF_results_reproduction_sn_skew.ipynb``:
simulate the d = 144 lattice (α₀ = 1, α₁ = 1e-3, β = 8; skew-t dynamics
α = 0.9, ν = 8, γ-scale 0.1; Poisson counts with m₁ = 1, m₂ = 1/3; T = 10,
seed 42), then run each filter with the notebook's Gaussian working model

  * dynamics  g(x) = α x with working process covariance Q = Σ,
  * measurement h(x) = m₁ e^{m₂ x}, Jacobian diag(m₁ m₂ e^{m₂ x}),
    working R = diag(h(0)) (Poisson variance at the prior mean),
  * flows additionally use the exact Poisson log-likelihood
    (the notebook's has a bugged but x-independent factorial constant),

and report per-filter MSE / ESS / wall-clock. The notebook averages 100
trials and adds d = 400; pass ``--trials``/``--d`` to match (defaults are
lighter so the script runs in minutes on CPU).

Differences from the notebook: each trial is the filter's single ``lax.scan`` over
time (the notebook hand-loops predict/update), trials share one compiled
function, and the UKF uses alpha = 0.5 — the notebook's 1e-3 is
information-theoretically unusable in f32 (see
``unscented_kalman_filter.py`` docstring).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import argparse
import time

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
    make_ekf_state,
    make_ukf_state,
)
from particle_filters_jax.simulators import (
    SkewTDynConfig,
    SkewTGridConfig,
    SkewTMeasConfig,
    SkewTSimConfig,
    simulate_skewt_many,
)

p = argparse.ArgumentParser()
p.add_argument("--d", type=int, default=144, help="lattice dimension (notebook: 144 and 400)")
p.add_argument("--trials", type=int, default=10, help="MC trials (notebook: 100)")
p.add_argument("--edh-big", type=int, default=0,
               help="also run EDH with this many particles (notebook: 10000)")
args = p.parse_args()

D, TRIALS, T = args.d, args.trials, 10
M1, M2, ALPHA = 1.0, 1.0 / 3.0, 0.9

print(f"simulating skew-t sensor network: d={D}, T={T}, {TRIALS} trials...")
data = simulate_skewt_many(
    SkewTGridConfig(d=D, alpha0=1.0, alpha1=1e-3, beta=8.0),
    SkewTDynConfig(alpha=ALPHA, nu=8.0, gamma_scale=0.1, seed=42),
    SkewTMeasConfig(m1=M1, m2=M2),
    SkewTSimConfig(T=T, n_trials=TRIALS),
)
X_all = jnp.asarray(data.X)  # (TRIALS, T, d)
Z_all = jnp.asarray(data.Z, jnp.float32)
Sigma = jnp.asarray(data.Sigma)
LQ = jnp.asarray(data.L)

# Working Gaussian model (notebook cell 5, prepare_skewt_model)
h = lambda x: M1 * jnp.exp(M2 * jnp.clip(x, -10, 10))
jac_h = jax.jacfwd(h)
R = jnp.diag(h(jnp.zeros(D)))  # linearized around zero
g_kf = lambda x, u: ALPHA * x
g_flow = lambda x, u, v: ALPHA * x + v
lt = lambda xn, xo: mvn_logpdf_chol(xn, ALPHA * xo, LQ)
ns = lambda k, n, nx: jax.random.normal(k, (n, nx)) @ LQ.T


def poisson_ll(z, x):
    lam = h(x)
    return jnp.sum(z * jnp.log(lam + 1e-10) - lam)


def bench(name, fn, per_trial_args, ref=""):
    """Run fn over all trials (compile once on trial 0), report MSE ± std."""
    fn = jax.jit(fn)
    out0 = fn(*per_trial_args(0))
    jax.block_until_ready(out0)
    t0 = time.perf_counter()
    mses, esss = [], []
    for i in range(TRIALS):
        means, ess = fn(*per_trial_args(i))
        mses.append(float(jnp.mean((means - X_all[i]) ** 2)))
        if ess is not None:
            esss.append(float(jnp.mean(ess)))
    dt = (time.perf_counter() - t0) / TRIALS
    ess_s = f"ESS {np.mean(esss):7.1f}" if esss else f"ESS {'—':>7s}"
    print(
        f"  {name:14s} MSE {np.mean(mses):.4f} ± {np.std(mses):.4f}   "
        f"{ess_s}   {dt * 1e3:8.1f} ms/trial{ref}"
    )


print(f"\nfilters on the skew-t network (d={D}, {TRIALS} trials; "
      "notebook table: 100 trials):")

ekf = ExtendedKalmanFilter(g_kf, h, Sigma, R, joseph=True, jitter=1e-4)
bench(
    "EKF",
    lambda z: (ekf.run(make_ekf_state(jnp.zeros(D), Sigma), z)[1], None),
    lambda i: (Z_all[i],),
)

ukf = UnscentedKalmanFilter(g_kf, h, Sigma, R, alpha=0.5, jitter=1e-5)
bench(
    "UKF",
    lambda z: (ukf.run(make_ukf_state(jnp.zeros(D), Sigma), z)[1], None),
    lambda i: (Z_all[i],),
)

flow_specs = [("EDH-200", EDHFlowPF,
               EDHConfig(n_particles=200, n_lambda_steps=8,
                         flow_integrator="euler", resample_ess_ratio=0.5))]
if args.edh_big:
    flow_specs.append((f"EDH-{args.edh_big}", EDHFlowPF,
                       EDHConfig(n_particles=args.edh_big, n_lambda_steps=8,
                                 flow_integrator="euler", resample_ess_ratio=0.5)))
flow_specs.append(("LEDH-200", LEDHFlowPF,
                   LEDHConfig(n_particles=200, n_lambda_steps=8,
                              resample_ess_ratio=0.5)))

for name, cls, cfg in flow_specs:
    # UKF tracker, as the notebook uses (run_pf in cell 6)
    ukf_tr = UnscentedKalmanFilter(g_kf, h, Sigma, R, alpha=0.5, jitter=1e-5)
    tracker = GaussianTracker(ukf_tr)
    filt = cls(tracker, g_flow, h, jac_h, lt, poisson_ll, R, cfg)

    def run_flow(key, z, filt=filt, tracker=tracker):
        st = filt.init_from_gaussian(key, jnp.zeros(D), Sigma)
        ts = tracker.init(jnp.zeros(D), Sigma)
        _, _, hist = filt.run(
            jax.random.fold_in(key, 1), st, ts, z, process_noise_sampler=ns
        )
        return hist["mean"], hist["ess"]

    bench(name, run_flow, lambda i: (jax.random.fold_in(jax.random.PRNGKey(7), i), Z_all[i]))

print(
    "\nreference table (d=144, 100 trials, notebook cell 9):\n"
    "  EDH-200   MSE 1.0535 ± 0.3244   ESS 165.2   1.05 s/trial\n"
    "  EDH-10000 MSE 1.0427 ± 0.3134   ESS 8450.6  31.7 s/trial\n"
    "  LEDH-200  MSE 0.9695 ± 0.2804   ESS 163.1   13.2 s/trial\n"
    "its finding: LEDH's per-particle linearization beats EDH at ~13× EDH's\n"
    "cost upstream — here the vmapped Woodbury LEDH reproduces the MSE\n"
    "ordering; at d=400 pass --d 400 (reference: LEDH 0.9689 ± 0.2338)."
)
