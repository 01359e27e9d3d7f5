#!/usr/bin/env python
"""Kernel-PF experiments on Lorenz-96: scalar vs matrix (diagonal) kernels.

Script equivalent of reference ``notebooks/kernel_PF_experiments.ipynb``:

  * simulate Lorenz-96 at nx = 1000 with a 20-member ensemble, observing
    every 4th variable every 20 steps (obs_error_std = 1, seed = 42),
  * take the prior ensemble at the FIRST assimilation time (obs index 1),
  * compute a stochastic (perturbed-observation) EnKF posterior as the
    reference answer,
  * run the kernel particle flow twice from the same prior — once with the
    scalar RBF kernel (fixed lengthscale 1.0, the configuration the notebook
    shows collapsing), once with the diagonal matrix-valued kernel
    (per-dimension std lengthscales),
  * report the notebook's two tables: the 2-D marginal [x19 (unobserved),
    x20 (observed)] posterior-covariance traces vs EnKF, and the
    observed/unobserved variance-reduction analysis ("matrix-valued kernels
    prevent collapse").

Differences from the notebook: the EnKF member update is one ``vmap`` (the notebook
loops over members), and the KPF pseudo-time loop is the library's
``lax.while_loop`` with simultaneous (Jacobi) particle updates rather than
the notebook's randomized Gauss-Seidel sweep.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from particle_filters_jax.models.kernel_particle_filter import (
    KernelParticleFilter,
    KPFConfig,
    Model,
)
from particle_filters_jax.simulators import simulate_lorenz96

# ---- simulation (reference cell 2) ------------------------------------------
print("Simulating Lorenz-96 (nx=1000, Np=20)...")
result = simulate_lorenz96(
    nx=1000, F=8.0, dt=0.01, spinup_steps=1000, total_steps=1500,
    Np=20, obs_interval=20, obs_fraction=4, obs_error_std=1.0, seed=42,
)
nx = result.config["nx"]

# First assimilation update (reference cell 4)
obs_idx = 1
t_first = int(result.obs_times[obs_idx])
y_first = result.observations[obs_idx]
X_prior = result.ensemble_traj[:, t_first, :]  # (Np, nx)
H_idx = result.H_idx
R = result.R
VARS = (19, 20)  # [unobserved, observed] marginal the notebook plots

print(f"analysis at t = {t_first} (time {t_first * result.config['dt']:.2f}); "
      f"prior ensemble {X_prior.shape}, {y_first.shape[0]} observations")


# ---- stochastic EnKF reference (reference cell 5) ----------------------------
def enkf_update(key, X, y, H_idx, R):
    """Perturbed-observation EnKF; the member loop is a vmap."""
    Np, nx = X.shape
    ny = H_idx.shape[0]
    mu = jnp.mean(X, axis=0)
    A = X - mu
    P = (A.T @ A) / (Np - 1)
    HP = jnp.take(P, H_idx, axis=0)  # (ny, nx) = H P
    S = jnp.take(HP, H_idx, axis=1) + R  # (ny, ny)
    K = jnp.linalg.solve(S, HP).T  # (nx, ny) = P Hᵀ S⁻¹
    LR = jnp.linalg.cholesky(R)
    pert = jax.random.normal(key, (Np, ny)) @ LR.T

    def member(x, e):
        return x + K @ (y + e - jnp.take(x, H_idx))

    X_post = jax.vmap(member)(X, pert)
    # analytic posterior covariance (I − KH)P for comparison
    P_analytic = P - K @ HP
    return X_post, P_analytic


X_enkf, P_enkf_analytic = jax.jit(enkf_update, static_argnames=())(
    jax.random.PRNGKey(999), X_prior, y_first, H_idx, R
)


def ens_cov_2d(X, idx=VARS):
    A = X - jnp.mean(X, axis=0)
    P = (A.T @ A) / (X.shape[0] - 1)
    return P[jnp.ix_(jnp.array(idx), jnp.array(idx))]


P_enkf_2d = ens_cov_2d(X_enkf)
print(f"\nEnKF posterior: ensemble mean diag {float(jnp.var(X_enkf, axis=0).mean()):.4f}, "
      f"analytic mean diag {float(jnp.diag(P_enkf_analytic).mean()):.4f}")

# ---- kernel PFs (reference cell 6) -------------------------------------------
obs_model = Model(
    H=lambda x: jnp.take(x, H_idx),
    JH=lambda x: jnp.zeros((H_idx.shape[0], nx)).at[
        jnp.arange(H_idx.shape[0]), H_idx
    ].set(1.0),
    R=R,
)
CONFIGS = {
    "scalar (full matrix)": KPFConfig(
        ds_init=0.2, ds_min=1e-3, c_move_max=2.0, min_steps=5, max_steps=100,
        kernel_type="scalar", lengthscale_mode="fixed", fixed_lengthscale=1.0,
        localization_radius=np.inf, reg=1e-6,
    ),
    "diagonal (matrix)": KPFConfig(
        ds_init=0.2, ds_min=1e-3, c_move_max=2.0, min_steps=5, max_steps=100,
        kernel_type="diagonal", lengthscale_mode="std",
        localization_radius=np.inf, reg=1e-6,
    ),
}
posteriors = {}
for name, cfg in CONFIGS.items():
    kpf = KernelParticleFilter(obs_model, cfg)
    st = jax.jit(kpf.analyze)(X_prior, y_first)
    posteriors[name] = st.particles
    print(f"{name:22s} converged: s = {float(st.s):.3f} in {int(st.steps)} steps")

# ---- table 1: 2-D marginal covariance traces (reference cell 6 tail) ---------
print(f"\nposterior covariance trace of the (x[{VARS[0]}] unobs, x[{VARS[1]}] obs) marginal:")
tr_enkf = float(jnp.trace(P_enkf_2d))
print(f"  {'EnKF':22s} {tr_enkf:8.4f}   (reference answer)")
for name, Xp in posteriors.items():
    tr = float(jnp.trace(ens_cov_2d(Xp)))
    print(f"  {name:22s} {tr:8.4f}   ({tr / tr_enkf:.2f}x EnKF)")

# ---- table 2: variance reduction, observed vs unobserved (reference cell 10) -
unobs_idx = jnp.asarray(np.setdiff1d(np.arange(nx), np.asarray(H_idx)))
prior_var = jnp.var(X_prior, axis=0)


def reduction(X):
    v = jnp.var(X, axis=0)
    obs = float(jnp.mean(jnp.take(v, H_idx)))
    unobs = float(jnp.mean(jnp.take(v, unobs_idx)))
    return obs, unobs


obs_p, unobs_p = reduction(X_prior)
print("\nvariance analysis (observed = every 4th of 1000 dims):")
print(f"  {'method':22s} {'obs var':>9s} {'unobs var':>10s} {'obs red%':>9s} {'unobs red%':>11s}")
print(f"  {'prior':22s} {obs_p:9.4f} {unobs_p:10.4f} {'—':>9s} {'—':>11s}")
for name, X in [("EnKF", X_enkf)] + list(posteriors.items()):
    o, u = reduction(X)
    print(
        f"  {name:22s} {o:9.4f} {u:10.4f} "
        f"{100 * (1 - o / obs_p):8.2f}% {100 * (1 - u / unobs_p):10.2f}%"
    )
print(
    "\nreference notebook (cell 10): EnKF 97.68/97.53%, diagonal kernel\n"
    "88.96/89.03%, scalar kernel 1.17/0.71% — its key finding: the diagonal\n"
    "(matrix-valued) kernel reduces variance in BOTH observed and unobserved\n"
    "dimensions while the fixed-lengthscale scalar kernel FAILS. Here the\n"
    "EnKF and diagonal-kernel numbers match the notebook to ~1%; the scalar\n"
    "kernel fails in the other direction (variance inflation) because the\n"
    "simultaneous Jacobi update overshoots where the notebook's random-order\n"
    "Gauss-Seidel sweep stalls — both conclude 'scalar kernel cannot track\n"
    "the posterior', the notebook's point."
)
