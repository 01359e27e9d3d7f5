#!/usr/bin/env python
"""Particle-degeneracy analysis of the SIR PF on the stochastic-volatility model.

Script equivalent of reference ``notebooks/particle_filter_NLNGSSM.ipynb``:
instrument the filter with the phase-1 degeneracy panel (ESS, normalized
weight entropy, Gini coefficient, max weight, post-resample unique-particle
fraction, resample events), then run the notebook's phase-4 comparative
experiments —

  * experiment 1: vary the particle count Np,
  * experiment 2: vary the resample threshold and method,
  * experiment 3: robustness over random seeds (vmapped here, not a loop),
  * experiment 4: boundary cases (threshold 0 = never resample in practice,
    threshold 1 = always resample).

Differences from the notebook: the per-step metrics are computed
inside the single ``lax.scan`` (``ParticleFilter.run(track_degeneracy=True)``),
and the seed-robustness study is one ``vmap`` over keys instead of a Python
loop.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from particle_filters_jax.models import ParticleFilter
from particle_filters_jax.simulators import simulate_sv_1d
from particle_filters_jax.utils import rmse

N_STEPS, ALPHA, SIGMA, BETA = 2000, 0.91, 1.0, 0.5
sv = simulate_sv_1d(N_STEPS, ALPHA, SIGMA, BETA, seed=123)
ys = sv.Y[:, None]

g = lambda x, u: ALPHA * x
Q = jnp.array([[SIGMA**2]])
P0 = jnp.array([[SIGMA**2 / (1 - ALPHA**2)]])


def obs_ll(x, z):
    var = BETA**2 * jnp.exp(x[0])
    return -0.5 * (z[0] ** 2 / var + jnp.log(var))


def run_pf(key, Np, thresh=0.5, method="systematic", regularize=True):
    pf = ParticleFilter(
        g, None, Q, None, Np=Np, obs_loglik=obs_ll,
        resample_thresh=thresh, resample_method=method,
        regularize_after_resample=regularize,
    )
    k0, k1 = jax.random.split(key)
    st = pf.initialize(k0, jnp.zeros(1), P0)
    _, hist = pf.run(k1, st, ys, track_degeneracy=True)
    return hist


# ---- Phase 1+2: baseline run with the full degeneracy panel ----------------
hist = jax.jit(lambda k: run_pf(k, 1000))(jax.random.PRNGKey(1))
print("baseline (Np=1000, thresh=0.5, systematic, regularized):")
print(f"  RMSE            {float(rmse(hist['mean'][:, 0], sv.X)):.4f}")
print(f"  ESS mean/min    {float(hist['ess'].mean()):.1f} / {float(hist['ess'].min()):.1f}")
print(f"  entropy mean    {float(hist['entropy'].mean()):.4f}  (1 = uniform)")
print(f"  gini mean/max   {float(hist['gini'].mean()):.4f} / {float(hist['gini'].max()):.4f}")
print(f"  max-w mean/max  {float(hist['max_weight'].mean()):.4f} / {float(hist['max_weight'].max()):.4f}")
print(f"  resample rate   {float(hist['resampled'].mean()) * 100:.1f}%")
ru = hist["unique_frac"][hist["resampled"]]
print(f"  unique frac after resample: mean {float(ru.mean()):.3f}, min {float(ru.min()):.3f}")

# ---- figure: the phase-1 degeneracy panel (first 400 steps) -----------------
import figstyle  # noqa: E402

W = 400
plt = figstyle.get_pyplot()
fig, axes = plt.subplots(3, 1, figsize=(7.2, 5.4), sharex=True)
t = np.arange(W)
ess = np.asarray(hist["ess"][:W]) / 1000.0
ent = np.asarray(hist["entropy"][:W])
mw = np.asarray(hist["max_weight"][:W])
res_ev = np.asarray(hist["resampled"][:W])
uf = np.asarray(hist["unique_frac"][:W])

axes[0].plot(t, ess, color=figstyle.BLUE, lw=0.9, label="ESS / Np")
axes[0].axhline(0.5, color=figstyle.GRAY, lw=1.0, ls="--")
axes[0].set_ylabel("ESS / Np")
axes[0].set_ylim(0, 1.02)
axes[0].set_title(
    "SIR PF degeneracy panel — SV model, Np=1000, thresh=0.5 "
    "(dashed = resample trigger)",
    fontsize=9, loc="left",
)

axes[1].plot(t, ent, color=figstyle.GREEN, lw=0.9, label="weight entropy")
axes[1].plot(t, mw, color=figstyle.VERMILLION, lw=0.9, ls="--",
             label="max weight")
axes[1].set_ylabel("entropy / max-w")
axes[1].set_ylim(0, 1.02)
axes[1].legend(loc="center right", ncol=2)

ev = np.where(res_ev)[0]
axes[2].vlines(ev, 0, 1, color="#dddddd", lw=0.7, zorder=0)
axes[2].scatter(ev, uf[ev], s=7, color=figstyle.BLUE, zorder=2,
                label="unique frac after resample")
axes[2].set_ylabel("unique frac")
axes[2].set_xlabel("time step")
axes[2].set_ylim(0, 1.02)
axes[2].legend(loc="lower right")
path = figstyle.save(fig, "15_degeneracy_panel.png")
print(f"  figure: {os.path.relpath(path)}")

# ---- Experiment 1: particle count sweep -------------------------------------
print("\nexperiment 1 — particle count (thresh=0.5):")
print(f"  {'Np':>6s} {'RMSE':>8s} {'ESS/Np':>8s} {'resample%':>10s} {'unique':>8s}")
for Np in (100, 500, 1000, 2000, 5000):
    h = jax.jit(lambda k: run_pf(k, Np))(jax.random.PRNGKey(2))
    uf = h["unique_frac"][h["resampled"]]
    print(
        f"  {Np:6d} {float(rmse(h['mean'][:, 0], sv.X)):8.4f} "
        f"{float(h['ess'].mean()) / Np:8.3f} "
        f"{float(h['resampled'].mean()) * 100:9.1f}% "
        f"{float(uf.mean()):8.3f}"
    )

# ---- Experiment 2: resample threshold and method ----------------------------
print("\nexperiment 2 — resample threshold × method (Np=1000):")
print(f"  {'thresh':>7s} {'method':>12s} {'RMSE':>8s} {'resample%':>10s} {'ESS mean':>9s}")
for thresh in (0.3, 0.5, 0.7):
    for method in ("systematic", "stratified", "multinomial"):
        h = jax.jit(lambda k: run_pf(k, 1000, thresh, method))(jax.random.PRNGKey(3))
        print(
            f"  {thresh:7.1f} {method:>12s} "
            f"{float(rmse(h['mean'][:, 0], sv.X)):8.4f} "
            f"{float(h['resampled'].mean()) * 100:9.1f}% "
            f"{float(h['ess'].mean()):9.1f}"
        )

# ---- Experiment 3: seed robustness (one vmap, not a loop) --------------------
keys = jax.random.split(jax.random.PRNGKey(10), 16)
hists = jax.jit(jax.vmap(lambda k: run_pf(k, 1000)))(keys)
rmses = jnp.sqrt(jnp.mean((hists["mean"][:, :, 0] - sv.X[None]) ** 2, axis=1))
print(
    f"\nexperiment 3 — 16 seeds (vmapped): RMSE "
    f"{float(rmses.mean()):.4f} ± {float(rmses.std()):.4f} "
    f"(notebook: stable, ~2% variation)"
)

# ---- Experiment 4: boundary cases --------------------------------------------
print("\nexperiment 4 — boundary thresholds (Np=1000):")
for thresh, label in ((1e-9, "never resample"), (1.0 + 1e-9, "always resample")):
    h = jax.jit(lambda k: run_pf(k, 1000, thresh))(jax.random.PRNGKey(4))
    print(
        f"  {label:16s} RMSE {float(rmse(h['mean'][:, 0], sv.X)):8.4f}   "
        f"ESS min {float(h['ess'].min()):8.1f}   "
        f"resample {float(h['resampled'].mean()) * 100:5.1f}%"
    )
