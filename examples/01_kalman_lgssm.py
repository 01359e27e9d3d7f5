#!/usr/bin/env python
"""Kalman filtering of a simulated LGSSM: NEES consistency, RMSE, coverage.

Script equivalent of reference ``notebooks/kalman_filter_LGSSM.ipynb``
(reported there: mean NEES 2.189, 10-seed MC RMSE 0.1915, Joseph == standard).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from particle_filters_jax.models import kalman_filter_general
from particle_filters_jax.simulators import simulate_lgssm
from particle_filters_jax.utils import coverage_95, nees, rmse

# README §4 system of the reference
A = np.array([[0.9, 0.5], [0.0, 0.7]], np.float32)
B = np.diag([np.sqrt(0.05), np.sqrt(0.02)]).astype(np.float32)
C = np.eye(2, dtype=np.float32)
D = (np.sqrt(0.1) * np.eye(2)).astype(np.float32)
Sigma = np.eye(2, dtype=np.float32)
Q, R = B @ B.T, D @ D.T

rmses, neeses, covs = [], [], []
for seed in [42, 7, 123, 2024, 9999, 1, 2, 3, 4, 5]:
    data = simulate_lgssm(A, B, C, D, Sigma, 1000, seed=seed)
    res = kalman_filter_general(
        data.Y, A, C, np.eye(2, dtype=np.float32), Q, R,
        x0=np.zeros(2, np.float32), P0=Sigma, use_joseph=True,
    )
    rmses.append(float(rmse(res.x_filt, data.X)))
    neeses.append(float(jnp.mean(nees(res.x_filt, res.P_filt, data.X))))
    covs.append(float(coverage_95(res.x_filt, res.P_filt, data.X)))

print(f"10-seed Monte Carlo (T=1000, nx=2):")
print(f"  RMSE      : {np.mean(rmses):.4f}  (reference: 0.1915)")
print(f"  mean NEES : {np.mean(neeses):.3f}   (expected ≈ 2.0; reference: 2.189)")
print(f"  95% cover : {np.mean(covs)*100:.1f}%  (reference: 93.5%)")

# ---- figure: NEES consistency + coverage panel (seed 42) --------------------
# (the reference notebook's cell-6/cell-12 figures, as one committed PNG)
from scipy.stats import chi2  # noqa: E402

import figstyle  # noqa: E402

data = simulate_lgssm(A, B, C, D, Sigma, 1000, seed=42)
res = kalman_filter_general(
    data.Y, A, C, np.eye(2, dtype=np.float32), Q, R,
    x0=np.zeros(2, np.float32), P0=Sigma, use_joseph=True,
)
nees_t = np.asarray(nees(res.x_filt, res.P_filt, data.X))

plt = figstyle.get_pyplot()
fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(7.2, 4.6))

lo, hi = chi2.ppf(0.025, df=2), chi2.ppf(0.975, df=2)
ax1.axhspan(lo, hi, color="#eeeeee", zorder=0)
ax1.plot(nees_t, color=figstyle.BLUE, lw=0.7)
ax1.axhline(2.0, color=figstyle.GRAY, lw=1.0, ls="--")
ax1.set_ylabel("NEES")
ax1.set_ylim(0, 12)
ax1.set_title(
    f"KF on LGSSM, seed 42 — per-step NEES "
    f"(mean {nees_t.mean():.2f}, expected 2.0; band = 95% χ²₂)",
    fontsize=9, loc="left",
)

t = np.arange(200)
mu = np.asarray(res.x_filt[:200, 0])
sd = np.sqrt(np.asarray(res.P_filt[:200, 0, 0]))
ax2.fill_between(t, mu - 1.96 * sd, mu + 1.96 * sd,
                 color=figstyle.BLUE, alpha=0.18, lw=0)
ax2.plot(t, mu, color=figstyle.BLUE, lw=1.1, label="KF mean ± 95% CI")
ax2.plot(t, np.asarray(data.X[:200, 0]), color=figstyle.VERMILLION,
         lw=0.9, ls=":", label="truth")
ax2.set_xlabel("time step")
ax2.set_ylabel("$x_1$")
ax2.legend(loc="upper right", ncol=2)
path = figstyle.save(fig, "01_kalman_nees_coverage.png")
print(f"  figure    : {os.path.relpath(path)}")
