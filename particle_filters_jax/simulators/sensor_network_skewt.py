"""Skew-t dynamics sensor network with Poisson count measurements.

Model (reference ``simulator/simulator_sensor_network_skewt_dynamic.py``):

    W_k ~ InvGamma(ν/2, ν/2)
    x_k = α x_{k−1} + W_k γ + √W_k · L z_k,   z_k ~ N(0, I),  Σ = L Lᵀ spatial SE kernel
    λ_k = m₁ exp(m₂ · clip(x_k)),  z-counts ~ Poisson(λ_k)

Design: InvGamma via ``1/jax.random.gamma``, Poisson via
``jax.random.poisson``; the T-step recursion is one ``lax.scan``; multiple
trials vectorize under ``vmap`` with ``fold_in`` per-trial keys (the
reference offsets integer seeds per trial, ``simulate_many`` :343-345).
"""

from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from particle_filters_jax.core.linalg import chol_with_jitter
from particle_filters_jax.core.structs import pytree_dataclass, static_field


@dataclass(frozen=True)
class SkewTGridConfig:
    """Reference ``GridConfig`` (:29-47)."""

    d: int = 144
    alpha0: float = 1.0
    alpha1: float = 1e-3
    beta: float = 8.0


@dataclass(frozen=True)
class SkewTDynConfig:
    """Reference ``DynConfig`` (:50-74)."""

    alpha: float = 0.9
    nu: float = 8.0
    gamma_scale: float = 0.1
    gamma_vec: Optional[Any] = None
    clip_x: Optional[Tuple[float, float]] = (-10.0, 10.0)
    chol_jitter: float = 1e-8
    seed: Optional[int] = 123


@dataclass(frozen=True)
class SkewTMeasConfig:
    """Reference ``MeasConfig`` (:77-88)."""

    m1: float = 1.0
    m2: float = 1.0 / 3.0


@dataclass(frozen=True)
class SkewTSimConfig:
    """Reference ``SimConfig`` (:91-105)."""

    T: int = 10
    n_trials: int = 1
    save_lambda: bool = True


def make_lattice(d: int) -> jax.Array:
    """(d, 2) sensor lattice, 'xy' meshgrid ordering (reference :113)."""
    s = int(np.sqrt(d))
    if s * s != d:
        raise ValueError(f"d={d} is not a perfect square; got sqrt={s}.")
    xs, ys = jnp.meshgrid(jnp.arange(s), jnp.arange(s), indexing="xy")
    return jnp.stack([xs.ravel(), ys.ravel()], axis=1).astype(jnp.float32)


def build_spatial_cov(
    R: jax.Array, alpha0: float, alpha1: float, beta: float
) -> jax.Array:
    """Σ_ij = α₀ exp(−‖Rᵢ−Rⱼ‖²/β) + α₁ δᵢⱼ (reference :128)."""
    diffs = R[:, None, :] - R[None, :, :]
    dist2 = jnp.sum(diffs * diffs, axis=-1)
    K = alpha0 * jnp.exp(-dist2 / beta)
    return K + alpha1 * jnp.eye(R.shape[0], dtype=K.dtype)


def sample_inverse_gamma(key, shape_p: float, scale_p: float, shape=()) -> jax.Array:
    """W ~ InvGamma(shape_p, scale_p) via 1 / Gamma(shape_p, rate=scale_p).

    Reference :188 uses ``1 / rng.gamma(shape, scale=1/scale_p)``;
    ``jax.random.gamma`` is standard (rate 1), so divide by the rate.
    """
    g = jax.random.gamma(key, shape_p, shape=shape) / scale_p
    return 1.0 / g


def prepare_gamma_vector(
    key, d: int, gamma_scale: float, gamma_vec: Optional[Any]
) -> jax.Array:
    """Skew vector γ: explicit, or a random unit vector scaled by γ_scale
    (reference :214)."""
    if gamma_vec is not None:
        g = jnp.asarray(gamma_vec).reshape(-1)
        if g.shape[0] != d:
            raise ValueError(f"gamma_vec shape {g.shape} incompatible with d={d}")
        return g
    v = jax.random.normal(key, (d,))
    return gamma_scale * v / (jnp.linalg.norm(v) + 1e-12)


@pytree_dataclass
class SkewTTrialResult:
    """One trial (or stacked trials): X latent, Z counts, Λ rates, geometry.

    Same keys as the dict returned by reference ``simulate_trial`` (:232)."""

    X: jax.Array  # (T, d) or (n_trials, T, d)
    Z: jax.Array  # same leading shape, int counts
    Lambda: Optional[jax.Array]
    Sigma: jax.Array
    L: jax.Array
    R: jax.Array
    gamma: jax.Array
    meta: Dict[str, Any] = static_field(default=None)

    def as_dict(self) -> Dict[str, Any]:
        out = {
            "X": self.X,
            "Z": self.Z,
            "Sigma": self.Sigma,
            "L": self.L,
            "R": self.R,
            "gamma": self.gamma,
            "meta": self.meta,
        }
        if self.Lambda is not None:
            out["Lambda"] = self.Lambda
        return out


def _scan_trial(key, L, gamma, dyn: SkewTDynConfig, meas: SkewTMeasConfig, T: int, d: int):
    """lax.scan body for one trial: draw (W, z, poisson) per step."""
    shape_p = dyn.nu / 2.0

    def step(x, k):
        kw, kz, kp = jax.random.split(k, 3)
        W = sample_inverse_gamma(kw, shape_p, shape_p)
        z = jax.random.normal(kz, (d,))
        x_next = dyn.alpha * x + W * gamma + jnp.sqrt(W) * (L @ z)
        x_eff = x_next
        if dyn.clip_x is not None:
            x_eff = jnp.clip(x_eff, dyn.clip_x[0], dyn.clip_x[1])
        lam = meas.m1 * jnp.exp(meas.m2 * x_eff)
        counts = jax.random.poisson(kp, lam)
        return x_next, (x_next, counts, lam)

    keys = jax.random.split(key, T)
    x0 = jnp.zeros((d,), L.dtype)
    _, (X, Z, Lam) = lax.scan(step, x0, keys)
    return X, Z, Lam


def simulate_skewt_trial(
    grid_cfg: SkewTGridConfig,
    dyn_cfg: SkewTDynConfig,
    meas_cfg: SkewTMeasConfig,
    sim_cfg: SkewTSimConfig,
) -> SkewTTrialResult:
    """Single-trial simulation; parity with reference ``simulate_trial`` (:232)."""
    key = jax.random.PRNGKey(0 if dyn_cfg.seed is None else int(dyn_cfg.seed))
    kg, ks = jax.random.split(key)

    R = make_lattice(grid_cfg.d)
    Sigma = build_spatial_cov(R, grid_cfg.alpha0, grid_cfg.alpha1, grid_cfg.beta)
    L = chol_with_jitter(Sigma, jitter=dyn_cfg.chol_jitter)
    gamma = prepare_gamma_vector(kg, grid_cfg.d, dyn_cfg.gamma_scale, dyn_cfg.gamma_vec)

    X, Z, Lam = _scan_trial(ks, L, gamma, dyn_cfg, meas_cfg, sim_cfg.T, grid_cfg.d)
    meta = {
        "grid_cfg": asdict(grid_cfg),
        "dyn_cfg": {
            **{k: v for k, v in asdict(dyn_cfg).items() if k != "gamma_vec"},
            "gamma_vec": "provided" if dyn_cfg.gamma_vec is not None else None,
        },
        "meas_cfg": asdict(meas_cfg),
        "sim_cfg": asdict(sim_cfg),
    }
    return SkewTTrialResult(
        X=X,
        Z=Z,
        Lambda=Lam if sim_cfg.save_lambda else None,
        Sigma=Sigma,
        L=L,
        R=R,
        gamma=gamma,
        meta=meta,
    )


def simulate_skewt_many(
    grid_cfg: SkewTGridConfig,
    dyn_cfg: SkewTDynConfig,
    meas_cfg: SkewTMeasConfig,
    sim_cfg: SkewTSimConfig,
) -> SkewTTrialResult:
    """Stacked multi-trial simulation (reference ``simulate_many`` :320).

    Trials vectorize under ``vmap``; trial i's key is ``fold_in(base, i)``
    (the moral equivalent of the reference's ``seed + i`` offsets).
    Geometry (Σ, L, γ) is shared across trials, as in the reference where
    each per-trial Σ is identical.
    """
    base = jax.random.PRNGKey(0 if dyn_cfg.seed is None else int(dyn_cfg.seed))
    kg, _ = jax.random.split(base)

    R = make_lattice(grid_cfg.d)
    Sigma = build_spatial_cov(R, grid_cfg.alpha0, grid_cfg.alpha1, grid_cfg.beta)
    L = chol_with_jitter(Sigma, jitter=dyn_cfg.chol_jitter)
    gamma = prepare_gamma_vector(kg, grid_cfg.d, dyn_cfg.gamma_scale, dyn_cfg.gamma_vec)

    trial_keys = jax.vmap(lambda i: jax.random.fold_in(base, i))(
        jnp.arange(sim_cfg.n_trials)
    )
    X, Z, Lam = jax.vmap(
        lambda k: _scan_trial(k, L, gamma, dyn_cfg, meas_cfg, sim_cfg.T, grid_cfg.d)
    )(trial_keys)

    meta = {
        "grid_cfg": asdict(grid_cfg),
        "dyn_cfg": {
            **{k: v for k, v in asdict(dyn_cfg).items() if k != "gamma_vec"},
            "gamma_vec": "provided" if dyn_cfg.gamma_vec is not None else None,
        },
        "meas_cfg": asdict(meas_cfg),
        "sim_cfg": asdict(sim_cfg),
    }
    return SkewTTrialResult(
        X=X,
        Z=Z,
        Lambda=Lam if sim_cfg.save_lambda else None,
        Sigma=Sigma,
        L=L,
        R=R,
        gamma=gamma,
        meta=meta,
    )


def save_npz(path: str, result: SkewTTrialResult) -> None:
    """Persist to compressed npz (reference ``save_npz`` :363)."""
    data = {
        k: np.asarray(v)
        for k, v in result.as_dict().items()
        if k != "meta" and v is not None
    }
    np.savez_compressed(path, **data)


def load_npz(path: str) -> Dict[str, Any]:
    with np.load(path, allow_pickle=True) as f:
        return {k: f[k] for k in f.files}
