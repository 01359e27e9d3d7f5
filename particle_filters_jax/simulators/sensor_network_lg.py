"""Linear-Gaussian spatial sensor-network (SNLG / LSSN) simulator.

Model (reference ``simulator/simulator_sensor_network_linear_gaussian.py``):

    x_t = α x_{t−1} + v_t,   v_t ~ N(0, Σ),  Σ_ij = α₀ exp(−‖rᵢ−rⱼ‖²/β) + α₁ δᵢⱼ
    z_t = x_t + w_t,         w_t ~ N(0, σ_z² I)

over an n×n grid (d = n²), for S noise levels × R trials × T steps.

Design: the (S, R) replication axes vectorize under ``vmap`` with
per-trial ``fold_in`` keys; the time recursion is one ``lax.scan`` whose body
is a rank-d matvec through the pre-factored Cholesky, replacing
the reference's triple Python loop (``simulate_dataset`` :159-205).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from particle_filters_jax.core.linalg import chol_with_jitter
from particle_filters_jax.core.structs import pytree_dataclass, static_field


@dataclass(frozen=True)
class SNLGConfig:
    """Validated config; parity with reference ``SimConfig``
    (``simulator_sensor_network_linear_gaussian.py:23-70``) including the
    ``__post_init__`` checks."""

    d: int = 64
    alpha: float = 0.9
    alpha0: float = 3.0
    alpha1: float = 0.01
    beta: float = 20.0
    T: int = 10
    trials: int = 100
    sigmas: Tuple[float, ...] = (2.0, 1.0, 0.5)
    seed: int = 123

    def __post_init__(self) -> None:
        n = int(round(self.d**0.5))
        if n * n != self.d:
            raise ValueError("d must be a perfect square (e.g., 64 = 8×8).")
        if self.T <= 0 or self.trials <= 0:
            raise ValueError("T and trials must be positive integers.")
        if any(s <= 0 for s in self.sigmas):
            raise ValueError("All observation std deviations must be positive.")
        if self.alpha1 < 0:
            raise ValueError("alpha1 (nugget) must be nonnegative.")
        if self.beta <= 0:
            raise ValueError("beta must be positive.")


def make_grid_coords(d: int) -> jax.Array:
    """(d, 2) row-major integer grid coordinates (reference :74)."""
    n = int(np.sqrt(d))
    xs, ys = jnp.meshgrid(jnp.arange(n), jnp.arange(n), indexing="ij")
    return jnp.stack([xs.ravel(), ys.ravel()], axis=1).astype(jnp.float32)


def se_kernel_cov(
    coords: jax.Array, alpha0: float, beta: float, alpha1: float
) -> jax.Array:
    """Σ_ij = α₀ exp(−‖rᵢ−rⱼ‖²/β) + α₁ δᵢⱼ (reference :97)."""
    diff = coords[:, None, :] - coords[None, :, :]
    dist2 = jnp.sum(diff * diff, axis=-1)
    K = alpha0 * jnp.exp(-dist2 / beta)
    K = K + alpha1 * jnp.eye(coords.shape[0], dtype=K.dtype)
    return 0.5 * (K + K.T)


@pytree_dataclass
class SNLGDataset:
    """X (S, R, T+1, d); Z (S, R, T, d); grid coords; process covariance Σ."""

    X: jax.Array
    Z: jax.Array
    coords: jax.Array
    Sigma: jax.Array
    config: SNLGConfig = static_field(default=None)

    def save_npz(self, path: str) -> None:
        """Same key layout as reference ``save_npz`` (:208-245)."""
        cfg = self.config
        np.savez_compressed(
            path,
            X=np.asarray(self.X),
            Z=np.asarray(self.Z),
            coords=np.asarray(self.coords),
            Sigma=np.asarray(self.Sigma),
            sigmas=np.array(cfg.sigmas, dtype=np.float64),
            alpha=np.array([cfg.alpha], dtype=np.float64),
            T=np.array([cfg.T], dtype=np.int32),
            trials=np.array([cfg.trials], dtype=np.int32),
            d=np.array([cfg.d], dtype=np.int32),
            seed=np.array([cfg.seed], dtype=np.int64),
        )

    def dump_config_json(self, path: str) -> None:
        """Reference ``dump_config_json`` (:248-257)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(asdict(self.config), f, indent=2)

    @classmethod
    def load_npz(cls, path: str) -> "SNLGDataset":
        with np.load(path) as f:
            cfg = SNLGConfig(
                d=int(f["d"][0]),
                alpha=float(f["alpha"][0]),
                T=int(f["T"][0]),
                trials=int(f["trials"][0]),
                sigmas=tuple(float(s) for s in f["sigmas"]),
                seed=int(f["seed"][0]),
            )
            return cls(
                X=jnp.asarray(f["X"]),
                Z=jnp.asarray(f["Z"]),
                coords=jnp.asarray(f["coords"]),
                Sigma=jnp.asarray(f["Sigma"]),
                config=cfg,
            )


def _simulate_one_trial(key, L, alpha, sigma_z, T, d, dtype):
    """One (trial, noise level): scan over T with pre-drawn noise."""
    kv, kw = jax.random.split(key)
    V = jax.random.normal(kv, (T, d), dtype) @ L.T  # correlated process noise
    W = sigma_z * jax.random.normal(kw, (T, d), dtype)

    def step(x, inputs):
        v, w = inputs
        x_next = alpha * x + v
        z = x_next + w
        return x_next, (x_next, z)

    x0 = jnp.zeros((d,), dtype)
    _, (Xs, Zs) = lax.scan(step, x0, (V, W))
    X = jnp.concatenate([x0[None], Xs], axis=0)  # (T+1, d) incl. x0
    return X, Zs


def simulate_snlg_dataset(cfg: SNLGConfig, dtype=jnp.float32) -> SNLGDataset:
    """Simulate all (S noise levels × R trials); parity with reference
    ``simulate_dataset`` (:159) — returns X (S,R,T+1,d), Z (S,R,T,d).

    The reference draws all trials from one serial RNG stream; here each
    (s, r) cell gets an independent key via ``fold_in`` so the whole dataset
    is one vmapped, jittable computation.
    """
    coords = make_grid_coords(cfg.d)
    Sigma = se_kernel_cov(coords, cfg.alpha0, cfg.beta, cfg.alpha1)
    L = chol_with_jitter(Sigma.astype(dtype))

    base = jax.random.PRNGKey(cfg.seed)
    sigmas = jnp.asarray(cfg.sigmas, dtype)
    S, R = len(cfg.sigmas), cfg.trials
    cell = jnp.arange(S * R).reshape(S, R)
    keys = jax.vmap(jax.vmap(lambda i: jax.random.fold_in(base, i)))(cell)

    sim = lambda key, sz: _simulate_one_trial(
        key, L, cfg.alpha, sz, cfg.T, cfg.d, dtype
    )
    sim_trials = jax.vmap(sim, in_axes=(0, None))  # over R
    sim_all = jax.vmap(sim_trials, in_axes=(0, 0))  # over S
    X, Z = sim_all(keys, sigmas)
    return SNLGDataset(X=X, Z=Z, coords=coords, Sigma=Sigma, config=cfg)
