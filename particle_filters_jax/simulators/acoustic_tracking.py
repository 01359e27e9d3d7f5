"""Multi-target acoustic tracking (MAT) simulator.

C targets with 2-D constant-velocity dynamics [x, y, vx, vy], article-exact
process noise, reflective area boundaries, and an S-sensor grid measuring
additive acoustic amplitudes Z(t, s) = Σ_c ψ / (‖p_c − r_s‖² + d₀)
(reference ``simulator/simulator_Multi_acoustic_tracking.py``).

Design: targets propagate as one batched matmul per step inside a
``lax.scan``; boundary reflection is branchless ``jnp.where`` (the reference
uses a per-target Python if-ladder, :252-268); the acoustic model is a single
broadcast reduction (:299-309 — already vectorized in the reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from particle_filters_jax.core.structs import pytree_dataclass


@dataclass(frozen=True)
class MATDynamicsConfig:
    """Reference ``DynamicsConfig`` (:30-40)."""

    dt: float = 1.0


@dataclass(frozen=True)
class MATScenarioConfig:
    """Reference ``ScenarioConfig`` (:43-73)."""

    n_targets: int = 4
    n_steps: int = 100
    area_xy: Tuple[float, float] = (40.0, 40.0)
    sensor_grid_shape: Tuple[int, int] = (5, 5)
    psi: float = 10.0
    d0: float = 0.1
    seed: int = 7
    use_article_init: bool = True


def build_cv_transition(dt: float) -> jax.Array:
    """Constant-velocity transition F for state [x, y, vx, vy] (reference :77)."""
    return jnp.array(
        [
            [1.0, 0.0, dt, 0.0],
            [0.0, 1.0, 0.0, dt],
            [0.0, 0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=jnp.float32,
    )


def article_process_noise_cov() -> jax.Array:
    """The article's fixed (4, 4) process noise covariance V (reference :104)."""
    return (1.0 / 20.0) * jnp.array(
        [
            [1.0 / 3.0, 0.0, 0.5, 0.0],
            [0.0, 1.0 / 3.0, 0.0, 0.5],
            [0.5, 0.0, 1.0, 0.0],
            [0.0, 0.5, 0.0, 1.0],
        ],
        dtype=jnp.float32,
    )


def article_initial_states(n_targets: int) -> jax.Array:
    """The article's deterministic 4-target initial states (reference :130)."""
    if n_targets != 4:
        raise ValueError("Article initial states are defined for n_targets == 4.")
    return jnp.array(
        [
            [12.0, 6.0, 0.001, 0.001],
            [32.0, 32.0, -0.001, -0.005],
            [20.0, 13.0, -0.1, 0.01],
            [15.0, 35.0, 0.002, 0.002],
        ],
        dtype=jnp.float32,
    )


def make_sensor_grid(
    area_xy: Tuple[float, float], grid_shape: Tuple[int, int]
) -> jax.Array:
    """(S, 2) sensor grid over the area, boundaries inclusive (reference :169)."""
    width, height = area_xy
    n_r, n_c = grid_shape
    xs = jnp.linspace(0.0, width, n_c)
    ys = jnp.linspace(0.0, height, n_r)
    XX, YY = jnp.meshgrid(xs, ys)
    return jnp.column_stack([XX.ravel(), YY.ravel()])


def _reflect(pos, vel, lo, hi, eps):
    """Branchless boundary reflection (reference's if-ladder :252-268)."""
    below = pos <= lo
    above = pos >= hi
    pos = jnp.where(below, -pos + eps, jnp.where(above, 2.0 * hi - pos - eps, pos))
    vel = jnp.where(below | above, -vel, vel)
    return pos, vel


def simulate_cv_targets(
    n_steps: int,
    n_targets: int,
    area_xy: Tuple[float, float],
    dyn_cfg: MATDynamicsConfig,
    key: jax.Array,
    use_article_init: bool = True,
    init_vel_std: float = 0.5,
    enforce_boundaries: bool = True,
) -> jax.Array:
    """(n_steps, n_targets, 4) CV trajectories with reflective boundaries.

    Parity with reference ``simulate_cv_targets`` (:196-271): same dynamics
    F, article process noise V, reflection-with-velocity-flip semantics and
    the strict-inequality epsilon buffer.
    """
    F = build_cv_transition(dyn_cfg.dt)
    V = article_process_noise_cov()
    L = jnp.linalg.cholesky(V + 1e-12 * jnp.eye(4))
    width, height = area_xy
    eps = 1e-6

    k_init, k_noise = jax.random.split(key)
    if use_article_init and n_targets == 4:
        x0 = article_initial_states(n_targets)
    else:
        ku = jax.random.split(k_init, 4)
        px = jax.random.uniform(ku[0], (n_targets, 1), minval=0.25 * width, maxval=0.75 * width)
        py = jax.random.uniform(ku[1], (n_targets, 1), minval=0.25 * height, maxval=0.75 * height)
        vx = init_vel_std * jax.random.normal(ku[2], (n_targets, 1))
        vy = init_vel_std * jax.random.normal(ku[3], (n_targets, 1))
        x0 = jnp.concatenate([px, py, vx, vy], axis=1)

    noise = jax.random.normal(k_noise, (n_steps - 1, n_targets, 4)) @ L.T

    def step(x, w):
        x_next = x @ F.T + w  # (n_targets, 4)
        if enforce_boundaries:
            px, vx = _reflect(x_next[:, 0], x_next[:, 2], 0.0, width, eps)
            py, vy = _reflect(x_next[:, 1], x_next[:, 3], 0.0, height, eps)
            x_next = jnp.stack([px, py, vx, vy], axis=1)
        return x_next, x_next

    _, traj = lax.scan(step, x0, noise)
    return jnp.concatenate([x0[None], traj], axis=0)


def acoustic_measurement_model(
    positions: jax.Array, sensors: jax.Array, psi: float, d0: float
) -> jax.Array:
    """Z(t, s) = Σ_c ψ / (‖p_{t,c} − r_s‖² + d₀), noiseless (reference :273).

    ``positions``: (..., C, 2); ``sensors``: (S, 2) → returns (..., S).
    Broadcast-reduction form vectorizes over time, particles, or both.
    """
    d2 = jnp.sum(
        (positions[..., :, None, :] - sensors[None, :, :]) ** 2, axis=-1
    )  # (..., C, S)
    return jnp.sum(psi / (d2 + d0), axis=-2)


@pytree_dataclass
class MATDataset:
    """X (T, C, 4); P (T, C, 2); S sensors (S, 2); Z (T, S); meta [W,H,ψ,d₀,dt].

    Same keys as the reference's returned dict
    (``simulate_acoustic_dataset`` :312-345)."""

    X: jax.Array
    P: jax.Array
    S: jax.Array
    Z: jax.Array
    meta: jax.Array

    def as_dict(self) -> Dict[str, jax.Array]:
        return {"X": self.X, "P": self.P, "S": self.S, "Z": self.Z, "meta": self.meta}

    def save_npz(self, path: str) -> None:
        np.savez_compressed(path, **{k: np.asarray(v) for k, v in self.as_dict().items()})

    @classmethod
    def load_npz(cls, path: str) -> "MATDataset":
        with np.load(path) as f:
            return cls(**{k: jnp.asarray(f[k]) for k in ("X", "P", "S", "Z", "meta")})


def simulate_acoustic_dataset(
    cfg: MATScenarioConfig, dyn_cfg: MATDynamicsConfig
) -> MATDataset:
    """Full MAT dataset; parity with reference ``simulate_acoustic_dataset`` (:312)."""
    key = jax.random.PRNGKey(cfg.seed)
    sensors = make_sensor_grid(cfg.area_xy, cfg.sensor_grid_shape)
    X = simulate_cv_targets(
        cfg.n_steps,
        cfg.n_targets,
        cfg.area_xy,
        dyn_cfg,
        key,
        use_article_init=cfg.use_article_init,
    )
    P = X[..., :2]
    Z = acoustic_measurement_model(P, sensors, psi=cfg.psi, d0=cfg.d0)
    meta = jnp.array(
        [cfg.area_xy[0], cfg.area_xy[1], cfg.psi, cfg.d0, dyn_cfg.dt],
        dtype=jnp.float32,
    )
    return MATDataset(X=X, P=P, S=sensors, Z=Z, meta=meta)
