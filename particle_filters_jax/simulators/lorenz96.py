"""Lorenz-96 chaotic dynamics simulator with sparse observations.

Capability parity with reference ``simulator/simulator_Lorenz_96.py``:
RK4-integrated L96 dynamics (:35-85), spin-up, perturbed ensemble, sparse
linear observations every ``obs_interval`` steps on every ``obs_fraction``-th
variable, npz + JSON persistence (:215-295), RMSE / spread utilities
(:440-475).

Design: ``l96_rhs`` is pure ``jnp.roll`` arithmetic (vectorizes
over arbitrary leading batch axes, so the ensemble integrates under one
``vmap`` instead of the reference's per-member Python loop), and
``l96_integrate`` is a single ``lax.scan``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from particle_filters_jax.core.structs import pytree_dataclass, static_field


def l96_rhs(x: jax.Array, F: float = 8.0) -> jax.Array:
    """dx_a/dt = (x_{a+1} − x_{a−2}) x_{a−1} − x_a + F (cyclic), batched over
    leading axes. Reference: ``simulator_Lorenz_96.py:35``."""
    xp1 = jnp.roll(x, -1, axis=-1)
    xm1 = jnp.roll(x, 1, axis=-1)
    xm2 = jnp.roll(x, 2, axis=-1)
    return (xp1 - xm2) * xm1 - x + F


def rk4_step(x: jax.Array, dt: float, f) -> jax.Array:
    """One classical RK4 step (reference ``simulator_Lorenz_96.py:62``)."""
    k1 = f(x)
    k2 = f(x + 0.5 * dt * k1)
    k3 = f(x + 0.5 * dt * k2)
    k4 = f(x + dt * k3)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def l96_integrate(
    x0: jax.Array,
    dt: float,
    steps: int,
    F: float = 8.0,
    q_std: float = 0.0,
    key: Optional[jax.Array] = None,
) -> jax.Array:
    """Integrate L96 forward ``steps`` RK4 steps; returns (steps+1, ...) incl. x0.

    Optional additive N(0, q_std²) noise per step (reference
    ``simulator_Lorenz_96.py:87``). Batched over leading axes of ``x0``.
    """
    rhs = lambda z: l96_rhs(z, F)
    if q_std > 0.0:
        if key is None:
            key = jax.random.PRNGKey(0)
        noise = q_std * jax.random.normal(key, (steps,) + x0.shape, x0.dtype)
    else:
        noise = jnp.zeros((steps,) + x0.shape, x0.dtype)

    def step(x, eps):
        x_next = rk4_step(x, dt, rhs) + eps
        return x_next, x_next

    _, traj = lax.scan(step, x0, noise)
    return jnp.concatenate([x0[None], traj], axis=0)


@pytree_dataclass
class ObsModel:
    """Sparse linear observation: pick components ``H_idx`` of the state.

    Reference ``simulator_Lorenz_96.py:132-181``. ``H``/``JH`` are gather /
    one-hot scatter — both lower to cheap XLA gathers, no dense matmul.
    """

    H_idx: jax.Array  # (ny,) int
    R: jax.Array  # (ny, ny)

    def H(self, x: jax.Array) -> jax.Array:
        return jnp.take(x, self.H_idx, axis=-1)

    def JH(self, x: jax.Array) -> jax.Array:
        ny = self.H_idx.shape[0]
        nx = x.shape[-1]
        return jnp.zeros((ny, nx), x.dtype).at[jnp.arange(ny), self.H_idx].set(1.0)


@pytree_dataclass
class Lorenz96Config:
    nx: int = static_field(default=1000)
    F: float = static_field(default=8.0)
    dt: float = static_field(default=0.01)
    spinup_steps: int = static_field(default=1000)
    total_steps: int = static_field(default=1500)
    Np: int = static_field(default=20)
    obs_interval: int = static_field(default=20)
    obs_fraction: int = static_field(default=4)
    obs_error_std: float = static_field(default=1.0)
    perturbation_std: Optional[float] = static_field(default=None)
    seed: Optional[int] = static_field(default=None)


@pytree_dataclass
class Lorenz96SimulationResult:
    """Truth + ensemble trajectories, sparse observations, obs system, config.

    Same fields and ``.npz``/``.json`` persistence layout as reference
    ``Lorenz96SimulationResult`` (``simulator_Lorenz_96.py:185-295``).
    """

    truth_traj: jax.Array  # (T+1, nx)
    ensemble_traj: jax.Array  # (Np, T+1, nx)
    observations: jax.Array  # (n_obs_times, ny)
    obs_times: jax.Array  # (n_obs_times,)
    H_idx: jax.Array  # (ny,)
    R: jax.Array  # (ny, ny)
    config: Dict[str, Any] = static_field(default=None)

    @property
    def obs_model(self) -> ObsModel:
        return ObsModel(H_idx=self.H_idx, R=self.R)

    def save(self, filepath: str, overwrite: bool = False) -> None:
        path = Path(filepath)
        if not str(path).endswith(".npz"):
            path = path.with_suffix(".npz")
        if path.exists() and not overwrite:
            raise FileExistsError(f"File already exists: {path}")
        np.savez(
            path,
            truth_traj=np.asarray(self.truth_traj),
            ensemble_traj=np.asarray(self.ensemble_traj),
            observations=np.asarray(self.observations),
            obs_times=np.asarray(self.obs_times),
            H_idx=np.asarray(self.H_idx),
            R=np.asarray(self.R),
        )
        with open(path.with_suffix(".json"), "w") as f:
            json.dump(self.config, f, indent=2)

    @classmethod
    def load(cls, filepath: str) -> "Lorenz96SimulationResult":
        path = Path(filepath)
        if not str(path).endswith(".npz"):
            path = path.with_suffix(".npz")
        data = np.load(path)
        config_path = path.with_suffix(".json")
        config = json.loads(config_path.read_text()) if config_path.exists() else {}
        return cls(
            truth_traj=jnp.asarray(data["truth_traj"]),
            ensemble_traj=jnp.asarray(data["ensemble_traj"]),
            observations=jnp.asarray(data["observations"]),
            obs_times=jnp.asarray(data["obs_times"]),
            H_idx=jnp.asarray(data["H_idx"]),
            R=jnp.asarray(data["R"]),
            config=config,
        )


def simulate_lorenz96(
    nx: int = 1000,
    F: float = 8.0,
    dt: float = 0.01,
    spinup_steps: int = 1000,
    total_steps: int = 1500,
    Np: int = 20,
    obs_interval: int = 20,
    obs_fraction: int = 4,
    obs_error_std: float = 1.0,
    perturbation_std: Optional[float] = None,
    x0: Optional[jax.Array] = None,
    seed: Optional[int] = None,
    dtype=jnp.float32,
) -> Lorenz96SimulationResult:
    """Simulate Lorenz-96 truth + ensemble + sparse observations.

    Protocol and defaults match reference ``simulate_lorenz96``
    (``simulator_Lorenz_96.py:299-426``): standard init pattern
    x_a(0)=F (+1 every 5th), deterministic spin-up, √2-perturbed ensemble,
    H = every ``obs_fraction``-th variable, obs every ``obs_interval`` steps.
    The Np ensemble members integrate under one ``vmap`` (batched)
    instead of the reference's per-member Python loop (:395-397).
    """
    if perturbation_std is None:
        perturbation_std = float(np.sqrt(2.0))

    if x0 is None:
        x0_arr = jnp.full((nx,), F, dtype)
        x0_arr = x0_arr.at[jnp.arange(0, nx, 5)].set(F + 1.0)
    else:
        x0_arr = jnp.asarray(x0, dtype)
        if x0_arr.shape != (nx,):
            raise ValueError(f"x0 must have shape ({nx},), got {x0_arr.shape}")

    key = jax.random.PRNGKey(0 if seed is None else int(seed))
    k_pert, k_obs = jax.random.split(key)

    # Spin-up (deterministic) then truth trajectory.
    x_at_spinup = l96_integrate(x0_arr, dt, spinup_steps, F=F)[-1]
    truth_traj = l96_integrate(x_at_spinup, dt, total_steps, F=F)

    # Ensemble: perturb then batch-integrate under vmap.
    pert = perturbation_std * jax.random.normal(k_pert, (Np, nx), dtype)
    ensemble0 = x_at_spinup[None, :] + pert
    ensemble_traj = jax.vmap(lambda e: l96_integrate(e, dt, total_steps, F=F))(
        ensemble0
    )

    # Observation system.
    H_idx = jnp.arange(0, nx, obs_fraction)
    ny = int(H_idx.shape[0])
    R = (obs_error_std**2) * jnp.eye(ny, dtype=dtype)
    obs_times = jnp.arange(0, total_steps + 1, obs_interval)
    true_obs = jnp.take(truth_traj[obs_times], H_idx, axis=-1)
    obs_noise = obs_error_std * jax.random.normal(
        k_obs, true_obs.shape, dtype
    )
    observations = true_obs + obs_noise

    config = {
        "nx": int(nx),
        "F": float(F),
        "dt": float(dt),
        "spinup_steps": int(spinup_steps),
        "total_steps": int(total_steps),
        "Np": int(Np),
        "obs_interval": int(obs_interval),
        "obs_fraction": int(obs_fraction),
        "obs_error_std": float(obs_error_std),
        "perturbation_std": float(perturbation_std),
        "seed": seed,
        "ny": ny,
        "n_obs_times": int(obs_times.shape[0]),
    }
    return Lorenz96SimulationResult(
        truth_traj=truth_traj,
        ensemble_traj=ensemble_traj,
        observations=observations,
        obs_times=obs_times,
        H_idx=H_idx,
        R=R,
        config=config,
    )


def compute_rmse(forecast: jax.Array, truth: jax.Array) -> jax.Array:
    """RMSE (reference ``simulator_Lorenz_96.py:440``)."""
    return jnp.sqrt(jnp.mean((forecast - truth) ** 2))


def compute_ensemble_spread(ensemble: jax.Array, axis: int = 0) -> jax.Array:
    """Ensemble std (reference ``simulator_Lorenz_96.py:459``)."""
    return jnp.std(ensemble, axis=axis)
