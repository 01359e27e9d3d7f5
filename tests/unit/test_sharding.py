"""Multi-device sharding tests on an 8-virtual-CPU-device mesh.

SURVEY.md §4: "single-host multi-device sharding tests (8 cores behave like
1 within tolerance)".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.models import ParticleFilter
from particle_filters_jax.parallel import (
    make_mesh,
    make_sharded_pf_run,
    shard_pf_state,
)


def _make_pf(axis_name=None, Np=1024):
    alpha, sigma, beta = 0.9, 0.2, 1.0

    def obs_loglik(x, z):
        var = beta**2 * jnp.exp(x[0])
        return -0.5 * (z[0] ** 2 / var + jnp.log(var))

    return ParticleFilter(
        lambda x, u: alpha * x,
        None,
        Q=np.array([[sigma**2]], np.float32),
        R=None,
        Np=Np,
        obs_loglik=obs_loglik,
        axis_name=axis_name,
    )


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(n_batch=1, n_particles=8)


class TestMesh:
    def test_make_mesh_shapes(self, mesh):
        assert mesh.axis_names == ("batch", "particles")
        assert mesh.devices.shape == (1, 8)

    def test_make_mesh_validation(self):
        with pytest.raises(ValueError):
            make_mesh(n_batch=3)  # 8 % 3 != 0
        with pytest.raises(ValueError):
            make_mesh(n_batch=4, n_particles=4)  # 16 > 8


class TestShardedPF:
    def test_runs_and_tracks(self, key, sv_data):
        mesh = make_mesh(n_batch=1, n_particles=8)
        pf = _make_pf(axis_name="particles", Np=1024)
        st0 = pf.initialize(
            key, np.zeros(1, np.float32), np.array([[1.05]], np.float32)
        )
        st0 = shard_pf_state(st0, mesh)
        run = make_sharded_pf_run(pf, mesh)
        final, hist = run(jax.random.fold_in(key, 1), st0, sv_data.Y[:, None])
        rmse = float(jnp.sqrt(jnp.mean((hist["mean"][:, 0] - sv_data.X) ** 2)))
        assert rmse < 1.5
        assert np.all(np.isfinite(np.asarray(hist["ess"])))

    def test_sharded_matches_single_device_statistically(self, key, sv_data):
        """8-shard run tracks the same signal as the single-device run:
        RMSEs agree within Monte-Carlo tolerance."""
        Np = 1024
        zs = sv_data.Y[:200, None]
        xs = sv_data.X[:200]

        pf1 = _make_pf(axis_name=None, Np=Np)
        st1 = pf1.initialize(
            key, np.zeros(1, np.float32), np.array([[1.05]], np.float32)
        )
        _, h1 = jax.jit(lambda k, s: pf1.run(k, s, zs))(
            jax.random.fold_in(key, 2), st1
        )
        rmse1 = float(jnp.sqrt(jnp.mean((h1["mean"][:, 0] - xs) ** 2)))

        mesh = make_mesh(n_batch=1, n_particles=8)
        pf8 = _make_pf(axis_name="particles", Np=Np)
        st8 = shard_pf_state(
            pf8.initialize(
                key, np.zeros(1, np.float32), np.array([[1.05]], np.float32)
            ),
            mesh,
        )
        _, h8 = make_sharded_pf_run(pf8, mesh)(
            jax.random.fold_in(key, 2), st8, zs
        )
        rmse8 = float(jnp.sqrt(jnp.mean((h8["mean"][:, 0] - xs) ** 2)))
        assert abs(rmse1 - rmse8) < 0.25 * max(rmse1, rmse8) + 0.05

    def test_ess_is_global(self, key):
        """Sharded ESS equals the global particle count for uniform weights."""
        mesh = make_mesh(n_batch=1, n_particles=8)
        pf = _make_pf(axis_name="particles", Np=1024)
        st0 = shard_pf_state(
            pf.initialize(
                key, np.zeros(1, np.float32), np.eye(1, dtype=np.float32)
            ),
            mesh,
        )
        run = make_sharded_pf_run(pf, mesh)
        _, hist = run(jax.random.fold_in(key, 3), st0, jnp.zeros((3, 1)))
        # ESS is bounded by the GLOBAL N (1024), not the local shard (128).
        assert np.all(np.asarray(hist["ess"]) <= 1024 + 1)
        assert np.any(np.asarray(hist["ess"]) > 128)


class TestShardedDPFTraining:
    def test_train_step_runs_and_updates(self, key):
        """Packaged sharded DPF training step: finite loss, params move."""
        import numpy as np
        from jax.sharding import Mesh

        from particle_filters_jax.parallel.dpf_sharded import (
            make_sharded_dpf_train_step,
        )

        devs = jax.devices()[:8]
        mesh = Mesh(np.asarray(devs).reshape(2, 4), ("batch", "particles"))
        B, N, T = 4, 64, 4
        params = {"alpha": jnp.asarray(0.9)}
        xs = jax.random.normal(key, (B, T, 1))
        ys = xs + 0.3 * jax.random.normal(jax.random.fold_in(key, 1), (B, T, 1))

        def transition_fn(p, k, particles):
            return p["alpha"] * particles + 0.25 * jax.random.normal(
                k, particles.shape
            )

        def obs_loglik_fn(p, particles, y):
            return -0.5 * jnp.sum((y[None, :] - particles) ** 2 / 0.09, axis=-1)

        def init_fn(p, k, n_local):
            return jax.random.normal(k, (n_local, 1))

        step = make_sharded_dpf_train_step(
            mesh,
            n_particles=N,
            transition_fn=transition_fn,
            obs_loglik_fn=obs_loglik_fn,
            init_fn=init_fn,
            loss_fn=lambda means, truth: jnp.mean((means - truth) ** 2),
        )
        loss, new_params = step(params, key, ys, xs)
        assert np.isfinite(float(loss))
        assert float(new_params["alpha"]) != 0.9  # gradient flowed

    def test_soft_resample_differs_across_shards(self, key):
        """Regression: each shard must draw DISTINCT Gumbel noise (its own
        rows of the global (N, N) assignment). With a shared key every
        shard resamples identical ancestors and the global cloud holds
        only n_local distinct particles."""
        from functools import partial

        from jax import shard_map
        from jax.sharding import Mesh, PartitionSpec as P

        from particle_filters_jax.parallel.dpf_sharded import (
            sharded_soft_resample,
        )

        devs = jax.devices()[:8]
        mesh = Mesh(np.asarray(devs).reshape(1, 8), ("batch", "particles"))
        N, d = 64, 2
        particles = jax.random.normal(key, (N, d))
        logw = jnp.full((N,), -jnp.log(float(N)))

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), P("particles", None), P("particles")),
            out_specs=(P("particles", None), P("particles")),
            check_vma=False,
        )
        def resample(k, p, lw):
            return sharded_soft_resample(
                k, p, lw, n_particles=N, temperature=0.1
            )

        new_p, _ = resample(jax.random.fold_in(key, 7), particles, logw)
        blocks = np.asarray(new_p).reshape(8, N // 8, d)
        for i in range(1, 8):
            assert not np.allclose(blocks[0], blocks[i]), (
                f"shard {i} resampled identical particles to shard 0 "
                "(Gumbel key not folded with the shard index)"
            )
        # low temperature => rows are near-one-hot over true ancestors
        assert np.all(np.isfinite(blocks))

    def test_validates_particle_divisibility(self):
        import numpy as np
        from jax.sharding import Mesh

        from particle_filters_jax.parallel.dpf_sharded import (
            make_sharded_dpf_train_step,
        )

        mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(1, 8), ("batch", "particles"))
        with pytest.raises(ValueError, match="divide"):
            make_sharded_dpf_train_step(
                mesh, n_particles=30,
                transition_fn=None, obs_loglik_fn=None,
                init_fn=None, loss_fn=None,
            )
