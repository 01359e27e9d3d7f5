"""Utils: metrics, timing, checkpoint round-trips, phased runner."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.utils import Timer, coverage_95, mae, mse, nees, omat, rmse
from particle_filters_jax.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)


class TestMetrics:
    def test_rmse_mae_mse(self):
        a = jnp.array([1.0, 2.0, 3.0])
        b = jnp.array([1.0, 2.0, 5.0])
        assert np.isclose(float(mse(a, b)), 4.0 / 3.0)
        assert np.isclose(float(rmse(a, b)), np.sqrt(4.0 / 3.0))
        assert np.isclose(float(mae(a, b)), 2.0 / 3.0)

    def test_nees_identity(self, key):
        T, nx = 50, 2
        diff = jax.random.normal(key, (T, nx))
        means = diff  # truth = 0
        covs = jnp.tile(jnp.eye(nx), (T, 1, 1))
        n = nees(means, covs, jnp.zeros((T, nx)))
        # NEES of standard normal errors with identity covs ~ chi2(2): mean 2
        assert 1.0 < float(jnp.mean(n)) < 3.5

    def test_coverage(self, key):
        T, nx = 400, 2
        diff = jax.random.normal(key, (T, nx))
        covs = jnp.tile(jnp.eye(nx), (T, 1, 1))
        c = coverage_95(diff, covs, jnp.zeros((T, nx)))
        assert 0.85 < float(c) <= 1.0

    def test_omat_exact_match(self):
        est = np.array([[1.0, 2.0], [3.0, 4.0]])
        assert omat(est, est) == 0.0

    def test_omat_permutation_invariant(self):
        a = np.array([[0.0, 0.0], [5.0, 5.0], [1.0, 2.0]])
        assert omat(a[[2, 0, 1]], a) < 1e-12

    def test_omat_positive_on_error(self):
        est = np.array([[0.0, 0.0], [1.0, 0.0]])
        tru = np.array([[0.0, 1.0], [1.0, 1.0]])
        assert np.isclose(omat(est, tru), 1.0)


class TestTimer:
    def test_records_phases(self):
        t = Timer()
        x = jnp.ones(10)
        with t.phase("a", sync=x):
            y = x * 2
        t.time_fn("b", lambda v: v + 1, x)
        s = t.summary()
        assert "a" in s and "b" in s
        assert s["a"]["count"] == 1
        assert s["b"]["mean_ms"] >= 0


class TestTimeBest:
    @pytest.mark.parametrize("reps,warmup", [(1, 1), (3, 2)])
    def test_counts_calls_and_returns_output(self, reps, warmup):
        from particle_filters_jax.utils import time_best

        calls = []

        def fn(x):
            calls.append(1)
            return x * 2.0

        best, first, out = time_best(fn, jnp.ones(3), reps=reps, warmup=warmup)
        assert len(calls) == warmup + reps
        assert 0.0 <= best and 0.0 <= first
        np.testing.assert_array_equal(np.asarray(out), 2.0 * np.ones(3))


class TestCheckpoint:
    def test_roundtrip_pytree(self, tmp_path, key):
        state = {
            "particles": jax.random.normal(key, (16, 2)),
            "logw": jnp.zeros(16),
            "t": jnp.asarray(7, jnp.int32),
        }
        d = save_checkpoint(str(tmp_path / "ckpt"), state, step=3)
        restored = restore_checkpoint(str(tmp_path / "ckpt"), step=3)
        np.testing.assert_allclose(
            np.asarray(restored["particles"]), np.asarray(state["particles"])
        )
        assert int(restored["t"]) == 7
        assert latest_step(str(tmp_path / "ckpt")) == 3

    def test_latest_step_empty(self, tmp_path):
        assert latest_step(str(tmp_path / "nothing")) is None

    def test_pfstate_roundtrip(self, tmp_path, key):
        from particle_filters_jax.models import ParticleFilter

        pf = ParticleFilter(
            lambda x, u: 0.9 * x, lambda x: x,
            np.eye(1, dtype=np.float32), np.eye(1, dtype=np.float32), Np=32,
        )
        st = pf.initialize(key, np.zeros(1, np.float32), np.eye(1, dtype=np.float32))
        as_dict = {
            "particles": st.particles,
            "weights": st.weights,
            "log_weights": st.log_weights,
            "mean": st.mean,
            "cov": st.cov,
            "t": st.t,
        }
        save_checkpoint(str(tmp_path / "pf"), as_dict)
        restored = restore_checkpoint(str(tmp_path / "pf"))
        np.testing.assert_allclose(
            np.asarray(restored["particles"]), np.asarray(st.particles)
        )


class TestManualRunner:
    def test_list_phases(self):
        out = subprocess.run(
            [sys.executable, "tests/manual_run.py", "--list"],
            capture_output=True, text=True,
        )
        assert out.returncode == 0
        assert "pf" in out.stdout and "all" in out.stdout

    def test_runs_one_phase(self):
        out = subprocess.run(
            [
                sys.executable, "tests/manual_run.py", "--phase", "core",
                "--co",  # collect-only: fast smoke of the wiring
            ],
            capture_output=True, text=True,
        )
        assert out.returncode == 0
        assert "PASSED" in out.stdout


class TestDegeneracyMetrics:
    """Degeneracy panel of ``notebooks/particle_filter_NLNGSSM.ipynb``:
    entropy / Gini / max-weight / unique fraction on log-weights."""

    def test_entropy_uniform_is_one(self):
        from particle_filters_jax.utils import weight_entropy

        lw = jnp.zeros((64,))  # uniform in log domain up to a constant
        assert np.isclose(float(weight_entropy(lw)), 1.0, atol=1e-6)

    def test_entropy_point_mass_is_zero(self):
        from particle_filters_jax.utils import weight_entropy

        lw = jnp.full((64,), -1e9).at[3].set(0.0)
        assert float(weight_entropy(lw)) < 1e-6

    def test_entropy_single_particle_defined(self):
        """N=1: log(N)=0 must not produce NaN; a lone particle is uniform."""
        from particle_filters_jax.utils import weight_entropy

        lw = jnp.zeros((1,))
        assert float(weight_entropy(lw)) == 1.0
        assert float(weight_entropy(lw, normalized=False)) == 0.0

    def test_entropy_unnormalized_option(self):
        from particle_filters_jax.utils import weight_entropy

        lw = jnp.zeros((64,))
        assert np.isclose(
            float(weight_entropy(lw, normalized=False)), np.log(64), atol=1e-5
        )

    def test_gini_bounds(self, key):
        from particle_filters_jax.utils import weight_gini

        uniform = jnp.zeros((128,))
        assert abs(float(weight_gini(uniform))) < 1e-5
        point = jnp.full((128,), -1e9).at[0].set(0.0)
        # point mass: G → (N−1)/N
        assert np.isclose(float(weight_gini(point)), 127 / 128, atol=1e-4)
        random = jax.random.normal(key, (128,))
        g = float(weight_gini(random))
        assert 0.0 < g < 1.0

    def test_max_weight(self):
        from particle_filters_jax.utils import max_weight

        lw = jnp.log(jnp.array([0.7, 0.2, 0.1]))
        assert np.isclose(float(max_weight(lw)), 0.7, atol=1e-6)

    def test_unique_fraction(self):
        from particle_filters_jax.utils import unique_fraction

        a = jnp.array([0, 0, 0, 3], jnp.int32)
        assert np.isclose(float(unique_fraction(a)), 0.5)
        assert np.isclose(float(unique_fraction(jnp.arange(8))), 1.0)

    def test_degeneracy_report_consistent_with_ess(self, key):
        from particle_filters_jax.core.weights import ess_from_logw
        from particle_filters_jax.utils import degeneracy_report

        lw = jax.random.normal(key, (10, 64))
        rep = degeneracy_report(lw)
        assert set(rep) == {"ess", "entropy", "gini", "max_weight"}
        for v in rep.values():
            assert v.shape == (10,)
        ess_direct = jax.vmap(ess_from_logw)(lw)
        np.testing.assert_allclose(
            np.asarray(rep["ess"]), np.asarray(ess_direct), rtol=1e-5
        )

    def test_batched_entropy_gini(self, key):
        from particle_filters_jax.utils import weight_entropy, weight_gini

        lw = jax.random.normal(key, (5, 32))
        assert weight_entropy(lw).shape == (5,)
        assert weight_gini(lw).shape == (5,)
