"""Skew-t sensor-network persistence and config-matrix tests — counterpart
of the reference ``tests/unit_tests/simulator/test_sn_skewt_io.py`` (14
tests) and the config portions of ``test_sn_skewt_config.py`` not already in
``tests/unit/test_skewt_simulator.py``.
"""

import pathlib
from dataclasses import asdict

import jax.numpy as jnp
import numpy as np
import pytest

from particle_filters_jax.simulators.sensor_network_skewt import (
    SkewTDynConfig,
    SkewTGridConfig,
    SkewTMeasConfig,
    SkewTSimConfig,
    load_npz,
    save_npz,
    simulate_skewt_many,
    simulate_skewt_trial,
)


@pytest.fixture(scope="module")
def small_cfgs():
    return (
        SkewTGridConfig(d=16, alpha0=1.0, alpha1=1e-3, beta=8.0),
        SkewTDynConfig(alpha=0.9, nu=8.0, gamma_scale=0.1, seed=5),
        SkewTMeasConfig(),
        SkewTSimConfig(T=6, n_trials=1),
    )


@pytest.fixture(scope="module")
def trial(small_cfgs):
    return simulate_skewt_trial(*small_cfgs)


class TestSkewTIO:
    def test_save_creates_file(self, trial, tmp_path):
        p = str(tmp_path / "t.npz")
        save_npz(p, trial)
        assert (tmp_path / "t.npz").exists()

    def test_roundtrip_trial(self, trial, tmp_path):
        p = str(tmp_path / "t.npz")
        save_npz(p, trial)
        back = load_npz(p)
        np.testing.assert_allclose(back["X"], np.asarray(trial.X), rtol=1e-6)
        np.testing.assert_array_equal(back["Z"], np.asarray(trial.Z))
        np.testing.assert_allclose(back["Sigma"], np.asarray(trial.Sigma), rtol=1e-6)
        np.testing.assert_allclose(back["gamma"], np.asarray(trial.gamma), rtol=1e-6)

    @pytest.mark.slow
    def test_roundtrip_many(self, small_cfgs, tmp_path):
        g, d, m, _ = small_cfgs
        res = simulate_skewt_many(g, d, m, SkewTSimConfig(T=4, n_trials=3))
        p = str(tmp_path / "many.npz")
        save_npz(p, res)
        back = load_npz(p)
        assert back["X"].shape == (3, 4, 16)
        assert back["Z"].shape == (3, 4, 16)

    def test_roundtrip_without_lambda(self, small_cfgs, tmp_path):
        g, d, m, _ = small_cfgs
        res = simulate_skewt_trial(g, d, m, SkewTSimConfig(T=4, save_lambda=False))
        p = str(tmp_path / "nl.npz")
        save_npz(p, res)
        assert "Lambda" not in load_npz(p)

    def test_lambda_saved_when_requested(self, trial, tmp_path):
        p = str(tmp_path / "wl.npz")
        save_npz(p, trial)
        back = load_npz(p)
        assert "Lambda" in back and back["Lambda"].shape == back["X"].shape

    def test_shapes_preserved(self, trial, tmp_path):
        p = str(tmp_path / "s.npz")
        save_npz(p, trial)
        back = load_npz(p)
        for k in ("X", "Z", "Sigma", "L", "R", "gamma"):
            assert back[k].shape == tuple(np.asarray(getattr(trial, k)).shape)

    def test_dtypes_preserved(self, trial, tmp_path):
        p = str(tmp_path / "d.npz")
        save_npz(p, trial)
        back = load_npz(p)
        assert np.issubdtype(back["X"].dtype, np.floating)
        assert np.issubdtype(back["Z"].dtype, np.integer) or np.issubdtype(
            back["Z"].dtype, np.floating
        )

    def test_load_nonexistent_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            load_npz(str(tmp_path / "missing.npz"))

    def test_save_with_path_object(self, trial, tmp_path):
        p = pathlib.Path(tmp_path) / "p.npz"
        save_npz(str(p), trial)
        assert p.exists()

    def test_save_multiple_files(self, trial, tmp_path):
        for name in ("a.npz", "b.npz"):
            save_npz(str(tmp_path / name), trial)
        a, b = load_npz(str(tmp_path / "a.npz")), load_npz(str(tmp_path / "b.npz"))
        np.testing.assert_array_equal(a["X"], b["X"])

    def test_save_overwrite_existing(self, trial, tmp_path):
        p = str(tmp_path / "o.npz")
        save_npz(p, trial)
        save_npz(p, trial)
        assert load_npz(p)["X"].shape == tuple(np.asarray(trial.X).shape)

    def test_load_returns_dict(self, trial, tmp_path):
        p = str(tmp_path / "r.npz")
        save_npz(p, trial)
        assert isinstance(load_npz(p), dict)


class TestSkewTConfigMatrix:
    @pytest.mark.parametrize("d", [4, 16, 64, 144])
    def test_grid_config_square_sizes(self, d):
        assert SkewTGridConfig(d=d).d == d

    def test_grid_config_custom(self):
        g = SkewTGridConfig(d=25, alpha0=2.0, alpha1=0.1, beta=4.0)
        assert (g.alpha0, g.alpha1, g.beta) == (2.0, 0.1, 4.0)

    @pytest.mark.parametrize("nu", [2.1, 4.0, 8.0, 30.0])
    def test_dyn_config_nu_range_simulates(self, nu):
        g = SkewTGridConfig(d=4)
        res = simulate_skewt_trial(
            g,
            SkewTDynConfig(nu=nu, seed=1),
            SkewTMeasConfig(),
            SkewTSimConfig(T=3),
        )
        assert np.isfinite(np.asarray(res.X)).all()

    @pytest.mark.parametrize("alpha", [0.0, 0.5, 0.99])
    def test_dyn_config_alpha_range_simulates(self, alpha):
        g = SkewTGridConfig(d=4)
        res = simulate_skewt_trial(
            g,
            SkewTDynConfig(alpha=alpha, seed=1),
            SkewTMeasConfig(),
            SkewTSimConfig(T=3),
        )
        assert np.isfinite(np.asarray(res.X)).all()

    def test_dyn_config_with_gamma_vec(self):
        gv = np.full(4, 0.25, np.float32)
        res = simulate_skewt_trial(
            SkewTGridConfig(d=4),
            SkewTDynConfig(gamma_vec=gv, seed=1),
            SkewTMeasConfig(),
            SkewTSimConfig(T=3),
        )
        np.testing.assert_allclose(np.asarray(res.gamma), gv)

    def test_meas_config_zero_m1_gives_zero_counts(self):
        res = simulate_skewt_trial(
            SkewTGridConfig(d=4),
            SkewTDynConfig(seed=1),
            SkewTMeasConfig(m1=0.0),
            SkewTSimConfig(T=3),
        )
        np.testing.assert_array_equal(np.asarray(res.Z), 0)

    def test_meas_config_negative_m2_inverts_link(self):
        # negative m2: larger x ⇒ smaller rate
        res = simulate_skewt_trial(
            SkewTGridConfig(d=4),
            SkewTDynConfig(seed=1),
            SkewTMeasConfig(m1=1.0, m2=-0.5),
            SkewTSimConfig(T=20),
        )
        lam = np.asarray(res.Lambda)
        x = np.clip(np.asarray(res.X), -10, 10)
        np.testing.assert_allclose(lam, np.exp(-0.5 * x), rtol=1e-5)

    @pytest.mark.parametrize("m1,m2", [(0.5, 0.1), (2.0, 1.0), (1.0, 1 / 3)])
    def test_meas_config_rate_formula(self, m1, m2):
        res = simulate_skewt_trial(
            SkewTGridConfig(d=4),
            SkewTDynConfig(seed=2),
            SkewTMeasConfig(m1=m1, m2=m2),
            SkewTSimConfig(T=5),
        )
        x = np.clip(np.asarray(res.X), -10, 10)
        np.testing.assert_allclose(np.asarray(res.Lambda), m1 * np.exp(m2 * x), rtol=1e-5)

    def test_sim_config_single_timestep(self):
        res = simulate_skewt_trial(
            SkewTGridConfig(d=4), SkewTDynConfig(seed=1), SkewTMeasConfig(),
            SkewTSimConfig(T=1),
        )
        assert res.X.shape == (1, 4)

    def test_sim_config_many_trials(self):
        res = simulate_skewt_many(
            SkewTGridConfig(d=4), SkewTDynConfig(seed=1), SkewTMeasConfig(),
            SkewTSimConfig(T=2, n_trials=7),
        )
        assert res.X.shape == (7, 2, 4)

    def test_sim_config_large_T(self):
        res = simulate_skewt_trial(
            SkewTGridConfig(d=4), SkewTDynConfig(seed=1), SkewTMeasConfig(),
            SkewTSimConfig(T=200),
        )
        assert res.X.shape == (200, 4) and np.isfinite(np.asarray(res.X)).all()

    def test_configs_to_dict_roundtrip(self):
        g = SkewTGridConfig(d=9)
        d = asdict(g)
        assert SkewTGridConfig(**d) == g
        dyn = SkewTDynConfig(alpha=0.7, nu=5.0)
        assert SkewTDynConfig(**asdict(dyn)) == dyn

    def test_config_immutability(self):
        m = SkewTMeasConfig()
        with pytest.raises(Exception):
            m.m1 = 2.0

    def test_meta_records_all_configs(self):
        res = simulate_skewt_trial(
            SkewTGridConfig(d=4), SkewTDynConfig(seed=3), SkewTMeasConfig(),
            SkewTSimConfig(T=2),
        )
        assert set(res.meta) == {"grid_cfg", "dyn_cfg", "meas_cfg", "sim_cfg"}
        assert res.meta["grid_cfg"]["d"] == 4
