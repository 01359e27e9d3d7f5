"""The GPU entry points on the CPU: ``chip_smoke.py`` and ``bench.py`` refuse
to run without a GPU, the compile-cache helper, the card query, the
comparison helpers of ``chip_smoke.py``, and ``_provision_devices``.

The ``gpu``-marked tests at the end need a card; ``gpu_device`` skips them
here.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from particle_filters_jax.utils import device as devmod  # noqa: E402


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _run(args, cwd, **extra):
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, env=_cpu_env(**extra),
        capture_output=True, text=True, timeout=300,
    )


# --------------------------------------------------------------------------
# The entry points refuse a machine without a GPU
# --------------------------------------------------------------------------


class TestRefuseWithoutGpu:
    @pytest.mark.parametrize(
        "args",
        [["chip_smoke.py"], ["chip_smoke.py", "--four"], ["bench.py"]],
        ids=["chip_smoke", "chip_smoke_four", "bench"],
    )
    def test_exits_nonzero_on_cpu(self, args):
        r = _run(args, REPO)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
        assert "particle_steps_per_sec" not in r.stdout

    def test_chip_smoke_alone_fails(self, tmp_path):
        """Without the rest of the repo beside it, the script fails."""
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        r = _run(["chip_smoke.py"], str(tmp_path))
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout

    def test_require_gpu_raises_on_cpu(self):
        with pytest.raises(SystemExit) as e:
            devmod.require_gpu()
        assert e.value.code not in (None, 0)


# --------------------------------------------------------------------------
# chip_smoke's final line
# --------------------------------------------------------------------------


class TestFinalLine:
    @pytest.mark.parametrize(
        "dev",
        [
            {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1},
            {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4},
            {"platform": "gpu", "kind": "H100", "count": np.int64(1)},
        ],
    )
    def test_format(self, dev):
        line = chip_smoke.final_line(dev)
        assert "\n" not in line
        obj = json.loads(line)
        assert obj == {
            "ok": True,
            "device": {
                "platform": "gpu", "kind": dev["kind"], "count": int(dev["count"]),
            },
        }
        assert line.startswith('{"ok": true, "device": {"platform": "gpu"')

    def test_device_summary_names_this_backend(self):
        s = devmod.device_summary()
        assert s == {
            "platform": jax.devices()[0].platform,
            "kind": jax.devices()[0].device_kind,
            "count": len(jax.devices()),
        }


# --------------------------------------------------------------------------
# Compile cache
# --------------------------------------------------------------------------


class TestCompileCache:
    @pytest.fixture
    def restore_cache_dir(self):
        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_env_dir_is_used(self, monkeypatch, tmp_path, restore_cache_dir):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert devmod.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)

    def test_default_is_repo_dir(self, monkeypatch, restore_cache_dir):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = devmod.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert got == devmod.DEFAULT_CACHE_DIR
        assert jax.config.jax_compilation_cache_dir == got

    def test_entries_land_only_in_env_dir(self, tmp_path):
        """A process with the variable set writes its cache there and the
        helper sets no other directory."""
        cache = tmp_path / "cache"
        code = (
            "import jax, jax.numpy as jnp\n"
            "from particle_filters_jax.utils.device import "
            "enable_compile_cache\n"
            "d = enable_compile_cache(min_compile_time_secs=0.0, "
            "min_entry_size_bytes=-1)\n"
            "print(d, jax.config.jax_compilation_cache_dir)\n"
            "jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)(jnp.ones(7))"
            ".block_until_ready()\n"
        )
        r = _run(["-c", code], REPO, JAX_COMPILATION_CACHE_DIR=str(cache))
        assert r.returncode == 0, r.stderr
        assert r.stdout.split() == [str(cache), str(cache)]
        assert cache.is_dir() and any(cache.iterdir())


# --------------------------------------------------------------------------
# nvidia-smi output
# --------------------------------------------------------------------------


class TestParseNvidiaSmi:
    @pytest.mark.parametrize(
        "text, want",
        [
            ("NVIDIA H100 80GB HBM3, 700.00 W\n",
             [("NVIDIA H100 80GB HBM3", "700.00 W")]),
            ("NVIDIA H100 80GB HBM3, 500.00 W",
             [("NVIDIA H100 80GB HBM3", "500.00 W")]),
            ("NVIDIA H100 80GB HBM3, 700.00 W\n" * 4,
             [("NVIDIA H100 80GB HBM3", "700.00 W")] * 4),
            ("\n  NVIDIA H100 PCIe , 350.00 W  \n\n",
             [("NVIDIA H100 PCIe", "350.00 W")]),
            ("Card, with comma, [N/A]\n", [("Card, with comma", "[N/A]")]),
            ("", []),
        ],
        ids=["one", "capped", "four", "padded", "comma_in_name", "empty"],
    )
    def test_parse(self, text, want):
        assert devmod.parse_nvidia_smi(text) == want

    def test_malformed_line_raises(self):
        with pytest.raises(ValueError):
            devmod.parse_nvidia_smi("NVIDIA H100 80GB HBM3\n")

    def test_query_uses_the_documented_command(self):
        assert devmod.NVIDIA_SMI_QUERY == [
            "nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ]


# --------------------------------------------------------------------------
# chip_smoke's comparison helpers
# --------------------------------------------------------------------------


class TestToleranceHelpers:
    @pytest.mark.parametrize(
        "a, b, want",
        [([1.0, 2.0], [1.0, 2.5], 0.5), ([], [], 0.0), ([[3.0]], [[-1.0]], 4.0)],
    )
    def test_max_abs_diff(self, a, b, want):
        assert chip_smoke.max_abs_diff(a, b) == pytest.approx(want)

    @pytest.mark.parametrize(
        "a, b, atol, want",
        [
            ([0.0, 0.0, 0.0, 0.0], [0.0, 0.01, 0.05, 0.2], 0.05, 0.75),
            ([1.0, 2.0], [1.0, 2.0], 0.0, 1.0),
            ([], [], 0.1, 1.0),
        ],
    )
    def test_frac_within(self, a, b, atol, want):
        assert chip_smoke.frac_within(a, b, atol) == pytest.approx(want)

    def test_frac_equal(self):
        assert chip_smoke.frac_equal([True, False, True], [True, True, True]) \
            == pytest.approx(2 / 3)

    @pytest.mark.parametrize(
        "got, ref, kw, want",
        [
            (1.05, 1.0, {"rtol": 0.1}, True),
            (1.2, 1.0, {"rtol": 0.1}, False),
            ([0.0, 1e-4], [0.0, 0.0], {"atol": 1e-3}, True),
            (np.nan, 1.0, {"rtol": 1.0}, False),
            ([1.0, 2.0], [1.0], {"rtol": 1.0}, False),
        ],
        ids=["rel_ok", "rel_fail", "abs_ok", "nan", "shape"],
    )
    def test_within(self, got, ref, kw, want):
        assert chip_smoke.within(got, ref, **kw) is want

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError):
            chip_smoke.max_abs_diff([1.0], [1.0, 2.0])
        with pytest.raises(ValueError):
            chip_smoke.frac_within([1.0], [1.0, 2.0], 0.1)

    def test_check_raises(self):
        chip_smoke._check(True, "fine")
        with pytest.raises(AssertionError, match="broken"):
            chip_smoke._check(False, "broken")

    def test_numpy_oracle_matches_hard(self, key):
        from particle_filters_jax.resampling.hard import (
            _systematic_starts,
            systematic_resample_values,
        )

        n = 2000
        w = jax.nn.softmax(2.0 * jax.random.normal(key, (n,)))
        p = jax.random.normal(jax.random.fold_in(key, 1), (n, 3))
        starts = np.asarray(_systematic_starts(key, w, n))
        np.testing.assert_array_equal(
            chip_smoke._numpy_resample_oracle(starts, np.asarray(p)),
            np.asarray(systematic_resample_values(key, p, w=w)),
        )


# --------------------------------------------------------------------------
# _provision_devices
# --------------------------------------------------------------------------


class TestProvisionDevices:
    def test_raises_off_cpu(self, monkeypatch):
        """A process not started for the CPU never switches to virtual CPU
        devices: too few devices is an error."""
        import __graft_entry__ as g

        monkeypatch.setenv("JAX_PLATFORMS", "cuda")
        before = jax.devices()
        with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
            g._provision_devices(len(before) + 1)
        assert jax.devices() == before

    def test_enough_devices_is_a_no_op(self, monkeypatch):
        import __graft_entry__ as g

        monkeypatch.setenv("JAX_PLATFORMS", "cuda")
        before = jax.devices()
        g._provision_devices(len(before))
        assert jax.devices() == before

    def test_cpu_process_gets_virtual_devices(self):
        code = (
            "import jax, __graft_entry__ as g\n"
            "g._provision_devices(3)\n"
            "print(jax.device_count(), jax.devices()[0].platform)\n"
        )
        r = _run(["-c", code], REPO)
        assert r.returncode == 0, r.stderr
        assert r.stdout.split() == ["3", "cpu"]


# --------------------------------------------------------------------------
# On a card (skipped here)
# --------------------------------------------------------------------------


@pytest.mark.gpu
class TestOnGpu:
    @pytest.mark.parametrize("shape", [(4,), (), (144,), (2, 3)],
                             ids=["d4", "1d", "d144", "2x3"])
    def test_resample_selection_matches_cpu(self, gpu_device, key, shape):
        from particle_filters_jax.resampling.hard import (
            _systematic_starts,
            resample_values_from_starts,
        )

        n = 1 << 16
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            w = jax.nn.softmax(3.0 * jax.random.normal(key, (n,)))
            starts = np.asarray(_systematic_starts(key, w, n))
            p = np.asarray(jax.random.normal(jax.random.fold_in(key, 1),
                                             (n,) + shape))
        got = jax.jit(resample_values_from_starts)(
            *jax.device_put((starts, p), gpu_device)
        )
        np.testing.assert_array_equal(
            np.asarray(got), chip_smoke._numpy_resample_oracle(starts, p)
        )

    def test_sv_filter_runs(self, gpu_device):
        from bench import make_sv_filter, sv_prior

        pf = make_sv_filter(1 << 16)
        with jax.default_device(gpu_device):
            st = pf.initialize(jax.random.PRNGKey(0), *sv_prior())
            zs = 0.5 * jnp.ones((10, 1), jnp.float32)
            _, hist = jax.jit(lambda k, s: pf.run(k, s, zs))(
                jax.random.PRNGKey(1), st
            )
        assert np.all(np.isfinite(np.asarray(hist["mean"])))
