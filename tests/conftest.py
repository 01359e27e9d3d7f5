"""Shared fixtures. Tests run on CPU with 8 virtual devices so sharding
tests exercise a real multi-device mesh without accelerator hardware
(SURVEY.md §7). Tests marked ``gpu`` take the ``gpu_device`` fixture, which
skips them when JAX sees no GPU.

Mirrors the reference's session-scoped dataset fixtures
(``tests/conftest.py`` :12-360): simulators ARE the fixtures — in-process,
seeded, cheap. No mocks.
"""

import os

# Must be set before jax initializes. NOTE: override, not setdefault — the
# environment may pin JAX_PLATFORMS to an accelerator, and the test suite
# must run on the host CPU with 8 virtual devices. The one exception is the
# run of the ``gpu``-marked tests on a machine with a card:
#   PARTICLE_FILTERS_TEST_GPU=1 python -m pytest tests/ -m gpu
# which leaves JAX's default platform (the GPU) in place.
ON_GPU = os.environ.get("PARTICLE_FILTERS_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite's wall time is dominated by
# XLA:CPU compiles; warm runs skip them. The cache key includes jaxlib
# version, backend and HLO, so stale hits are not a correctness concern.
# JAX_COMPILATION_CACHE_DIR, when set, names the directory; otherwise the
# repo's gitignored .jax_cache/ is used.
from particle_filters_jax.utils.device import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_time_secs=0.0, min_entry_size_bytes=-1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_per_module():
    """Bound per-process compiled-executable accumulation.

    A full single-process run compiles ~400 distinct XLA:CPU programs; at
    ~#330 the compiler segfaults inside ``backend_compile_and_load``
    (observed twice at *different* tests — test_spf β-bisection and
    test_simulators skew-t vmap — i.e. a resource/state problem, not a bad
    program; chunked runs of the same tests all pass). Dropping the
    compilation caches between modules keeps the live-executable count
    bounded; modules share few jitted functions, so the recompile cost is
    small.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU JAX sees; skips the test when there is none. Decided
    here, at run time, never while test modules are imported."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (JAX sees none here)")
    return gpus[0]


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(42)


@pytest.fixture(scope="session")
def small_system():
    """A stable 2-D LGSSM (the README §4 system of the reference)."""
    A = np.array([[0.9, 0.5], [0.0, 0.7]], np.float32)
    B = np.diag([np.sqrt(0.05), np.sqrt(0.02)]).astype(np.float32)
    C = np.eye(2, dtype=np.float32)
    D = (np.sqrt(0.1) * np.eye(2)).astype(np.float32)
    Sigma = np.eye(2, dtype=np.float32)
    return dict(A=A, B=B, C=C, D=D, Sigma=Sigma, Q=B @ B.T, R=D @ D.T)


@pytest.fixture(scope="session")
def lgssm_data(small_system):
    from particle_filters_jax.simulators import simulate_lgssm

    s = small_system
    return simulate_lgssm(
        s["A"], s["B"], s["C"], s["D"], s["Sigma"], 300, seed=42
    )


@pytest.fixture(scope="session")
def sv_params():
    """SV params used throughout the reference tests
    (``tests/conftest.py:61-69``)."""
    return dict(alpha=0.9, sigma=0.2, beta=1.0, n=500, seed=42)


@pytest.fixture(scope="session")
def sv_data(sv_params):
    from particle_filters_jax.simulators import simulate_sv_1d

    p = sv_params
    return simulate_sv_1d(
        p["n"], p["alpha"], p["sigma"], p["beta"], seed=p["seed"]
    )


@pytest.fixture(scope="session")
def skewt_small():
    from particle_filters_jax.simulators import (
        SkewTDynConfig,
        SkewTGridConfig,
        SkewTMeasConfig,
        SkewTSimConfig,
        simulate_skewt_trial,
    )

    return simulate_skewt_trial(
        SkewTGridConfig(d=16),
        SkewTDynConfig(seed=123),
        SkewTMeasConfig(),
        SkewTSimConfig(T=10),
    )


@pytest.fixture(scope="session")
def mat_small():
    from particle_filters_jax.simulators import (
        MATDynamicsConfig,
        MATScenarioConfig,
        simulate_acoustic_dataset,
    )

    return simulate_acoustic_dataset(
        MATScenarioConfig(n_steps=30), MATDynamicsConfig()
    )
