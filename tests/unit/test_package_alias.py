"""The package's former name is an alias of ``particle_filters_jax``.

An alias package sits beside ``particle_filters_jax`` at the repository
root and declares ``ALIAS_OF``; importing it, or a module under it, must
give the very module objects of ``particle_filters_jax``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
ALIASES = sorted(
    p.parent.name for p in REPO.glob("*/__init__.py")
    if "ALIAS_OF = " in p.read_text()
)


def test_an_alias_exists():
    assert ALIASES


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("alias", ALIASES)
def test_alias_gives_the_same_modules(alias):
    code = f"""
import importlib, warnings
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    old = importlib.import_module("{alias}")
assert any(issubclass(w.category, DeprecationWarning) for w in caught)
import particle_filters_jax as new
import particle_filters_jax.models.particle_filter as new_pf
assert old is new
assert importlib.import_module("{alias}.models.particle_filter") is new_pf
from {alias}.models import ParticleFilter
assert ParticleFilter is new_pf.ParticleFilter
from {alias}.resampling.hard import systematic_resample
import particle_filters_jax.resampling.hard as hard
assert systematic_resample is hard.systematic_resample
print("ok")
"""
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
