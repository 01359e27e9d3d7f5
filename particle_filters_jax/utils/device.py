"""Device checks, card identity and the persistent compile cache.

Shared by ``bench.py``, ``chip_smoke.py`` and ``tests/conftest.py`` so that
every measurement names the card it ran on and every process finds the same
compile cache.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Optional, Tuple

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")

NVIDIA_SMI_QUERY = [
    "nvidia-smi",
    "--query-gpu=name,power.limit",
    "--format=csv,noheader",
]


def enable_compile_cache(
    min_compile_time_secs: Optional[float] = None,
    min_entry_size_bytes: Optional[int] = None,
) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and that
    directory is used as is; no other is set. Otherwise the cache lives at
    the fixed ``<repo>/.jax_cache`` (gitignored), so that every process of
    this checkout shares one cache key prefix.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    cache_dir = env if env else DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    if min_compile_time_secs is not None:
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", min_compile_time_secs
        )
    if min_entry_size_bytes is not None:
        jax.config.update(
            "jax_persistent_cache_min_entry_size_bytes", min_entry_size_bytes
        )
    return cache_dir


def parse_nvidia_smi(text: str) -> List[Tuple[str, str]]:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    output -> ``[(name, power_limit), ...]``, one pair per card.

    The name may itself hold commas, so the limit is taken after the last
    one. Blank lines are skipped; a line without a comma is an error.
    """
    cards = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if "," not in line:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        name, limit = line.rsplit(",", 1)
        cards.append((name.strip(), limit.strip()))
    return cards


def query_cards(timeout: float = 30.0) -> List[Tuple[str, str]]:
    """Name and power limit of every visible NVIDIA card, read by a child
    ``nvidia-smi`` process (which does not import JAX). Raises if the tool
    is missing, fails, or lists no card."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=timeout,
        check=True,
    ).stdout
    cards = parse_nvidia_smi(out)
    if not cards:
        raise RuntimeError("nvidia-smi listed no card")
    return cards


def require_gpu() -> jax.Device:
    """The first JAX device, which must be a GPU. Raises ``SystemExit``
    with a non-zero code otherwise: measurements never fall back to the
    CPU."""
    try:
        dev = jax.devices()[0]
    except RuntimeError as e:  # no backend could be initialised
        raise SystemExit(f"no JAX device: {e}") from None
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs a GPU, but JAX's first device is {dev.platform!r} "
            f"({dev.device_kind})"
        )
    return dev


def device_summary() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
