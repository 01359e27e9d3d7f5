"""Lightweight wall-clock timing + jax.profiler hooks.

The reference sprinkles ``time.time()`` inside DPF diagnostics
(``models/DPF_soft_resampling.py:430-437``); here timing is explicit and
device-synchronized, plus a thin wrapper over ``jax.profiler`` traces
(SURVEY.md §5.1).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import jax


class Timer:
    """Accumulating named phase timer with device synchronization."""

    def __init__(self) -> None:
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Time a phase; pass ``sync=result`` pytree to block on device work."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            jax.block_until_ready(sync)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)

    def time_fn(self, name: str, fn, *args, **kwargs):
        """Run fn, block on its outputs, record elapsed time, return outputs."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        self.records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.records.items():
            out[name] = {
                "total_s": sum(ts),
                "mean_ms": 1e3 * sum(ts) / len(ts),
                "count": len(ts),
                "min_ms": 1e3 * min(ts),
                "max_ms": 1e3 * max(ts),
            }
        return out


def time_best(fn, *args, reps: int = 5, warmup: int = 1):
    """Best wall time of ``fn(*args)`` over ``reps`` calls, each ended by
    ``jax.block_until_ready``, after ``warmup`` untimed calls (the first
    compiles). Returns ``(best_seconds, first_call_seconds, output)``."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    for _ in range(warmup - 1):
        out = jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, first, out


@contextlib.contextmanager
def timed(label: str = ""):
    """Simple timed block printing elapsed milliseconds."""
    t0 = time.perf_counter()
    yield
    print(f"[{label}] {1e3 * (time.perf_counter() - t0):.2f} ms")


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
