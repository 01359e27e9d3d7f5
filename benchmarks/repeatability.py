"""Does the north-star filter give the same bits twice on a GPU?

Runs ``ParticleFilter.run`` on the SV model (N = 2²⁰, T = 200, the program
of ``bench.py`` and ``chip_smoke.py``), with threefry keys under
``default_matmul_precision("highest")`` and with rbg keys at default
precision, twice each from one compiled executable, and prints for each
the RMSE against the simulated truth, a SHA-256 digest of the history
(means, ESS, resample triggers) and whether the two runs were
bit-identical. Run it in several processes (for example once more with
``XLA_FLAGS=--xla_gpu_deterministic_ops=true``) and compare the digests to
see whether compilation or execution moves the result.

Usage (GPU only; exits non-zero elsewhere):
    python benchmarks/repeatability.py [--no-cache] [--label NAME]
``--no-cache`` compiles without the persistent compile cache, so each
process makes its own compiler choices.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bench import ALPHA, BETA, SIGMA, make_sv_filter, sv_prior  # noqa: E402

N, T = 1 << 20, 200


def digest(hist) -> str:
    h = hashlib.sha256()
    for k in ("mean", "ess", "resampled"):
        h.update(np.ascontiguousarray(np.asarray(hist[k])).tobytes())
    return h.hexdigest()[:16]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-cache", action="store_true")
    ap.add_argument("--label", default="")
    args = ap.parse_args()

    from particle_filters_jax.simulators import simulate_sv_1d
    from particle_filters_jax.utils.device import (
        enable_compile_cache,
        query_cards,
        require_gpu,
    )

    require_gpu()
    if args.no_cache:
        jax.config.update("jax_enable_compilation_cache", False)
    else:
        enable_compile_cache()
    card = query_cards()[0]
    sv = simulate_sv_1d(T, ALPHA, SIGMA, BETA, seed=42)
    zs = jnp.asarray(sv.Y[:, None], jnp.float32)
    x_true = np.asarray(sv.X)
    pf = make_sv_filter(N)
    for impl, precision in (("threefry2x32", "highest"), ("rbg", "default")):
        with jax.default_matmul_precision(precision):
            state0 = pf.initialize(jax.random.key(0, impl=impl), *sv_prior())
            key = jax.random.key(2, impl=impl)
            run = jax.jit(lambda k, s: pf.run(k, s, zs)).lower(
                key, state0).compile()
            hists = [jax.device_get(jax.block_until_ready(run(key, state0))[1])
                     for _ in range(2)]
        same = all(np.array_equal(np.asarray(hists[0][k]),
                                  np.asarray(hists[1][k]))
                   for k in ("mean", "ess", "resampled"))
        rmse = float(np.sqrt(np.mean(
            (np.asarray(hists[0]["mean"][:, 0]) - x_true) ** 2)))
        print(json.dumps({
            "what": "repeatability", "label": args.label, "keys": impl,
            "precision": precision, "n": N, "T": T, "rmse": repr(rmse),
            "digest": digest(hists[0]), "in_process_bit_identical": same,
            "compile_cache": not args.no_cache,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "card": card[0], "power_limit": card[1]}), flush=True)


if __name__ == "__main__":
    main()
