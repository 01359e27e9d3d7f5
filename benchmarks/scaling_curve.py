"""North-star scaling curve: particle-steps/s vs particle count on a GPU.

Runs ``bench.py``'s workload — the generic ``ParticleFilter`` on the SV
model, T = 200, ESS-triggered systematic resampling — at N = 2¹⁴ … 2²²,
each timed with ``jax.block_until_ready`` after a warm-up of the same
shape. Needs a GPU: exits non-zero elsewhere.

Usage:  python benchmarks/scaling_curve.py [--out bench_out/scaling.json]
Prints one line per N and writes the rows as JSON.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import (  # noqa: E402
    ALPHA,
    BASELINE_PARTICLE_STEPS_PER_SEC,
    BETA,
    N_STEPS,
    SIGMA,
    make_sv_filter,
    sv_prior,
)
from particle_filters_jax.simulators import simulate_sv_1d  # noqa: E402
from particle_filters_jax.utils.device import (  # noqa: E402
    device_summary,
    enable_compile_cache,
    query_cards,
    require_gpu,
)
from particle_filters_jax.utils.timing import time_best  # noqa: E402


def measure(n_particles: int, zs) -> dict:
    pf = make_sv_filter(n_particles)
    state0 = pf.initialize(jax.random.key(0, impl="rbg"), *sv_prior())
    run = jax.jit(lambda k, s: pf.run(k, s, zs))
    best, first, (_, hist) = time_best(
        run, jax.random.key(2, impl="rbg"), state0
    )
    return {
        "n_particles": n_particles,
        "n_steps": N_STEPS,
        "seconds": best,
        "first_call_s": first,
        "ms_per_step": best / N_STEPS * 1e3,
        "particle_steps_per_sec": n_particles * N_STEPS / best,
        "resample_frac": float(jnp.mean(hist["resampled"])),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="bench_out/scaling.json")
    args = ap.parse_args()
    require_gpu()
    enable_compile_cache()
    card = query_cards()[0]
    sv = simulate_sv_1d(N_STEPS, ALPHA, SIGMA, BETA, seed=42)
    zs = jnp.asarray(sv.Y[:, None], jnp.float32)
    rows = []
    for logn in (14, 16, 18, 20, 22):
        r = measure(1 << logn, zs)
        r["log2_n"] = logn
        rows.append(r)
        print(
            f"N=2^{logn}: {r['particle_steps_per_sec']:.6e} particle-steps/s "
            f"({r['ms_per_step']:.6f} ms/step, resample "
            f"{r['resample_frac'] * 100:.0f}%) on {card[0]}, {card[1]}",
            flush=True,
        )
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"device": device_summary(), "card": card[0],
                   "power_limit": card[1],
                   "baseline": BASELINE_PARTICLE_STEPS_PER_SEC,
                   "rows": rows}, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
