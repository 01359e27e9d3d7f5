"""The ops/ Triton kernels against their plain-JAX twins and candidates, on
a GPU.

Everything is timed inside a 200-step ``lax.scan`` at N = 2²⁰ and 2²², with
``jax.block_until_ready`` after a warm-up of the same shape; the variants
of one comparison run in turn, in forward then reverse order:

- resample widths: a scan that propagates (one elementwise pass over the
  (N, d) state), weights and resamples every step, with the value
  resample through ``resampling.hard`` (the Triton gather) or the plain
  path (integer scatter + prefix sum + ``jnp.take``), at each state width
  of ``--widths``;
- resample candidates, d = 1: the plain path, the same with ``jnp.cumsum``
  in place of ``core.block_cumsum``, a telescoping float scatter + cumsum
  of value differences, ``jnp.searchsorted`` on the CDF + ``jnp.take``,
  and the Triton gather;
- agreement: for each width, whether the Triton and plain scans end on the
  same bits, and per-step checksums (bit patterns summed as integers, so
  the checksum does not depend on summation order) of the state after the
  propagate, the normalised weights and the resampled state, naming the
  first step and stage at which the two programs part; and whether one
  compiled program gives the same bits twice;
- end to end: ``ParticleFilter.run`` with the plain or the Triton
  resample, and ``FusedSIRFilter.run`` (fused Triton step + Triton
  resample);
- one short profiler trace per end-to-end variant at N = 2²⁰: device
  kernel events per step and the device's busy share of the window.

Usage (GPU only; exits non-zero elsewhere):
    python benchmarks/kernels_vs_plain.py [--sizes 20,22] [--widths 1,4,8,16,64,144]
Prints one JSON line per measurement and writes bench_out/kernels.json.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from bench import (  # noqa: E402
    ALPHA,
    BETA,
    SIGMA,
    make_sv_filter,
    make_sv_fused_filter,
    sv_prior,
)
from particle_filters_jax.core.weights import log_normalize  # noqa: E402
from particle_filters_jax.resampling import hard  # noqa: E402

T_STEPS = 200


# -- value resamples: (key, particles, normalised weights) -> particles ------


def sel_triton(key, p, w):
    """``resampling.hard``: the Triton gather on CUDA."""
    starts = hard._systematic_starts(key, w, w.shape[0])
    return hard.resample_values_from_starts(starts, p)


def sel_plain(key, p, w):
    """Integer scatter + ``blocked_cumsum`` + take (the non-CUDA path)."""
    starts = hard._systematic_starts(key, w, w.shape[0])
    return jnp.take(p, hard._ancestors_from_starts(starts, p.shape[0]), axis=0)


def sel_jnp_cumsum(key, p, w):
    """Integer scatter + ``jnp.cumsum`` + take."""
    n = p.shape[0]
    starts = hard._systematic_starts(key, w, n)
    marks = jnp.zeros((n,), jnp.int32).at[starts].add(
        1, indices_are_sorted=True, mode="drop")
    return jnp.take(p, jnp.cumsum(marks) - 1, axis=0)


def sel_telescoping(key, p, w):
    """Scatter p_j − p_{j−1} at each run start, then a float cumsum over
    rows (not exact: rounding in the cumsum)."""
    starts = hard._systematic_starts(key, w, w.shape[0])
    diffs = jnp.diff(p, axis=0, prepend=jnp.zeros_like(p[:1]))
    acc = jnp.zeros_like(p).at[starts].add(
        diffs, indices_are_sorted=True, mode="drop")
    return jnp.cumsum(acc, axis=0)


def sel_searchsorted(key, p, w):
    """``jnp.searchsorted`` of the systematic positions into the CDF."""
    n = w.shape[0]
    u = jax.random.uniform(key, (), w.dtype)
    pos = (u + jnp.arange(n, dtype=w.dtype)) / n
    return jnp.take(p, hard._inverse_cdf(jnp.cumsum(w), pos), axis=0)


def _checksum(a):
    """Sum of the bit patterns as int32 (wrapping): equal arrays give equal
    checksums whatever the summation order."""
    return jnp.sum(lax.bitcast_convert_type(a, jnp.int32), dtype=jnp.int32)


def forced_resample_scan(select, checksums=False):
    """T steps of propagate → weight → resample (every step), the carry fed
    back, so the resample is timed where it runs and cannot be elided. The
    propagate draws one normal per particle and moves every column with
    it, so at wide states it stays one elementwise pass. Per step it
    outputs x[0, 0] after the propagate, or with ``checksums`` the
    checksums of the propagated state, the weights and the resampled
    state."""

    def run(key, x0, zs):
        keys = jax.random.split(key, zs.shape[0])

        def body(x, inp):
            k, z = inp
            k1, k2 = jax.random.split(k)
            eps = jax.random.normal(k1, (x.shape[0],))
            x = ALPHA * x + SIGMA * eps[:, None]
            var = BETA**2 * jnp.exp(x[:, 0])
            logw = -0.5 * (z[0] ** 2 / var + jnp.log(var))
            w = jnp.exp(log_normalize(logw)[0])
            out = select(k2, x, w)
            if checksums:
                return out, jnp.stack(
                    [_checksum(x), _checksum(w), _checksum(out)])
            return out, x[0, 0]

        return lax.scan(body, x0, (keys, zs))

    return jax.jit(run)


def generic_with(n, resample_fn):
    pf = make_sv_filter(n)
    if resample_fn is not None:
        pf._resample_values = lambda k, p, lw: resample_fn(
            k, p, jnp.exp(log_normalize(lw)[0]))
    return pf


def _time_all(fns, args, reps):
    """Best time of each jitted fn over ``reps`` rounds, each round running
    every fn once, in forward order on even rounds and reverse on odd."""
    outs = [jax.block_until_ready(f(*args)) for f in fns]
    best = [float("inf")] * len(fns)
    order = list(range(len(fns)))
    for r in range(reps):
        for i in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            outs[i] = jax.block_until_ready(fns[i](*args))
            best[i] = min(best[i], time.perf_counter() - t0)
    return best, outs


def _first_difference(a, b):
    """Index of the first row where a and b differ, or None."""
    diff = np.nonzero(np.any(np.asarray(a).reshape(len(a), -1)
                             != np.asarray(b).reshape(len(b), -1), axis=1))[0]
    return int(diff[0]) if diff.size else None


def trace_summary(fn, args, trace_dir):
    """Kernel events on the device stream and busy share of the window."""
    jax.block_until_ready(fn(*args))
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn(*args))
    path = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    ivs, names = [], {}
    for plane in jax.profiler.ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                ivs.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                names[ev.name] = names.get(ev.name, 0) + 1
    ivs.sort()
    busy, cur = 0.0, None
    for s, e in ivs:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    window = ivs[-1][1] - ivs[0][0] if ivs else 0.0
    return {
        "kernel_events_per_step": len(ivs) / T_STEPS,
        "busy_share": busy / window if window else None,
        "top_kernels": sorted(names.items(), key=lambda kv: -kv[1])[:12],
    }


CANDIDATES = {
    "plain": sel_plain,
    "jnp_cumsum": sel_jnp_cumsum,
    "telescoping": sel_telescoping,
    "searchsorted": sel_searchsorted,
    "triton": sel_triton,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="20,22")
    ap.add_argument("--widths", default="1,4,8,16,64,144")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    from particle_filters_jax.simulators import simulate_sv_1d
    from particle_filters_jax.utils.device import (
        enable_compile_cache,
        query_cards,
        require_gpu,
    )

    require_gpu()
    enable_compile_cache()
    card = query_cards()[0]
    sv = simulate_sv_1d(T_STEPS, ALPHA, SIGMA, BETA, seed=42)
    zs = jnp.asarray(sv.Y[:, None], jnp.float32)
    x_true = np.asarray(sv.X)
    results = []

    def emit(rec):
        rec.update(card=card[0], power_limit=card[1])
        results.append(rec)
        print(json.dumps(rec), flush=True)

    def rmse(hist):
        return float(np.sqrt(np.mean(
            (np.asarray(hist["mean"][:, 0]) - x_true) ** 2)))

    key = jax.random.PRNGKey(7)
    for lg in [int(s) for s in args.sizes.split(",")]:
        n = 1 << lg
        for d in [int(s) for s in args.widths.split(",")]:
            x0 = jax.random.normal(jax.random.PRNGKey(3), (n, d)) * 0.64
            scan_args = (key, x0, zs)
            fns = [forced_resample_scan(sel_plain),
                   forced_resample_scan(sel_triton)]
            (t_p, t_k), (o_p, o_k) = _time_all(fns, scan_args, args.reps)
            again = jax.block_until_ready(fns[1](*scan_args))
            c_p, c_k = (jax.device_get(forced_resample_scan(f, True)(
                *scan_args)[1]) for f in (sel_plain, sel_triton))
            first = {stage: _first_difference(c_p[:, i], c_k[:, i])
                     for i, stage in enumerate(("propagate", "weights",
                                                "resampled"))}
            emit({"what": "resample_width", "n": n, "d": d, "T": T_STEPS,
                  "plain_ms_per_step": t_p / T_STEPS * 1e3,
                  "triton_ms_per_step": t_k / T_STEPS * 1e3,
                  "bit_identical": bool(np.array_equal(
                      np.asarray(o_p[0]), np.asarray(o_k[0]))),
                  "first_step_x00_differs": _first_difference(
                      o_p[1][:, None], o_k[1][:, None]),
                  "checksum_first_difference": first,
                  "triton_repeat_bit_identical": bool(np.array_equal(
                      np.asarray(o_k[0]), np.asarray(again[0])))})
            del x0, o_p, o_k, again

        x0 = jax.random.normal(jax.random.PRNGKey(3), (n, 1)) * 0.64
        names = list(CANDIDATES)
        times, outs = _time_all(
            [forced_resample_scan(CANDIDATES[k]) for k in names],
            (key, x0, zs), args.reps)
        ref = np.asarray(outs[names.index("plain")][0])
        emit({"what": "resample_candidates", "n": n, "d": 1, "T": T_STEPS,
              "ms_per_step": {k: t / T_STEPS * 1e3
                              for k, t in zip(names, times)},
              "final_max_abs_diff_vs_plain": {
                  k: float(np.max(np.abs(np.asarray(o[0]) - ref)))
                  for k, o in zip(names, outs)}})
        del outs

        state0 = make_sv_filter(n).initialize(jax.random.PRNGKey(0),
                                              *sv_prior())
        runs = {
            "generic_plain_resample": generic_with(n, sel_plain),
            "generic_triton_resample": generic_with(n, None),
            "fused_triton": make_sv_fused_filter(n),
        }
        jitted = {k: jax.jit(lambda k_, s, pf=pf: pf.run(k_, s, zs))
                  for k, pf in runs.items()}
        names = list(jitted)
        times, outs = _time_all([jitted[k] for k in names], (key, state0),
                                args.reps)
        emit({"what": "e2e", "n": n, "T": T_STEPS,
              "ms_per_step": {k: t / T_STEPS * 1e3
                              for k, t in zip(names, times)},
              "rmse": {k: rmse(o[1]) for k, o in zip(names, outs)},
              "resample_frac": {k: float(jnp.mean(o[1]["resampled"]))
                                for k, o in zip(names, outs)},
              # The two ParticleFilter programs differ only in the
              # resample: the first step at which each history field
              # parts says whether the weights (ess, log_evidence) or the
              # resampled cloud (mean, cov) parted first.
              "plain_vs_triton_first_difference": {
                  f: _first_difference(outs[0][1][f], outs[1][1][f])
                  for f in ("ess", "log_evidence", "mean", "cov",
                            "resampled")},
              "plain_resampled_steps": np.nonzero(np.asarray(
                  outs[0][1]["resampled"]))[0].tolist()})
        if n == 1 << 20:
            for name, fn in jitted.items():
                emit({"what": "trace", "variant": name, "n": n, **trace_summary(
                    fn, (key, state0), os.path.join("bench_out", "trace",
                                                    name))})

    os.makedirs("bench_out", exist_ok=True)
    with open("bench_out/kernels.json", "w") as f:
        json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
