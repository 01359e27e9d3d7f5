#!/usr/bin/env python
"""Phased test runner — run the suite in named phases.

Equivalent of reference ``tests/manual_run.py`` (a 797-line argparse
subprocess-pytest wrapper with ANSI formatting): select a phase with
``--phase`` and it shells out to pytest for that slice of the suite.

    python tests/manual_run.py --phase pf
    python tests/manual_run.py --phase all
    python tests/manual_run.py --list
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

PHASES = {
    "core": ["tests/unit/test_core.py"],
    "resampling": ["tests/unit/test_resampling.py"],
    "sim": ["tests/unit/test_simulators.py"],
    "kf": [
        "tests/unit/test_classical_filters.py::TestKF",
        "tests/unit/test_classical_filters_api.py::TestKFEdges",
        "tests/integration/test_kf_timevarying.py",
    ],
    "ekf": [
        "tests/unit/test_classical_filters.py::TestEKF",
        "tests/unit/test_classical_filters_api.py::TestEKFShapesAPI",
        "tests/unit/test_classical_filters_api.py::TestEKFInnovationAndGains",
        "tests/integration/test_ekf_vs_sv.py",
    ],
    "ukf": [
        "tests/unit/test_classical_filters.py::TestUKF",
        "tests/unit/test_classical_filters_api.py::TestUKFSigmaPointsAndWeights",
        "tests/unit/test_classical_filters_api.py::TestUKFShapesAPI",
        "tests/integration/test_ukf_vs_sv.py",
    ],
    "pf": [
        "tests/unit/test_particle_filter.py",
    ],
    "flows": [
        "tests/unit/test_flow_filters.py",
        "tests/unit/test_flow_filters_extra.py",
        "tests/unit/test_ledh_woodbury.py",
    ],
    "trackers": ["tests/unit/test_trackers.py"],
    "kpf": [
        "tests/unit/test_kpf.py",
        "tests/integration/test_kpf_vs_lgssm.py",
    ],
    "spf": [
        "tests/unit/test_spf.py",
        "tests/unit/test_spf_api.py",
        "tests/unit/test_spf_condition_number.py",
        "tests/integration/test_spf_vs_kalman_posterior.py",
    ],
    "dpf": [
        "tests/unit/test_dpf.py",
        "tests/unit/test_dpf_api.py",
        "tests/unit/test_grad_checks.py",
        "tests/integration/test_dpf_soft_vs_lgssm.py",
        "tests/integration/test_dpf_ot_vs_lgssm.py",
        "tests/integration/test_dpf_rnn_vs_lgssm.py",
        "tests/integration/test_dpf_rnn_training.py",
    ],
    "sharding": [
        "tests/unit/test_sharding.py",
        "tests/unit/test_distributed_resample.py",
    ],
    "utils": ["tests/unit/test_utils.py"],
    "unit": ["tests/unit"],
    "integration": ["tests/integration"],
    "sv": [
        "tests/unit/test_particle_filter.py::TestPFOnSV",
        "tests/unit/test_simulators.py::TestSV",
    ],
    "lorenz": [
        "tests/unit/test_simulators.py::TestLorenz96",
        "tests/unit/test_lorenz96_simulator.py",
        "tests/integration/test_kpf_lorenz96.py",
    ],
    "snlg": [
        "tests/unit/test_simulators.py::TestSNLG",
        "tests/unit/test_snlg_simulator.py",
        "tests/integration/test_filters_snlg.py",
    ],
    "skewt": [
        "tests/unit/test_simulators.py::TestSkewT",
        "tests/unit/test_skewt_simulator.py",
        "tests/unit/test_skewt_io_and_configs.py",
        "tests/integration/test_filters_skewt.py",
    ],
    "mat": [
        "tests/unit/test_simulators.py::TestMAT",
        "tests/unit/test_mat_simulator.py",
        "tests/integration/test_filters_mat.py",
    ],
    "parity": ["tests/parity/test_vs_reference.py"],
    "all": ["tests"],
}

BOLD, GREEN, RED, RESET = "\033[1m", "\033[92m", "\033[91m", "\033[0m"


def run_phase(name: str, extra: list[str]) -> int:
    targets = PHASES[name]
    print(f"{BOLD}=== phase: {name} → {' '.join(targets)} ==={RESET}")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", *targets, *extra]
    )
    dt = time.time() - t0
    color = GREEN if proc.returncode == 0 else RED
    status = "PASSED" if proc.returncode == 0 else "FAILED"
    print(f"{color}{BOLD}phase {name}: {status} in {dt:.1f}s{RESET}")
    return proc.returncode


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--phase",
        choices=sorted(PHASES),
        default="all",
        help="named test phase to run",
    )
    parser.add_argument(
        "--list", action="store_true", help="list phases and exit"
    )
    args, extra = parser.parse_known_args()
    if args.list:
        for name, targets in sorted(PHASES.items()):
            print(f"{name:12s} -> {' '.join(targets)}")
        return 0
    return run_phase(args.phase, extra)


if __name__ == "__main__":
    sys.exit(main())
