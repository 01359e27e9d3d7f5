"""Checkpoint / resume for filter state (orbax-backed).

The reference persists only datasets (.npz); filter state is never
checkpointable (SURVEY.md §5.4). For long runs this module saves and
restores any pytree filter carry (PFState, FlowPFState + TrackerState, DPF
particles/weights, resampler params) with orbax, so a filtering or training
run can resume mid-sequence.
"""

from __future__ import annotations

import os
from typing import Any, Optional


def save_checkpoint(path: str, state: Any, step: Optional[int] = None) -> str:
    """Save a pytree ``state`` to ``path`` (optionally under a step subdir).

    Returns the directory written. Uses orbax's PyTreeCheckpointer.
    """
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step:08d}")
    ckpt = ocp.PyTreeCheckpointer()
    ckpt.save(path, state, force=True)
    return path


def restore_checkpoint(path: str, template: Any = None, step: Optional[int] = None) -> Any:
    """Restore a pytree from ``path``; ``template`` (a matching pytree of
    arrays) restores exact dtypes/shapes/custom dataclasses."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step:08d}")
    ckpt = ocp.PyTreeCheckpointer()
    if template is not None:
        return ckpt.restore(path, args=ocp.args.PyTreeRestore(item=template))
    return ckpt.restore(path)


def latest_step(path: str) -> Optional[int]:
    """Largest step_XXXXXXXX subdirectory under ``path``, or None."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(path)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    return max(steps) if steps else None
