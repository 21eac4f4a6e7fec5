"""Checkpoint and resume of the full algorithm state.

Counterpart of the JAX package's `utils/checkpoint.py`. One checkpoint
holds the whole state at an outer-loop boundary: the stacked client
parameters, a BatchNorm model's statistics, the loop cursor and the
per-group ADMM rho store. That is the complete state there: the L-BFGS
history and the consensus y and z start fresh in every group round, rho
is the one consensus quantity that outlives a round, and each epoch's
shuffle is a function of (seed, loop indices) alone. So a resumed run
replays the trajectory the uninterrupted run takes.

A checkpoint is one `torch.save` file, `directory/step_N`, of CPU tensors
and plain ints; it is read with `torch.load(..., map_location="cpu",
weights_only=True)`, so one written on the card loads on the CPU. Writes
are atomic: the file is staged as `directory/.tmp_step_N`, then
`os.replace`d onto its name, which also overwrites an older checkpoint of
the same step. The loader falls back past unreadable checkpoints, so a
crash at any instant of a run leaves a resumable directory.

Unlike the JAX package's writer this one has no orbax tree and no
bounded retry of storage faults: the fault package (`fault/io.py`) is not
ported yet.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Optional

import torch


def checkpoint_path(directory: str, step: int) -> str:
    """The one place that knows the `directory/step_N` layout."""
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def _list_steps(root: str) -> list:
    # staging files (".tmp_step_N") do not match by construction
    return sorted(
        int(d.split("_", 1)[1])
        for d in (os.listdir(root) if os.path.isdir(root) else [])
        if d.startswith("step_") and d.split("_", 1)[1].isdigit()
    )


def _to_cpu(state: Any) -> Any:
    if isinstance(state, dict):
        return {k: _to_cpu(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.detach().cpu().clone()
    return state


def save_checkpoint(directory: str, state: dict, *, step: int) -> str:
    """Atomically write `state` (nested dicts of tensors and ints) as
    `directory/step_N`, replacing any checkpoint of that step. Returns the
    checkpoint's path."""
    root = os.path.abspath(directory)
    path = checkpoint_path(directory, step)
    tmp = os.path.join(root, f".tmp_step_{step}")
    os.makedirs(root, exist_ok=True)
    with open(tmp, "wb") as f:
        torch.save(_to_cpu(state), f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(directory: str, *, step: Optional[int] = None) -> dict:
    """Load the checkpoint at `step`, or the newest readable one if None.

    With `step=None` an unreadable checkpoint (a torn file, a directory
    in its place) is skipped with a warning and the next-newest is tried.
    With an explicit `step` its error propagates: the caller named that
    checkpoint. Raises FileNotFoundError when nothing can be restored.
    """
    root = os.path.abspath(directory)
    if step is not None:
        path = checkpoint_path(directory, step)
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return _load(path)
    steps = _list_steps(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    for s in reversed(steps):
        path = checkpoint_path(directory, s)
        try:
            return _load(path)
        except Exception as e:  # torch.load raises several types on a torn file
            warnings.warn(
                f"skipping unreadable checkpoint {path}: {type(e).__name__}: {e}; falling back to the next-newest"
            )
    raise FileNotFoundError(f"no readable checkpoint under {root} (tried steps {steps})")
