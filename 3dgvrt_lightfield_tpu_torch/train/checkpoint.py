"""Checkpoint / resume for the fine-tune loop.

Counterpart of the JAX package's `train/checkpoint.py`, with `torch.save`
in place of orbax.  Layout on disk:

    <dir>/step_<N>/state.pt   {"model": six leaves, "opt_state": optimizer
                               state_dict, "step": N}
    <dir>/latest.txt          step number of the newest complete checkpoint

Both are written atomically: the step directory is filled under a temporary
name and renamed into place, and `latest.txt` is replaced by a rename, so a
crash leaves the previous checkpoint intact.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Optional, Tuple

import torch

from ..models.gaussians import LEAVES, GaussianModel

_STATE = "state.pt"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, state: Tuple[GaussianModel, Any],
                    step: int) -> str:
    """Save (model, optimizer) at `step`; returns the checkpoint path."""
    model, optimizer = state
    root = os.path.abspath(ckpt_dir)
    os.makedirs(root, exist_ok=True)
    path = _step_dir(root, step)
    tmp = tempfile.mkdtemp(prefix=f".step_{step:08d}.", dir=root)
    torch.save({"model": {k: getattr(model, k).detach().cpu()
                          for k in LEAVES},
                "opt_state": optimizer.state_dict(), "step": int(step)},
               os.path.join(tmp, _STATE))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    marker = os.path.join(root, "latest.txt")
    with open(marker + ".tmp", "w") as f:
        f.write(str(step))
    os.replace(marker + ".tmp", marker)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    marker = os.path.join(ckpt_dir, "latest.txt")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def restore_checkpoint(ckpt_dir: str, state: Tuple[GaussianModel, Any],
                       step: Optional[int] = None):
    """Restore into the given (model, optimizer), in place.

    Returns (state, step), or (state, None) if no checkpoint exists."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            return state, None
    model, optimizer = state
    saved = torch.load(os.path.join(_step_dir(ckpt_dir, step), _STATE),
                       map_location="cpu", weights_only=True)
    with torch.no_grad():
        for k in LEAVES:
            getattr(model, k).copy_(saved["model"][k])
    optimizer.load_state_dict(saved["opt_state"])
    return (model, optimizer), int(saved["step"])
