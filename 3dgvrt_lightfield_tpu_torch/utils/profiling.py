"""Tracing and frame timing.

Counterpart of the JAX package's `utils/profiling.py`:

  * `trace(logdir)`: a context manager around `torch.profiler` (host and,
    on a card, device activity) that writes a Chrome trace into `logdir`
    (open it in chrome://tracing or Perfetto);
  * `FrameTimer`: steady-state frame timing with a warmup, reporting
    mean/best/worst ms and fps, with a device fence per frame;
  * `device_sync(x)`: the fence, a device-to-host read of one element of
    the first tensor in `x` (PyTorch returns before the card finishes).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch


def _first_tensor(x):
    """The first tensor of a tensor, dict, tuple/list or module."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, torch.nn.Module):
        x = list(x.parameters())
    elif isinstance(x, dict):
        x = list(x.values())
    for item in x if isinstance(x, (list, tuple)) else ():
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def device_sync(x):
    """Wait for the computation of `x` (a D2H read of one element of its
    first tensor) and return `x`."""
    t = _first_tensor(x)
    if t is not None and t.numel():
        t.detach().reshape(-1)[0].item()
    return x


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with `torch.profiler` (CPU, and CUDA when a card is
    present) and write `logdir/trace.json` (Chrome trace format).  Yields
    the profiler, whose `key_averages()` sums time by op."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@dataclass
class FrameTimer:
    """Per-frame wall-clock timing with warmup (the reference viewer's
    calculateFPS)."""
    warmup: int = 2
    _times: List[float] = field(default_factory=list)
    _seen: int = 0
    _t0: float = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self._times.append(dt)
        return False

    def frame(self, fn, *args):
        """Run fn(*args), sync, and record the frame time."""
        with self:
            out = device_sync(fn(*args))
        return out

    @property
    def frame_times_ms(self) -> np.ndarray:
        return np.asarray(self._times) * 1e3

    def summary(self) -> dict:
        t = self.frame_times_ms
        if len(t) == 0:
            return {"frames": 0}
        return {
            "frames": len(t),
            "mean_ms": float(t.mean()),
            "best_ms": float(t.min()),
            "worst_ms": float(t.max()),
            "fps": float(1e3 / t.mean()),
        }
