"""Tracing, spans and counters, and frame timing.

Counterpart of the JAX package's `utils/profiling.py`, with the port's own
spans and counters:

  * `trace(logdir)`: a context manager around `torch.profiler` (host and,
    on a card, device activity) that writes a Chrome trace into `logdir`
    (open it in chrome://tracing or Perfetto) and the program's span table
    beside it (`span_table.json`, `recorded()`);
  * `span(name)`, a context manager and decorator, and `count(name, n)`:
    the program's spans and counters.  They record only while a
    `torch.profiler` records (this module's `trace()` or any other);
    otherwise a span costs one check of the profiler's flag and records
    nothing.  A span opens a `record_function` range of its name, so it
    sits in the device trace on the profiler's clock, and records its
    parent (the innermost span open on its thread; on autograd's thread,
    the innermost one of the thread that opened the frame or step), its
    unit (frames and steps are roots: each root span starts a new unit),
    its host times and, where CUDA is in use, a pair of timing events on
    the current stream, resolved only when read.  A span opened inside one
    of its own name counts once.  While a root span records on a card,
    CUDA's sync debug mode counts the calls that wait for the card into
    `gvrt.host_syncs`.  `recorded()` reads the record as a table,
    `reset()` empties it;
  * `FrameTimer`: steady-state frame timing with a warmup, reporting
    mean/best/worst ms and fps, with a device fence per frame;
  * `device_sync(x)`: the fence, a device-to-host read of one element of
    the first tensor in `x` (PyTorch returns before the card finishes).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

#: the counter of the calls inside a frame or step that wait for the card,
#: as CUDA's sync debug mode reports them
HOST_SYNCS = "gvrt.host_syncs"
_SYNC_WARNING = "called a synchronizing CUDA operation"
_warned = {}   # where the warnings passed on have shown, as `warnings` keeps

_local = threading.local()   # .stack: this thread's open spans
_lock = threading.Lock()
_ids = itertools.count()
_closed = []                 # (name, id, parent id, unit, t0, t1, ev0, ev1)
_counts = {}                 # name -> [int total, [0-d tensors]]
_roots = {}                  # root span name -> units opened
_open = 0                    # spans entered and not yet left, every thread
_unit = 0
_unit_stack = None           # the open spans of the thread whose unit runs


class _SyncWatch:
    """From a root span's opening to its closing, CUDA's sync debug mode
    warns of every call that waits for the card; the warnings are counted
    into `HOST_SYNCS` and, where the mode was already on, passed on with
    every other warning."""
    __slots__ = ("mode", "catch", "log")

    def __init__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        self.catch = warnings.catch_warnings(record=True)
        self.log = self.catch.__enter__()
        warnings.simplefilter("always")
        if self.mode == 0:
            torch.cuda.set_sync_debug_mode(1)

    def close(self):
        torch.cuda.set_sync_debug_mode(self.mode)
        self.catch.__exit__(None, None, None)
        n = 0
        for w in self.log:
            synced = _SYNC_WARNING in str(w.message)
            n += synced
            if self.mode or not synced:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno, registry=_warned,
                                       source=w.source)
        if n:
            count(HOST_SYNCS, n)


class _Frame:
    __slots__ = ("name", "id", "parent", "unit", "rf", "t0", "ev0",
                 "merged", "syncs")


def _enter(name: str):
    """Open the span `name` on this thread, or merge it into the open span
    of its own name."""
    global _open, _unit, _unit_stack
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    with _lock:
        _open += 1
        if stack and stack[-1].name == name:
            stack[-1].merged += 1
            return
        if stack:
            parent = stack[-1]
        else:
            parent = _unit_stack[-1] if _unit_stack else None
        if parent is None:
            _unit += 1
            _unit_stack = stack
            _roots[name] = _roots.get(name, 0) + 1
        f = _Frame()
        f.name, f.id, f.merged = name, next(_ids), 0
        f.parent = None if parent is None else parent.id
        f.unit = _unit
    f.rf = _autograd_profiler.record_function(name)
    f.rf.__enter__()
    f.ev0 = f.syncs = None
    if torch.cuda.is_initialized():
        if parent is None:
            f.syncs = _SyncWatch()
        f.ev0 = torch.cuda.Event(enable_timing=True)
        f.ev0.record()
    f.t0 = time.perf_counter()
    stack.append(f)


def _leave(name: str):
    global _open
    stack = getattr(_local, "stack", None)
    if not stack or stack[-1].name != name:   # entered while off
        return
    f = stack[-1]
    with _lock:
        _open -= 1
        if f.merged:
            f.merged -= 1
            return
    t1 = time.perf_counter()
    ev1 = None
    if f.ev0 is not None:
        ev1 = torch.cuda.Event(enable_timing=True)
        ev1.record()
    stack.pop()
    f.rf.__exit__(None, None, None)
    if f.syncs is not None:
        f.syncs.close()
    _closed.append((f.name, f.id, f.parent, f.unit, f.t0, t1, f.ev0, ev1))


class _Span:
    """One span name: a context manager, and a decorator of functions."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            _enter(self.name)
        return self

    def __exit__(self, *exc):
        if _open:
            _leave(self.name)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            _enter(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _leave(name)
        return spanned


_spans = {}


def span(name: str) -> _Span:
    """The span `name`: `with span(name): ...` or `@span(name)`."""
    s = _spans.get(name)
    if s is None:
        s = _spans[name] = _Span(name)
    return s


def count(name: str, n=1):
    """Add `n` to the counter `name` while a profiler records.  `n` may be
    a 0-d device tensor: it is kept and summed when the record is read,
    never read here."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _lock:
        c = _counts.get(name)
        if c is None:
            c = _counts[name] = [0, []]
        if isinstance(n, torch.Tensor):
            c[1].append(n.detach())
        else:
            c[0] += int(n)


def _count_total(c) -> int:
    total, tensors = c
    by_dev = {}
    for t in tensors:
        by_dev.setdefault(t.device, []).append(t.reshape(()).long())
    for ts in by_dev.values():
        total += int(torch.stack(ts).sum())
    return total


def recorded() -> dict:
    """The record since the last `reset()`: {"spans": {name: {calls,
    host_ms, device_ms (None without CUDA), self_host_ms}}, "counts":
    {name: total}, "units": {root span name: units}}.  A span's self time
    is its duration less its children's.  Reading waits for the device
    once, to resolve the timing events."""
    closed = list(_closed)
    if any(ev0 is not None for *_, ev0, _ in closed):
        torch.cuda.synchronize()
    inner = {}
    for _, _, parent, _, t0, t1, _, _ in closed:
        if parent is not None:
            inner[parent] = inner.get(parent, 0.0) + (t1 - t0)
    spans = {}
    for name, sid, _, _, t0, t1, ev0, ev1 in closed:
        row = spans.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                      "device_ms": None,
                                      "self_host_ms": 0.0})
        row["calls"] += 1
        row["host_ms"] += 1e3 * (t1 - t0)
        row["self_host_ms"] += 1e3 * (t1 - t0 - inner.get(sid, 0.0))
        if ev0 is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + \
                ev0.elapsed_time(ev1)
    return {"spans": spans,
            "counts": {k: _count_total(c) for k, c in _counts.items()},
            "units": dict(_roots)}


def reset():
    """Empty the record (spans open now still close into the next one)."""
    global _unit
    with _lock:
        _closed.clear()
        _counts.clear()
        _roots.clear()
        _unit = 0


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
    present) and write `logdir/trace.json` (Chrome trace format) and
    `logdir/span_table.json`, the program's spans and counters over the
    block (`recorded()`; the record is reset on entry).  Yields the
    profiler, whose `key_averages()` sums time by op."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "span_table.json"), "w") as f:
        json.dump(recorded(), f, indent=1, sort_keys=True)


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
