"""What a traced run reads from the program: spans around named
attributes of its modules, its kernels' launch counters, and the device
trace of `torch.profiler`.

Spans are recorded by the benchmark's own wrappers, installed where the
program's path looks the names up (`spans.json`); each call is fenced by
CUDA events on the current stream, or read on the host's clock where the
entry says `"clock": "host"` (work the host does itself), and marked in
the device trace by a `record_function` range of the span's name.  The kernel
table (`kernels.json`) names each kernel as the device trace shows it and
the counter of its launches.  A name that has gone leaves its metric
absent and is reported on standard error.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import sys
import tempfile
import time

import torch

PKG = "gvrt_tpu_torch"
HERE = os.path.dirname(os.path.abspath(__file__))


def load_table(name: str) -> dict:
    with open(os.path.join(HERE, name)) as f:
        return json.load(f)


def resolve(module: str, attr: str):
    """(owner, last name) of `attr` (dotted) in the program's `module`;
    raises AttributeError or ImportError when a name has gone."""
    obj = importlib.import_module(f"{PKG}.{module}")
    parts = attr.split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    getattr(obj, parts[-1])
    return obj, parts[-1]


def read_counter(entry: dict):
    """The current value of a launch counter, or None (said on standard
    error) when it has gone."""
    try:
        owner, name = resolve(entry["module"], entry["attr"])
    except (AttributeError, ImportError):
        print(f"portbench: counter {entry['module']}:{entry['attr']} has "
              f"gone", file=sys.stderr)
        return None
    return getattr(owner, name)


class Spans:
    """Wraps every attribute of the span table; `on` turns recording on."""

    def __init__(self, table: dict, device: torch.device):
        self.cuda = device.type == "cuda"
        self.on = False
        self.calls = {name: [] for name in table}
        self.missing = {}
        self._undo = []
        for name, entries in table.items():
            for e in entries:
                try:
                    owner, attr = resolve(e["module"], e["attr"])
                except (AttributeError, ImportError):
                    self.missing[name] = f"{e['module']}:{e['attr']}"
                    print(f"portbench: span {name}: {self.missing[name]} "
                          f"has gone", file=sys.stderr)
                    continue
                orig = (owner.__dict__.get(attr, getattr(owner, attr))
                        if isinstance(owner, type) else getattr(owner, attr))
                host = e.get("clock") == "host" or not self.cuda
                setattr(owner, attr, self._wrap(name, orig, host))
                self._undo.append((owner, attr, orig))

    def _wrap(self, name, fn, host: bool):
        calls = self.calls[name]

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                if host:
                    start = time.perf_counter()
                    out = fn(*args, **kwargs)
                    end = time.perf_counter()
                else:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*args, **kwargs)
                    end.record()
            calls.append((start, end))
            return out
        return wrapper

    def remove(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []

    def total_ms(self, name: str):
        """Milliseconds inside the span over the recorded calls; None when
        a name of it has gone or nothing called it."""
        if name in self.missing or not self.calls.get(name):
            return None
        if self.cuda:
            torch.cuda.synchronize()
        return sum(1e3 * (e - s) if isinstance(s, float) else
                   s.elapsed_time(e) for s, e in self.calls[name])


def _union_us(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between the merged intervals as (start, end)."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


class DeviceTrace:
    """`torch.profiler` over a stretch of the window, read from its Chrome
    trace: kernel intervals, their union, the top device operations and
    the longest idle gaps labelled by the host operation running then."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.window_s = None
        self.kernels = []   # (ts, dur, name), microseconds
        self.host_ops = []  # (ts, dur, name)

    def start(self):
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()

    def read(self):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.remove(path)
        events = events.get("traceEvents", events) if isinstance(
            events, dict) else events
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            item = (float(e["ts"]), float(e["dur"]), str(e.get("name", "")))
            cat = e.get("cat", "")
            if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                self.kernels.append(item)
            elif cat in ("cpu_op", "user_annotation", "python_function"):
                self.host_ops.append(item)
        self.kernels.sort()
        return self

    @property
    def busy_s(self):
        return _union_us([(t, t + d) for t, d, _ in self.kernels])[0] / 1e6

    def kernel_ms(self, substring: str, count: int):
        """Device ms of the first `count` kernels whose name holds
        `substring`; None unless the trace has that many."""
        hits = [d for _, d, n in self.kernels if substring in n][:count]
        if count <= 0 or len(hits) < count:
            return None
        return sum(hits) / 1e3

    def breakdown(self, top: int = 10):
        by_name = {}
        for _, d, n in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        _, gaps = _union_us([(t, t + d) for t, d, _ in self.kernels])
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        labelled = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inner = [(d, n) for t, d, n in self.host_ops if t <= mid <= t + d]
            label = min(inner)[1] if inner else "(no host op)"
            labelled.append([label, (e - s) / 1e6])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": labelled}
