"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the numbers of the result line.

Everything that belongs to one cell is found by name: the configuration
(`configs/<config>.json`), the traffic mix (`traffic/<mix>.json`, read
by `generator.py`), the limits (`limits/<cell>.json`), the program's
entry that the mix names (`entries/<entry>.py`) and, for each kernel of
the kernel table, the bound its roofline share is taken against
(`bounds/<bound>.py`).  A new cell, entry or kernel metric is new files
and table entries; this module stays as it is.

An entry module defines `Session(ctx)`, whose constructor does the set-up
(the scene drawn from the seed on the device, the program's objects built
as a user's path builds them, every shape of the window warmed up), and
whose methods are `start()` (just before the window), `unit(i)` (one
frame or step; returns its failures and leaves the views it used in
`unit_views`), `release()` (drops the program's state once the window has
closed), `readings(control)` (the compared numbers, the reference's work)
and `bound_leaves()` (the parameters the roofline sample ran on).  Its
`SYNC_EACH_UNIT` says whether each unit ends on the host's wait for the
device (a viewer's closed loop) or only the window does.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import counts as cnt
from . import trace as tr
from .reference import binning as ref_bin
from .reference import camera as ref_cam
from .reference import composite as ref_comp
from .reference.math import Settings, activate, param_rows, response_cutoff

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    entry: dict          # the workload's entry of BENCHMARK.json
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list     # metric entries that this cell reports untraced
    per_layer: list      # metric entries that this cell reports traced


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench: dict = None, root: str = ROOT) -> Cell:
    """The cell named `workload`, with its configuration, traffic mix and
    limits found by name."""
    if bench is None:
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {workload!r}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", entry["traffic"] + ".json")) as f:
        traffic = json.load(f)
    with open(os.path.join(HERE, "limits", workload + ".json")) as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    layers = [m for m in bench["per_layer"] if _reports(m, workload)]
    return Cell(workload, entry, config, traffic, limits, e2e, layers)


def load_module(folder: str, name: str):
    """`portbench/<folder>/<name>.py` as a module, or None when there is no
    such file."""
    path = os.path.join(HERE, folder, name + ".py")
    if not os.path.isfile(path):
        return None
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def settings(config: dict) -> Settings:
    return Settings(**config.get("render", {}))


def size(config: dict):
    """(width, height) of the configuration's images."""
    w, h = config["resolution"]
    return int(w), int(h)


def log(msg: str):
    """A progress line on standard error, with the process's clock."""
    print(f"portbench: {time.perf_counter():.2f} {msg}", file=sys.stderr,
          flush=True)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def camera(gt, view):
    """The program's Camera of a reference View."""
    return gt.Camera.from_fovy(view.width, view.height, view.fovy_deg,
                               view.c2w)


def render_config(gt, config):
    r = config.get("render", {})
    return gt.RenderConfig(**{k: r[k] for k in ("tile_size", "chunk_size")
                              if k in r})


@dataclass
class Context:
    """What an entry's session is given."""
    gt: object           # the program's package
    cell: Cell
    seed: int
    dev: torch.device
    trace: bool


@dataclass
class Window:
    """What the window and its traced stretch leave for the metrics."""
    units: int = 0
    started: float = 0.0   # perf_counter at the window's start
    seconds: float = 0.0
    latencies: list = field(default_factory=list)
    failed: int = 0
    spans: Optional[tr.Spans] = None
    device: Optional[tr.DeviceTrace] = None
    launches: dict = field(default_factory=dict)   # kernel -> sample count
    kernel_ms: dict = field(default_factory=dict)  # kernel -> sample ms
    bound_ms: dict = field(default_factory=dict)   # kernel -> sample ms


class Tracer:
    """Spans, launch counters and the profiler of a traced run."""

    def __init__(self, cell: Cell, dev: torch.device, win: Window):
        self.win, self.dev = win, dev
        self.sample = int(cell.traffic["roofline_sample"])
        self.stretch = float(cell.traffic["trace_seconds"])
        self.kernels = tr.load_table("kernels.json")
        win.spans = tr.Spans(tr.load_table("spans.json"), dev)
        self._before = None

    def _counters(self):
        return {k: tr.read_counter(v["launches"])
                for k, v in self.kernels.items()}

    def start(self):
        self.win.spans.on = True
        self._before = self._counters()
        if self.dev.type == "cuda":
            self.win.device = tr.DeviceTrace()
            self.win.device.start()

    def after_unit(self, done: int, elapsed: float):
        if done == self.sample:
            after = self._counters()
            self.win.launches = {
                k: after[k] - self._before[k] for k in after
                if after[k] is not None and self._before[k] is not None}
        dt = self.win.device
        if dt is not None and dt.window_s is None and done >= self.sample \
                and elapsed >= self.stretch:
            dt.stop()

    def finish(self):
        self.win.spans.on = False
        self.win.spans.remove()
        dt = self.win.device
        if dt is None:
            return
        if dt.window_s is None:
            dt.stop()
        dt.read()
        for k, v in self.kernels.items():
            n = self.win.launches.get(k, 0)
            if n:
                self.win.kernel_ms[k] = dt.kernel_ms(v["kernel"], n)
                if self.win.kernel_ms[k] is None:
                    log(f"kernel {k}: fewer than {n} {v['kernel']!r} in the "
                        f"device trace")


# ---- the yardstick of the roofline shares -----------------------------------

class Work:
    """What one sampled view's data needs of the tile kernels, worked out
    on the reference's side (its own binning and plain forward with the
    transmittance at every block's start); each bound reads what it needs,
    computed once."""

    def __init__(self, view, act, rows, st: Settings, dev):
        self.view, self.st = view, st
        w2c, proj = ref_cam.matrices(view, st)
        self.binned = ref_bin.bin_frame(act, w2c, proj, view.width,
                                        view.height, st)
        self.rays = ref_cam.tile_rays(view, st, dev)
        self.acc, self.t_in = ref_comp.render(rows, self.binned, self.rays,
                                              st, residual=True)
        self.counts = cnt.chain_counts(
            rows[self.binned.gid], self.rays, self.binned.tile_counts,
            self.t_in, float(self.acc[:, 5].double().sum()),
            response_cutoff(st), st.min_transmittance)
        g = self.binned.gid[self.binned.gid < self.binned.num_gaussians]
        self.touched = int(torch.unique(g).numel())


def sample_bounds(cell: Cell, views, leaves, dev, kernels: dict,
                  table: dict):
    """{kernel: least ms of the sample's work} for each kernel of
    `kernels` whose table entry names a bound in `bounds/`; a kernel whose
    bound has no file is left out (its metric reads absent) and named on
    standard error."""
    fns = {}
    for k in kernels:
        name = table.get(k, {}).get("bound")
        mod = load_module("bounds", name) if name else None
        if mod is None:
            log(f"kernel {k}: no bound {name!r} in bounds/")
            continue
        fns[k] = mod.bound_ms
    if not fns:
        return {}
    st = settings(cell.config)
    act = activate(*leaves)
    rows = param_rows(act)
    out = dict.fromkeys(fns, 0.0)
    for view in views:
        work = Work(view, act, rows, st, dev)
        for k, fn in fns.items():
            out[k] += float(fn(work))
        del work
    return out


# ---- one run ----------------------------------------------------------------

def load_entry(name: str):
    mod = load_module("entries", name)
    if mod is None:
        raise SystemExit(f"portbench: no entry {name!r} in entries/")
    return mod


def measure(gt, cell: Cell, seed: int, seconds: float, trace: bool, dev,
            control: bool = False):
    """Run the cell once -> (window, peak device bytes, readings): the
    readings hold the compared numbers of the program ("prog") and, with
    `control`, of the reference in bfloat16 in its place ("ctrl")."""
    entry = load_entry(cell.traffic["entry"])
    sess = entry.Session(Context(gt, cell, int(seed), dev, trace))
    sync(dev)
    win = Window()
    tracer = Tracer(cell, dev, win) if trace else None
    sample = []
    sess.start()
    if tracer:
        tracer.start()
    each = bool(entry.SYNC_EACH_UNIT)
    t0 = win.started = time.perf_counter()
    i = 0
    while True:
        ta = time.perf_counter()
        win.failed += int(sess.unit(i))
        if each:
            sync(dev)
        tb = time.perf_counter()
        if each:
            win.latencies.append(tb - ta)
        i += 1
        if tracer:
            if i <= tracer.sample:
                sample.extend(sess.unit_views)
            tracer.after_unit(i, tb - t0)
        if tb - t0 >= seconds:
            break
    sync(dev)
    win.units, win.seconds = i, time.perf_counter() - t0
    if tracer:
        tracer.finish()
    log(f"window: {win.units} units in {win.seconds:.3f} s")
    if len(win.latencies) >= 2:
        half = len(win.latencies) // 2
        log("unit latency medians, first and second half (ms): "
            f"{1e3 * np.median(win.latencies[:half]):.2f} "
            f"{1e3 * np.median(win.latencies[half:]):.2f}, p95 "
            f"{1e3 * np.percentile(win.latencies, 95):.2f}, max "
            f"{1e3 * max(win.latencies):.2f}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    sess.release()
    free(dev)
    # the reference: float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = sess.readings(control)
    log(f"reference: {readings}")
    if trace and win.kernel_ms:
        leaves = sess.bound_leaves()
        win.bound_ms = sample_bounds(cell, sample, leaves, dev,
                                     win.kernel_ms, tracer.kernels)
        del leaves
        log(f"bounds: {win.bound_ms}, kernel ms {win.kernel_ms}")
    return win, peak, readings


def check(limits: dict, numbers: dict):
    """[(name, value, limit, sense, ok)] for every limit of the cell; a
    number that is missing fails."""
    rows = []
    for name, spec in limits.items():
        v = numbers.get(name)
        lim, sense = float(spec["limit"]), spec.get("sense", "max")
        ok = v is not None and np.isfinite(v) and (
            v <= lim if sense == "max" else v >= lim)
        rows.append((name, v, lim, sense, bool(ok)))
    return rows
