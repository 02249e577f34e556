"""The readers of the program's own spans and counters (`metrics/` over
`program_record.py`), fed a hand-built record and device trace; and a
program without a record, whose metrics read absent."""

import sys
import types

import pytest
from torch.autograd import DeviceType

from portbench import program_record as pr
from portbench.run import load_reader

SERVE = ("rays_numpy_ms.serve", "host_syncs.serve", "ray_cache_hits.serve")
TRAIN = ("rays_numpy_ms.train", "host_syncs.train")
LAUNCHED = ("gather_ms.serve", "gather_ms.train", "param_table_ms.train")
CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _row(calls, host_ms, device_ms):
    return {"calls": calls, "host_ms": host_ms, "device_ms": device_ms,
            "self_host_ms": host_ms}


SERVE_RECORD = {
    "spans": {"gvrt.frame": _row(4, 1600.0, 1590.0),
              "gvrt.rays.numpy": _row(4, 1200.0, 1201.0),
              "gvrt.gather": _row(4, 8.0, 4.0)},
    "counts": {"gvrt.host_syncs": 56, "gvrt.rays.built": 3,
               "gvrt.rays.cache_hit": 1},
    "units": {"gvrt.frame": 4}}

TRAIN_RECORD = {
    "spans": {"gvrt.step": _row(10, 1500.0, 1490.0),
              "gvrt.rays.numpy": _row(1, 350.0, 351.0),
              "gvrt.gather": _row(40, 90.0, 60.0),
              "gvrt.gather.bwd": _row(20, 50.0, 40.0),
              "gvrt.param_table": _row(10, 20.0, 15.0),
              "gvrt.param_table.bwd": _row(10, 30.0, 25.0)},
    "counts": {"gvrt.host_syncs": 87},
    "units": {"gvrt.step": 10}}


class _Trace:
    """A device trace of 1000 us: kernels at [0, 100) and [600, 700) (busy
    200, idle 800); host ranges in microseconds."""

    def __init__(self, host_ops):
        self.window_s = 1e-3
        self.kernels = [(0.0, 100.0, "k"), (600.0, 100.0, "k")]
        self.host_ops = host_ops


class _Event:
    """One of the profiler's events (times in microseconds): a host op or
    range links to nothing, device work to its launching op."""

    def __init__(self, device, name="", corr=0, linked=0, thread=1,
                 start=0.0, dur=0.0):
        self.device, self._name, self.corr = device, name, corr
        self.linked, self.thread, self.start, self.dur = (linked, thread,
                                                          start, dur)

    def device_type(self):
        return self.device

    def name(self):
        return self._name

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked

    def start_thread_id(self):
        return self.thread

    def start_ns(self):
        return int(1e3 * self.start)

    def end_ns(self):
        return int(1e3 * (self.start + self.dur))

    def duration_ns(self):
        return int(1e3 * self.dur)


def _profiled(events):
    """A device trace whose profiler holds `events`."""
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(prof=types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results)))


def _annotation(name, corr, start, dur, thread=1):
    return _Event(CPU, name, corr, thread=thread, start=start, dur=dur)


def _op(corr, start, thread=1):
    return _Event(CPU, "aten::index", corr, thread=thread, start=start,
                  dur=1.0)


def _kernel(linked, dur, name="k"):
    return _Event(CUDA, name, 10_000 + linked, linked, thread=7, dur=dur)


def _program(monkeypatch, rec):
    """Make `rec` the running program's record (None: a program that
    keeps none)."""
    profiling = types.SimpleNamespace()
    if rec is not None:
        profiling.recorded = lambda: rec
    pkg = types.SimpleNamespace(utils=types.SimpleNamespace(
        profiling=profiling))
    monkeypatch.setitem(sys.modules, pr.PKG, pkg)


def _run(trace=None):
    return types.SimpleNamespace(window=types.SimpleNamespace(device=trace))


def test_serving_readers(monkeypatch):
    _program(monkeypatch, SERVE_RECORD)
    got = {m: load_reader(m)(_run()) for m in SERVE}
    assert got == {"rays_numpy_ms.serve": 300.0, "host_syncs.serve": 14.0,
                   "ray_cache_hits.serve": 25.0}


def test_training_readers(monkeypatch):
    _program(monkeypatch, TRAIN_RECORD)
    got = {m: load_reader(m)(_run()) for m in TRAIN}
    assert got == {"rays_numpy_ms.train": 35.0, "host_syncs.train": 8.7}


def test_a_window_without_rays_reads_zero(monkeypatch):
    rec = dict(TRAIN_RECORD, spans={
        k: v for k, v in TRAIN_RECORD["spans"].items()
        if k != "gvrt.rays.numpy"})
    _program(monkeypatch, rec)
    assert load_reader("rays_numpy_ms.train")(_run()) == 0.0


def test_serving_gather_reads_the_kernels_it_launched():
    """Two frames; the gather's kernels count at the op that launched them
    inside a `gvrt.gather` range on that thread, or at the range itself;
    not the range's own device span, nor work launched outside it."""
    events = [
        _annotation("gvrt.frame", 1, 0, 1000), _annotation("gvrt.frame", 2,
                                                           1000, 1000),
        _annotation("gvrt.gather", 3, 100, 100),
        _annotation("gvrt.gather", 4, 1100, 100),
        _op(5, 120), _op(6, 300), _op(7, 150, thread=2),
        _kernel(5, 1500.0), _kernel(4, 2500.0, "Memset (Device)"),
        _kernel(6, 9000.0), _kernel(7, 9000.0),
        _kernel(3, 5000.0, "gvrt.gather"),   # the range's device span
        _Event(CPU, "cudaLaunchKernel", 5, 5, start=120, dur=9000.0)]
    got = load_reader("gather_ms.serve")(_run(_profiled(events)))
    assert got == pytest.approx(2.0)


def test_training_reads_the_kernels_launched_both_ways():
    """Four steps; the table's backward runs on autograd's thread (2),
    the gather's recomputation inside its backward counts once."""
    steps = [_annotation("gvrt.step", 1 + i, 1000 * i, 1000)
             for i in range(4)]
    events = steps + [
        _annotation("gvrt.param_table", 10, 50, 50),
        _annotation("gvrt.param_table.bwd", 11, 600, 100, thread=2),
        _annotation("gvrt.gather", 12, 200, 50),
        _annotation("gvrt.gather.bwd", 13, 500, 80, thread=2),
        _annotation("gvrt.gather", 14, 510, 20, thread=2),
        _op(20, 60), _op(21, 650, thread=2), _op(22, 210), _op(23, 520,
                                                            thread=2),
        _op(24, 650),   # the main thread, outside every table range
        _kernel(20, 1000.0), _kernel(21, 3000.0), _kernel(22, 2000.0),
        _kernel(23, 6000.0), _kernel(24, 50000.0)]
    run = _run(_profiled(events))
    assert load_reader("param_table_ms.train")(run) == pytest.approx(1.0)
    assert load_reader("gather_ms.train")(run) == pytest.approx(2.0)


def test_launched_work_absent_without_units_or_events():
    no_steps = _profiled([_annotation("gvrt.gather", 1, 0, 10), _op(2, 5),
                          _kernel(2, 10.0)])
    assert load_reader("gather_ms.train")(_run(no_steps)) is None
    assert load_reader("gather_ms.train")(_run(types.SimpleNamespace(
        prof=None))) is None   # said on standard error


def test_device_clock_absent_on_the_cpu(monkeypatch):
    rec = {"spans": {"gvrt.gather": _row(2, 3.0, None)}, "counts": {},
           "units": {"gvrt.frame": 2}}
    _program(monkeypatch, rec)
    assert load_reader("gather_ms.serve")(_run()) is None
    assert load_reader("host_syncs.serve")(_run()) == 0.0


@pytest.mark.parametrize("name", SERVE + TRAIN + LAUNCHED)
def test_a_program_without_a_record_reads_absent(monkeypatch, name):
    _program(monkeypatch, None)
    assert load_reader(name)(_run()) is None


@pytest.mark.parametrize("suffix", ("serve", "train"))
def test_idle_unspanned(suffix):
    read = load_reader(f"idle_unspanned.{suffix}")
    # a root covers everything and counts for nothing; gvrt.rays covers
    # [100, 500) of the idle [100, 600) and [700, 1000); aten ops count
    # for nothing
    host = [(0.0, 1000.0, "gvrt.frame"), (0.0, 1000.0, "gvrt.step"),
            (100.0, 400.0, "gvrt.rays"), (500.0, 50.0, "aten::sub"),
            (650.0, 100.0, "gvrt.binning.sort")]
    # idle 800 us; spanned: [100, 500) and [700, 750): 450 us
    assert read(_run(_Trace(host))) == pytest.approx(100.0 * 350 / 800)
    # no gvrt. range at all: a program without spans reads absent
    assert read(_run(_Trace([(0.0, 1000.0, "aten::sub")]))) is None
    assert read(_run(None)) is None
