"""What a traced run reads from the program's own record: the spans and
counters of its `utils/profiling.py` (`recorded()`), which record while a
`torch.profiler` records, so over exactly the stretch of the window that
the device trace covers.  Readers divide by the units the record holds:
`gvrt.frame` spans (serving), `gvrt.step` spans (training).  A program
that keeps no record leaves every such metric absent.  The device time of
a layer's own kernels comes from the profiler's events instead
(`launched_ms_per_unit`): the kernels, copies and fills that the host
launched inside the layer's `gvrt.` ranges."""

from __future__ import annotations

import bisect
import sys

PKG = "gvrt_tpu_torch"
#: the program's root spans, one per frame or step: every other `gvrt.`
#: span sits inside one
ROOTS = ("gvrt.frame", "gvrt.step")


def record():
    """The running program's record, or None where it keeps none."""
    profiling = getattr(getattr(sys.modules.get(PKG), "utils", None),
                        "profiling", None)
    read = getattr(profiling, "recorded", None)
    return read() if read is not None else None


def per_unit(rec, root: str, value: float):
    """`value` over the record's `root` units, or None without a record
    or a unit."""
    if rec is None or not rec["units"].get(root):
        return None
    return value / rec["units"][root]


def host_ms_per_unit(root: str, name: str):
    """The host ms of the span `name` (0 where it never ran) per `root`
    unit."""
    rec = record()
    row = None if rec is None else rec["spans"].get(name)
    return per_unit(rec, root, 0.0 if row is None else row["host_ms"])


def count_per_unit(root: str, name: str):
    rec = record()
    if rec is None:
        return None
    return per_unit(rec, root, float(rec["counts"].get(name, 0)))


def idle_unspanned(dt):
    """The share of the device's idle time (%) during which no non-root
    `gvrt.` range is open on the host: idle time that no layer of the
    program owns.  None without a device trace or without `gvrt.`
    ranges in it."""
    from portbench.trace import _union_us
    if dt is None or not dt.window_s or not dt.kernels:
        return None
    ranges = [(t, t + d) for t, d, n in dt.host_ops
              if n.startswith("gvrt.") and n not in ROOTS]
    if not ranges:
        return None
    window = dt.window_s * 1e6
    busy, _ = _union_us([(t, t + d) for t, d, _ in dt.kernels])
    idle = window - busy
    if idle <= 0:
        return 0.0
    covered, _ = _union_us(ranges + [(t, t + d) for t, d, _ in dt.kernels])
    return 100.0 * min(max(window - covered, 0.0), idle) / idle


_parsed = [None, None]   # the device trace last read, what it holds


def _launches(dt):
    """({name: {host thread: [(start, end)]}} of the `gvrt.` ranges, and
    (thread, start, us) of each piece of device work at the host op that
    launched it) from the profiler's own events, as its own parser links
    them: a host op or range links to nothing (its linked id is 0), device
    work links to the innermost one open at its launch, and a range's own
    device span bears the range's name.  None where the profiler keeps no
    such events."""
    if _parsed[0] is dt:
        return _parsed[1]
    from torch.autograd import DeviceType
    try:
        events = dt.prof.profiler.kineto_results.events()
        ops, ranges, device = {}, {}, []
        for e in events:
            linked = e.linked_correlation_id()
            if e.device_type() != DeviceType.CPU:
                if linked > 0:
                    device.append((linked, e.name(), e.duration_ns() / 1e3))
            elif linked == 0:
                name, thread = e.name(), e.start_thread_id()
                ops[e.correlation_id()] = (thread, e.start_ns(), name)
                if name.startswith("gvrt."):
                    ranges.setdefault(name, {}).setdefault(thread, []).append(
                        (e.start_ns(), e.end_ns()))
    except Exception as err:   # a profiler that keeps other events
        print(f"portbench: the profiler's events: {err!r}", file=sys.stderr)
        return None
    launched = [ops[c][:2] + (us,) for c, name, us in device
                if c in ops and name != ops[c][2]]
    _parsed[:] = [dt, (ranges, launched)]
    return _parsed[1]


def launched_ms_per_unit(dt, root: str, names):
    """Device ms per `root` unit of the kernels, copies and fills that the
    host launched while a range of `names` was open on the launching
    thread (each counted once): a layer's own device work, without the
    time the card waits for the host inside its ranges.  None without a
    device trace or without `root` ranges in it."""
    parsed = None if dt is None else _launches(dt)
    if parsed is None:
        return None
    ranges, launched = parsed
    units = sum(len(v) for v in ranges.get(root, {}).values())
    if not units:
        return None
    by_thread = {}
    for name in names:
        for thread, spans in ranges.get(name, {}).items():
            by_thread.setdefault(thread, []).extend(spans)
    starts, ends = {}, {}
    for thread, spans in by_thread.items():
        merged = []
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts[thread] = [s for s, _ in merged]
        ends[thread] = [e for _, e in merged]
    us = 0.0
    for thread, t, d in launched:
        i = bisect.bisect_right(starts.get(thread, ()), t) - 1
        if i >= 0 and t <= ends[thread][i]:
            us += d
    return us / 1e3 / units
