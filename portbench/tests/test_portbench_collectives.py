"""The readers of the collectives' layer (`allreduce_ms.train`,
`allreduce_roofline`), fed a hand-built record and device trace as
`test_portbench_program_metrics.py` feeds the others; both read absent
where the program has no `gvrt.allreduce` span or counters."""

import types

import pytest

from portbench.run import load_reader
from test_portbench_program_metrics import (_annotation, _kernel, _op,
                                            _profiled, _program, _row, _run)

NCCL = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"
BUCKET = 4 * (59 * 5_000_000 + 1)
RECORD = {"spans": {"gvrt.step": _row(2, 400.0, 398.0),
                    "gvrt.allreduce": _row(2, 12.0, 10.0)},
          "counts": {"gvrt.allreduce.bytes": 2 * BUCKET, "gvrt.ranks": 8},
          "units": {"gvrt.step": 2}}
PARENT = {"spans": {"gvrt.step": _row(2, 400.0, 398.0)}, "counts": {},
          "units": {"gvrt.step": 2}}


def test_allreduce_ms_reads_the_work_launched_inside(monkeypatch):
    """Two steps: the pack, the collective and the copy back launched
    inside `gvrt.allreduce` count; the step's other work does not."""
    _program(monkeypatch, RECORD)
    events = [_annotation("gvrt.step", 1, 0, 1000),
              _annotation("gvrt.step", 2, 1000, 1000),
              _annotation("gvrt.allreduce", 3, 800, 150),
              _annotation("gvrt.allreduce", 4, 1800, 150),
              _op(10, 810), _op(11, 820), _op(12, 1810), _op(13, 500),
              _kernel(10, 700.0), _kernel(11, 5000.0, NCCL),
              _kernel(12, 5300.0, NCCL), _kernel(13, 90000.0)]
    got = load_reader("allreduce_ms.train")(_run(_profiled(events)))
    assert got == pytest.approx(5.5)


def test_allreduce_roofline_against_the_link(monkeypatch):
    """The least all-reduce kernel against 3/4 of the bucket over 450 GB/s
    (the link's bound exceeds HBM's 2 x bucket / 3.35 TB/s)."""
    _program(monkeypatch, RECORD)
    trace = types.SimpleNamespace(kernels=[
        (0.0, 5000.0, NCCL), (900.0, 4000.0, NCCL), (50.0, 10.0, "k")])
    want = 100.0 * (0.75 * BUCKET / 450e9) / 4e-3
    got = load_reader("allreduce_roofline")(_run(trace))
    assert got == pytest.approx(want) and 40.0 < got < 60.0


@pytest.mark.parametrize("name", ("allreduce_ms.train",
                                  "allreduce_roofline"))
def test_absent_without_the_span_or_counters(monkeypatch, name):
    trace = types.SimpleNamespace(kernels=[(0.0, 5000.0, NCCL)])
    _program(monkeypatch, PARENT)
    assert load_reader(name)(_run(trace)) is None
    _program(monkeypatch, None)
    assert load_reader(name)(_run(trace)) is None


def test_roofline_absent_on_one_rank(monkeypatch):
    _program(monkeypatch, dict(RECORD, counts={
        "gvrt.allreduce.bytes": 2 * BUCKET, "gvrt.ranks": 2}))
    trace = types.SimpleNamespace(kernels=[(0.0, 5000.0, NCCL)])
    assert load_reader("allreduce_roofline")(_run(trace)) is None
