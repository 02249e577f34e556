"""Binning's span per step over the whole window (ms): CUDA events around
each call of the names that spans.json lists under binning.train."""


def read(run):
    ms = run.window.spans.total_ms("binning.train") if run.window.spans \
        else None
    return None if ms is None or not run.window.units else \
        ms / run.window.units
