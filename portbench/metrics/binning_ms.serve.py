"""Binning's span per frame over the whole window (ms): CUDA events around
each call of the names that spans.json lists under binning.serve."""


def read(run):
    ms = run.window.spans.total_ms("binning.serve") if run.window.spans \
        else None
    return None if ms is None or not run.window.units else \
        ms / run.window.units
