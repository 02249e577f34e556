"""Serving frame time: the window over the frames it completed (ms)."""


def read(run):
    w = run.window
    return 1e3 * w.seconds / w.units if w.units else None
