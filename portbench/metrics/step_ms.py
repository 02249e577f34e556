"""Training step time: the window over the steps it completed,
topology refreshes included (ms)."""


def read(run):
    w = run.window
    return 1e3 * w.seconds / w.units if w.units else None
