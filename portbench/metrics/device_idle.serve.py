"""The device's idle share over the traced stretch (%): 1 - the union
of the profiler's kernel intervals over the stretch's wall time."""


def read(run):
    dt = run.window.device
    if dt is None or not dt.window_s or not dt.kernels:
        return None
    return 100.0 * (1.0 - dt.busy_s / dt.window_s)
