"""The peak of allocated device memory over the whole run, set-up
included (GiB)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
