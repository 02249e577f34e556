"""The camera rays' span per frame over the whole window (ms), on the
host's clock: a new camera's per-pixel rays, made on the host and copied
to the card (the names spans.json lists under rays.serve)."""


def read(run):
    ms = run.window.spans.total_ms("rays.serve") if run.window.spans \
        else None
    return None if ms is None or not run.window.units else \
        ms / run.window.units
