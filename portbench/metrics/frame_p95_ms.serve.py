"""The 95th percentile of every frame latency of the window (ms): the
host clock from the render call to the frame's rgb being ready.  A
per-layer reading: with ~70-120 frames a window it follows the host's
stalls more than the frame's work."""

import numpy as np


def read(run):
    lat = run.window.latencies
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
