"""The host's speed at the serving frame's host work, timed apart from
the benchmark: a 1080p camera's per-pixel rays in NumPy
(`Camera.rays`), then the port's `tile_rays` (those rays copied to the
card and tiled), each in a loop for SECONDS; prints the medians of
every 8 calls and the minor page faults a call.  Not part of a
benchmark run; run it between runs to see how the host drifts.

    python3 portbench/host_probe.py 8
"""

import os
import resource
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(seconds: float):
    import numpy as np
    import torch
    import gvrt_tpu_torch as gt
    from gvrt_tpu_torch.render.binning import tile_rays
    dev = torch.device("cuda", 0)
    for label in ("numpy", "tile_rays"):
        t_end = time.perf_counter() + seconds
        seg, medians, i = [], [], 0
        f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        while time.perf_counter() < t_end:
            c2w = np.eye(4)
            c2w[0, 3] = 0.001 * i      # a new camera each call
            cam = gt.Camera.from_fovy(1920, 1088, 50.0, c2w)
            t = time.perf_counter()
            if label == "numpy":
                cam.rays()
            else:
                tile_rays(cam, gt.DEFAULT_CONFIG, dev)
                torch.cuda.synchronize()
            seg.append(1e3 * (time.perf_counter() - t))
            i += 1
            if len(seg) == 8:
                medians.append(statistics.median(seg))
                seg = []
        f1 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        print(label, "calls", i, "minflt/call", (f1 - f0) / max(i, 1),
              "medians of 8 (ms):", [round(x, 1) for x in medians],
              flush=True)


if __name__ == "__main__":
    main(float(sys.argv[1]))
