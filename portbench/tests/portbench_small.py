"""Cells of the benchmark cut to a size the CPU runs in seconds: 4000
Gaussians of the synthetic scene's geometry at 64 x 64 (about 26 hits per
ray), a 4-view pool, plans over 2 views, 2 checked frames."""

import torch

from portbench import harness

SMALL_CONFIG = {"gaussians": 4000, "extent": 1.0, "centre": [0.0, 0.0, -3.0],
                "scale_log_range": [-3.6, -2.8], "camera_distance": 3.0,
                "fovy_deg": 50.0, "resolution": [64, 64]}
SMALL_TRAFFIC = {"plan_views": 2, "pool_views": 4, "check_frames": 2,
                 "trace_seconds": 0.3}
WORKLOADS = ("synth300k.train_views", "garden5m.train_held10",
             "synth300k.serve_orbit", "garden5m.serve_orbit")
CPU = torch.device("cpu")


def small_cell(workload: str) -> harness.Cell:
    cell = harness.load_cell(workload)
    cell.config = {**cell.config, **SMALL_CONFIG}
    cell.traffic = {**cell.traffic, **SMALL_TRAFFIC}
    return cell


def run_small(workload: str, seed: int = 20260101, control: bool = False,
              trace: bool = False, seconds: float = 0.4, traffic: dict = None):
    """(cell, window, readings) of one small run on the CPU; `traffic`
    overrides keys of the cell's mix."""
    import gvrt_tpu_torch as gt
    torch.set_num_threads(min(4, torch.get_num_threads()))
    cell = small_cell(workload)
    cell.traffic.update(traffic or {})
    win, _, readings = harness.measure(gt, cell, seed, seconds, trace, CPU,
                                       control=control)
    return cell, win, readings


def failing(cell, numbers) -> list:
    """Names of the cell's compared numbers that miss their limits."""
    return [r[0] for r in harness.check(cell.limits, numbers) if not r[4]]
