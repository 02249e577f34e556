"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Measures the PyTorch and CUDA port (`3dgvrt_lightfield_tpu_torch`, through
its shim `gvrt_tpu_torch`) on the cards of this machine.  With --trace 0
the metrics are the cell's end-to-end metrics, with --trace 1 its
per-layer metrics; each is read by `metrics/<name>.py`.  The last lines
on standard error, and the result's last key, give every compared number
beside its limit.  Exits non-zero, printing no result, without a card,
with fewer cards than the cell asks for, without the port beside this
directory, or when JAX or the JAX package was loaded.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level module names the port's run must never load, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "3dgvrt_lightfield_tpu", "gvrt_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def load_reader(name: str):
    """The `read(run)` function of `metrics/<name>.py`."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a metric's reader reads: the window, the set-up time, the peak
    of device memory and the cell."""

    def __init__(self, cell, window, setup_s, peak_bytes):
        self.cell, self.window = cell, window
        self.setup_s, self.peak_bytes = setup_s, peak_bytes

    def roofline(self, kernel: str):
        """100 x the sample's least time over its device time, or None."""
        ms = self.window.kernel_ms.get(kernel)
        bound = self.window.bound_ms.get(kernel)
        if not ms or bound is None:
            return None
        return 100.0 * bound / ms


def power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0]) if out else None
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    sys.path.insert(0, ROOT)
    from portbench import harness
    cell = harness.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    try:
        import gvrt_tpu_torch as gt
    except ImportError as e:
        print(f"portbench: the port is not beside portbench/: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    trace = bool(args.trace)
    win, peak, readings = harness.measure(gt, cell, args.seed, args.seconds,
                                          trace, dev)
    run = Run(cell, win, win.started - PROCESS_START, peak)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(run)
        if value is None:
            print(f"portbench: {m['name']}: nothing to read",
                  file=sys.stderr)
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = dict(readings["prog"])
    limits = dict(cell.limits)
    if trace:
        for name, v in metrics.items():
            if "roofline" in name:   # the count or the time is wrong
                numbers[name] = v["value"]
                limits[name] = {"limit": 105.0, "sense": "max"}
    rows = harness.check(limits, numbers)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": peak,
              "power_limit_w": power_limit()}
    result = {"correct": all(r[4] for r in rows), "attempted": win.units,
              "failed": win.failed, "metrics": metrics, "device": device}
    if trace and win.device is not None:
        device["busy_s"] = win.device.busy_s
        device["window_s"] = win.device.window_s
        result["breakdown"] = win.device.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim, "sense": sense}
                        for name, v, lim, sense, _ in rows}
    print(json.dumps(result), flush=True)
    for name, v, lim, sense, ok in rows:
        print(f"check {name} {v!r} {'<=' if sense == 'max' else '>='} "
              f"{lim!r} {'ok' if ok else 'FAIL'}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
