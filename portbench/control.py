"""Readings of a cell's compared numbers over many seeds in one process:
the program's (the lower readings of its limits) and, on the control
seeds, those of the reference computed in bfloat16 in the program's
place (the upper readings); with --fault, the program's with that fault
of `faults.py` planted (a training cell's further upper readings).  Not
part of a benchmark run.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault half_batch] [--seconds 2]

Prints one JSON line per seed: {"seed", "prog": {...}, "ctrl": {...}}.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default=None)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    import gvrt_tpu_torch as gt
    from portbench import harness
    from portbench import faults
    cell = harness.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    if args.fault:
        faults.plant(gt, args.fault, cell.traffic["entry"])
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(x) for x in args.seeds.split(",")):
        _, _, readings = harness.measure(gt, cell, s, args.seconds, False,
                                         dev, control=s in ctrl)
        print(json.dumps({"workload": args.workload, "seed": s,
                          "fault": args.fault, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
