"""Faults planted in the pose step's timed path, to show that the pose
cell's comparison catches them (tests on the CPU; on the card through
`control.py`'s runs, with the fault planted first):

  * "ray_cotangents": the ray cotangents of the backward (K2's `bar_rays`
    output, or its plain version's) scaled by 0.9 where they are produced;
  * "pose_unchanged": the pose's optimizer step returns without updating
    the deltas.

    python3 portbench/faults_pose.py --fault ray_cotangents \
        --workload synth300k.pose --seeds 1,2,3 [--seconds 2]

`plant` returns a function that takes the fault out again.
"""

from __future__ import annotations

import functools
import os
import sys

FAULTS = ("ray_cotangents", "pose_unchanged")


def _patch(undo, owner, name, new):
    undo.append((owner, name, owner.__dict__[name]))
    setattr(owner, name, new)


def plant(gt, name: str):
    """Plant fault `name` in the program `gt`; returns the undo function."""
    undo = []
    if name == "ray_cotangents":
        pv = gt.render.pallas_vjp
        for fn in ("tile_backward", "_backward_plain"):
            real = getattr(pv, fn)

            @functools.wraps(real)   # keeps the launch counter
            def scaled(*args, _real=real):
                bar_chunks, bar_rays = _real(*args)
                return bar_chunks, None if bar_rays is None else \
                    bar_rays * 0.9
            _patch(undo, pv, fn, scaled)
    elif name == "pose_unchanged":
        cls = gt.train.pose.PoseRefiner
        real_init = cls.__dict__["__init__"]

        @functools.wraps(real_init)
        def init(self, *args, **kwargs):
            real_init(self, *args, **kwargs)
            self.opt.step = lambda closure=None: None
        _patch(undo, cls, "__init__", init)
    else:
        raise ValueError(f"no pose fault {name!r}")

    def take_out():
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)
    return take_out


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    i = argv.index("--fault")
    name = argv[i + 1]
    del argv[i:i + 2]
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.dirname(here))
    import gvrt_tpu_torch as gt
    from portbench import control
    plant(gt, name)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
