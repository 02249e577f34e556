"""A fault planted in the combined frame's mesh pass, to show that the
combined cell's comparison catches it (tests on the CPU; on the card
through `control.py`'s runs, with the fault planted first):

  * "no_shadows": the shadow test dropped: `occluded` reports every
    shadow ray unblocked, so every mesh point within a light's radius is
    lit by it.

    python3 portbench/faults_mesh.py --fault no_shadows \
        --workload garden5m_mesh.serve_combined --seeds 1,2 [--seconds 2]

`plant` returns a function that takes the fault out again.
"""

from __future__ import annotations

import functools
import os
import sys

import torch

FAULTS = ("no_shadows",)


def plant(gt, name: str):
    """Plant fault `name` in the program `gt`; returns the undo function."""
    if name != "no_shadows":
        raise ValueError(f"no mesh fault {name!r}")
    owner = gt.hybrid.pipeline
    real = owner.__dict__["occluded"]

    @functools.wraps(real)
    def unblocked(rays, *args, **kwargs):
        return torch.zeros(rays.shape[0], dtype=torch.bool,
                           device=rays.device)
    owner.occluded = unblocked

    def take_out():
        owner.occluded = real
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
