"""The one generator of every traffic mix: a mix is a data file of
parameters (`traffic/<mix>.json`) that this module reads.

Every camera sits on the configuration's orbit: the circle of radius
`camera_distance` about the vertical axis through the scene's centre, at
elevation 0.  The seed picks the orbit's start among `start_angles_deg`
(multiples of the scene's symmetry, so every seed sees the same set of
views in another order) and the order of a training pool.

  * "serve": one viewer, closed loop; frame i looks from the start angle
    plus i * `orbit_step_deg`; capacity is planned over `plan_views`
    views evenly round the orbit, and `warmup_frames` frames before the
    first are rendered at set-up.
  * "train": one trainer, closed loop; a pool of `pool_views` views
    evenly round the orbit, `held_out` ones never trained on; the steps
    walk the rest in seeded random passes, each view held for
    `hold_steps` steps.  The `check_steps` steps that set-up takes for
    the comparison draw their views from a stream of their own, each
    held `check_hold` steps (default `hold_steps`), so that they can
    cross a view switch of a held cadence.

Which program entry a mix drives is its `entry` (`entries/<entry>.py`).
"""

from __future__ import annotations

import numpy as np

from .reference.camera import orbit_view


class Mix:
    def __init__(self, traffic: dict, config: dict, seed: int):
        self.traffic, self.config = traffic, config
        rng = np.random.default_rng(int(seed))
        self.check_rng = np.random.default_rng([int(seed), 1])
        angles = traffic["start_angles_deg"]
        self.start = float(angles[int(rng.integers(len(angles)))])
        self.rng = rng

    def view(self, angle_deg: float):
        c = self.config
        w, h = c["resolution"]
        return orbit_view(c["centre"], c["camera_distance"], angle_deg,
                          c["fovy_deg"], w, h)

    # ---- serving ---------------------------------------------------------
    def frame(self, i: int):
        return self.view(self.start + self.traffic["orbit_step_deg"] * i)

    def plan_views(self):
        k = int(self.traffic["plan_views"])
        return [self.view(self.start + 360.0 * j / k) for j in range(k)]

    def warmup_views(self):
        return [self.frame(-i) for i in range(
            int(self.traffic["warmup_frames"]), 0, -1)]

    # ---- training --------------------------------------------------------
    def pool(self):
        k = int(self.traffic["pool_views"])
        return [self.view(self.start + 360.0 * j / k) for j in range(k)]

    def trained(self):
        held = set(self.traffic.get("held_out", []))
        return [j for j in range(int(self.traffic["pool_views"]))
                if j not in held]

    def steps(self):
        """Pool index of every step, without end."""
        views, hold = self.trained(), int(self.traffic["hold_steps"])
        while True:
            for j in self.rng.permutation(views):
                for _ in range(hold):
                    yield int(j)

    def check_order(self):
        """Pool index of each of the `check_steps` steps taken at set-up."""
        t = self.traffic
        n = int(t["check_steps"])
        hold = int(t.get("check_hold", t["hold_steps"]))
        views = self.check_rng.permutation(self.trained())
        return [int(views[(k // hold) % len(views)]) for k in range(n)]
