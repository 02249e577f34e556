"""The pose refiner's entry: `PoseRefiner.step` in a closed loop, driven
as `optimize_camera_poses` (the CLI's `train --optimize-poses N
--perturb-poses SIGMA`) drives it, camera after camera.

Set-up draws the scene from the seed and renders the targets: the
program's renders of the scene at the pool's true poses (`TiledRenderer`
planned over `plan_views` pool views, under `no_grad`), held on the host
as float32 (H, W, 3) arrays, as the CLI holds its images.  A visit is one
camera's refinement: a pool view, its pose perturbed with
`perturb_cameras`' recipe (sigma_t `perturb_sigma_t`, sigma_r sigma_t / 3
rad) from `np.random.default_rng([seed, 2, visit])`, a `PoseRefiner`
built (the bind) and its loss at the base pose read, `hold_steps` steps,
then the refined camera and its report read to the host.  One unit is one
pose step; a visit's bind and reads fall in the unit that starts or ends
it, inside the window.

Set-up takes the `check_steps` checked steps (`Mix.check_order`: visits 0
and 1, held `check_hold` steps: A, A, B), and the window goes on with B's
visit; later visits draw their views from the seed's passes over the pool
(`Mix.steps`, one view a visit).  After the window the reference
(`reference/pose.py`) follows the checked steps from the same scene, seed,
views and perturbations, with targets it renders itself (and holds the
program's targets of those views against them), binning at each perturbed
base pose, its autograd gradients and Adam.
"""

from __future__ import annotations

import itertools

import torch

from portbench import harness as h
from portbench.entries.train import target_off
from portbench.generator import Mix
from portbench.reference import binning as ref_bin
from portbench.reference import camera as ref_cam
from portbench.reference import composite as ref_comp
from portbench.reference import pose as ref_pose
from portbench.reference.math import activate, param_rows
from portbench.scene import draw

SYNC_EACH_UNIT = False
#: the stream of the perturbations: np.random.default_rng([seed, 2, visit])
PERTURB_STREAM = 2
#: a component of a delta whose reference gradient at the visit's first
#: step is under this share of the delta's gradient norm is left out of
#: pose_change_gap: round-off alone can flip its sign, and Adam then moves
#: it by about lr whichever way it points
CHANGE_FLOOR = 1e-3


def _rel(got, want) -> float:
    got, want = (torch.as_tensor(x, dtype=torch.float64).cpu()
                 for x in (got, want))
    if not bool(torch.isfinite(got).all()):
        return float("nan")
    den = float(torch.linalg.vector_norm(want))
    return float(torch.linalg.vector_norm(got - want)) / max(den, 1e-30)


def numbers(side: dict, ref: dict) -> dict:
    """The compared numbers of one side against the float32 reference:
    loss_gap (the worst checked step's relative gap), pose_grad_gap (each
    delta's first gradient, relative L2, the worse of t and r),
    pose_change_gap (each visit's t and r after the checked steps against
    the reference's, relative L2 over the components that
    `CHANGE_FLOOR` keeps, the worst), target_off, and the reference's
    hits per ray at the first step."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(side["loss"], ref["loss"])]
    changes = []
    for got, want, g in zip(side["change"], ref["change"], ref["visit_grad"]):
        g = torch.as_tensor(g, dtype=torch.float64).abs().cpu()
        keep = g >= CHANGE_FLOOR * float(torch.linalg.vector_norm(g))
        changes.append(_rel(torch.as_tensor(got).cpu()[keep],
                            torch.as_tensor(want).cpu()[keep]))
    return {"loss_gap": max(losses),
            "pose_grad_gap": max(_rel(a, b) for a, b in zip(side["grad"],
                                                             ref["grad"])),
            "pose_change_gap": max(changes),
            "target_off": side["target_off"],
            "hits_per_ray": ref["hits_per_ray"]}


def starts(order):
    """Whether each checked step starts a visit: the first, and wherever
    the view changes."""
    return [k == 0 or j != order[k - 1] for k, j in enumerate(order)]


class Session:
    def __init__(self, ctx: h.Context):
        self.ctx = ctx
        gt, cell, seed, dev = ctx.gt, ctx.cell, ctx.seed, ctx.dev
        c, t = cell.config, cell.traffic
        self.cfg = h.render_config(gt, c)
        width, height = h.size(c)
        scene, _ = draw(c, seed, dev)
        self.model = gt.GaussianModel(*scene)
        del scene
        mix = Mix(t, c, seed)
        self.pool = mix.pool()
        self.cams = [h.camera(gt, v) for v in self.pool]
        planner = gt.render.TiledRenderer(width, height, self.cfg,
                                          device=dev)
        planner.plan(self.model, self.cams[:int(t["plan_views"])])
        with torch.no_grad():
            self.targets = {j: planner.render(self.model, self.cams[j])
                            ["rgb"].cpu().numpy() for j in mix.trained()}
        del planner
        h.log("pose: targets rendered")
        self.sigma, self.lr = float(t["perturb_sigma_t"]), float(t["lr"])
        self.hold = int(t["hold_steps"])
        self.visit = 0
        self.check = mix.check_order()
        prog = {"change": []}
        losses = []
        for k, (j, new) in enumerate(zip(self.check, starts(self.check))):
            if new:
                if k:
                    prog["change"] += self._deltas()
                self._start_visit(j)
            losses.append(self.refiner.step())
            self.done += 1
            if k == 0:
                prog["grad"] = [g.detach().to("cpu", copy=True)
                                for g in self.refiner.grads()]
        prog["change"] += self._deltas()
        prog["loss"] = [float(x) for x in losses]
        h.sync(dev)
        h.log(f"pose: checked steps {prog['loss']} on views {self.check}")
        self.prog = prog
        ts = self.cfg.tile_size
        self.kept_targets = {j: ref_cam.to_tiles(
            torch.from_numpy(self.targets[j]), ts) for j in set(self.check)}
        self.views = itertools.islice(mix.steps(), 0, None, self.hold)
        self.unit_views = []

    def _view(self, j: int, visit: int):
        """The reference's View of visit `visit` at pool view `j`: the
        perturbed base pose, worked out on the reference's side."""
        return ref_pose.perturbed_view(
            self.pool[j], [self.ctx.seed, PERTURB_STREAM, visit], self.sigma)

    def _start_visit(self, j: int):
        """A new camera, as `optimize_camera_poses` starts one: view j
        perturbed, a `PoseRefiner` bound to it and its loss at the base
        pose read."""
        gt = self.ctx.gt
        cam = gt.train.perturb_cameras(
            [self.cams[j]], self.sigma,
            seed=[self.ctx.seed, PERTURB_STREAM, self.visit])[0]
        self.view = self._view(j, self.visit)
        self.visit += 1
        self.refiner = gt.train.PoseRefiner(self.model, cam, self.targets[j],
                                            self.cfg, self.lr)
        self.refiner.initial_loss()
        self.done = 0

    def _deltas(self):
        return [x.detach().to("cpu", copy=True)
                for x in (self.refiner.t, self.refiner.r)]

    def start(self):
        pass

    def unit(self, i: int) -> int:
        if self.done >= self.hold:
            self.refiner.result()   # the camera's end: the host's reads
            self._start_visit(next(self.views))
        self.refiner.step()
        self.done += 1
        self.unit_views = [self.view]
        return 0

    def release(self):
        self.model = self.refiner = self.targets = None

    def reference_steps(self, dtype=torch.float32):
        """The reference's checked steps from the same inputs: losses, the
        first gradients, each visit's first gradients and deltas after the
        steps, the first step's mean hits per ray, and its targets of the
        checked views (tiles, 3, R), composited in `dtype`."""
        cell, dev, seed = self.ctx.cell, self.ctx.dev, self.ctx.seed
        st = h.settings(cell.config)
        scene, _ = draw(cell.config, seed, dev)
        act = activate(*scene)
        rows = param_rows(act).to(dtype)
        del scene
        targets = {}
        for j in sorted(set(self.check)):
            view = self.pool[j]
            w2c, proj = ref_cam.matrices(view, st)
            binned = ref_bin.bin_frame(act, w2c, proj, view.width,
                                       view.height, st)
            rays = ref_cam.tile_rays(view, st, dev)
            targets[j] = ref_comp.render(rows, binned, rays,
                                         st)[:, 0:3].float()
            del binned, rays
        out = {"loss": [], "change": [], "visit_grad": [],
               "targets": targets}
        ref, visit = None, -1
        for k, (j, new) in enumerate(zip(self.check, starts(self.check))):
            if new:
                if ref is not None:
                    out["change"] += [ref.t.clone(), ref.r.clone()]
                visit += 1
                ref = ref_pose.Refinement(act, rows, self._view(j, visit),
                                          targets[j], st)
            loss, g_t, g_r, hits = ref.step()
            out["loss"].append(loss)
            if new:
                out["visit_grad"] += [g_t, g_r]
            if k == 0:
                out["grad"] = [g_t, g_r]
                out["hits_per_ray"] = hits
        out["change"] += [ref.t.clone(), ref.r.clone()]
        return out

    def readings(self, control: bool):
        ref = self.reference_steps()
        want = ref["targets"]
        self.prog["target_off"] = max(
            target_off(self.kept_targets[j], want[j]) for j in want)
        out = {"prog": numbers(self.prog, ref)}
        if control:
            low = self.reference_steps(torch.bfloat16)
            low["target_off"] = max(target_off(low["targets"][j], want[j])
                                    for j in want)
            out["ctrl"] = numbers(low, ref)
        return out

    def bound_leaves(self):
        return draw(self.ctx.cell.config, self.ctx.seed, self.ctx.dev)[0]
