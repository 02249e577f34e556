"""The trainer's entry: `Trainer.step` in a closed loop, unbanded (the
CLI's `train` step) or banded (`bands` > 1, the held-topology trainer).

Set-up draws the scene and, from the same stream, the model to train:
the scene with its opacity logits and sh_dc perturbed, so the loss and
gradients are not zero.  The targets are the unperturbed scene's renders
of the trained views, made by the program at set-up.  The unbanded
trainer is fed camera batches (`parallel.camera_batch`): with `rays`
"pool" (the default) each pool view's batch is made once at set-up, so
the window times the step alone; with "each_step" every step makes its
batch on the host, as the CLI's loop does.  The banded trainer takes the
camera and builds its band rays when it binds.

Set-up then takes the trainer's first `check_steps` steps through the
window's own call and feed (`Mix.check_order`) and hands the same trainer
to the window.  After the window the reference follows those steps from
the same scene, seed and views, with targets it renders itself (and
holds the program's targets of those views against them), its own
binning (banded: the topology of the last bind, as stale as the
program's), autograd gradients and Adam.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import harness as h
from portbench.generator import Mix
from portbench.reference import adam as ref_adam
from portbench.reference import binning as ref_bin
from portbench.reference import camera as ref_cam
from portbench.reference import composite as ref_comp
from portbench.reference.math import activate, param_rows
from portbench.scene import draw

SYNC_EACH_UNIT = False


def _leaf_norms(tensors):
    return [float(torch.linalg.vector_norm(x.detach().float()))
            for x in tensors]


def rebinds(order, bands, refresh):
    """When the trainer rebuilds its topology: every step unbanded; on a
    new view or after `refresh` steps on one banded."""
    if bands == 1:
        return [True] * len(order)
    flags, age, prev = [], None, None
    for j in order:
        fresh = age is None or j != prev or age >= refresh
        age = 0 if fresh else age
        flags.append(fresh)
        age += 1
        prev = j
    return flags


def gap(got, want):
    """Worst leaf of |got - want| / max(want, median leaf)."""
    med = float(np.median(want))
    worst = 0.0
    for g, w in zip(got, want):
        if not np.isfinite(g):
            return float("nan")
        worst = max(worst, abs(g - w) / max(w, med, 1e-30))
    return worst


def target_off(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of the target pixels (tiles, 3, R) whose rgb differs from the
    reference's by more than 1e-5 in some channel."""
    d = (got.to("cpu", torch.float32) - want.to("cpu", torch.float32)).abs()
    off = d.amax(1) > 1e-5
    return float(off.sum()) / off.numel()


def numbers(side: dict, ref: dict):
    """The compared numbers of one side against the reference: loss_gap,
    grad_gap and change_gap (the change leaves out leaves whose reference
    gradient is under a thousandth of the median leaf's: round-off alone
    moves them), target_off, and the reference's hits per ray."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(side["loss"], ref["loss"])]
    floor = 1e-3 * float(np.median(ref["grad"]))
    keep = [g >= floor for g in ref["grad"]]
    change_got = [x for x, k in zip(side["change"], keep) if k]
    change_ref = [x for x, k in zip(ref["change"], keep) if k]
    return {"loss_gap": max(losses), "grad_gap": gap(side["grad"],
                                                     ref["grad"]),
            "change_gap": gap(change_got, change_ref),
            "target_off": side["target_off"],
            "hits_per_ray": ref["hits_per_ray"]}


class Session:
    def __init__(self, ctx: h.Context):
        self.ctx = ctx
        gt, cell, seed, dev = ctx.gt, ctx.cell, ctx.seed, ctx.dev
        c, t = cell.config, cell.traffic
        cfg = h.render_config(gt, c)
        width, height = h.size(c)
        scene, perturbed = draw(c, seed, dev, t["perturb"])
        mix = Mix(t, c, seed)
        self.pool = mix.pool()
        cams = [h.camera(gt, v) for v in self.pool]
        self.bands = bands = int(t.get("bands", 1))
        each_step = t.get("rays", "pool") == "each_step"
        plan_cams = cams[:int(t["plan_views"])]
        # the targets: the unperturbed scene's renders of the trained views
        scene_model = gt.GaussianModel(*scene)
        planner = gt.render.TiledRenderer(width, height, cfg, device=dev)
        cap = planner.plan(scene_model, plan_cams)
        mesh = gt.parallel.make_mesh(1, devices=[dev])
        targets, batches = {}, {}
        with torch.no_grad():
            for j in mix.trained():
                batch = gt.parallel.camera_batch([cams[j]], cfg, dev)
                targets[j] = gt.parallel.render_batch_sharded(
                    scene_model, batch, mesh, width, height, cfg,
                    *cap)[0, ..., 0:3].contiguous()
                if bands == 1 and not each_step:
                    batches[j] = batch
                del batch
        del scene_model, scene, planner
        h.log("train: targets rendered")
        self.check = mix.check_order()
        self.steps = mix.steps()
        model = gt.GaussianModel(*perturbed)
        del perturbed
        if t.get("sort_scene"):
            model = model.sorted_for_camera(cams[self.check[0]], cfg)
        tc = gt.train.TrainConfig(**t.get("train_config", {}))
        self.refresh = tc.refresh_every
        if bands > 1:
            trainer = gt.train.Trainer(width, height, cfg, tc,
                                       n_bands=bands, device=dev)

            def feed(j):
                return cams[j], targets[j]
        else:
            planner = gt.render.TiledRenderer(width, height, cfg,
                                              device=dev)
            capacity = planner.plan(model, plan_cams)
            del planner
            trainer = gt.train.Trainer(width, height, cfg, tc, capacity,
                                       device=dev)

            def feed(j):
                if each_step:
                    return (gt.parallel.camera_batch([cams[j]], cfg, dev),
                            targets[j][None])
                return batches[j], targets[j][None]
        state = trainer.init(model)
        h.log("train: trainer built")
        p0 = [p.detach().to("cpu", copy=True) for p in model.leaves()]
        prog = {"loss": []}
        for k, j in enumerate(self.check):
            state, loss = trainer.step(state, *feed(j))
            prog["loss"].append(float(loss))
            if k == 0:
                # the first gradient as the optimizer took it: Adam's first
                # moment after one step is (1 - beta1) g
                opt = state[1]
                prog["grad"] = [
                    float(torch.linalg.vector_norm(opt.state[p]["exp_avg"]))
                    / (1.0 - opt.param_groups[i]["betas"][0])
                    if "exp_avg" in opt.state[p] else float("nan")
                    for i, p in enumerate(model.leaves())]
        prog["change"] = [float(torch.linalg.vector_norm(
            p.detach() - q.to(dev))) for p, q in zip(model.leaves(), p0)]
        del p0
        h.sync(dev)
        h.log(f"train: first steps {prog['loss']} on views {self.check}")
        self.prog = prog
        self.kept_targets = {j: ref_cam.to_tiles(targets[j], cfg.tile_size)
                             .to("cpu", copy=True) for j in set(self.check)}
        self.trainer, self.model, self.state = trainer, model, state
        self.targets, self.batches, self.feed = targets, batches, feed
        self.start_leaves = None
        self.unit_views = []

    def start(self):
        if self.ctx.trace:
            self.start_leaves = [p.detach().to("cpu", copy=True)
                                 for p in self.model.leaves()]

    def unit(self, i: int) -> int:
        j = next(self.steps)
        self.state, _ = self.trainer.step(self.state, *self.feed(j))
        self.unit_views = [self.pool[j]]
        return 0

    def release(self):
        self.trainer = self.model = self.state = self.feed = None
        self.targets = self.batches = None

    def _ref_targets(self, dtype):
        """The reference's render of the scene at each checked view: (tiles,
        3, R) rgb per pool index, composited in `dtype`."""
        c, st, dev = self.ctx.cell.config, h.settings(self.ctx.cell.config), \
            self.ctx.dev
        scene, _ = draw(c, self.ctx.seed, dev)
        act = activate(*scene)
        rows = param_rows(act).to(dtype)
        out = {}
        for j in sorted(set(self.check)):
            view = self.pool[j]
            w2c, proj = ref_cam.matrices(view, st)
            binned = ref_bin.bin_frame(act, w2c, proj, view.width,
                                       view.height, st)
            rays = ref_cam.tile_rays(view, st, dev)
            out[j] = ref_comp.render(rows, binned, rays, st)[:, 0:3].float()
            del binned, rays
        return out

    def reference_steps(self, dtype=torch.float32):
        """The reference's first steps from the same inputs: losses, the
        first gradient's norm and the change after the steps, per leaf,
        the first step's mean hits per ray, and how far its targets lie
        from the reference's in float32 (`target_off`: the program's
        targets for the float32 side)."""
        cell, dev = self.ctx.cell, self.ctx.dev
        c, st = cell.config, h.settings(cell.config)
        targets = self._ref_targets(dtype)
        _, leaves = draw(c, self.ctx.seed, dev, cell.traffic["perturb"])
        if cell.traffic.get("sort_scene"):
            v = self.pool[self.check[0]]
            w2c, proj = ref_cam.matrices(v, st)
            with torch.no_grad():
                perm = ref_bin.y_sort_permutation(
                    activate(*leaves), w2c, proj, v.width, v.height, st)
            leaves = [x[perm].contiguous() for x in leaves]
        params = [x.clone() for x in leaves]
        opt = ref_adam.Adam(params)
        out = {"loss": [], "targets": targets}
        binned = None
        flags = rebinds(self.check, self.bands, self.refresh)
        for k, (j, fresh) in enumerate(zip(self.check, flags)):
            view = self.pool[j]
            w2c, proj = ref_cam.matrices(view, st)
            if fresh:
                with torch.no_grad():
                    binned = ref_bin.bin_frame(activate(*params), w2c, proj,
                                               view.width, view.height, st)
            rays = ref_cam.tile_rays(view, st, dev)
            loss, grads, hits = ref_comp.loss_and_grads(
                params, binned, rays, targets[j].to(dev), st, dtype)
            out["loss"].append(loss)
            if k == 0:
                out["grad"] = _leaf_norms(grads)
                out["hits_per_ray"] = hits
            opt.step(grads)
            del grads, rays
        out["change"] = _leaf_norms([p - q for p, q in zip(params, leaves)])
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
        return [x.to(self.ctx.dev) for x in self.start_leaves]
