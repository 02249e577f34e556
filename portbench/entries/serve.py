"""The viewer's entry: `TiledRenderer.render` under `torch.no_grad()`, the
CLI's `render`/`benchmark` path, one frame after another in a closed loop
(the next frame once the previous frame's image is ready).

Set-up plans the renderer's capacity over `plan_views` views of the orbit
and renders `warmup_frames` frames before the window's first.  The
window keeps `check_frames` frames drawn from the seed over the whole
window; afterwards the reference draws the scene again, bins and
composites the same views, and compares every ray.  A frame whose
binning overflowed its plan counts as failed.
"""

from __future__ import annotations

import random

import torch

from portbench import harness as h
from portbench.generator import Mix
from portbench.reference import binning as ref_bin
from portbench.reference import camera as ref_cam
from portbench.reference import composite as ref_comp
from portbench.reference.math import activate, param_rows
from portbench.scene import draw

SYNC_EACH_UNIT = True


def frame_numbers(got: dict, want: torch.Tensor):
    """(rays off, rays, |d rgb| sum) of a frame against the reference's
    (H, W, 8) image: a ray is off when rgb or T differs by more than 1e-5,
    depth by more than 1e-4, or its hit count at all."""
    w = want.to("cpu", torch.float32)
    g = {k: v.to("cpu", torch.float32) for k, v in got.items()}
    d_rgb = (g["rgb"] - w[..., 0:3]).abs()
    off = ((d_rgb.amax(-1) > 1e-5)
           | ((g["transmittance"] - w[..., 4]).abs() > 1e-5)
           | ((g["depth"] - w[..., 3]).abs() > 1e-4)
           | (g["hit_count"] != w[..., 5]))
    return int(off.sum()), off.numel(), float(d_rgb.double().sum())


class Session:
    def __init__(self, ctx: h.Context):
        self.ctx = ctx
        gt, c, t, dev = ctx.gt, ctx.cell.config, ctx.cell.traffic, ctx.dev
        cfg = h.render_config(gt, c)
        width, height = h.size(c)
        scene, _ = draw(c, ctx.seed, dev)
        self.model = gt.GaussianModel(*scene)
        del scene
        self.mix = Mix(t, c, ctx.seed)
        self.renderer = gt.render.TiledRenderer(width, height, cfg,
                                                device=dev)
        h.log("serve: scene drawn")
        self.renderer.plan(self.model, [h.camera(gt, v)
                                        for v in self.mix.plan_views()])
        h.log(f"serve: planned {self.renderer.capacity}")
        with torch.no_grad():
            for v in self.mix.warmup_views():
                self.renderer.render(self.model, h.camera(gt, v))
        h.sync(dev)
        h.log("serve: warmed up")
        self.pick = random.Random(ctx.seed)
        self.keep = int(t["check_frames"])
        self.kept = []
        self.overflow = 0
        self.unit_views = []

    def start(self):
        pass

    def unit(self, i: int) -> int:
        view = self.mix.frame(i)
        with torch.no_grad():
            out = self.renderer.render(self.model, h.camera(self.ctx.gt, view))
        failed = int(int(out["overflow"]) > 0)
        self.overflow += failed
        if i < self.keep:
            self.kept.append((view, out))
        else:
            j = self.pick.randrange(i + 1)
            if j < self.keep:
                self.kept[j] = (view, out)
        self.unit_views = [view]
        return failed

    def release(self):
        self.kept = [(v, {k: out[k].detach().to("cpu") for k in
                          ("rgb", "depth", "transmittance", "hit_count")})
                     for v, out in self.kept]
        self.renderer = self.model = None

    def readings(self, control: bool):
        """The compared numbers of the kept frames, and with `control`
        those of the reference in bfloat16 in the program's place."""
        cell, dev = self.ctx.cell, self.ctx.dev
        c, st = cell.config, h.settings(cell.config)
        leaves, _ = draw(c, self.ctx.seed, dev)
        act = activate(*leaves)
        rows = param_rows(act)
        tot = {"prog": [0, 0, 0.0], "ctrl": [0, 0, 0.0]}
        hits = rays_n = 0.0
        for view, got in self.kept:
            w2c, proj = ref_cam.matrices(view, st)
            binned = ref_bin.bin_frame(act, w2c, proj, view.width,
                                       view.height, st)
            rays = ref_cam.tile_rays(view, st, dev)
            acc = ref_comp.render(rows, binned, rays, st)
            want = ref_cam.from_tiles(acc, view.width, view.height,
                                      st.tile_size)
            hits += float(acc[:, 5].double().sum())
            rays_n += acc.shape[0] * acc.shape[2]
            sides = [("prog", got)]
            if control:
                low = ref_comp.render(rows.to(torch.bfloat16), binned, rays,
                                      st)
                img = ref_cam.from_tiles(low.float(), view.width,
                                         view.height, st.tile_size)
                sides.append(("ctrl", {
                    "rgb": img[..., 0:3], "depth": img[..., 3],
                    "transmittance": img[..., 4], "hit_count": img[..., 5]}))
            for side, out in sides:
                off, n, drgb = frame_numbers(out, want)
                tot[side][0] += off
                tot[side][1] += n
                tot[side][2] += drgb
            del binned, rays, acc, want
        out = {}
        for side, (off, n, drgb) in tot.items():
            if n:
                out[side] = {"rays_off": off / n, "rgb_gap": drgb / (3 * n),
                             "hits_per_ray": hits / rays_n}
        out["prog"]["overflow"] = self.overflow
        return out

    def bound_leaves(self):
        return draw(self.ctx.cell.config, self.ctx.seed, self.ctx.dev)[0]
