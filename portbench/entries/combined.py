"""The mesh viewer's entry: `render.combined.CombinedRenderer.render` under
`torch.no_grad()`, the CLI's `render --mesh` / `benchmark --mesh` path, one
frame after another in a closed loop, as the viewer's entry (`serve.py`)
drives `TiledRenderer.render`.

Set-up builds the renderer first, with the configuration's mesh (the
CLI's procedural scene that `mesh.scene` names, placed in the cloud's box;
the reference builds it from the numbers under `mesh`), so a program
without it fails before the scene is drawn; then as `serve.py`: the scene
drawn from the seed, capacity planned over `plan_views` orbit views,
`warmup_frames` frames.  The window keeps `check_frames` frames drawn from
the seed; afterwards the reference (`reference/mesh.py` over the Gaussian
reference) draws the scene and the mesh again and renders the same views.
Compared: `rays_off` and `rgb_gap` of the combined frame (rgb, T, depth,
hit counts, as `serve.py`), `mesh_off` (the share of pixels whose mesh hit
or miss differs, or whose t differs by more than 1e-5 of it), and
`mesh_rgb_gap` (the mean |d mesh_rgb|); `hits_per_ray` over the rays the
reference's mesh leaves unclipped.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from portbench import harness as h
from portbench.entries import serve
from portbench.generator import Mix
from portbench.reference import binning as ref_bin
from portbench.reference import camera as ref_cam
from portbench.reference import mesh as ref_mesh
from portbench.reference.math import activate, param_rows
from portbench.scene import draw

SYNC_EACH_UNIT = True
#: what the window keeps of a frame for the comparison
KEPT = ("rgb", "depth", "transmittance", "hit_count", "mesh_rgb", "mesh_t")


def mesh_scene(gt, config: dict):
    """The program's MeshScene of the configuration: the CLI's procedural
    scene `mesh.scene` (`render --mesh NAME`) placed in the cloud's box,
    centre +- extent, with y up."""
    c, e = np.asarray(config["centre"], np.float64), float(config["extent"])
    m = config["mesh"]
    return gt.hybrid.mesh.PROCEDURAL[m["scene"]](
        c - e, c + e, up=1, subdiv=int(m["sphere_subdiv"]))


def mesh_numbers(got: dict, want: dict):
    """(pixels off, pixels, |d mesh_rgb| sum) of the mesh pass: a pixel is
    off when one side hits and the other misses, or when both hit and t
    differs by more than 1e-5 of the reference's."""
    g_t, w_t = got["mesh_t"].float().cpu(), want["mesh_t"].float().cpu()
    g_hit, w_hit = torch.isfinite(g_t), torch.isfinite(w_t)
    both = g_hit & w_hit
    far = torch.zeros_like(both)
    far[both] = (g_t[both] - w_t[both]).abs() > 1e-5 * w_t[both].abs()
    off = (g_hit != w_hit) | far
    d_rgb = (got["mesh_rgb"].float().cpu() - want["mesh_rgb"].float().cpu())
    return int(off.sum()), off.numel(), float(d_rgb.abs().double().sum())


class Session(serve.Session):
    def __init__(self, ctx: h.Context):
        self.ctx = ctx
        gt, c, t, dev = ctx.gt, ctx.cell.config, ctx.cell.traffic, ctx.dev
        cfg = h.render_config(gt, c)
        width, height = h.size(c)
        m = c["mesh"]
        hcfg = gt.hybrid.HybridConfig(shadow_rays=bool(m["shadow_rays"]))
        self.shadows = bool(m["gaussian_shadows"])
        self.renderer = gt.render.combined.CombinedRenderer(
            width, height, mesh_scene(gt, c), cfg, hcfg, device=dev)
        scene, _ = draw(c, ctx.seed, dev)
        self.model = gt.GaussianModel(*scene)
        del scene
        self.mix = Mix(t, c, ctx.seed)
        h.log("combined: scene drawn, mesh packed")
        self.renderer.plan(self.model, [h.camera(gt, v)
                                        for v in self.mix.plan_views()])
        h.log(f"combined: planned {self.renderer.gaussians.capacity}")
        with torch.no_grad():
            for v in self.mix.warmup_views():
                self.render(h.camera(gt, v))
        h.sync(dev)
        h.log("combined: warmed up")
        self.pick = random.Random(ctx.seed)
        self.keep = int(t["check_frames"])
        self.kept = []
        self.overflow = 0
        self.unit_views = []

    def render(self, camera):
        return self.renderer.render(self.model, camera,
                                    gaussian_shadows=self.shadows)

    def unit(self, i: int) -> int:
        view = self.mix.frame(i)
        with torch.no_grad():
            out = self.render(h.camera(self.ctx.gt, view))
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
        self.kept = [(v, {k: out[k].detach().to("cpu") for k in KEPT})
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
        del leaves
        mesh = ref_mesh.Mesh(c["mesh"], dev)
        tot = {side: [0, 0, 0.0, 0, 0, 0.0] for side in ("prog", "ctrl")}
        hits = rays_n = 0.0
        for view, got in self.kept:
            w2c, proj = ref_cam.matrices(view, st)
            binned = ref_bin.bin_frame(act, w2c, proj, view.width,
                                       view.height, st)
            want = ref_mesh.render(rows, binned, view, st, mesh, dev)
            free = ~torch.isfinite(want["mesh_t"])
            hits += float(want["hit_count"][free].double().sum())
            rays_n += float(free.sum())
            sides = [("prog", got)]
            if control:
                sides.append(("ctrl", ref_mesh.render(
                    rows.to(torch.bfloat16), binned, view, st, mesh, dev)))
            img = torch.cat([want["rgb"], want["depth"][..., None],
                             want["transmittance"][..., None],
                             want["hit_count"][..., None]], -1)
            for side, out in sides:
                off, n, drgb = serve.frame_numbers(out, img)
                m_off, m_n, m_rgb = mesh_numbers(out, want)
                for k, x in enumerate((off, n, drgb, m_off, m_n, m_rgb)):
                    tot[side][k] += x
            del binned, want, img
        out = {}
        for side, (off, n, drgb, m_off, m_n, m_rgb) in tot.items():
            if n:
                out[side] = {"rays_off": off / n, "rgb_gap": drgb / (3 * n),
                             "mesh_off": m_off / m_n,
                             "mesh_rgb_gap": m_rgb / (3 * m_n),
                             "hits_per_ray": hits / max(rays_n, 1.0)}
        out["prog"]["overflow"] = self.overflow
        return out
