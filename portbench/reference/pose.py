"""Camera-pose refinement of one view against its target, written out:
the perturbation drawn from the seed, the rays moved by a 6-DOF delta and
built in autograd's graph, the squared-error loss through the blocked
composite, autograd to both deltas, and Adam.

It follows the program's semantics where they depart from an exact trace
at the moved pose: the scene is binned once, at the perturbed base pose
(`binning.bin_frame`), and every step composites the moved rays through
those tile lists (`composite`), as the program's bind does.  A Gaussian
that the moved camera would see in another tile than the base camera
does is missed by both, alike.

Everything runs in float32 with TF32 off (`refinement` turns it off);
the composite may run in another dtype (the bfloat16 control), the rays'
geometry and Adam stay in float32.

  * `rodrigues(r)`: axis-angle (3,) -> rotation (3, 3), the small-angle
    series below t^2 = 1e-12;
  * `perturbed_view(view, seed, sigma_t)`: the view jittered as the
    program's `perturb_cameras` draws it from `np.random.default_rng(seed)`:
    a translation of sigma_t, then a rotation of sigma_t / 3 radians, each
    normal per axis; the rotation's matrix in float32 multiplies the
    pose's in float64;
  * `posed_rays(view, st, t, r)`: (tiles, 24, R) rays of the view moved by
    (t, rodrigues(r)): each pixel's NDC target through the projection's
    inverse (float64 on the host, then float32), rotated by rodrigues(r)
    times the pose's rotation, normalised; origins the pose's centre plus
    t; the clip and SH-basis rows as `camera.tile_rays` builds them;
  * `Refinement(act, rows, view, target_tiles, st)`: one camera's
    refinement; `step()` -> (loss before the update, d loss / d t,
    d loss / d r, mean hits per ray), then one Adam step (b1 0.9, b2
    0.999, eps 1e-8, lr 3e-3: optax's `adam` defaults).
"""

from __future__ import annotations

import numpy as np
import torch

from . import binning as ref_bin
from . import camera as ref_cam
from .composite import _batches, _order, _walk
from .math import Settings, clip_box, sh_basis

LR, B1, B2, EPS = 3e-3, 0.9, 0.999, 1e-8


def rodrigues(r: torch.Tensor) -> torch.Tensor:
    """R = I + A sin(t)/t + A^2 (1 - cos t)/t^2, A = skew(r); below t^2 =
    1e-12 the coefficients' series, the other branch fed a safe angle."""
    t2 = (r * r).sum()
    big = t2 > 1e-12
    safe = torch.where(big, t2, torch.ones_like(t2))
    t = torch.sqrt(safe)
    a = torch.where(big, torch.sin(t) / t, 1.0 - t2 / 6.0)
    b = torch.where(big, (1.0 - torch.cos(t)) / safe, 0.5 - t2 / 24.0)
    zero = torch.zeros_like(r[0])
    skew = torch.stack([torch.stack([zero, -r[2], r[1]]),
                        torch.stack([r[2], zero, -r[0]]),
                        torch.stack([-r[1], r[0], zero])])
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + a * skew + b * (skew @ skew)


def perturbed_view(view: ref_cam.View, seed, sigma_t: float
                   ) -> ref_cam.View:
    rng = np.random.default_rng(seed)
    dt = rng.normal(0.0, sigma_t, 3)
    dr = rng.normal(0.0, sigma_t / 3.0, 3)
    with torch.no_grad():
        rot = rodrigues(torch.as_tensor(dr, dtype=torch.float32)).numpy()
    c2w = np.array(view.c2w, np.float64)
    c2w[:3, :3] = rot @ c2w[:3, :3]
    c2w[:3, 3] = c2w[:3, 3] + dt
    return view._replace(c2w=c2w)


def ndc_targets(view: ref_cam.View, st: Settings, device) -> torch.Tensor:
    """(H, W, 3) float32: each pixel centre's NDC point through the
    projection's inverse, worked out in float64."""
    h, w = view.height, view.width
    proj_inv = np.linalg.inv(ref_cam.projection(view, st))
    xs = (np.arange(w, dtype=np.float64) + 0.5) / w * 2.0 - 1.0
    ys = (np.arange(h, dtype=np.float64) + 0.5) / h * 2.0 - 1.0
    dx, dy = np.meshgrid(xs, ys)
    ndc = np.stack([dx, dy, np.ones_like(dx), np.ones_like(dx)], axis=-1)
    return torch.as_tensor((ndc @ proj_inv.T)[..., :3].astype(np.float32),
                           device=device)


def posed_rays(view: ref_cam.View, st: Settings, ndc: torch.Tensor,
               t: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    dev = ndc.device
    c2w = torch.as_tensor(np.asarray(view.c2w, np.float32), device=dev)
    rot = rodrigues(r) @ c2w[:3, :3]
    d = ndc @ rot.T
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    o = (c2w[:3, 3] + t).expand(d.shape)
    tmin, tmax = clip_box(st.aabb, o, d)
    basis = sh_basis(d[..., 0], d[..., 1], d[..., 2], st.sh_degree)
    rays = torch.cat([o, d, tmin[..., None], tmax[..., None],
                      torch.stack(basis, dim=-1)], dim=-1)
    ts, h, w = st.tile_size, view.height, view.width
    return (rays.reshape(h // ts, ts, w // ts, ts, 24).permute(0, 2, 4, 1, 3)
            .reshape(-1, 24, ts * ts))


def loss_and_ray_grads(rows: torch.Tensor, binned: ref_bin.Binned,
                       rays: torch.Tensor, target_tiles: torch.Tensor,
                       st: Settings, max_blocks: int = 4096):
    """The mean squared rgb error over every pixel and channel, its
    gradient w.r.t. the (tiles, 24, R) rays in float32, and the mean hit
    count per ray.  The composite runs in rows' dtype (the rays cast to
    it), in batches of tiles, each batch's loss differentiated on its own;
    a tile no block reaches is black."""
    num_tiles, _, r = rays.shape
    denom = float(num_tiles * r * 3)
    rays_d = rays.detach().to(rows.dtype).requires_grad_()
    grad = torch.zeros(rays.shape, dtype=torch.float32, device=rays.device)
    counts, order = _order(binned)
    reached = np.zeros(num_tiles, bool)
    reached[order] = True
    loss = ((target_tiles[torch.as_tensor(~reached, device=rays.device)]
             ** 2).sum(dtype=torch.float64) / denom)
    hits = torch.zeros((), dtype=torch.float64, device=rays.device)
    for tiles in _batches(counts, order, 1024, max_blocks):
        rgb, _, _, h = _walk(rows, binned, rays_d, tiles, counts, st)
        tt = torch.as_tensor(tiles, device=rays.device)
        part = ((rgb.to(target_tiles.dtype) - target_tiles[tt]) ** 2).sum() \
            / denom
        g, = torch.autograd.grad(part, rays_d)
        grad += g.float()
        loss = loss + part.detach().double()
        hits = hits + h.sum(dtype=torch.float64)
    return float(loss), grad, float(hits) / (num_tiles * r)


class Refinement:
    """One camera bound at `view` (its perturbed base pose): its tile lists
    from `act`, the scene's rows `rows` (their dtype is the composite's),
    the target (tiles, 3, R) float32, and Adam over (t, r) from zero."""

    def __init__(self, act, rows, view: ref_cam.View, target_tiles,
                 st: Settings):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = target_tiles.device
        self.view, self.st, self.rows = view, st, rows
        self.target = target_tiles
        w2c, proj = ref_cam.matrices(view, st)
        with torch.no_grad():
            self.binned = ref_bin.bin_frame(act, w2c, proj, view.width,
                                            view.height, st)
        self.ndc = ndc_targets(view, st, dev)
        self.t = torch.zeros(3, device=dev)
        self.r = torch.zeros(3, device=dev)
        self.m = [torch.zeros(3, device=dev) for _ in range(2)]
        self.v = [torch.zeros(3, device=dev) for _ in range(2)]
        self.k = 0

    def step(self):
        t = self.t.clone().requires_grad_()
        r = self.r.clone().requires_grad_()
        rays = posed_rays(self.view, self.st, self.ndc, t, r)
        loss, bar_rays, hits = loss_and_ray_grads(
            self.rows, self.binned, rays, self.target, self.st)
        g_t, g_r = torch.autograd.grad(rays, (t, r), bar_rays)
        self.k += 1
        with torch.no_grad():
            for i, (p, g) in enumerate(((self.t, g_t), (self.r, g_r))):
                self.m[i] = B1 * self.m[i] + (1.0 - B1) * g
                self.v[i] = B2 * self.v[i] + (1.0 - B2) * g * g
                m_hat = self.m[i] / (1.0 - B1 ** self.k)
                v_hat = self.v[i] / (1.0 - B2 ** self.k)
                p -= LR * m_hat / (torch.sqrt(v_hat) + EPS)
        return loss, g_t, g_r, hits
